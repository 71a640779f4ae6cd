"""Text-recognition metrics: word accuracy variants, character precision
and recall, 1 - N.E.D. (copy of ``tps_pp_tpu/evaluation/ocr_metric.py``,
the reference's ``mmocr/core/evaluation/ocr_metric.py:84-134``).

The headline metric is ``word_acc_ignore_case_symbol``: lower-cased, with
every character outside ``[A-Za-z0-9一-龥]`` dropped. Levenshtein distance
is rapidfuzz's where it is installed, else a pure-Python DP; the JAX
package's optional C extension (``tps_pp_tpu.native``) is not used.
"""
from __future__ import annotations

import re
from difflib import SequenceMatcher
from typing import Dict, List


def _levenshtein_py(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _resolve_levenshtein():
    try:
        from rapidfuzz.distance import Levenshtein
        return Levenshtein.distance
    except ImportError:
        return _levenshtein_py


levenshtein = _resolve_levenshtein()

_IGNORE_SYMBOL_RE = re.compile('[^A-Z^a-z^0-9^一-龥]')


def cal_true_positive_char(pred: str, gt: str) -> int:
    tp = 0
    for opt, _, _, s2, e2 in SequenceMatcher(None, pred, gt).get_opcodes():
        if opt == 'equal':
            tp += e2 - s2
    return tp


def count_matches(pred_texts: List[str], gt_texts: List[str]) -> Dict:
    match_res = {
        'gt_char_num': 0,
        'pred_char_num': 0,
        'true_positive_char_num': 0,
        'gt_word_num': 0,
        'match_word_num': 0,
        'match_word_ignore_case': 0,
        'match_word_ignore_case_symbol': 0,
    }
    norm_ed_sum = 0.0
    for pred_text, gt_text in zip(pred_texts, gt_texts):
        if gt_text == pred_text:
            match_res['match_word_num'] += 1
        gt_lower = gt_text.lower()
        pred_lower = pred_text.lower()
        if gt_lower == pred_lower:
            match_res['match_word_ignore_case'] += 1
        gt_ignore = _IGNORE_SYMBOL_RE.sub('', gt_lower)
        pred_ignore = _IGNORE_SYMBOL_RE.sub('', pred_lower)
        if gt_ignore == pred_ignore:
            match_res['match_word_ignore_case_symbol'] += 1
        match_res['gt_word_num'] += 1

        edit_dist = levenshtein(pred_ignore, gt_ignore)
        norm_ed_sum += float(edit_dist) / max(1, len(gt_ignore),
                                              len(pred_ignore))

        match_res['gt_char_num'] += len(gt_ignore)
        match_res['pred_char_num'] += len(pred_ignore)
        match_res['true_positive_char_num'] += cal_true_positive_char(
            pred_ignore, gt_ignore)

    match_res['ned'] = norm_ed_sum / max(1, len(gt_texts))
    return match_res


def eval_ocr_metric(pred_texts: List[str], gt_texts: List[str],
                    full: bool = False) -> Dict[str, float]:
    """The headline metric; ``full=True`` adds the ones the reference
    computes but leaves commented out (ocr_metric.py:124-129). Each value
    rounded to 4 decimals."""
    if len(pred_texts) != len(gt_texts):
        raise ValueError(f'{len(pred_texts)} predictions for '
                         f'{len(gt_texts)} ground truths')
    m = count_matches(pred_texts, gt_texts)
    eps = 1e-8
    res = {
        'word_acc_ignore_case_symbol':
            1.0 * m['match_word_ignore_case_symbol'] / (eps + m['gt_word_num'])
    }
    if full:
        res.update({
            'word_acc': 1.0 * m['match_word_num'] / (eps + m['gt_word_num']),
            'word_acc_ignore_case':
                1.0 * m['match_word_ignore_case'] / (eps + m['gt_word_num']),
            'char_recall':
                1.0 * m['true_positive_char_num'] / (eps + m['gt_char_num']),
            'char_precision':
                1.0 * m['true_positive_char_num'] / (eps + m['pred_char_num']),
            '1-N.E.D': 1.0 - m['ned'],
        })
    return {k: float(f'{v:.4f}') for k, v in res.items()}
