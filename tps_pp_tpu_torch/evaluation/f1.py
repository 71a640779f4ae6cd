"""KIE and NER metrics (counterpart of ``tps_pp_tpu/evaluation/f1.py``;
the reference's ``core/evaluation/kie_metric.py`` node F1 and
``ner_metric.py`` entity-level precision, recall and F1). numpy on the
host."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def compute_f1_score(preds: np.ndarray, gts: np.ndarray,
                     ignores: Sequence[int] = (),
                     num_classes: int = None) -> np.ndarray:
    """Each class's F1 of the node predictions, the ``ignores`` left out
    (reference ``kie_metric.compute_f1_score``). ``num_classes`` fixes the
    class count, as the logits' width does in the reference: a class that
    never occurs scores 0 instead of leaving the macro mean; without it the
    count is the largest id seen, plus one."""
    preds = np.asarray(preds)
    gts = np.asarray(gts)
    C = num_classes or int(max(preds.max(initial=0),
                               gts.max(initial=0))) + 1
    f1s = []
    for c in range(C):
        if c in ignores:
            continue
        tp = np.sum((preds == c) & (gts == c))
        fp = np.sum((preds == c) & (gts != c))
        fn = np.sum((preds != c) & (gts == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return np.asarray(f1s, np.float32)


def _extract_entities(labels: List[str]) -> List[Tuple[str, int, int]]:
    """BIO tags -> (type, start, end) spans, seqeval's reading: an ``I-X``
    after another type, or after ``O``, starts an X span."""
    entities = []
    start, etype = None, None
    for i, tag in enumerate(list(labels) + ['O']):
        cur = tag[2:] if (tag.startswith('B-') or
                          tag.startswith('I-')) else None
        if etype is not None and (cur != etype or tag.startswith('B-')):
            entities.append((etype, start, i - 1))
            etype = None
        if cur is not None and etype is None:
            etype, start = cur, i
    return entities


def eval_ner_f1(pred_tags: Sequence[List[str]],
                gt_tags: Sequence[List[str]]) -> Dict[str, float]:
    """Entity-level micro precision, recall and F1 over BIO sequences,
    rounded to 4 places (the reference's ``ner_metric``)."""
    n_pred = n_gt = n_correct = 0
    for p, g in zip(pred_tags, gt_tags):
        pe = set(_extract_entities(p))
        ge = set(_extract_entities(g))
        n_pred += len(pe)
        n_gt += len(ge)
        n_correct += len(pe & ge)
    eps = 1e-8
    precision = n_correct / (n_pred + eps)
    recall = n_correct / (n_gt + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return {'precision': round(precision, 4), 'recall': round(recall, 4),
            'f1-score': round(f1, 4)}
