"""CTC codec (copy of ``tps_pp_tpu/convertors/ctc.py``; reference
``convertors/ctc.py:41-145``).

Token layout: ``<BLK>`` at index 0, the charset, then ``<UKN>`` where
``with_unknown``. ``str2tensor`` gives each string's indexes
(``targets``), their concatenation cut to ``max_seq_len`` each
(``flatten_targets``), the lengths clamped to ``max_seq_len``
(``target_lengths``) and the dense (N, max_seq_len) ``padded_targets``
padded with 0. ``tensor2idx`` takes raw logits, softmaxes them in float64
and collapses repeats and blanks greedily over the first
``min(T, ceil(T * valid_ratio))`` frames.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..registry import CONVERTORS
from .base import BaseConvertor


@CONVERTORS.register_module()
class CTCConvertor(BaseConvertor):

    def __init__(self,
                 dict_type='DICT90',
                 dict_file=None,
                 dict_list=None,
                 with_unknown=True,
                 lower=False,
                 max_seq_len=40,
                 **kwargs):
        super().__init__(dict_type, dict_file, dict_list)
        self.with_unknown = bool(with_unknown)
        self.lower = bool(lower)
        self.max_seq_len = int(max_seq_len)
        self.update_dict()

    def update_dict(self):
        self.blank_idx = 0
        self.idx2char.insert(0, '<BLK>')
        self.unknown_idx = None
        if self.with_unknown:
            self.idx2char.append('<UKN>')
            self.unknown_idx = len(self.idx2char) - 1
        self._rebuild_char2idx()

    def str2tensor(self, strings: List[str]):
        indexes = self.str2idx(strings)
        L = self.max_seq_len
        lengths = np.asarray([len(x) for x in indexes], dtype=np.int32)
        flatten = (np.concatenate([np.asarray(x, dtype=np.int32)[:L]
                                   for x in indexes])
                   if any(len(x) for x in indexes)
                   else np.zeros((0,), dtype=np.int32))
        padded = np.zeros((len(strings), L), dtype=np.int32)
        for i, index in enumerate(indexes):
            n = min(len(index), L)
            padded[i, :n] = index[:n]
        return {
            'targets': [np.asarray(x, dtype=np.int32) for x in indexes],
            'flatten_targets': flatten,
            'target_lengths': np.minimum(lengths, L),
            'padded_targets': padded,
        }

    def tensor2idx(self, output, img_metas=None, topk=1, return_topk=False):
        """output: (N, T, C) raw logits. Returns (indexes, scores), the
        top-1 of each kept frame, or with ``return_topk`` the top-``topk``
        lists of each."""
        output = np.asarray(output, dtype=np.float64)
        output = np.exp(output - output.max(-1, keepdims=True))
        output = output / output.sum(-1, keepdims=True)
        valid_ratios = [1.0] * output.shape[0]
        if img_metas is not None:
            valid_ratios = [m.get('valid_ratio', 1.0) for m in img_metas]
        feat_len = output.shape[1]
        topk_idx = np.argsort(-output, axis=-1)[..., :topk]
        topk_value = np.take_along_axis(output, topk_idx, axis=-1)
        indexes, scores, indexes_topk, scores_topk = [], [], [], []
        for b in range(output.shape[0]):
            decode_len = min(feat_len, math.ceil(feat_len * valid_ratios[b]))
            pred = topk_idx[b, :, 0]
            select, prev = [], self.blank_idx
            for t in range(decode_len):
                v = int(pred[t])
                if v not in (prev, self.blank_idx):
                    select.append(t)
                prev = v
            idx_list = topk_idx[b, select, :].tolist()
            val_list = topk_value[b, select, :].tolist()
            indexes_topk.append(idx_list)
            scores_topk.append(val_list)
            indexes.append([x[0] for x in idx_list])
            scores.append([x[0] for x in val_list])
        if return_topk:
            return indexes_topk, scores_topk
        return indexes, scores
