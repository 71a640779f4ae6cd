"""Attention-decoder codec (copy of ``tps_pp_tpu/convertors/attn.py``).

Token layout: charset, then <UKN> (with_unknown), then <BOS/EOS> (one shared
index unless ``start_end_same=False``), then <PAD>. DICT90 + unknown gives 93
classes with start = end = 91 and pad = 92. ``tensor2idx`` is the greedy
argmax that stops at the first EOS.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..registry import CONVERTORS
from .base import BaseConvertor


@CONVERTORS.register_module()
class AttnConvertor(BaseConvertor):

    def __init__(self,
                 dict_type='DICT90',
                 dict_file=None,
                 dict_list=None,
                 with_unknown=True,
                 max_seq_len=40,
                 lower=False,
                 start_end_same=True,
                 **kwargs):
        super().__init__(dict_type, dict_file, dict_list)
        self.with_unknown = bool(with_unknown)
        self.max_seq_len = int(max_seq_len)
        self.lower = bool(lower)
        self.start_end_same = bool(start_end_same)
        self.update_dict()

    def update_dict(self):
        start_end_token = '<BOS/EOS>'
        unknown_token = '<UKN>'
        padding_token = '<PAD>'

        self.unknown_idx = None
        if self.with_unknown:
            self.idx2char.append(unknown_token)
            self.unknown_idx = len(self.idx2char) - 1

        self.idx2char.append(start_end_token)
        self.start_idx = len(self.idx2char) - 1
        if not self.start_end_same:
            self.idx2char.append(start_end_token)
        self.end_idx = len(self.idx2char) - 1

        self.idx2char.append(padding_token)
        self.padding_idx = len(self.idx2char) - 1

        self._rebuild_char2idx()

    def str2tensor(self, strings: List[str]):
        """``padded_targets`` (N, max_seq_len) int32:
        [BOS, c1..ck, EOS, PAD...] truncated at max_seq_len."""
        indexes = self.str2idx(strings)
        padded = np.full((len(strings), self.max_seq_len), self.padding_idx,
                         dtype=np.int32)
        for i, index in enumerate(indexes):
            src = [self.start_idx] + list(index) + [self.end_idx]
            n = min(len(src), self.max_seq_len)
            padded[i, :n] = src[:n]
        return {
            'targets': [np.asarray(x, dtype=np.int32) for x in indexes],
            'padded_targets': padded,
        }

    def tensor2idx(self, outputs, img_metas=None):
        """outputs: (N, T, C) scores as a numpy array."""
        outputs = np.asarray(outputs)
        max_idx = outputs.argmax(-1)
        max_value = np.take_along_axis(outputs, max_idx[..., None],
                                       axis=-1)[..., 0]
        indexes, scores = [], []
        for idx_seq, score_seq in zip(max_idx, max_value):
            str_index, str_score = [], []
            for char_index, char_score in zip(idx_seq.tolist(),
                                              score_seq.tolist()):
                if char_index == self.padding_idx:
                    continue
                if char_index == self.end_idx:
                    break
                str_index.append(char_index)
                str_score.append(char_score)
            indexes.append(str_index)
            scores.append(str_score)
        return indexes, scores
