"""ABINet codec (copy of ``tps_pp_tpu/convertors/abi.py``).

The ``AttnConvertor`` layout with ABINet's target format (reference
``convertors/abi.py:28-68``): a target is its character indexes, cut to
``max_seq_len - 1``, then EOS; ``padded_targets`` pad with EOS and carry no
BOS. ``target_lengths`` count the characters and the EOS. For DICT36
without ``<UKN>``, EOS is 36, ``<PAD>`` 37 and ``num_classes()`` 38.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..registry import CONVERTORS
from .attn import AttnConvertor


@CONVERTORS.register_module()
class ABIConvertor(AttnConvertor):

    def str2tensor(self, strings: List[str]):
        indexes = self.str2idx(strings)
        padded = np.full((len(strings), self.max_seq_len), self.end_idx,
                         dtype=np.int32)
        targets = []
        lengths = np.zeros((len(strings),), dtype=np.int32)
        for i, index in enumerate(indexes):
            src = list(index[:self.max_seq_len - 1]) + [self.end_idx]
            targets.append(np.asarray(src, dtype=np.int32))
            n = min(len(src), self.max_seq_len)
            padded[i, :n] = src[:n]
            lengths[i] = n
        return {'targets': targets, 'padded_targets': padded,
                'target_lengths': lengths}
