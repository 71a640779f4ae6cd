"""Masked-target codec variants (counterpart of
``tps_pp_tpu/convertors/mask.py``; reference ``convertors/maskctc.py`` and
``mask_abi.py``): chosen character positions become <UKN>, giving
(masked, complement) target pairs. The models that read them were deleted
from the reference; the codecs are kept for config compatibility.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..registry import CONVERTORS
from .attn import AttnConvertor
from .ctc import CTCConvertor


def _mask_pair(index: np.ndarray, mask_ids: Sequence[int], unknown: int):
    """(masked, complement): <UKN> at the mask positions, and <UKN>
    everywhere else. Ids outside the sequence are dropped."""
    sel = np.zeros(len(index), bool)
    ids = np.asarray(list(mask_ids), int)
    ids = ids[(ids >= 0) & (ids < len(index))]
    sel[ids] = True
    masked = np.where(sel, unknown, index).astype(np.int32)
    other = np.where(~sel, unknown, index).astype(np.int32)
    return masked, other


@CONVERTORS.register_module()
class MaskCTCConvertor(CTCConvertor):
    """``CTCConvertor`` with masked pairs of the raw character indexes."""

    def mask_id_gen(self, mask_ids, targets):
        pairs = [_mask_pair(t, m, self.unknown_idx)
                 for t, m in zip(targets, mask_ids)]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def str2tensor_mask(self, strings: List[str], mask_ids):
        out = self.str2tensor(strings)
        masked, other = self.mask_id_gen(mask_ids, out['targets'])
        out['masked_targets'] = masked
        out['other_targets'] = other
        return out


@CONVERTORS.register_module()
class Mask_ABIConvertor(AttnConvertor):
    """``AttnConvertor`` with masked pairs of the ABI-shaped sequences:
    truncated to ``max_seq_len - 1`` and EOS-terminated (reference
    mask_abi.py:51-52), so that the pairs line up with the mask ids."""

    def str2tensor_mask(self, strings: List[str], mask_ids):
        out = self.str2tensor(strings)
        tensors = [np.concatenate([
            np.asarray(t, np.int32)[:self.max_seq_len - 1],
            [self.end_idx]]) for t in out['targets']]
        pairs = [_mask_pair(t, m, self.unknown_idx)
                 for t, m in zip(tensors, mask_ids)]
        out['masked_targets'] = [p[0] for p in pairs]
        out['other_targets'] = [p[1] for p in pairs]
        return out
