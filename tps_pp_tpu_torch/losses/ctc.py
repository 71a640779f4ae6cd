"""``CTCLoss`` (counterpart of ``tps_pp_tpu/losses/ctc.py:24-74``; reference
``losses/ctc_loss.py:11-107``) on ``F.ctc_loss`` with ``reduction='none'``
over the float32 ``log_softmax`` of the logits.

The JAX package's behaviours, kept:

* each target length is clamped to ``min(L, T)`` (L the padded targets'
  width, T the frames), as the reference clamps them to the frame count;
* an empty target scores the all-blank alignment;
* ``flatten=False`` with a ``valid_ratio`` counts only the first
  ``ceil(valid_ratio * T)`` frames of each sequence;
* ``zero_infinity`` zeroes, with their gradient, the sequences whose loss
  cannot be made (torch's inf) and, as JAX's threshold on optax's
  saturated value does, any loss of 5e4 or more;
* ``'mean'`` divides each sequence's loss by ``max(length, 1)`` and then
  averages over the batch; ``'sum'`` sums; anything else returns the
  (N,) losses.

Kept from torch, not from optax: without ``zero_infinity`` a sequence
whose alignment cannot be made has loss ``inf`` (optax saturates near
1e5).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..registry import LOSSES

# optax's saturated loss of an alignment that cannot be made is ~1e5; the
# JAX package's zero_infinity zeroes from here up
SATURATION_THR = 0.5e5


@LOSSES.register_module()
class CTCLoss:

    def __init__(self, flatten=True, blank=0, reduction='mean',
                 zero_infinity=False, **kwargs):
        self.flatten = flatten
        self.blank = blank
        self.reduction = reduction
        self.zero_infinity = zero_infinity

    def __call__(self, outputs: torch.Tensor, targets_dict: Dict,
                 valid_ratio=None) -> Dict[str, torch.Tensor]:
        """outputs (N, T, C) raw logits; ``targets_dict`` holds
        ``padded_targets`` (N, L) and ``target_lengths`` (N,)."""
        N, T, _ = outputs.shape
        labels = targets_dict['padded_targets'].long()
        lengths = targets_dict['target_lengths'].long().clamp(
            0, min(labels.shape[1], T))
        if not self.flatten and valid_ratio is not None:
            vr = torch.as_tensor(valid_ratio, dtype=torch.float32,
                                 device=outputs.device)
            in_len = torch.ceil(vr * T).long().clamp(0, T)
        else:
            in_len = torch.full((N,), T, dtype=torch.long,
                                device=outputs.device)
        logp = F.log_softmax(outputs.float(), dim=-1).transpose(0, 1)
        per_seq = F.ctc_loss(logp, labels, in_len, lengths, blank=self.blank,
                             reduction='none',
                             zero_infinity=self.zero_infinity)
        if self.zero_infinity:
            per_seq = torch.where(per_seq < SATURATION_THR, per_seq,
                                  torch.zeros_like(per_seq))
        if self.reduction == 'mean':
            loss = (per_seq / lengths.clamp(min=1).float()).mean()
        elif self.reduction == 'sum':
            loss = per_seq.sum()
        else:
            loss = per_seq
        return {'loss_ctc': loss}
