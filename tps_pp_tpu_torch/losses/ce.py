"""Cross-entropy recognition losses (counterpart of
``tps_pp_tpu/losses/ce.py:27-98``): ``CELoss``, ``SARLoss`` and ``TFLoss``.

The reduction is the reference's end to end: with ``reduction='none'`` (the
default of both) the per-position losses are averaged over ALL positions,
as the reference's ``_parse_losses`` averages the 'none' vector (reference
recognizer/base.py:96-129). Ignored pads add 0 to the sum but count in the
denominator. ``'mean'`` averages over the positions that are not ignored,
as torch's ``CrossEntropyLoss`` does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..registry import LOSSES


def masked_ce(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int,
              reduction: str = 'none') -> torch.Tensor:
    """Cross entropy of logits (..., C) against integer targets (...), in
    float32; targets equal to ``ignore_index`` add nothing. A target outside
    [0, C) (the pad index of a C-1 classifier) is clipped before the lookup
    and must be ignored."""
    if reduction not in ('none', 'mean', 'sum'):
        raise ValueError(f'reduction {reduction!r}')
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = targets.long().clamp(0, logits.shape[-1] - 1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    mask = (targets != ignore_index).float()
    total = (nll * mask).sum()
    if reduction == 'mean':
        return total / mask.sum().clamp(min=1.0)
    if reduction == 'sum':
        return total
    return total / targets.numel()


@LOSSES.register_module()
class CELoss:

    def __init__(self, ignore_index=-1, reduction='none',
                 ignore_first_char=False, **kwargs):
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.ignore_first_char = ignore_first_char

    def format(self, outputs, targets):
        if self.ignore_first_char:
            return outputs[:, :-1, :], targets[:, 1:]
        return outputs, targets

    def __call__(self, outputs, targets_dict, valid_ratio=None
                 ) -> Dict[str, torch.Tensor]:
        outputs, targets = self.format(outputs,
                                       targets_dict['padded_targets'])
        return {'loss_ce': masked_ce(outputs, targets, self.ignore_index,
                                     self.reduction)}


@LOSSES.register_module()
class TFLoss(CELoss):
    """The transformer decoders' loss: the logits of steps 0..T-2 against
    the targets of steps 1..T-1 (reference ce_loss.py:124-134)."""

    def __init__(self, ignore_index=-1, reduction='none', flatten=True,
                 **kwargs):
        super().__init__(ignore_index, reduction)
        self.flatten = flatten

    def format(self, outputs, targets):
        return outputs[:, :-1, :], targets[:, 1:]


@LOSSES.register_module()
class SARLoss(CELoss):
    """SAR's and RobustScanner's loss: the logits of steps 0..T-2 against
    the targets of steps 1..T-1, averaged over the positions that are not
    ignored (``reduction='mean'``; reference ce_loss.py:86-96)."""

    def __init__(self, ignore_index=0, reduction='mean', **kwargs):
        super().__init__(ignore_index, reduction)

    def format(self, outputs, targets):
        return outputs[:, :-1, :], targets[:, 1:]
