"""``ABILoss`` (counterpart of ``tps_pp_tpu/losses/abi.py``; reference
losses/mix_loss.py:10-119).

Cross entropy of each branch's logits against the EOS-padded targets,
counting the positions below each target's length (its characters and
the EOS): the mean over those positions, as the reference's flattening to
the true lengths gives. The language and fusion terms average their
iterations; each term carries its weight.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..registry import LOSSES


def masked_ce_by_length(logits: torch.Tensor, targets: torch.Tensor,
                        lengths: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """logits (N, T, C), targets (N, T), lengths (N,) -> the mean float32
    cross entropy over the positions ``t < lengths``; targets are clipped to
    [0, num_classes - 1] before the lookup."""
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = targets.long().clamp(0, num_classes - 1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    pos = torch.arange(targets.shape[1], device=targets.device)
    mask = (pos[None, :] < lengths[:, None]).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


@LOSSES.register_module()
class ABILoss:

    def __init__(self, enc_weight=1.0, dec_weight=1.0, fusion_weight=1.0,
                 num_classes=37, **kwargs):
        self.enc_weight = float(enc_weight)
        self.dec_weight = float(dec_weight)
        self.fusion_weight = float(fusion_weight)
        self.num_classes = num_classes

    def __call__(self, outputs: Dict, targets_dict: Dict,
                 valid_ratio=None) -> Dict[str, torch.Tensor]:
        """``outputs``: the recognizer's ``out_enc``, ``out_decs`` and
        ``out_fusers``; ``targets_dict``: ``padded_targets`` and
        ``target_lengths``."""
        targets = targets_dict['padded_targets']
        lengths = targets_dict['target_lengths']

        def ce(out):
            return masked_ce_by_length(out['logits'], targets, lengths,
                                       self.num_classes)

        losses = {}
        if outputs.get('out_enc') is not None:
            losses['loss_visual'] = self.enc_weight * ce(outputs['out_enc'])
        if outputs.get('out_decs'):
            dec = [ce(o) for o in outputs['out_decs']]
            losses['loss_lang'] = self.dec_weight * sum(dec) / len(dec)
        if outputs.get('out_fusers'):
            fus = [ce(o) for o in outputs['out_fusers']]
            losses['loss_fusion'] = self.fusion_weight * sum(fus) / len(fus)
        return losses
