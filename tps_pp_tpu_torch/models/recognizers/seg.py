"""The segmentation-based recognizer: FPNOCR neck, SegHead, SegLoss
(counterpart of ``tps_pp_tpu/models/recognizers/seg.py:21-110``; reference
``necks/fpn_ocr.py``, ``heads/seg_head.py``, ``losses/seg_loss.py`` and
``recognizer/seg_recognizer.py``).

The backbone emits multi-scale features (``ResNet31OCR`` with
``out_indices``); the neck merges them top-down and the head predicts a
per-pixel class map. NHWC at the module boundaries, NCHW views inside.
Module names are MMOCR 0.4.0's: ``neck.lateral_convs.{i}``,
``neck.smooth_convs_1x1.{i}``, ``neck.smooth_convs_3x3.{i}``,
``head.seg_conv``, ``head.pred_conv``. Plain PyTorch (cuDNN convolutions,
ATen resizes): in JAX the family is plain XLA, and no Pallas kernel is on
its path.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import HEADS, LOSSES, NECKS
from ..layers import (ConvModule, nchw_to_nhwc, nhwc_to_nchw,
                      resize_nearest)


def _resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., 'bilinear')`` of an NCHW tensor: half-pixel
    centres; where a tap falls outside, the weights of the taps inside are
    renormalised. For an upsample that is torch's ``align_corners=False``
    bilinear, whose clamped source index gives the same edge rows; a
    downsample is antialiased, as in JAX."""
    down = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False, antialias=down)


@NECKS.register_module()
class FPNOCR(nn.Module):
    """Top-down FPN (JAX ``seg.py:21-49``): a 1x1 ``ConvModule`` (BN, no
    bias) a level, then from the coarsest level up: a 2x bilinear upsample,
    a concat with the next finer lateral, a 1x1 and a 3x3 ``ConvModule``.
    Returns the finest output as a 1-tuple (``last_stage_only``) or all of
    them, coarse to fine; NHWC."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512, 512),
                 out_channels: int = 256, last_stage_only: bool = True):
        super().__init__()
        self.last_stage_only = last_stage_only
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, use_norm=True)
            for c in in_channels)
        self.smooth_convs_1x1 = nn.ModuleList(
            ConvModule(2 * out_channels, out_channels, 1, use_norm=True)
            for _ in range(n - 1))
        self.smooth_convs_3x3 = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       use_norm=True) for _ in range(n - 1))

    def forward(self, inputs):
        laterals = [conv(nhwc_to_nchw(x))
                    for conv, x in zip(self.lateral_convs, inputs)]
        outs = []
        for i in range(len(laterals) - 1, 0, -1):
            last = outs[-1] if outs else laterals[-1]
            up = F.interpolate(last, scale_factor=2, mode='bilinear',
                               align_corners=False)
            s = self.smooth_convs_1x1[i - 1](
                torch.cat([up, laterals[i - 1]], dim=1))
            outs.append(self.smooth_convs_3x3[i - 1](s))
        outs = outs[-1:] if self.last_stage_only else outs
        return tuple(nchw_to_nhwc(o) for o in outs)


@HEADS.register_module()
class SegHead(nn.Module):
    """``seg_conv`` (3x3 ``ConvModule`` + BN) and ``pred_conv`` (1x1 with
    bias) on the neck's last output, then the upsample: ``upsample`` (a
    scale, nearest) or the reference's ``upsample_param=dict(scale_factor,
    mode)``, which takes precedence (JAX ``seg.py:52-80``). The nearest
    resize reads JAX's source index (``resize_nearest``). (N, H, W, C)
    logits."""

    def __init__(self, in_channels: int = 128, num_classes: int = 37,
                 upsample: Optional[float] = None,
                 upsample_param: Optional[Dict] = None):
        super().__init__()
        self.seg_conv = ConvModule(in_channels, in_channels, 3, padding=1,
                                   use_norm=True)
        self.pred_conv = nn.Conv2d(in_channels, num_classes, 1)
        self.scale, self.mode = upsample, 'nearest'
        if upsample_param:
            self.scale = float(upsample_param.get('scale_factor', 2.0))
            self.mode = str(upsample_param.get('mode', 'nearest'))

    def forward(self, out_neck):
        x = self.pred_conv(self.seg_conv(nhwc_to_nchw(out_neck[-1])))
        if self.scale:
            size = (int(x.shape[2] * self.scale),
                    int(x.shape[3] * self.scale))
            x = (_resize_bilinear(x, size) if self.mode == 'bilinear'
                 else resize_nearest(x, size))
        return nchw_to_nhwc(x)


@LOSSES.register_module()
class SegLoss:
    """Per-pixel cross entropy in float32 (JAX ``seg.py:83-110``):
    ``ignore_index`` pixels out, the target clipped into the classes
    before the gather; with ``seg_with_loss_weight`` the foreground pixels
    weigh ``n_neg / max(n_valid - n_neg, 1)`` and the background 1; the
    weighted sum over the sum of the weights (at least 1)."""

    def __init__(self, seg_downsample_ratio=0.5, seg_with_loss_weight=True,
                 ignore_index=255, **kwargs):
        self.seg_downsample_ratio = seg_downsample_ratio
        self.seg_with_loss_weight = seg_with_loss_weight
        self.ignore_index = ignore_index

    def __call__(self, out_head: torch.Tensor, gt_kernels: torch.Tensor,
                 valid_ratio=None) -> Dict[str, torch.Tensor]:
        """out_head (N, H, W, C) logits; gt_kernels (N, H, W) integers at
        the head's resolution."""
        C = out_head.shape[-1]
        logits = out_head.reshape(-1, C).float()
        target = gt_kernels.reshape(-1).long()
        valid = target != self.ignore_index
        tgt = target.clamp(0, C - 1)
        nll = -F.log_softmax(logits, dim=-1).gather(1, tgt[:, None])[:, 0]
        if self.seg_with_loss_weight:
            n_valid = valid.sum()
            n_neg = (valid & (target == 0)).sum()
            w_pos = n_neg / torch.clamp(n_valid - n_neg, min=1)
            weights = torch.where(tgt == 0, torch.ones_like(nll),
                                  w_pos.to(nll.dtype))
        else:
            weights = torch.ones_like(nll)
        weights = weights * valid
        return {'loss_seg': (nll * weights).sum() /
                torch.clamp(weights.sum(), min=1.0)}


class SegRecognizerModule(nn.Module):
    """backbone (multi-scale) -> FPNOCR -> SegHead: (N, H, W, C) logits of
    an (N, H0, W0, 3) image."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.neck(self.backbone(img)))

    def forward_test_nar(self, img: torch.Tensor, valid_ratio=None,
                         plain: bool = False) -> torch.Tensor:
        """The serving pass; no kernel is on it, so ``plain`` changes
        nothing."""
        return self(img)
