"""DBNet, the differentiable-binarization text detector (counterpart of
``tps_pp_tpu/models/textdet/dbnet.py:29-195``).

* ``ResNetDet``: a ResNet-18-style trunk, a 7x7/2 stem and a 3/2/1 max
  pool, then BasicBlock stages, giving C2-C5 at strides 4, 8, 16 and 32.
* ``FPNC``: 1x1 laterals, top-down nearest adds, 3x3 smooths, every level
  resized to the 1/4 scale and concatenated. The nearest resize is
  ``jax.image.resize``'s (``models/layers.py`` ``resize_nearest``), which
  differs from torch's ``'nearest'`` where the ratio is not an integer
  (an input side that is not a multiple of 32).
* ``DBHead``: a probability and a threshold branch, each conv3x3-BN-ReLU
  and two stride-2 transposed convolutions, fused as
  ``1 / (1 + exp(-k (P - T)))``; the output is [prob, thr, binary].
* ``DBLoss``: balanced BCE with OHEM on the probability map (all
  positives and the largest ``min(#neg, 3 #pos)`` negative losses, summed
  from a descending sort as JAX does, so that no count leaves the card),
  masked L1 on the threshold map, dice on the binary map; float32.

Modules take and return NHWC (the JAX package's layout) at the detector's
boundary, and run NCHW inside. The ``state_dict`` names are MMOCR 0.4.0's:
mmdet ``ResNet``'s ``conv1`` / ``bn1`` / ``layer{i}.{j}``, FPNC's
``lateral_convs.{i}.conv`` / ``smooth_convs.{i}.conv`` and DBHead's
``binarize.{0,1,3,4,6}`` / ``threshold.{0,1,3,4,6}``. flax's
``ConvTranspose`` does not flip its kernel, so the converter flips it
(``utils/convert.py``, kind ``'conv_transpose'``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import BACKBONES, HEADS, LOSSES, NECKS
from ..layers import (BasicBlock, BatchNorm2d, max_pool, nhwc_to_nchw,
                      resize_nearest)


class _ResNetStem(nn.Module):
    """mmdet's ``ResNet`` without its stages: ``conv1`` 7x7/2, ``bn1``,
    ReLU and the 3/2/1 max pool, then ``layer1..4``, which a subclass
    makes; ``forward`` takes NHWC, the stages run NCHW."""

    def __init__(self, base_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, base_channels, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(base_channels, eps=1e-5)

    def forward(self, x: torch.Tensor):
        """NHWC image -> (C2, C3, C4, C5), NCHW."""
        x = max_pool(F.relu(self.bn1(self.conv1(nhwc_to_nchw(x)))), 3, 2, 1)
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNetDet(_ResNetStem):
    """ResNet-18-style trunk: BasicBlock stages of ``base_channels`` x 1,
    2, 4, 8, the first block of stages 2-4 at stride 2."""

    def __init__(self, stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 base_channels: int = 64, **kwargs):
        super().__init__(base_channels)
        cin, ch = base_channels, base_channels
        for si, blocks in enumerate(stage_blocks):
            layers = []
            for b in range(blocks):
                s = 2 if (si > 0 and b == 0) else 1
                layers.append(BasicBlock(cin, ch, stride=s,
                                         use_downsample=s != 1 or cin != ch,
                                         use_conv1x1=False))
                cin = ch
            setattr(self, f'layer{si + 1}', nn.Sequential(*layers))
            ch *= 2


class _Conv(nn.Module):
    """mmcv's ``ConvModule`` with neither norm nor activation: ``.conv``
    (FPNC's has no bias, mmdet's FPN's has one)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)

    def forward(self, x):
        return self.conv(x)


@NECKS.register_module()
class FPNC(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 256, 512),
                 lateral_channels: int = 256, out_channels: int = 64,
                 **kwargs):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            _Conv(c, lateral_channels, 1) for c in in_channels)
        self.smooth_convs = nn.ModuleList(
            _Conv(lateral_channels, out_channels, 3) for _ in in_channels)

    def forward(self, inputs):
        """NCHW levels -> their fusion at the first level's size, NCHW."""
        lat = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_nearest(lat[i],
                                                     lat[i - 1].shape[2:])
        outs = [conv(x) for conv, x in zip(self.smooth_convs, lat)]
        size = outs[0].shape[2:]
        return torch.cat([outs[0]] + [resize_nearest(o, size)
                                      for o in outs[1:]], dim=1)


def _up_branch(cin: int, mid: int) -> nn.Sequential:
    """conv3x3-BN-ReLU, then two stride-2 transposed convolutions, then a
    sigmoid (MMOCR's ``db_head.py:60-66``; the indices are its names)."""
    return nn.Sequential(
        nn.Conv2d(cin, mid, 3, padding=1, bias=False),
        BatchNorm2d(mid, eps=1e-5), nn.ReLU(),
        nn.ConvTranspose2d(mid, mid, 2, stride=2),
        BatchNorm2d(mid, eps=1e-5), nn.ReLU(),
        nn.ConvTranspose2d(mid, 1, 2, stride=2), nn.Sigmoid())


@HEADS.register_module()
class DBHead(nn.Module):
    def __init__(self, in_channels: int = 256, k: float = 50.0, **kwargs):
        super().__init__()
        self.k = float(k)
        self.binarize = _up_branch(in_channels, in_channels // 4)
        self.threshold = _up_branch(in_channels, in_channels // 4)

    def forward(self, x):
        """NCHW features -> (N, 3, 4H, 4W): [prob, thr, binary]."""
        prob = self.binarize(x)
        thr = self.threshold(x)
        binary = 1.0 / (1.0 + torch.exp(-self.k * (prob - thr)))
        return torch.cat([prob, thr, binary], dim=1)


@LOSSES.register_module()
class DBLoss:
    """Balanced BCE + masked L1 + dice (reference ``losses/db_loss.py``;
    JAX ``dbnet.py:133-182``)."""

    def __init__(self, alpha=5.0, beta=10.0, negative_ratio=3.0, eps=1e-6,
                 **kwargs):
        self.alpha = alpha
        self.beta = beta
        self.negative_ratio = negative_ratio
        self.eps = eps

    def __call__(self, preds: torch.Tensor, targets) -> dict:
        """preds: (N, H, W, 3) [prob, thr, binary]; targets: ``gt_shrink``,
        ``gt_shrink_mask``, ``gt_thr``, ``gt_thr_mask``, each (N, H, W)."""
        prob, thr, binary = preds.float().unbind(-1)
        gt = targets['gt_shrink'].float()
        mask = targets['gt_shrink_mask'].float()
        gt_thr = targets['gt_thr'].float()
        thr_mask = targets['gt_thr_mask'].float()
        eps = self.eps
        bce = -(gt * torch.log(prob + eps)
                + (1 - gt) * torch.log(1 - prob + eps))
        pos = gt * mask
        neg = (1 - gt) * mask
        n_pos = pos.sum()
        n_neg_keep = torch.minimum(neg.sum(),
                                   n_pos * self.negative_ratio).floor()
        neg_losses = torch.sort((bce * neg).reshape(-1),
                                descending=True).values
        keep = (torch.arange(neg_losses.numel(), device=preds.device)
                < n_neg_keep).float()
        loss_prob = ((bce * pos).sum() + (neg_losses * keep).sum()) / (
            n_pos + n_neg_keep + eps)
        loss_thr = ((thr - gt_thr).abs() * thr_mask).sum() / (
            thr_mask.sum() + eps)
        inter = (binary * gt * mask).sum()
        union = (binary * mask).sum() + (gt * mask).sum() + eps
        return {'loss_prob': self.alpha * loss_prob,
                'loss_thr': self.beta * loss_thr,
                'loss_db': 1 - 2.0 * inter / union}


class DBNetModule(nn.Module):
    """backbone -> FPNC -> DBHead; NHWC image in, NHWC maps
    (N, H, W, 3) out."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.neck(self.backbone(img))).permute(0, 2, 3, 1)
