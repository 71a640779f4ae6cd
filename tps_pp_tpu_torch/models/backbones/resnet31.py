"""ResNet31-OCR, the NRTR / SAR / RobustScanner trunk (counterpart of
``tps_pp_tpu/models/backbones/resnet31.py``; reference
``backbones/resnet31_ocr.py:11-159``).

Two stem conv-BN-ReLUs, then four stages of (max pool, BasicBlocks in the
3x3 + 3x3 form, conv-BN-ReLU), with the stage-4 pool asymmetric by default
((2, 1): the width kept). ``stem_and_head`` runs the stems and stage 2 (the
reference's TPS hook) and returns (x, skips); ``tail`` runs the rest. Both
take and return NHWC; inside, the convolutions run on NCHW views. Module
names are the reference's: ``conv1_1`` / ``bn1_1``, ``conv1_2`` /
``bn1_2``, ``block{k}.{b}`` (``downsample.{0,1}`` where the width changes)
and ``conv{k}`` / ``bn{k}`` for k = 2..5.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from ...registry import BACKBONES
from ..layers import BasicBlock, BatchNorm2d, max_pool, nchw_to_nhwc, \
    nhwc_to_nchw


@BACKBONES.register_module()
class ResNet31OCR(nn.Module):
    """``stage4_pool`` is the stage-4 pool's window (and stride), None for
    none; the reference's ``stage4_pool_cfg`` (``dict(kernel_size,
    stride)`` of ints or pairs, or None) takes precedence where it is set,
    so that reference configs translate as they are. ``out_indices``
    selects among the four residual stages' outputs (0 = stage 2 ... 3 =
    stage 5) and returns them as a tuple; ``last_stage_pool`` pools 2 x 2
    before stage 5."""

    def __init__(self, base_channels: int = 3,
                 layers: Sequence[int] = (1, 2, 5, 3),
                 channels: Sequence[int] = (64, 128, 256, 256, 512, 512,
                                            512),
                 out_indices: Optional[Sequence[int]] = None,
                 stage4_pool: Optional[Tuple[int, int]] = (2, 1),
                 stage4_pool_cfg='unset', last_stage_pool: bool = False):
        super().__init__()
        ch = list(channels)
        self.out_indices = out_indices
        self.last_stage_pool = last_stage_pool
        pool4, stride4 = stage4_pool, None
        if stage4_pool_cfg != 'unset':
            pool4 = None
            if stage4_pool_cfg:
                k = stage4_pool_cfg['kernel_size']
                st = stage4_pool_cfg.get('stride', k)
                pool4, stride4 = k, st
        self.pool4 = (tuple(pool4) if isinstance(pool4, (list, tuple))
                      else pool4)
        self.stride4 = (tuple(stride4) if isinstance(stride4, (list, tuple))
                        else stride4) or self.pool4
        self.conv1_1 = nn.Conv2d(base_channels, ch[0], 3, padding=1)
        self.bn1_1 = BatchNorm2d(ch[0], eps=1e-5)
        self.conv1_2 = nn.Conv2d(ch[0], ch[1], 3, padding=1)
        self.bn1_2 = BatchNorm2d(ch[1], eps=1e-5)
        inplanes = ch[1]
        for i, blocks in enumerate(layers):
            k, planes = i + 2, ch[i + 2]
            self.add_module(f'block{k}', nn.Sequential(*[
                BasicBlock(inplanes if b == 0 else planes, planes,
                           use_downsample=b == 0 and inplanes != planes,
                           use_conv1x1=False) for b in range(blocks)]))
            self.add_module(f'conv{k}', nn.Conv2d(planes, planes, 3,
                                                  padding=1))
            self.add_module(f'bn{k}', BatchNorm2d(planes, eps=1e-5))
            inplanes = planes
        # channels of stem_and_head's skips and of its output feature
        self.head_channels = (ch[0], ch[1], ch[2])

    def _stage(self, k: int, x):
        x = getattr(self, f'block{k}')(x)
        return F.relu(getattr(self, f'bn{k}')(getattr(self, f'conv{k}')(x)))

    def stem_and_head(self, img):
        """img (N, H, W, C) -> (stage 2's output, [the two stems' outputs]),
        NHWC."""
        x = F.relu(self.bn1_1(self.conv1_1(nhwc_to_nchw(img))))
        skips = [nchw_to_nhwc(x)]
        x = F.relu(self.bn1_2(self.conv1_2(x)))
        skips.append(nchw_to_nhwc(x))
        x = self._stage(2, max_pool(x, 2, 2))
        return nchw_to_nhwc(x), skips

    def tail(self, x):
        """Stage 2's output (N, h, w, c) -> the last stage's (or the
        ``out_indices`` tuple), NHWC."""
        x = nhwc_to_nchw(x)
        outs = [x]
        x = self._stage(3, max_pool(x, 2, 2))
        outs.append(x)
        if self.pool4:
            x = max_pool(x, self.pool4, self.stride4)
        x = self._stage(4, x)
        outs.append(x)
        if self.last_stage_pool:
            x = max_pool(x, 2, 2)
        x = self._stage(5, x)
        outs.append(x)
        if self.out_indices is not None:
            return tuple(nchw_to_nhwc(outs[i]) for i in self.out_indices)
        return nchw_to_nhwc(x)

    def forward(self, img):
        return self.tail(self.stem_and_head(img)[0])
