"""ABINet-style ResNet backbones with the mid-backbone TPS++ hook
(counterpart of ``tps_pp_tpu/models/backbones/resnet_abi.py``).

One trunk, ``ResNetABIBase``, under two names: ``ResNetABI`` (reference
resnet_abi.py, ABINet's ResNet-45, default strides [2, 1, 2, 1, 1]) and
``ResNetABI_v2_large`` (reference resnet_v2_large.py, the NRTR + TPS++
flagship's, with the consistent stride geometry [1, 2, 2, 1, 2]). Either
takes any strides. ``stem_and_head`` runs the stem and the
first ``tps_stage`` stages and returns (x, skips); ``tail`` runs the rest.
Both take and return NHWC; inside, the convolutions run on NCHW views.
Module names are the reference's (conv1/bn1/layer{i}.{j}). BatchNorm follows
the module's mode: running statistics in eval, batch statistics (updating
the running ones as flax does, ``layers.BatchNorm2d``) in train.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.stem import fold_stem
from ...registry import BACKBONES
from ..layers import (BasicBlock, BatchNorm2d, nchw_to_nhwc, nhwc_to_nchw,
                      cached_per_weights)


class ResNetABIBase(nn.Module):
    """The trunk: stem, then stages of conv1x1-style BasicBlocks whose
    first block downsamples where stride or width change."""

    def __init__(self, in_channels: int = 3, stem_channels: int = 32,
                 base_channels: int = 32,
                 arch_settings: Sequence[int] = (3, 4, 6, 6, 3),
                 strides: Sequence[int] = (2, 1, 2, 1, 1),
                 tps_stage: int = 2):
        super().__init__()
        self.tps_stage = tps_stage
        # the geometry TextRecognizer.resolved_stem_mode reads
        self.strides = tuple(strides)
        self.stem_channels, self.base_channels = stem_channels, base_channels
        self.conv1 = nn.Conv2d(in_channels, stem_channels, 3, padding=1)
        self.bn1 = BatchNorm2d(stem_channels, eps=1e-5)
        inplanes, planes = stem_channels, base_channels
        channels = [stem_channels]       # input of each stage, then output
        for i, num_blocks in enumerate(arch_settings):
            stride = strides[i]
            blocks = [BasicBlock(inplanes, planes, stride,
                                 use_downsample=(stride != 1 or
                                                 inplanes != planes))]
            blocks += [BasicBlock(planes, planes)
                       for _ in range(1, num_blocks)]
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            inplanes, planes = planes, planes * 2
            channels.append(inplanes)
        self.num_stages = len(arch_settings)
        # channels of stem_and_head's skips and of its output feature
        self.head_channels = tuple(channels[:tps_stage + 1])
        self._fused_stem: Dict = {}   # (device, dtype) -> (stamp, weights)

    def fused_stem_weights(self, dtype: torch.dtype) -> Dict:
        """The stem's and the first two stages' weights with their
        BatchNorms folded, for ``ops.stem.fused_stem_forward``; computed once
        per (device, dtype) and weights stamp."""
        return cached_per_weights(self._fused_stem,
                                  (self.conv1.weight.device, dtype), self,
                                  lambda: fold_stem(self, dtype))

    def _stage(self, i):
        return getattr(self, f'layer{i + 1}')

    def stem_and_head(self, x):
        """x (N, H, W, C_in) -> (feature (N, h, w, c), [skip, ...]), all
        NHWC; the skips are the inputs of the first ``tps_stage`` stages."""
        x = F.relu(self.bn1(self.conv1(nhwc_to_nchw(x))))
        skips: List = []
        for i in range(self.tps_stage):
            skips.append(nchw_to_nhwc(x))
            x = self._stage(i)(x)
        return nchw_to_nhwc(x), skips

    def tail(self, x):
        x = nhwc_to_nchw(x)
        for i in range(self.tps_stage, self.num_stages):
            x = self._stage(i)(x)
        return nchw_to_nhwc(x)

    def forward(self, x):
        """x (N, H, W, C_in) -> the feature (N, h, w, c), NHWC."""
        return self.tail(self.stem_and_head(x)[0])


@BACKBONES.register_module()
class ResNetABI(ResNetABIBase):
    """ABINet's ResNet-45 (reference resnet_abi.py): 512 channels at H/4
    with the default strides."""


@BACKBONES.register_module()
class ResNetABI_v2_large(ResNetABIBase):
    """The NRTR + TPS++ flagship trunk (reference resnet_v2_large.py)."""

    def __init__(self, in_channels: int = 3, stem_channels: int = 32,
                 base_channels: int = 32,
                 arch_settings: Sequence[int] = (3, 4, 6, 6, 3),
                 strides: Sequence[int] = (1, 2, 2, 1, 2),
                 tps_stage: int = 2):
        super().__init__(in_channels, stem_channels, base_channels,
                         arch_settings, strides, tps_stage)
