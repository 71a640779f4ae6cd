"""The ResNet-50 trunk of the detectors (counterpart of the trunk of
``tps_pp_tpu/models/textdet/pan.py:43-123``; PANet's and PSENet's necks,
heads and losses come with their slice).

``Bottleneck`` is mmdet's (1x1 -> 3x3 with the stride -> 1x1 x 4, names
``conv1..3`` / ``bn1..3`` / ``downsample.{0,1}``); with ``dcn`` its 3x3 is
a DCNv2 layer (``ops/deform_conv.py``), whose ``state_dict`` names are
mmcv's: ``conv2.weight`` and ``conv2.conv_offset.*``.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ...ops.deform_conv import ModulatedDeformConv
from ...registry import BACKBONES
from ..layers import BatchNorm2d
from .dbnet import _ResNetStem


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dcn: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = (ModulatedDeformConv(planes, planes, stride=stride)
                      if dcn else nn.Conv2d(planes, planes, 3, stride=stride,
                                            padding=1, bias=False))
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4, eps=1e-5)) if use_downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNetDet50(_ResNetStem):
    """ResNet-50 trunk emitting C2-C5 with (256, 512, 1024, 2048) channels;
    with a ``dcn`` config, the stages flagged in ``stage_with_dcn`` take
    DCNv2 3x3s (only DCNv2 semantics exist, as in JAX)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 base_channels: int = 64,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dcn: Any = None, **kwargs):
        super().__init__(base_channels)
        cin, ch = base_channels, base_channels
        for si, blocks in enumerate(stage_blocks):
            use_dcn = bool(stage_with_dcn[si]) if dcn else False
            layers = []
            for b in range(blocks):
                s = 2 if (si > 0 and b == 0) else 1
                layers.append(Bottleneck(
                    cin, ch, stride=s,
                    use_downsample=s != 1 or cin != ch * 4, dcn=use_dcn))
                cin = ch * 4
            setattr(self, f'layer{si + 1}', nn.Sequential(*layers))
            ch *= 2
