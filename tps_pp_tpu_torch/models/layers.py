"""Shared conv building blocks (counterpart of
``tps_pp_tpu/models/layers.py``).

NCHW, as PyTorch's convolutions expect. The trunk's public functions take
and return NHWC (the JAX package's layout) through ``permute`` views, so the
tensors inside are NCHW-shaped with channels-last strides and no copy is
made at either boundary.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class ConvModule(nn.Module):
    """Conv2d + optional BatchNorm + ReLU, mmcv ConvModule semantics: the
    conv has a bias iff there is no norm."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 use_norm: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, _pair(kernel_size),
                              stride=_pair(stride), padding=_pair(padding),
                              bias=not use_norm)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5) if use_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class BasicBlock(nn.Module):
    """ResNet basic block in its ``use_conv1x1`` form, the one the ABINet
    trunks use: conv1x1 -> conv3x3 with the stride on the 3x3 (reference
    conv_layer.py:31-33). ``downsample`` is the reference's
    ``Sequential(conv1x1, bn)`` shortcut."""

    def __init__(self, inplanes: int, planes: int,
                 stride: Union[int, Tuple[int, int]] = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=_pair(stride),
                               padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride=_pair(stride), bias=False),
            nn.BatchNorm2d(planes, eps=1e-5)) if use_downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def upsample_nearest(x: torch.Tensor, scale) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW tensor by integer factors."""
    sh, sw = _pair(scale)
    if sh > 1:
        x = x.repeat_interleave(sh, dim=2)
    if sw > 1:
        x = x.repeat_interleave(sw, dim=3)
    return x


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW-shaped view (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)
