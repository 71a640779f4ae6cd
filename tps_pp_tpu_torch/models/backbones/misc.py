"""Small stems: ShallowCNN (SATRN) and NRTRModalityTransform (counterpart
of ``tps_pp_tpu/models/backbones/misc.py``; reference
``backbones/shallow_cnn.py`` and ``backbones/nrtr_modality_transformer.py``).

Both take and return NHWC; inside, the convolutions run on NCHW views.
Module names are the reference's: ``conv1`` / ``conv2`` ConvModules
(``.conv``, ``.bn``) for ShallowCNN; ``conv_1`` / ``bn_1`` / ``conv_2`` /
``bn_2`` / ``linear`` for the modality transform.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ...registry import BACKBONES
from ..layers import (BatchNorm2d, ConvModule, max_pool, nchw_to_nhwc,
                      nhwc_to_nchw)


@BACKBONES.register_module()
class ShallowCNN(nn.Module):
    """Two (3x3 conv, BatchNorm, ReLU, 2x2 max pool) halvings, to
    ``hidden_dim / 2`` then ``hidden_dim`` channels: (N, H, W, C) ->
    (N, H/4, W/4, hidden_dim)."""

    def __init__(self, input_channels: int = 1, hidden_dim: int = 512):
        super().__init__()
        self.conv1 = ConvModule(input_channels, hidden_dim // 2, 3,
                                padding=1, use_norm=True)
        self.conv2 = ConvModule(hidden_dim // 2, hidden_dim, 3, padding=1,
                                use_norm=True)

    def forward(self, img):
        x = nhwc_to_nchw(img)
        for conv in (self.conv1, self.conv2):
            x = max_pool(conv(x), 2, 2)
        return nchw_to_nhwc(x)


@BACKBONES.register_module()
class NRTRModalityTransform(nn.Module):
    """Two stride-2 3x3 convs (32 and 64 channels), each followed by ReLU
    then BatchNorm, then a Linear over each column's (h, c) values, h-major
    as the JAX package flattens them (NHWC -> (N, W/4, H/4 * 64)):
    (N, 32, W, C) -> (N, 1, W/4, 512). The Linear takes the reference's 512
    inputs, the values of a column of a 32-pixel-high crop."""

    def __init__(self, input_channels: int = 3):
        super().__init__()
        self.conv_1 = nn.Conv2d(input_channels, 32, 3, stride=2, padding=1)
        self.bn_1 = BatchNorm2d(32, eps=1e-5)
        self.conv_2 = nn.Conv2d(32, 64, 3, stride=2, padding=1)
        self.bn_2 = BatchNorm2d(64, eps=1e-5)
        self.linear = nn.Linear(512, 512)

    def forward(self, img):
        x = self.bn_1(F.relu(self.conv_1(nhwc_to_nchw(img))))
        x = self.bn_2(F.relu(self.conv_2(x)))
        n, c, h, w = x.shape
        x = x.permute(0, 3, 2, 1).reshape(n, w, h * c)
        return self.linear(x).reshape(n, 1, w, 512)
