"""``VeryDeepVgg``, CRNN's backbone (counterpart of
``tps_pp_tpu/models/backbones/vgg.py:18-55``; reference
``backbones/very_deep_vgg.py:27-64``).

Seven convs (with biases), BatchNorm on convs 2, 4 and 6, ReLU or
LeakyReLU(0.2), and the asymmetric pools: 2x2 stride 2 twice, then 2x2
stride (2, 1) padding (0, 1) twice, so a (N, 32, 100, C) crop gives a
(N, 1, 26, 512) feature. NHWC in and out; the parameters carry the
reference's names, ``cnn.conv{i}`` and ``cnn.batchnorm{i}``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import BACKBONES
from ..layers import BatchNorm2d, max_pool, nchw_to_nhwc, nhwc_to_nchw


# the pool after conv i: (window, stride, padding)
_POOLS = {0: (2, 2, 0), 1: (2, 2, 0), 3: ((2, 2), (2, 1), (0, 1)),
          5: ((2, 2), (2, 1), (0, 1))}


@BACKBONES.register_module()
class VeryDeepVgg(nn.Module):

    def __init__(self, leaky_relu: bool = True, input_channels: int = 3):
        super().__init__()
        ks = [3, 3, 3, 3, 3, 3, 2]
        ps = [1, 1, 1, 1, 1, 1, 0]
        nm = [64, 128, 256, 256, 512, 512, 512]
        self.leaky_relu = leaky_relu
        self.cnn = nn.ModuleDict()
        for i in range(7):
            n_in = input_channels if i == 0 else nm[i - 1]
            self.cnn[f'conv{i}'] = nn.Conv2d(n_in, nm[i], ks[i], 1, ps[i])
            if i in (2, 4, 6):
                self.cnn[f'batchnorm{i}'] = BatchNorm2d(nm[i], eps=1e-5)
        self.out_channels = nm[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, C) -> (N, H/32, W/4 + 1, 512), NHWC."""
        x = nhwc_to_nchw(x)
        for i in range(7):
            x = self.cnn[f'conv{i}'](x)
            if f'batchnorm{i}' in self.cnn:
                x = self.cnn[f'batchnorm{i}'](x)
            x = F.leaky_relu(x, 0.2) if self.leaky_relu else F.relu(x)
            if i in _POOLS:
                x = max_pool(x, *_POOLS[i])
        return nchw_to_nhwc(x)
