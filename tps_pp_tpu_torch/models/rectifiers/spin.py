"""SPIN, the structure-preserving inner offset network, an image-space
colour rectifier (counterpart of ``tps_pp_tpu/models/rectifiers/spin.py:
24-124``; reference ``preprocessor/spin.py``).

A trunk (``spt_conv{i}`` / ``spt_bn{i}``, 32-64-128 channels, each pooled
2 x 2) and a structure branch (``fc1_conv{i}`` / ``fc1_bn{i}``, 256-256-512,
an average pool, ``fc1_linear``, ``fc1_bn1d``, ``fc2``) predict a weight
for each of the ``2K + 1`` exponents of ``generate_beta(K)`` and, with
``offsets``, the AIN gate. ``fc2`` starts at zero weights and the bias
``[0, .., 0, 5, -5]``, a near-identity transform (``reset_localization``).
The AIN branch (``offset_conv1`` / ``offset_bn1`` / ``offset_conv2``,
pooled, a sigmoid) gives a low-resolution offset map in the input's
channels, upsampled to the crop through ``ops.grid_sample.grid_sample``
(kernel 8 forward and kernel 10 backward on CUDA tensors: its grid is the
constant identity). The SPN colour transform then runs in float32 (or
wider) outside autocast: the crop un-normalised with the three-value mean
and std, blended with the offsets by the gate, clipped to [1e-6, 1], the
weighted sum of its powers, an instance norm over (H, W), a sigmoid and
the normalisation again; the result is cast to the input's dtype.

The mean and std broadcast over the last axis as in JAX, so a one-channel
crop comes out with three channels. Train-mode BatchNorm (``fc1_bn1d``
too) keeps flax's biased running variance (``models/layers.py``). NHWC in
and out.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import PREPROCESSORS
from ..layers import (BatchNorm1d, BatchNorm2d, max_pool, nchw_to_nhwc,
                      nhwc_to_nchw)
from .moran import IdentityGrids, resize_bilinear_ac


def generate_beta(K: int) -> List[float]:
    """The 2K + 1 exponents (reference spin.py:42-52)."""
    betas = []
    for i in range(1, K + 2):
        p = i / (2 * (K + 1))
        betas.append(round(float(np.log(1 - p) / np.log(p)), 2))
    for i in range(K + 2, 2 * K + 2):
        betas.append(round(1.0 / betas[i - (K + 1)], 2))
    return betas


def _conv_bn(n_in: int, n_out: int):
    return (nn.Conv2d(n_in, n_out, 3, padding=1, bias=False),
            BatchNorm2d(n_out, eps=1e-5))


@PREPROCESSORS.register_module()
class SPIN(nn.Module):

    def __init__(self, input_channel: int = 3, offsets: bool = True,
                 default_type: int = 6,
                 img_norm_mean: Sequence[float] = (0.485, 0.456, 0.406),
                 img_norm_std: Sequence[float] = (0.229, 0.224, 0.225)):
        super().__init__()
        self.offsets = bool(offsets)
        self.powers = generate_beta(default_type)
        self.img_norm_mean = tuple(img_norm_mean)
        self.img_norm_std = tuple(img_norm_std)
        n_in = input_channel
        for i, ch in enumerate((32, 64, 128)):
            conv, bn = _conv_bn(n_in, ch)
            self.add_module(f'spt_conv{i}', conv)
            self.add_module(f'spt_bn{i}', bn)
            n_in = ch
        for i, ch in enumerate((256, 256, 512)):
            conv, bn = _conv_bn(n_in, ch)
            self.add_module(f'fc1_conv{i}', conv)
            self.add_module(f'fc1_bn{i}', bn)
            n_in = ch
        self.fc1_linear = nn.Linear(512, 256)
        self.fc1_bn1d = BatchNorm1d(256, eps=1e-5)
        self.fc2 = nn.Linear(256, len(self.powers) + int(self.offsets))
        if self.offsets:
            self.offset_conv1, self.offset_bn1 = _conv_bn(128, 16)
            self.offset_conv2 = nn.Conv2d(16, input_channel, 3, padding=1)
        self._grids = IdentityGrids()
        self.reset_localization()

    def reset_localization(self):
        """fc2 at zero weights and the bias 5 on the last exponent's
        weight, -5 on the AIN gate (reference spin.py:316-328)."""
        bias = np.zeros(self.fc2.out_features, np.float32)
        bias[len(self.powers) - 1] = 5.0
        if self.offsets:
            bias[-1] = -5.0
        with torch.no_grad():
            self.fc2.weight.zero_()
            self.fc2.bias.copy_(torch.from_numpy(bias))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (N, H, W, C), normalised -> the transformed crop (N, H, W, 3
        or C) in x's dtype; ``plain`` sends the offset upsample to the
        plain version."""
        v = nhwc_to_nchw(x)
        for i in range(3):
            v = getattr(self, f'spt_bn{i}')(getattr(self, f'spt_conv{i}')(v))
            v = max_pool(F.relu(v), 2, 2)
        feat = s = v
        for i in range(3):
            s = F.relu(getattr(self, f'fc1_bn{i}')(
                getattr(self, f'fc1_conv{i}')(s)))
            if i < 2:
                s = max_pool(s, 2, 2)
        s = F.relu(self.fc1_bn1d(self.fc1_linear(s.mean(dim=(2, 3)))))
        wf = self.fc2(s)
        off = None
        if self.offsets:
            o = F.relu(self.offset_bn1(self.offset_conv1(feat)))
            o = torch.sigmoid(max_pool(self.offset_conv2(o), 2, 2))
            off = resize_bilinear_ac(
                nchw_to_nhwc(o),
                self._grids(x.device, x.shape[1], x.shape[2]), plain)
        cdt = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            wf = wf.to(cdt)
            mean = x.new_tensor(self.img_norm_mean, dtype=cdt)
            std = x.new_tensor(self.img_norm_std, dtype=cdt)
            img = x.to(cdt) * std + mean
            if off is not None:
                gate = torch.sigmoid(wf[:, -1])[:, None, None, None]
                img = img * (1 - gate) + off.to(cdt) * gate
                wf = wf[:, :-1]
            img = img.clamp(1e-6, 1.0)
            out = sum(wf[:, k, None, None, None] * img ** p
                      for k, p in enumerate(self.powers))
            var, mu = torch.var_mean(out, dim=(1, 2), keepdim=True,
                                     correction=0)
            out = torch.sigmoid((out - mu) * torch.rsqrt(var + 1e-5))
            return ((out - mean) / std).to(x.dtype)
