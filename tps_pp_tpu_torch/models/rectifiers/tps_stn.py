"""RARE's TPS-STN, the image-space preprocessor of CRNN-TPS (counterpart of
``tps_pp_tpu/models/rectifiers/tps_stn.py:25-94``; reference
``preprocessor/tps_preprocessor.py:25-282``).

``LocalizationNetwork``: four conv (no bias) - BatchNorm - ReLU stages,
2x2 max pools after the first three and a global average pool after the
last, then ``localization_fc1`` (Linear + ReLU) and ``localization_fc2``,
which predicts the 2F fiducials; the reference's module names
(``conv.{0,1,4,5,8,9,12,13}``). At its reference init fc2 has zero
weights and the reference's fiducial bias (x in [-1, 1]; y from 0 to -1
along the top, from 1 to 0 along the bottom), so the first grid is
already a warp of the crop, not the identity.

``TPSPreprocessor``: the classic (un-modulated) TPS grid
``[1 | P | P_hat] @ (inv_delta_C @ [C'; 0])`` over the border fiducials
``build_C_border`` and the pixel centres in [-1, 1], computed in float64
and rounded once to the float32 the warp takes (as the TPS++ rectifier's
training grid: the 23-term sums cancel), then the border-padded,
align_corners bilinear warp of the crop (``ops.grid_sample.grid_sample``:
kernel 8 forward, kernel 9 backward on CUDA tensors, their plain versions
on CPU tensors or with ``plain=True``). NHWC in and out, in the crop's
dtype; the grid and the warp run outside autocast.

``BasePreprocessor``: the identity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops import tps as tps_ops
from ...ops.grid_sample import grid_sample
from ...registry import PREPROCESSORS
from ..layers import BatchNorm2d, nhwc_to_nchw


class LocalizationNetwork(nn.Module):

    def __init__(self, num_fiducial: int = 20, num_img_channel: int = 1):
        super().__init__()
        self.num_fiducial = num_fiducial
        layers, n_in = [], num_img_channel
        for i, ch in enumerate((64, 128, 256, 512)):
            layers += [nn.Conv2d(n_in, ch, 3, 1, 1, bias=False),
                       BatchNorm2d(ch, eps=1e-5), nn.ReLU(),
                       nn.MaxPool2d(2, 2) if i < 3
                       else nn.AdaptiveAvgPool2d(1)]
            n_in = ch
        self.conv = nn.Sequential(*layers)
        self.localization_fc1 = nn.Sequential(nn.Linear(512, 256), nn.ReLU())
        self.localization_fc2 = nn.Linear(256, num_fiducial * 2)
        self.reset_localization()

    def reset_localization(self):
        """fc2 at zero weights and the reference's fiducial bias
        (tps_preprocessor.py:130-139)."""
        half = self.num_fiducial // 2
        cx = np.linspace(-1.0, 1.0, half)
        top = np.stack([cx, np.linspace(0.0, -1.0, half)], axis=1)
        bot = np.stack([cx, np.linspace(1.0, 0.0, half)], axis=1)
        bias = np.concatenate([top, bot], axis=0).reshape(-1)
        with torch.no_grad():
            self.localization_fc2.weight.zero_()
            self.localization_fc2.bias.copy_(torch.from_numpy(bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, C) -> fiducials (N, F, 2), (x, y) in [-1, 1]."""
        h = self.conv(nhwc_to_nchw(x)).flatten(1)
        cp = self.localization_fc2(self.localization_fc1(h))
        return cp.reshape(-1, self.num_fiducial, 2)


@PREPROCESSORS.register_module()
class TPSPreprocessor(nn.Module):

    def __init__(self, num_fiducial: int = 20,
                 img_size: Tuple[int, int] = (32, 100),
                 rectified_img_size: Tuple[int, int] = (32, 100),
                 num_img_channel: int = 1):
        super().__init__()
        self.rectified_img_size = tuple(rectified_img_size)
        self.LocalizationNetwork = LocalizationNetwork(num_fiducial,
                                                       num_img_channel)
        C = tps_ops.build_C_border(num_fiducial)
        Hr, Wr = self.rectified_img_size
        P = tps_ops.build_P_minus1_1(Wr, Hr)
        P_hat = tps_ops.build_P_hat(C, P, eps=1e-6)
        # float64 numpy; float64 tensors on each device, made on first use
        self._tps_np = (tps_ops.build_inv_delta_C(C),
                        np.concatenate([np.ones((P.shape[0], 1)), P, P_hat],
                                       axis=1))
        self._tps_on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def reset_localization(self):
        self.LocalizationNetwork.reset_localization()

    def tps_matrices(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inv_delta_C, [1 | P | P_hat]) as float64 tensors on
        ``device``, made outside inference mode."""
        if device not in self._tps_on:
            with torch.inference_mode(False):
                self._tps_on[device] = tuple(torch.from_numpy(a).to(device)
                                             for a in self._tps_np)
        return self._tps_on[device]

    def grid(self, batch_img: torch.Tensor) -> torch.Tensor:
        """The (N, Hr, Wr, 2) float32 sampling grid of a crop batch."""
        cp = self.LocalizationNetwork(batch_img)
        with torch.autocast(batch_img.device.type, enabled=False):
            grid = tps_ops.build_P_prime_plain(
                cp.double(), *self.tps_matrices(batch_img.device)).float()
        return grid.reshape(-1, *self.rectified_img_size, 2)

    def forward(self, batch_img: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
        """batch_img (N, H, W, C) -> the rectified (N, Hr, Wr, C) crop in
        its dtype; ``plain`` sends the warp to the plain versions."""
        return grid_sample(batch_img, self.grid(batch_img), plain=plain)


@PREPROCESSORS.register_module()
class BasePreprocessor(nn.Module):
    """The identity (reference base_preprocessor.py:1-12)."""

    def forward(self, batch_img: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
        return batch_img
