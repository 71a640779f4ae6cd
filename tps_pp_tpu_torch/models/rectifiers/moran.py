"""MORAN's MORN, the offset-based image-space rectifier (counterpart of
``tps_pp_tpu/models/rectifiers/moran.py:23-89``; reference
``preprocessor/moran.py``).

A small conv net (``conv{i}`` / ``bn{i}``, i = 0..4, channels 64, 128, 64,
16, 1) predicts a one-channel offset map from the crop resized to
``img_size``; its positive and negative parts are max-pooled (window 2,
stride 1, no padding: a 4 x 12 map becomes 3 x 11), sampled up to
``img_size`` and added to the y coordinates of the identity grid, which
then warps the crop. ``enhance`` more rounds refine the offsets with the
same net (one set of weights, as in the reference). The identity grid is
``np.linspace`` in float64 rounded to float32, as JAX builds it, so that
the identity resize lerps where JAX's does.

Every sample is ``ops.grid_sample.grid_sample`` (border,
``align_corners=True``): kernel 8 forward on CUDA tensors; backward kernel
9 for the final warp (its grid carries the offsets' gradient) and kernel
10 for the offset sample (a constant grid); the plain versions on CPU
tensors or with ``plain=True``. Every grid reaches the kernels in float32:
the offsets, in the net's dtype, are added to the float32 identity grid,
whose type wins over bf16, as in JAX's type promotion. NHWC in and out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.grid_sample import grid_sample
from ...registry import PREPROCESSORS
from ..layers import BatchNorm2d, max_pool, nchw_to_nhwc, nhwc_to_nchw


def identity_grid(h: int, w: int) -> np.ndarray:
    """(h, w, 2) float32 grid spanning [-1, 1] in x and y (align_corners
    semantics), from float64 ``np.linspace`` as JAX's ``_identity_grid``."""
    gx = np.linspace(-1.0, 1.0, w)
    gy = np.linspace(-1.0, 1.0, h)
    return np.stack(np.meshgrid(gx, gy), axis=-1).astype(np.float32)


class IdentityGrids:
    """The identity grids of a module, float32 tensors made once per
    (device, size) outside inference mode, so that they never take the
    model's dtype."""

    def __init__(self):
        self._on: Dict[Tuple, torch.Tensor] = {}

    def __call__(self, device, h: int, w: int) -> torch.Tensor:
        key = (device, h, w)
        if key not in self._on:
            with torch.inference_mode(False):
                self._on[key] = torch.from_numpy(identity_grid(h, w)).to(
                    device)
        return self._on[key]


def resize_bilinear_ac(x: torch.Tensor, grid: torch.Tensor,
                       plain: bool = False) -> torch.Tensor:
    """x (N, H0, W0, C) resized to the identity ``grid``'s (h, w, 2) size,
    bilinear with ``align_corners=True``, through ``grid_sample`` (JAX
    ``_resize_bilinear_ac``)."""
    grid = grid.expand(x.shape[0], *grid.shape).contiguous()
    return grid_sample(x, grid, plain=plain)


@PREPROCESSORS.register_module()
class MORAN(nn.Module):

    def __init__(self, num_img_channel: int = 3,
                 img_size: Tuple[int, int] = (32, 128), enhance: int = 0):
        super().__init__()
        self.img_size = tuple(img_size)
        self.enhance = int(enhance)
        n_in = num_img_channel
        for i, ch in enumerate((64, 128, 64, 16, 1)):
            self.add_module(f'conv{i}', nn.Conv2d(n_in, ch, 3, padding=1))
            self.add_module(f'bn{i}', BatchNorm2d(ch, eps=1e-5))
            n_in = ch
        self._grids = IdentityGrids()

    def offset_net(self, v: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> the pooled offsets (N, H/8 - 1, W/8 - 1, 1)."""
        v = max_pool(nhwc_to_nchw(v), 2, 2)
        for i in range(5):
            v = getattr(self, f'bn{i}')(getattr(self, f'conv{i}')(v))
            if i < 4:
                v = F.relu(v)
            if i in (0, 1):
                v = max_pool(v, 2, 2)
        o = max_pool(F.relu(v), 2, 1) - max_pool(F.relu(-v), 2, 1)
        return nchw_to_nhwc(o)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (N, H, W, C) -> the rectified (N, img_size, C) crop in x's
        dtype; ``plain`` sends every sample to the plain versions."""
        H, W = self.img_size
        base = self._grids(x.device, H, W)
        base_n = base.expand(x.shape[0], H, W, 2).contiguous()

        def offsets_from(v):       # (N, H, W, 1) in the net's dtype
            return grid_sample(self.offset_net(v), base_n, plain=plain)

        def warp(offsets):
            # float32 + bf16 is float32, as in JAX (float64 in f64 tests)
            y = base_n[..., 1:] + offsets
            grid = torch.cat([base_n[..., :1].to(y.dtype), y], dim=-1)
            return grid_sample(x, grid, plain=plain)

        offsets = offsets_from(resize_bilinear_ac(x, base, plain))
        x_rect = warp(offsets)
        for _ in range(self.enhance):
            offsets = offsets + offsets_from(x_rect)
            x_rect = warp(offsets)
        return x_rect
