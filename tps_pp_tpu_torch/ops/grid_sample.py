"""Bilinear grid sampling (counterpart of ``tps_pp_tpu/ops/grid_sample.py``).

The serving path needs one mode only: ``padding_mode='border'``,
``align_corners=True`` over NHWC features, which is what the JAX package's
``_gather_impl`` computes and what ``F.grid_sample`` computes natively.
Grid values are passed through unchanged: TPS++ feeds a [0,1] grid to this
[-1,1] sampler (reference tps_pp.py:606-615), a quirk kept on purpose.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C); grid (N, Ho, Wo, 2) in [-1,1] convention, last dim
    (x, y). Returns (N, Ho, Wo, C) in img's dtype; sampling runs in float32
    at least."""
    cdt = torch.promote_types(img.dtype, torch.float32)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(cdt), grid.to(cdt),
                        mode='bilinear', padding_mode='border',
                        align_corners=True)
    return out.permute(0, 2, 3, 1).to(img.dtype)
