"""TPS++ rectification: grid generation + bilinear warp.

Counterpart of ``tps_pp_tpu/ops/pallas_tps.py`` (``tps_grid_sample_fused``),
in its two variants:

* ``'dense'`` (kernel 1, replaces ``_kernel``): the bilinear weights stay
  float32 (the TPU kernel rounds their products to the feature type);
* ``'twostage'`` (kernel 2, replaces ``_kernel_twostage``): the same
  function contracted over w first, with the x-weights rounded to the
  feature type, then over h with float32 y-weights, as the TPU kernel
  rounds them.

``tps_grid_sample_fused`` also warps ``batch_img`` (``with_mp``) from the
same grid. ``tps_sampler`` is the rectified map alone, the serving path.
Both launch the CUDA kernel ``csrc/tps_sampler.cu`` on CUDA tensors and
take the plain version of their variant on CPU tensors;
``tps_sampler_plain`` (``build_P_prime`` + ``F.grid_sample``) and
``tps_sampler_plain_twostage`` are those plain versions.

``variant=None`` reads the ``TPS_SAMPLER_VARIANT`` environment variable
(default ``'dense'``) at each call. The JAX package reads it once per
trace, so there a change after the first compile is ignored; here it acts
on the next call.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import _lib
from .grid_sample import grid_sample_plain
from .tps import build_P_prime

VARIANTS = ('dense', 'twostage')


def resolve_variant(variant: Optional[str] = None) -> str:
    """``variant``, or the ``TPS_SAMPLER_VARIANT`` variable when None
    (default ``'dense'``); anything but ``'dense'`` / ``'twostage'``
    raises."""
    if variant is None:
        variant = os.environ.get('TPS_SAMPLER_VARIANT', 'dense')
    if variant not in VARIANTS:
        raise ValueError(f'TPS sampler variant {variant!r} not in '
                         f'{VARIANTS}')
    return variant


def _grid(control_point, pc_score, inv_delta_C, P_hat, P) -> torch.Tensor:
    """P' (N, n, 2) in float32."""
    f32 = torch.float32
    return build_P_prime(control_point.to(f32), pc_score.to(f32),
                         inv_delta_C.to(f32), P_hat.to(f32), P.to(f32))


def tps_sampler_plain(feat_grid, control_point, pc_score, inv_delta_C, P_hat,
                      P, out_hw: Tuple[int, int]) -> torch.Tensor:
    """feat_grid (N, Hg, Wg, C); control_point (N, F, 2); pc_score (N, n, F)
    with n = Hr*Wr; static inv_delta_C (F+3, F+3), P_hat (n, F), P (n, 2).
    Returns the rectified (N, Hr, Wr, C) in feat_grid's dtype; the grid is
    computed in float32."""
    Hr, Wr = out_hw
    grid = _grid(control_point, pc_score, inv_delta_C, P_hat, P)
    return grid_sample_plain(feat_grid, grid.reshape(-1, Hr, Wr, 2))


def _hat_pair(g: torch.Tensor, size: int):
    """The two taps (i0, i1) of the [0, size-1] coordinate g and their hat
    weights max(0, 1 - |g - i|), the TPU kernel's formula; the tap past the
    last pixel has weight 0."""
    i0 = torch.floor(g)
    w0 = torch.clamp(1.0 - torch.abs(g - i0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(g - (i0 + 1.0)), min=0.0)
    i0 = i0.long()
    w1 = torch.where(i0 + 1 < size, w1, torch.zeros_like(w1))
    return i0, torch.clamp(i0 + 1, max=size - 1), w0, w1


def warp_twostage(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C); grid (N, n, 2) in the [-1, 1] convention
    (align_corners, border clamp), float32 (float64 for a reference). Row
    sums over w with the x-weights rounded to img's dtype, then the y-blend
    in float32 (no fused
    multiply-adds, as the TPU kernel's two products), one rounding of the
    output: (N, n, C) in img's dtype."""
    N, H, W, C = img.shape
    cdt = torch.promote_types(img.dtype, torch.float32)
    gx = torch.clamp((grid[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1.0)
    gy = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1.0)
    x0, x1, wx0, wx1 = _hat_pair(gx, W)
    y0, y1, wy0, wy1 = _hat_pair(gy, H)
    wx0, wx1 = (w.to(img.dtype).to(cdt)[..., None] for w in (wx0, wx1))
    flat = img.reshape(N, H * W, C)

    def tap(y, x):
        idx = (y * W + x)[..., None].expand(-1, -1, C)
        return flat.gather(1, idx).to(cdt)

    r0 = wx0 * tap(y0, x0) + wx1 * tap(y0, x1)
    r1 = wx0 * tap(y1, x0) + wx1 * tap(y1, x1)
    out = wy0.to(cdt)[..., None] * r0 + wy1.to(cdt)[..., None] * r1
    return out.to(img.dtype)


def tps_sampler_plain_twostage(feat_grid, control_point, pc_score,
                               inv_delta_C, P_hat, P,
                               out_hw: Tuple[int, int]) -> torch.Tensor:
    """The two-stage variant of :func:`tps_sampler_plain` (same
    arguments)."""
    Hr, Wr = out_hw
    grid = _grid(control_point, pc_score, inv_delta_C, P_hat, P)
    return warp_twostage(feat_grid, grid).reshape(
        feat_grid.shape[0], Hr, Wr, feat_grid.shape[-1])


PLAIN = {'dense': tps_sampler_plain, 'twostage': tps_sampler_plain_twostage}


def tps_grid_sample_fused(feat_grid, batch_img, control_point, pc_score,
                          inv_delta_C, P_hat, P, out_hw: Tuple[int, int],
                          with_mp: bool = True,
                          variant: Optional[str] = None):
    """(rect (N, Hr, Wr, C), mp (N, Hr, Wr, C) or None): feat_grid and,
    with ``with_mp``, batch_img (N, Hi, Wi, C) warped by one TPS grid, in
    their dtypes, through ``variant`` (see the module docstring). The
    kernel on CUDA tensors (bf16 or float32 maps of one dtype, float32 TPS
    inputs; the limits of the shapes are stated in
    ``csrc/tps_sampler.cu``), the plain version on CPU tensors. Other
    arguments as :func:`tps_sampler_plain`."""
    variant = resolve_variant(variant)
    if feat_grid.device.type == 'cpu':
        plain = PLAIN[variant]
        args = (control_point, pc_score, inv_delta_C, P_hat, P, out_hw)
        return (plain(feat_grid, *args),
                plain(batch_img, *args) if with_mp else None)
    dev = feat_grid.device
    _lib.require_cuda(dev, 'tps_sampler')
    if feat_grid.dim() != 4:
        raise ValueError(f'tps_sampler: feat_grid must be (N, H, W, C), got '
                         f'{tuple(feat_grid.shape)}')
    N, Hg, Wg, C = feat_grid.shape
    Hr, Wr = out_hw
    n = Hr * Wr
    F = control_point.shape[1]
    f32, ft = torch.float32, feat_grid.dtype
    if ft not in (torch.bfloat16, f32):
        raise ValueError(f'tps_sampler: feat_grid must be bfloat16 or '
                         f'float32, got {ft}')
    expected = {
        'feat_grid': (feat_grid, (N, Hg, Wg, C), ft),
        'control_point': (control_point, (N, F, 2), f32),
        'pc_score': (pc_score, (N, n, F), f32),
        'inv_delta_C': (inv_delta_C, (F + 3, F + 3), f32),
        'P_hat': (P_hat, (n, F), f32), 'P': (P, (n, 2), f32)}
    Hi = Wi = 0
    if with_mp:
        if batch_img.dim() != 4:
            raise ValueError(f'tps_sampler: batch_img must be (N, H, W, C), '
                             f'got {tuple(batch_img.shape)}')
        Hi, Wi = batch_img.shape[1:3]
        expected['batch_img'] = (batch_img, (N, Hi, Wi, C), ft)
    _lib.check_args('tps_sampler', dev, expected)
    rect = torch.empty((N, Hr, Wr, C), dtype=ft, device=dev)
    mp = torch.empty_like(rect) if with_mp else None
    twostage = variant == 'twostage'
    rc = _lib.load().tpk_tps_sampler(
        feat_grid.data_ptr(), batch_img.data_ptr() if with_mp else None,
        control_point.data_ptr(), pc_score.data_ptr(),
        inv_delta_C.data_ptr(), P_hat.data_ptr(), P.data_ptr(),
        rect.data_ptr(), mp.data_ptr() if with_mp else None, N, Hg, Wg, Hi,
        Wi, C, n, F, int(ft == torch.bfloat16), int(twostage),
        _lib.stream_ptr(dev))
    _lib.check(rc, 'tps_sampler')
    if twostage:
        tps_sampler.launches_twostage += 1
    else:
        tps_sampler.launches += 1
    return rect, mp


def tps_sampler(feat_grid, control_point, pc_score, inv_delta_C, P_hat, P,
                out_hw: Tuple[int, int],
                variant: Optional[str] = None) -> torch.Tensor:
    """The rectified map alone (``with_mp=False``): the kernel of
    ``variant`` on CUDA tensors, its plain version on CPU tensors. Launches
    count in ``tps_sampler.launches`` (dense) and
    ``tps_sampler.launches_twostage``. Arguments as
    :func:`tps_sampler_plain`."""
    return tps_grid_sample_fused(feat_grid, None, control_point, pc_score,
                                 inv_delta_C, P_hat, P, out_hw,
                                 with_mp=False, variant=variant)[0]


tps_sampler.launches = 0
tps_sampler.launches_twostage = 0
