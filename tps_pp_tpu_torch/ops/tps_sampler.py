"""TPS++ rectification: grid generation + bilinear warp.

Counterpart of ``tps_pp_tpu/ops/pallas_tps.py`` (``tps_grid_sample_fused``
with ``with_mp=False``): ``tps_sampler`` launches the CUDA kernel
``csrc/tps_sampler.cu`` on CUDA tensors; ``tps_sampler_plain`` is the same
function in plain PyTorch (``build_P_prime`` + ``F.grid_sample``), used for
CPU tensors and as the kernel's reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _lib
from .grid_sample import grid_sample
from .tps import build_P_prime


def tps_sampler_plain(feat_grid, control_point, pc_score, inv_delta_C, P_hat,
                      P, out_hw: Tuple[int, int]) -> torch.Tensor:
    """feat_grid (N, Hg, Wg, C); control_point (N, F, 2); pc_score (N, n, F)
    with n = Hr*Wr; static inv_delta_C (F+3, F+3), P_hat (n, F), P (n, 2).
    Returns the rectified (N, Hr, Wr, C) in feat_grid's dtype; the grid is
    computed in float32."""
    f32 = torch.float32
    grid = build_P_prime(control_point.to(f32), pc_score.to(f32),
                         inv_delta_C.to(f32), P_hat.to(f32), P.to(f32))
    Hr, Wr = out_hw
    return grid_sample(feat_grid, grid.reshape(-1, Hr, Wr, 2))


def _expect(t, name, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'tps_sampler: {name} must be a contiguous {dtype} tensor of '
            f'shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on '
            f'{t.device} (contiguous={t.is_contiguous()})')


def tps_sampler(feat_grid, control_point, pc_score, inv_delta_C, P_hat, P,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """The kernel on CUDA tensors (bf16 features, f32 TPS inputs), the plain
    version on CPU tensors. Same arguments as :func:`tps_sampler_plain`."""
    if feat_grid.device.type == 'cpu':
        return tps_sampler_plain(feat_grid, control_point, pc_score,
                                 inv_delta_C, P_hat, P, out_hw)
    dev = feat_grid.device
    _lib.require_cuda(dev, 'tps_sampler')
    if feat_grid.dim() != 4:
        raise ValueError(f'tps_sampler: feat_grid must be (N, H, W, C), got '
                         f'{tuple(feat_grid.shape)}')
    N, Hg, Wg, C = feat_grid.shape
    Hr, Wr = out_hw
    n = Hr * Wr
    F = control_point.shape[1]
    f32 = torch.float32
    _expect(feat_grid, 'feat_grid', (N, Hg, Wg, C), torch.bfloat16, dev)
    _expect(control_point, 'control_point', (N, F, 2), f32, dev)
    _expect(pc_score, 'pc_score', (N, n, F), f32, dev)
    _expect(inv_delta_C, 'inv_delta_C', (F + 3, F + 3), f32, dev)
    _expect(P_hat, 'P_hat', (n, F), f32, dev)
    _expect(P, 'P', (n, 2), f32, dev)
    if C % 2 or F + 3 > 128:
        raise ValueError(f'tps_sampler: needs an even channel count and '
                         f'F + 3 <= 128, got C={C}, F={F}')
    out = torch.empty((N, Hr, Wr, C), dtype=torch.bfloat16, device=dev)
    lib = _lib.load()
    rc = lib.tpk_tps_sampler(
        feat_grid.data_ptr(), control_point.data_ptr(), pc_score.data_ptr(),
        inv_delta_C.data_ptr(), P_hat.data_ptr(), P.data_ptr(),
        out.data_ptr(), N, Hg, Wg, C, n, F, _lib.stream_ptr(dev))
    _lib.check(rc, 'tps_sampler')
    tps_sampler.launches += 1
    return out


tps_sampler.launches = 0
