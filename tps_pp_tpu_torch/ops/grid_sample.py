"""Bilinear grid sampling and its gradient (counterpart of
``tps_pp_tpu/ops/grid_sample.py`` and ``tps_pp_tpu/ops/pallas_grid_sample.py``).

One mode, the one TPS++ uses: ``padding_mode='border'``,
``align_corners=True``, over NHWC images. Grid values are passed through
unchanged: TPS++ feeds a [0,1] grid to this [-1,1] sampler (reference
tps_pp.py:606-615), a quirk kept on purpose.

Plain versions (CPU tensors take them; ``chip_smoke.py`` holds the kernels
to them on the card):

* ``grid_sample_plain``: ``F.grid_sample``.
* ``grid_sample_grad_plain(grid, cot, img) -> (d_img, d_grid)`` and
  ``grid_sample_grad_img_plain``: autograd of a gather + lerp written after
  the JAX package's ``_gather_impl`` with ``torch.clamp``. Its conventions
  are those of the Pallas backward (``pallas_grid_sample.py:96-99,
  246-265``): at a sample on a pixel centre the x-gradient is
  ``v[x0+1] - v[x0]``; at the last row or column it is 0 (the far tap clamps
  back onto the near one); the border clip passes the gradient where
  ``0 <= g <= size-1``, ties included (``jax.vjp`` of ``jnp.clip`` gives 0.5
  at a tie, ATen's ``grid_sample`` backward 0).

Kernels (``csrc/grid_sample.cu``), each wrapper launching on CUDA tensors and
taking the plain version on CPU tensors:

* ``grid_sample_forward``: kernel 8, replaces ``_fwd_kernel``; the operator
  ``torch.ops.tps_pp.grid_sample_fwd`` (``_lib.define_op``), which a
  serving path reaches (the backward kernels, training only, stay plain
  calls inside ``GridSampleFunction``);
* ``grid_sample_grad``: kernel 9, replaces ``_bwd_fused_kernel``;
* ``grid_sample_grad_img``: kernel 10, replaces ``_bwd_kernel``.

Kernel 8 at an odd C takes its narrow path: a warp a run of adjacent
samples, a lane every 32nd, their grid points loaded before the first tap;
a CTA an image's runs, the image's map staged in shared memory where it
fits (read where it lies where it does not); a warp's outputs stored as
whole lines through shared memory. ``grid_sample_fwd_plan`` reports the
plan it takes at a shape.

Kernels 9 and 10 sum d_img in shared memory and write all of it in their
one launch, so d_img is allocated with ``torch.empty`` and nothing zeroes
it before. An even C loads channel pairs (its image and cotangent aligned
to two elements): each CTA owns a band of source rows of one image (and a
slab of channels where one row of all of them does not fit) and stores it
once. An odd C (the CTC family's one-channel crops, RGB crops, MORAN's
and SPIN's offset maps) takes the narrow path: a cluster of CTAs an
image's band, each CTA a share of the image's samples and its own copy of
the band, a thread a run of samples whose taps it sums in registers while
they stay, the band a private copy for each thread where it is small;
each CTA zeroes its slice of the band in d_img and, after the cluster's
barrier, adds its copy to d_img by global reductions. ``grid_sample_plan``
reports the plan the kernels take at a shape on the current card, and
each wrapper keeps the plan of its last launch in ``last_plan``; a shape
that no plan fits raises, and so does a launch the card refuses.

``grid_sample(img, grid, plain=False)`` is the differentiable entry point
(``GridSampleFunction``): forward through kernel 8, backward through
kernel 9, or kernel 10 when the grid needs no gradient. ``plain=True``
takes the plain versions on any device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _lib


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (N, H, W, C); grid (N, Ho, Wo, 2) in [-1,1] convention, last dim
    (x, y). Returns (N, Ho, Wo, C) in img's dtype; sampling runs in float32
    at least."""
    cdt = _compute_dtype(img)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(cdt), grid.to(cdt),
                        mode='bilinear', padding_mode='border',
                        align_corners=True)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def _gather_lerp(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_gather_impl`` (border, align_corners=True):
    clamp, floor, four gathers with the far taps clamped, lerp. The
    coordinates and weights are float32 whatever the image's dtype, as
    there."""
    N, H, W, C = img.shape
    grid = grid.float()
    gx = torch.clamp((grid[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    gy = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = img.reshape(N, H * W, C)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(N, -1, 1).expand(-1, -1, C)
        return flat.gather(1, idx).reshape(*yi.shape, C)

    return ((tap(y0i, x0i) * (1 - wx) + tap(y0i, x1i) * wx) * (1 - wy) +
            (tap(y1i, x0i) * (1 - wx) + tap(y1i, x1i) * wx) * wy)


def grid_sample_grad_plain(grid: torch.Tensor, cot: torch.Tensor,
                           img: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full VJP: (d_img (N, H, W, C), d_grid (N, Ho, Wo, 2)), both in
    float32 (float64 for float64 inputs)."""
    cdt = _compute_dtype(img)
    with torch.enable_grad():
        im = img.detach().to(cdt).requires_grad_(True)
        gr = grid.detach().to(cdt).requires_grad_(True)
        out = _gather_lerp(im, gr)
        d_img, d_grid = torch.autograd.grad(out, (im, gr), cot.to(cdt))
    return d_img, d_grid


def grid_sample_grad_img_plain(grid: torch.Tensor, cot: torch.Tensor, H: int,
                               W: int) -> torch.Tensor:
    """The image's gradient only: (N, H, W, C) float32 (float64 for float64
    inputs); it does not depend on the image."""
    cdt = _compute_dtype(cot)
    N, C = cot.shape[0], cot.shape[-1]
    with torch.enable_grad():
        im = torch.zeros((N, H, W, C), dtype=cdt, device=cot.device,
                         requires_grad=True)
        out = _gather_lerp(im, grid.detach().to(cdt))
        d_img, = torch.autograd.grad(out, (im,), cot.to(cdt))
    return d_img


# ------------------------------------------------------------- the kernels

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _expect(t, what, name, shape, dtypes, device, pairs=True):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``device``
    in one of ``dtypes``, aligned for the kernels' two-element loads where
    ``pairs``."""
    align = (2 if pairs else 1) * t.element_size()
    if t.device != device or t.dtype not in dtypes or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.data_ptr() % align:
        raise ValueError(
            f'{what}: {name} must be a contiguous, {align}-byte aligned '
            f'tensor of shape {tuple(shape)} in one of {dtypes} on '
            f'{device}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')


def _check_common(what, grid, src, C):
    dev = src.device
    _lib.require_cuda(dev, what)
    if grid.dim() != 4 or src.dim() != 4 or C < 1:
        raise ValueError(f'{what}: needs 4-d NHWC tensors with a channel, '
                         f'got grid {tuple(grid.shape)}, '
                         f'{tuple(src.shape)}')
    N, Ho, Wo = grid.shape[:3]
    _expect(grid, what, 'grid', (N, Ho, Wo, 2), (torch.float32,), dev)
    return dev, N, Ho * Wo


def _forward_cuda(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    what = 'grid_sample_forward'
    N, H, W, C = img.shape
    dev, _, npix = _check_common(what, grid, img, C)
    _expect(img, what, 'img', (N, H, W, C), _KERNEL_DTYPES, dev, C % 2 == 0)
    out = torch.empty(tuple(grid.shape[:3]) + (C,), dtype=img.dtype,
                      device=dev)
    rc = _lib.load().tpk_grid_sample_fwd(
        img.data_ptr(), grid.data_ptr(), out.data_ptr(), N, H, W, C, npix,
        int(img.dtype == torch.bfloat16), _lib.stream_ptr(dev))
    _lib.check(rc, what)
    _lib.count_launch(grid_sample_forward)
    return out


_forward_op = _lib.define_op(
    'grid_sample_fwd', '(Tensor img, Tensor grid) -> Tensor', _forward_cuda,
    lambda img, grid: grid_sample_plain(img, grid).contiguous(),
    lambda img, grid: img.new_empty(tuple(grid.shape[:3]) +
                                    (img.shape[-1],)))


def grid_sample_forward(img: torch.Tensor, grid: torch.Tensor
                        ) -> torch.Tensor:
    """Kernel 8 on CUDA tensors (bf16 or f32 image, f32 grid), the plain
    version on CPU tensors, through ``torch.ops.tps_pp.grid_sample_fwd``.
    Same contract as :func:`grid_sample_plain`."""
    _lib.require_kernel_device(img.device, 'grid_sample_forward')
    return _forward_op(img, grid)


_PLAN_KEYS = ('rows', 'slab', 'ctas_per_sm', 'blocks', 'smem', 'cluster',
              'private')


def grid_sample_plan(N: int, H: int, W: int, C: int) -> Dict[str, int]:
    """The plan that kernels 9 and 10 take for an (N, H, W, C) image on the
    current CUDA device (``csrc/grid_sample.cu`` ``bwd_plan``; any C, the
    slab all of an odd one): ``rows`` a band, ``slab`` channels a CTA,
    ``ctas_per_sm`` that fit an SM, ``blocks`` (CTAs: one an image, band
    and slab at an even C; ``cluster`` an image and band at an odd C), the
    shared memory of a CTA in bytes (``smem``), ``cluster`` (CTAs a
    cluster: 1 at an even C) and ``private`` (1 where each thread of the
    narrow path sums into its own copy of the band). Raises a ValueError
    where no plan fits."""
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    _lib.check(_lib.load().tpk_grid_sample_plan(N, H, W, C, plan),
               'grid_sample_plan')
    return dict(zip(_PLAN_KEYS, plan))


_FWD_PLAN_KEYS = ('narrow', 'taps_shared', 'run', 'threads', 'blocks',
                  'smem')


def grid_sample_fwd_plan(N: int, H: int, W: int, C: int, P: int,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Dict[str, int]:
    """The plan that kernel 8 takes for an (N, H, W, C) image of ``dtype``
    sampled at P points an image, on the current CUDA device
    (``csrc/grid_sample.cu`` ``fwd_plan``): ``narrow`` (1 at an odd C; an
    even C runs a warp a sample, and only ``threads`` and ``blocks`` mean
    anything else), ``taps_shared`` (1 where the image's map is staged in
    shared memory, 0 where it is too large and the taps are read where
    they lie), ``run`` (samples a lane: a warp takes 32 x run), ``threads``
    (a CTA's), ``blocks`` (CTAs) and ``smem`` (bytes of a CTA). Raises a
    ValueError where no plan fits."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f'grid_sample_fwd_plan: {dtype} is not one of '
                         f'{_KERNEL_DTYPES}')
    plan = (ctypes.c_int * len(_FWD_PLAN_KEYS))()
    _lib.check(_lib.load().tpk_grid_sample_fwd_plan(
        N, H, W, C, P, int(dtype == torch.bfloat16), plan),
        'grid_sample_fwd_plan')
    return dict(zip(_FWD_PLAN_KEYS, plan))


def grid_sample_grad(grid: torch.Tensor, cot: torch.Tensor,
                     img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9 on CUDA tensors (cotangent and image of one dtype, bf16 or
    f32; f32 grid), the plain version on CPU tensors. Same contract as
    :func:`grid_sample_grad_plain`. d_img is summed by shared-memory f32
    atomics in a varying order, so its last bits vary from run to run."""
    if img.device.type == 'cpu':
        return grid_sample_grad_plain(grid, cot, img)
    what = 'grid_sample_grad'
    N, H, W, C = img.shape
    dev, _, npix = _check_common(what, grid, img, C)
    _expect(img, what, 'img', (N, H, W, C), _KERNEL_DTYPES, dev, C % 2 == 0)
    _expect(cot, what, 'cot', tuple(grid.shape[:3]) + (C,), (img.dtype,),
            dev, C % 2 == 0)
    d_img = torch.empty((N, H, W, C), dtype=torch.float32, device=dev)
    d_grid = torch.empty(grid.shape, dtype=torch.float32, device=dev)
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = _lib.load().tpk_grid_sample_grad(
        grid.data_ptr(), cot.data_ptr(), img.data_ptr(), d_img.data_ptr(),
        d_grid.data_ptr(), N, H, W, C, npix,
        int(img.dtype == torch.bfloat16), plan, _lib.stream_ptr(dev))
    _lib.check(rc, what)
    _lib.count_launch(grid_sample_grad)
    grid_sample_grad.last_plan = dict(zip(_PLAN_KEYS, plan))
    return d_img, d_grid


def grid_sample_grad_img(grid: torch.Tensor, cot: torch.Tensor, H: int,
                         W: int) -> torch.Tensor:
    """Kernel 10 on CUDA tensors (bf16 or f32 cotangent, f32 grid), the
    plain version on CPU tensors. Same contract as
    :func:`grid_sample_grad_img_plain`; the kernel of
    :func:`grid_sample_grad` without d_grid and without the image."""
    if cot.device.type == 'cpu':
        return grid_sample_grad_img_plain(grid, cot, H, W)
    what = 'grid_sample_grad_img'
    C = cot.shape[-1]
    dev, N, npix = _check_common(what, grid, cot, C)
    _expect(cot, what, 'cot', tuple(grid.shape[:3]) + (C,), _KERNEL_DTYPES,
            dev, C % 2 == 0)
    d_img = torch.empty((N, H, W, C), dtype=torch.float32, device=dev)
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = _lib.load().tpk_grid_sample_grad_img(
        grid.data_ptr(), cot.data_ptr(), d_img.data_ptr(), N, H, W, C, npix,
        int(cot.dtype == torch.bfloat16), plan, _lib.stream_ptr(dev))
    _lib.check(rc, what)
    _lib.count_launch(grid_sample_grad_img)
    grid_sample_grad_img.last_plan = dict(zip(_PLAN_KEYS, plan))
    return d_img


grid_sample_forward.launches = 0
grid_sample_grad.launches = 0
grid_sample_grad_img.launches = 0
grid_sample_grad.last_plan = grid_sample_grad_img.last_plan = None


class GridSampleFunction(torch.autograd.Function):
    """``grid_sample`` with the JAX package's custom VJP
    (``ops/grid_sample.py:108-140``): the forward through kernel 8; the
    backward through kernel 9, or kernel 10 when only the image needs a
    gradient; d_img is cast back to the image's dtype. Autocast is off
    inside: the sampling runs in the image's dtype with f32 weights."""

    @staticmethod
    @torch.amp.custom_fwd(device_type='cuda')
    def forward(ctx, img, grid, plain: bool = False):
        img, grid = img.contiguous(), grid.contiguous()
        ctx.save_for_backward(img, grid)
        ctx.plain = plain
        with torch.autocast(img.device.type, enabled=False):
            if plain:
                return grid_sample_plain(img, grid)
            return grid_sample_forward(img, grid)

    @staticmethod
    @torch.amp.custom_bwd(device_type='cuda')
    def backward(ctx, cot):
        img, grid = ctx.saved_tensors
        cot = cot.to(img.dtype).contiguous()
        with torch.autocast(img.device.type, enabled=False):
            if ctx.needs_input_grad[1]:
                fn = grid_sample_grad_plain if ctx.plain else grid_sample_grad
                d_img, d_grid = fn(grid, cot, img)
                d_img = (d_img.to(img.dtype) if ctx.needs_input_grad[0]
                         else None)
                return d_img, d_grid.to(grid.dtype), None
            fn = (grid_sample_grad_img_plain if ctx.plain
                  else grid_sample_grad_img)
            d_img = fn(grid, cot, img.shape[1], img.shape[2])
            return d_img.to(img.dtype), None, None


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """Differentiable bilinear sampling: img (N, H, W, C), grid
    (N, Ho, Wo, 2) -> (N, Ho, Wo, C) in img's dtype. The kernels on CUDA
    tensors, the plain versions on CPU tensors or with ``plain=True``."""
    return GridSampleFunction.apply(img, grid, plain)
