"""The fused stem: 3x3 convolutions and BasicBlocks in the (C, P) layout.

Counterpart of ``tps_pp_tpu/ops/pallas_stem.py``. Activations are
``(C, P)`` tensors with P = N*H*W the flat pixel index (w fastest), the JAX
package's public layout, and a 3x3 SAME convolution is one product of the
``(C_out, 9*C_in)`` tap weights ((dy, dx) row-major, C_in fastest) with the
nine shifted, zero-masked views of its input.

Kernels (``csrc/stem.cu``), each wrapper launching on CUDA tensors and
taking the plain version on CPU tensors:

* ``conv3x3_cp``: kernel 11, replaces ``_conv3x3_kernel``: a 3x3 SAME
  convolution + bias (+ ReLU);
* ``basic_block_cp``: kernel 12, replaces ``_block_kernel``: a BasicBlock
  (``use_conv1x1``) with its BatchNorms folded in.

In bf16 both run one band-walk kernel; ``stem_plan`` reports its plan.

``fused_stem_forward(backbone, img, dtype, plain=False)`` runs the flagship
trunk's stem, layer1 and layer2 through them, as the JAX function does
(``pallas_stem.py:229-302``), with one deliberate difference: the stem
conv's bias is folded too. The JAX function drops it, which no randomly
initialised model shows (its bias is zero); the port follows the module
stem, ``ResNetABI_v2_large.stem_and_head``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _lib

_F32 = torch.float32


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, _F32)


# ---------------------------------------------------------------- layouts
def nhwc_to_cp(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (C, N*H*W), contiguous."""
    N, H, W, C = x.shape
    return x.permute(3, 0, 1, 2).reshape(C, N * H * W).contiguous()


def cp_to_nhwc(x2d: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """(C, N*H*W) -> (N, H, W, C), a view."""
    N, H, W = shape
    return x2d.reshape(x2d.shape[0], N, H, W).permute(1, 2, 3, 0)


def hwio_to_taps(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C_in, C_out) weights -> (C_out, 9*C_in) tap rows, (dy, dx)
    row-major and C_in fastest."""
    KH, KW, Cin, Cout = w.shape
    if (KH, KW) != (3, 3):
        raise ValueError(f'hwio_to_taps: a 3x3 kernel, got {KH}x{KW}')
    return w.permute(3, 0, 1, 2).reshape(Cout, 9 * Cin)


def oihw_to_taps(w: torch.Tensor) -> torch.Tensor:
    """torch's (C_out, C_in, 3, 3) weights -> the same tap rows as
    :func:`hwio_to_taps`."""
    Cout, Cin, KH, KW = w.shape
    if (KH, KW) != (3, 3):
        raise ValueError(f'oihw_to_taps: a 3x3 kernel, got {KH}x{KW}')
    return w.permute(0, 2, 3, 1).reshape(Cout, 9 * Cin)


def fold_bn(weight: torch.Tensor, bn, conv_bias=None):
    """Fold an eval-mode BatchNorm module into the convolution before it:
    (weight * gamma / sigma, beta + gamma * (bias - mean) / sigma), with
    sigma = sqrt(var + eps) and bias 0 when the convolution has none, in
    float32 (float64 for a float64 module) whatever the module's dtype.
    ``weight`` keeps its layout; cast the results to the compute dtype."""
    f = _compute_dtype(weight.dtype)
    gamma, beta = bn.weight.to(f), bn.bias.to(f)
    mean, var = bn.running_mean.to(f), bn.running_var.to(f)
    sigma = torch.sqrt(var + bn.eps)
    scale = gamma / sigma
    w = weight.to(f) * scale.reshape((-1,) + (1,) * (weight.dim() - 1))
    if conv_bias is None:
        return w, beta - gamma * mean / sigma
    return w, beta + gamma * (conv_bias.to(f) - mean) / sigma


def _subsample2(x2d: torch.Tensor, n: int, H: int, W: int) -> torch.Tensor:
    """(C, n*H*W) -> (C, n*(H//2)*(W//2)), the even h and w."""
    C = x2d.shape[0]
    return x2d.reshape(C, n, H, W)[:, :, ::2, ::2].reshape(
        C, n * (H // 2) * (W // 2))


# ------------------------------------------------------- plain versions
def _shift_tap(x2d: torch.Tensor, dy: int, dx: int, H: int,
               W: int) -> torch.Tensor:
    """The (dy, dx) tap of x2d (C, n*H*W): the pixel at (h+dy, w+dx)
    aligned onto (h, w), zero outside its image."""
    shift = dy * W + dx
    t = x2d if shift == 0 else torch.roll(x2d, -shift, dims=1)
    pix = torch.arange(x2d.shape[1], device=x2d.device)
    w, h = pix % W, (pix // W) % H
    ok = torch.ones_like(pix, dtype=torch.bool)
    if dx > 0:
        ok &= w < W - dx
    elif dx < 0:
        ok &= w >= -dx
    if dy > 0:
        ok &= h < H - dy
    elif dy < 0:
        ok &= h >= -dy
    return torch.where(ok, t, torch.zeros((), dtype=t.dtype, device=t.device))


def _patches(x2d: torch.Tensor, H: int, W: int, cdt) -> torch.Tensor:
    """(9*C, P): the nine taps stacked in weight order, in ``cdt``."""
    return torch.cat([_shift_tap(x2d, dy, dx, H, W).to(cdt)
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def conv3x3_cp_plain(x2d, w, b, *, H: int, W: int,
                     relu: bool = False) -> torch.Tensor:
    """x2d (C_in, N*H*W); w (C_out, 9*C_in) tap rows; b (C_out, 1) float32.
    One product in float32 (float64 for float64 inputs), + b, optional
    ReLU, one rounding to x2d's dtype."""
    cdt = _compute_dtype(x2d.dtype)
    acc = torch.matmul(w.to(cdt), _patches(x2d, H, W, cdt)) + b.to(cdt)
    if relu:
        acc = torch.relu(acc)
    return acc.to(x2d.dtype)


def basic_block_cp_plain(t, w1, b1, wtaps, b2, *, H: int, W: int,
                         residual: bool = True) -> torch.Tensor:
    """t (C_in, P); w1 (C_mid, C_in); b1 (C_mid, 1) and b2 (C_out, 1)
    float32; wtaps (C_out, 9*C_mid). y = relu(w1 @ t + b1) rounded to t's
    dtype; z = wtaps @ taps(y) + b2; returns relu(z + t) (``residual``,
    which needs C_out == C_in) or z, rounded once to t's dtype."""
    cdt = _compute_dtype(t.dtype)
    y = torch.relu(torch.matmul(w1.to(cdt), t.to(cdt)) + b1.to(cdt))
    y = y.to(t.dtype)
    z = torch.matmul(wtaps.to(cdt), _patches(y, H, W, cdt)) + b2.to(cdt)
    if residual:
        z = torch.relu(z + t.to(cdt))
    return z.to(t.dtype)


# -------------------------------------------------------------- kernels
def _images(name, x2d, H, W) -> int:
    if x2d.dim() != 2 or H < 1 or W < 1 or x2d.shape[1] % (H * W):
        raise ValueError(f'{name}: input must be (C, N*H*W) with H={H}, '
                         f'W={W}, got {tuple(x2d.shape)}')
    return x2d.shape[1] // (H * W)


def _kernel_dtype(name, x2d) -> torch.dtype:
    if x2d.dtype not in (torch.bfloat16, _F32):
        raise ValueError(f'{name}: bfloat16 or float32 activations, got '
                         f'{x2d.dtype}')
    return x2d.dtype


def conv3x3_cp(x2d, w, b, *, H: int, W: int,
               relu: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors (bf16 or float32 activations and weights
    of the same dtype, float32 bias; the limits of the shapes are stated in
    ``csrc/stem.cu``), the plain version on CPU tensors. Arguments as
    :func:`conv3x3_cp_plain`."""
    if x2d.device.type == 'cpu':
        return conv3x3_cp_plain(x2d, w, b, H=H, W=W, relu=relu)
    dev = x2d.device
    _lib.require_cuda(dev, 'conv3x3_cp')
    N = _images('conv3x3_cp', x2d, H, W)
    dt = _kernel_dtype('conv3x3_cp', x2d)
    C, P = x2d.shape
    Cout = w.shape[0]
    _lib.check_args('conv3x3_cp', dev, {
        'x2d': (x2d, (C, P), dt), 'w': (w, (Cout, 9 * C), dt),
        'b': (b, (Cout, 1), _F32)})
    out = torch.empty((Cout, P), dtype=dt, device=dev)
    rc = _lib.load().tpk_conv3x3_cp(
        x2d.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), C, Cout,
        N, H, W, int(relu), int(dt == torch.bfloat16), _lib.stream_ptr(dev))
    _lib.check(rc, 'conv3x3_cp')
    conv3x3_cp.launches += 1
    return out


conv3x3_cp.launches = 0


def basic_block_cp(t, w1, b1, wtaps, b2, *, H: int, W: int,
                   residual: bool = True) -> torch.Tensor:
    """The kernel on CUDA tensors (bf16 or float32 activations and weights
    of the same dtype, float32 biases; the limits of the shapes are stated
    in ``csrc/stem.cu``), the plain version on CPU tensors. Arguments as
    :func:`basic_block_cp_plain`."""
    if t.device.type == 'cpu':
        return basic_block_cp_plain(t, w1, b1, wtaps, b2, H=H, W=W,
                                    residual=residual)
    dev = t.device
    _lib.require_cuda(dev, 'basic_block_cp')
    N = _images('basic_block_cp', t, H, W)
    dt = _kernel_dtype('basic_block_cp', t)
    Cin, P = t.shape
    Cmid, Cout = w1.shape[0], wtaps.shape[0]
    _lib.check_args('basic_block_cp', dev, {
        't': (t, (Cin, P), dt), 'w1': (w1, (Cmid, Cin), dt),
        'b1': (b1, (Cmid, 1), _F32), 'wtaps': (wtaps, (Cout, 9 * Cmid), dt),
        'b2': (b2, (Cout, 1), _F32)})
    out = torch.empty((Cout, P), dtype=dt, device=dev)
    rc = _lib.load().tpk_basic_block_cp(
        t.data_ptr(), w1.data_ptr(), b1.data_ptr(), wtaps.data_ptr(),
        b2.data_ptr(), out.data_ptr(), Cin, Cmid, Cout, N, H, W,
        int(residual), int(dt == torch.bfloat16), _lib.stream_ptr(dev))
    _lib.check(rc, 'basic_block_cp')
    basic_block_cp.launches += 1
    return out


basic_block_cp.launches = 0


def stem_plan(C_in: int, C_mid: int, C_out: int, N: int, H: int, W: int,
              block: bool = True) -> Dict[str, int]:
    """The plan that the bf16 kernel (12 with ``block``, else 11 with
    C_mid = C_in) takes at this shape on the current CUDA device: ``R``
    output rows a group, ``NR`` ring slots, ``blocks`` and the shared
    memory of a block in bytes (``csrc/stem.cu`` ``band_plan``). Raises a
    ValueError where no plan fits."""
    plan = (ctypes.c_int * 4)()
    _lib.check(_lib.load().tpk_stem_plan(C_in, C_mid, C_out, N, H, W,
                                         int(block), plan), 'stem_plan')
    return dict(zip(('R', 'NR', 'blocks', 'smem'), plan))


# ---------------------------------------------------------- fused stem
def _block_weights(blk, dtype) -> Dict[str, torch.Tensor]:
    bdt = _compute_dtype(dtype)
    w1, b1 = fold_bn(blk.conv1.weight[:, :, 0, 0], blk.bn1)
    w2, b2 = fold_bn(blk.conv2.weight, blk.bn2)
    out = dict(w1=w1.to(dtype).contiguous(), b1=b1[:, None].to(bdt),
               wt=oihw_to_taps(w2).to(dtype).contiguous(),
               b2=b2[:, None].to(bdt))
    if blk.downsample is not None:
        conv, bn = blk.downsample
        wd, bd = fold_bn(conv.weight[:, :, 0, 0], bn)
        out['wd'] = wd.to(dtype)
        out['bd'] = bd[:, None].to(bdt)
    return out


def fold_stem(backbone, dtype: torch.dtype) -> Dict:
    """The stem conv and the blocks of layer1 and layer2 of ``backbone``
    with their BatchNorms folded, matmul weights in ``dtype``, biases in
    float32 (float64 for a float64 ``dtype``; the stem conv's bias in
    ``dtype``, as it is added to the conv's output). The backbone caches
    it per weights stamp (``ResNetABI_v2_large.fused_stem_weights``)."""
    with torch.no_grad():
        k1, c1b = fold_bn(backbone.conv1.weight, backbone.bn1,
                          backbone.conv1.bias)
        return dict(k1=k1.to(dtype), c1b=c1b.to(dtype),
                    layer1=[_block_weights(b, dtype)
                            for b in backbone.layer1],
                    layer2=[_block_weights(b, dtype)
                            for b in backbone.layer2])


def fused_stem_forward(backbone, img: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16,
                       plain: bool = False):
    """The flagship stem (conv1 + bn1 + ReLU, layer1 at stride 1, layer2
    with its stride-2 first block) of ``backbone`` (a
    ``ResNetABI_v2_large`` in eval mode, ``strides[:2] == (1, 2)``) on img
    (N, H, W, 3), through kernels 11-12 in ``dtype``; ``plain`` takes their
    plain versions on any device. Returns (x, [skip0, skip1]) as
    ``backbone.stem_and_head`` does, all NHWC. H and W must be even."""
    N, H, W, _ = img.shape
    if H % 2 or W % 2:
        raise ValueError(f'fused stem: the stride-2 subsample needs an even '
                         f'H and W, got {H}x{W}; use stem_mode="xla"')
    block = basic_block_cp_plain if plain else basic_block_cp
    cdt = _compute_dtype(dtype)
    p = backbone.fused_stem_weights(dtype)

    # conv1 + bn1 + ReLU: 3 -> C channels, a library convolution, as the
    # JAX function leaves it to XLA
    x = F.conv2d(img.to(dtype).permute(0, 3, 1, 2), p['k1'], padding=1)
    x = torch.relu(x + p['c1b'].reshape(1, -1, 1, 1))
    skip0 = x.permute(0, 2, 3, 1)
    t = nhwc_to_cp(skip0)

    for a in p['layer1']:
        t = block(t, a['w1'], a['b1'], a['wt'], a['b2'], H=H, W=W,
                  residual=True)
    skip1 = cp_to_nhwc(t, (N, H, W))

    # layer2 block0: the stride-2 main path at full resolution, then the
    # even pixels; the downsample branch on the subsampled input, its
    # product kept in float32
    a0 = p['layer2'][0]
    z = block(t, a0['w1'], a0['b1'], a0['wt'], a0['b2'], H=H, W=W,
              residual=False)
    z = _subsample2(z, N, H, W)
    idn = torch.matmul(a0['wd'].to(cdt), _subsample2(t, N, H, W).to(cdt))
    t = torch.relu(z.to(cdt) + idn + a0['bd']).to(dtype)
    H, W = H // 2, W // 2
    for a in p['layer2'][1:]:
        t = block(t, a['w1'], a['b1'], a['wt'], a['b2'], H=H, W=W,
                  residual=True)
    return cp_to_nhwc(t, (N, H, W)), [skip0, skip1]
