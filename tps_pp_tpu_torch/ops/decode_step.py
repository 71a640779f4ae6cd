"""One NRTR decode step of one layer, in two fused functions.

Counterpart of ``tps_pp_tpu/ops/pallas_decode.py``, which the JAX ``steps``
decode runs with ``use_fused_step=True``: ``self_attn_step`` (LN1 + QKV +
cache append + masked attention + output projection + residual) and
``cross_ffn_step`` (LN2 + cross-attention + projection + residual + LN3 +
GELU FFN + residual). Each takes the JAX signature and layouts. The CUDA
kernels of ``csrc/decode_step.cu`` run on CUDA tensors (bf16 or float32
activations, caches and encoder K/V of the activations' dtype, bf16
weights; the limits of the shapes are stated there); the ``*_plain``
versions are the same functions in plain PyTorch, for CPU tensors (float64
too) and as the kernels' reference.

Rounding points are the Pallas kernels': LayerNorm with its affine in
float32 (not folded into the weights); matmul operands rounded to bf16,
products accumulated in float32; softmax weights kept in float32; the
residual stream in float32 inside a call, rounded to x's dtype on the way
out. The self-attention cache receives this step's K/V rounded to its dtype
at slot ``t`` (in place: the JAX call aliases the caches), while this
step's attention reads the unrounded float32 K/V at slot ``t``.
"""
from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _lib
from .encoder import NEG_INF, ln_norm, mm

_BF = torch.bfloat16
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _ln_affine(x, s, b):
    """LayerNorm (eps 1e-5) with its affine, in float32."""
    return ln_norm(x) * s.float() + b.float()


def _bmm(a, w):
    """bf16-rounded operands, float32 product."""
    return mm(a.to(_BF), w.to(_BF))


def self_attn_step_plain(x: torch.Tensor, ck: torch.Tensor,
                         cv: torch.Tensor, t: int, wqkv: torch.Tensor,
                         wfc: torch.Tensor, ln_s: torch.Tensor,
                         ln_b: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """x (N, D); ck/cv (N, H, T, DK) caches, slot ``t`` written in place;
    wqkv (D, 3*H*DK) (q|k|v, no bias); wfc (H*DK, D); ln_s/ln_b (D,).
    Returns (x_out in x's dtype, ck, cv)."""
    N = x.shape[0]
    _, H, T, DK = ck.shape
    HD = H * DK
    qkv = _bmm(_ln_affine(x, ln_s, ln_b), wqkv)
    q, k, v = (a.reshape(N, H, DK) for a in qkv.split(HD, dim=1))
    q = q * (1.0 / DK ** 0.5)
    ck[:, :, t] = k.to(ck.dtype)
    cv[:, :, t] = v.to(cv.dtype)
    # slots > t are masked: their softmax weights are exactly 0
    keys = torch.cat([ck[:, :, :t].float(), k[:, :, None]], dim=2)
    vals = torch.cat([cv[:, :, :t].float(), v[:, :, None]], dim=2)
    p = torch.softmax(torch.einsum('nhd,nhjd->nhj', q, keys), dim=-1)
    merged = torch.einsum('nhj,nhjd->nhd', p, vals).reshape(N, HD)
    return (x.float() + _bmm(merged, wfc)).to(x.dtype), ck, cv


def cross_ffn_step_plain(x: torch.Tensor, enc_k: torch.Tensor,
                         enc_v: torch.Tensor,
                         src_mask: Optional[torch.Tensor], wq, wfc, ln2_s,
                         ln2_b, w1, b1, w2, b2, ln3_s,
                         ln3_b) -> torch.Tensor:
    """x (N, D); enc_k/enc_v (N, H, TE, DK); src_mask (N, TE), key valid
    iff > 0 (None: all valid); wq (D, H*DK), wfc (H*DK, D), w1 (D, DI), b1
    (DI,), w2 (DI, D), b2 (D,), ln*_s/ln*_b (D,). Returns x_out in x's
    dtype."""
    N = x.shape[0]
    _, H, TE, DK = enc_k.shape
    q = _bmm(_ln_affine(x, ln2_s, ln2_b), wq).reshape(N, H, DK)
    s = torch.einsum('nhd,nhjd->nhj', q * (1.0 / DK ** 0.5), enc_k.float())
    if src_mask is not None:
        s = s.masked_fill(~(src_mask > 0)[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    merged = torch.einsum('nhj,nhjd->nhd', p, enc_v.float()).reshape(N, -1)
    x2 = x.float() + _bmm(merged, wfc)
    h = F.gelu(_bmm(_ln_affine(x2, ln3_s, ln3_b), w1) + b1.float())
    return (x2 + (_bmm(h, w2) + b2.float())).to(x.dtype)


def _act_dtype(name, x):
    """The activations' dtype, one the kernels take."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f'{name}: x must be one of {_KERNEL_DTYPES}, got '
                         f'{x.dtype}')
    return x.dtype


def _scratch(n_bytes, dev):
    """One uint8 scratch buffer of a call (the kernels carve it up)."""
    return torch.empty((n_bytes,), dtype=torch.uint8, device=dev)


# Weight tuples that passed a wrapper's checks, keyed by the tensors'
# storage pointers: a decode step passes the same weights at every step,
# so each tuple is checked once, and a call looks its key up in place of
# checking 4-10 tensors on the host. The weakrefs tell a tensor
# freed and its storage reused from the one checked; a weight given other
# storage has another key. (A weight resized in place over its storage
# after its first call is not checked again.)
_CHECKED = {}


def _weights_checked(name, ws, ptrs) -> bool:
    refs = _CHECKED.get((name,) + ptrs)
    return refs is not None and all(r() is t for r, t in zip(refs, ws))


def _remember_weights(name, ws, ptrs):
    if len(_CHECKED) >= 256:
        _CHECKED.clear()
    _CHECKED[(name,) + ptrs] = tuple(weakref.ref(t) for t in ws)


def self_attn_step(x, ck, cv, t: int, wqkv, wfc, ln_s, ln_b):
    """The kernel on CUDA tensors, the plain version on CPU tensors. Same
    arguments as :func:`self_attn_step_plain`."""
    if x.device.type == 'cpu':
        return self_attn_step_plain(x, ck, cv, t, wqkv, wfc, ln_s, ln_b)
    dev = x.device
    _lib.require_cuda(dev, 'self_attn_step')
    N, D = x.shape
    _, H, T, DK = ck.shape
    HD = H * DK
    f32, xt = torch.float32, _act_dtype('self_attn_step', x)
    _lib.check_args('self_attn_step', dev, {
        'x': (x, (N, D), xt), 'ck': (ck, (N, H, T, DK), xt),
        'cv': (cv, (N, H, T, DK), xt)})
    ws = (wqkv, wfc, ln_s, ln_b)
    wp = tuple(w.data_ptr() for w in ws)
    if not _weights_checked('self_attn_step', ws, wp):
        _lib.check_args('self_attn_step', dev, {
            'wqkv': (wqkv, (D, 3 * HD), _BF), 'wfc': (wfc, (HD, D), _BF),
            'ln_s': (ln_s, (D,), f32), 'ln_b': (ln_b, (D,), f32)})
        _remember_weights('self_attn_step', ws, wp)
    # qkv (N, 3HD) f32, then att (N, HD) bf16
    scratch = _scratch(N * HD * 14, dev)
    out = torch.empty((N, D), dtype=xt, device=dev)
    rc = _lib.load().tpk_self_attn_step(
        x.data_ptr(), ck.data_ptr(), cv.data_ptr(), *wp, scratch.data_ptr(),
        out.data_ptr(), N, D, H, DK, T, t, int(xt == _BF),
        _lib.stream_ptr(dev))
    _lib.check(rc, 'self_attn_step')
    self_attn_step.launches += 1
    return out, ck, cv


def cross_ffn_step(x, enc_k, enc_v, src_mask, wq, wfc, ln2_s, ln2_b, w1, b1,
                   w2, b2, ln3_s, ln3_b):
    """The kernel on CUDA tensors, the plain version on CPU tensors. Same
    arguments as :func:`cross_ffn_step_plain`."""
    args = (x, enc_k, enc_v, src_mask, wq, wfc, ln2_s, ln2_b, w1, b1, w2,
            b2, ln3_s, ln3_b)
    if x.device.type == 'cpu':
        return cross_ffn_step_plain(*args)
    dev = x.device
    _lib.require_cuda(dev, 'cross_ffn_step')
    N, D = x.shape
    _, H, TE, DK = enc_k.shape
    HD, DI = H * DK, w1.shape[1]
    f32, xt = torch.float32, _act_dtype('cross_ffn_step', x)
    if src_mask is None:
        src_mask = torch.ones((N, TE), dtype=f32, device=dev)
    _lib.check_args('cross_ffn_step', dev, {
        'x': (x, (N, D), xt), 'enc_k': (enc_k, (N, H, TE, DK), xt),
        'enc_v': (enc_v, (N, H, TE, DK), xt),
        'src_mask': (src_mask, (N, TE), f32)})
    ws = (wq, wfc, ln2_s, ln2_b, w1, b1, w2, b2, ln3_s, ln3_b)
    wp = tuple(w.data_ptr() for w in ws)
    if not _weights_checked('cross_ffn_step', ws, wp):
        _lib.check_args('cross_ffn_step', dev, {
            'wq': (wq, (D, HD), _BF), 'wfc': (wfc, (HD, D), _BF),
            'w1': (w1, (D, DI), _BF), 'b1': (b1, (DI,), f32),
            'w2': (w2, (DI, D), _BF), 'b2': (b2, (D,), f32),
            'ln2_s': (ln2_s, (D,), f32), 'ln2_b': (ln2_b, (D,), f32),
            'ln3_s': (ln3_s, (D,), f32), 'ln3_b': (ln3_b, (D,), f32)})
        _remember_weights('cross_ffn_step', ws, wp)
    # q (N, HD) f32, then att (N, HD) bf16
    scratch = _scratch(N * HD * 6, dev)
    out = torch.empty((N, D), dtype=xt, device=dev)
    rc = _lib.load().tpk_cross_ffn_step(
        x.data_ptr(), enc_k.data_ptr(), enc_v.data_ptr(), src_mask.data_ptr(),
        *wp, scratch.data_ptr(), out.data_ptr(), N, D, H, DK, TE, DI,
        int(xt == _BF), _lib.stream_ptr(dev))
    _lib.check(rc, 'cross_ffn_step')
    cross_ffn_step.launches += 1
    return out


self_attn_step.launches = 0
cross_ffn_step.launches = 0
