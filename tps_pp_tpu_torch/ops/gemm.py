"""The tensor-core GEMM of ``csrc/gemm.cu`` alone.

It carries the encoder's products (``ops/encoder.py``) and the whole
decode's encoder K/V projection (``ops/full_decode.py``), which launch it
from their C entry points. ``gemm`` launches it on CUDA tensors and runs
``gemm_plain``, the same function in plain PyTorch, on CPU tensors; the
tests hold one against the other. ``gemm`` is the operator
``torch.ops.tps_pp.gemm`` (``gemm_ln`` with the LayerNorm output).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib
from .encoder import ln_norm, mm


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None, gelu: bool = False,
               out_dtype: torch.dtype = torch.bfloat16, ln: bool = False,
               ln_s: Optional[torch.Tensor] = None,
               ln_b: Optional[torch.Tensor] = None):
    """v = a @ b in float32 (a (M, K), b (K, N)), then v += bias, v =
    GELU(v) (erf), v = residual + v. Returns v in ``out_dtype``; with
    ``ln`` also y = LN(v) (float32 statistics, eps 1e-5, then * ln_s + ln_b
    when given) in bfloat16, as (v, y)."""
    v = mm(a, b)
    if bias is not None:
        v = v + bias
    if gelu:
        v = F.gelu(v)
    if residual is not None:
        v = residual + v
    if not ln:
        return v.to(out_dtype)
    y = ln_norm(v)
    if ln_s is not None:
        y = y * ln_s + ln_b
    return v.to(out_dtype), y.to(torch.bfloat16)


def _gemm_cuda(a, b, bias, residual, gelu, out_dtype, ln, ln_s, ln_b):
    dev = a.device
    M, K = a.shape
    N = b.shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    args = {'a': (a, (M, K), bf), 'b': (b, (K, N), bf)}
    for name, t, shape in (('bias', bias, (N,)), ('residual', residual,
                                                  (M, N)),
                           ('ln_s', ln_s, (N,)), ('ln_b', ln_b, (N,))):
        if t is not None:
            args[name] = (t, shape, f32)
    _lib.check_args('gemm', dev, args)
    if out_dtype not in (bf, f32):
        raise ValueError(f'gemm: out_dtype {out_dtype}, not bf16 or f32')
    c = torch.empty((M, N), dtype=out_dtype, device=dev)
    y = torch.empty((M, N), dtype=bf, device=dev) if ln else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _lib.load().tpk_gemm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), ptr(bias), ptr(residual),
        ptr(y), ptr(ln_s), ptr(ln_b), M, N, K, int(out_dtype == bf),
        int(gelu), _lib.stream_ptr(dev))
    _lib.check(rc, 'gemm')
    _lib.count_launch(gemm)
    return (c, y) if ln else c


def _fake(a, b, bias, residual, gelu, out_dtype, ln, ln_s, ln_b):
    c = a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)
    return (c, a.new_empty(c.shape, dtype=torch.bfloat16)) if ln else c


_SCHEMA = ('(Tensor a, Tensor b, Tensor? bias, Tensor? residual, bool gelu, '
           'ScalarType out_dtype, bool ln, Tensor? ln_s, Tensor? ln_b) -> ')
# two operators, as a schema has no optional result: the product alone, and
# the product with its LayerNorm
_gemm_op = _lib.define_op('gemm', _SCHEMA + 'Tensor', _gemm_cuda,
                          lambda *a: gemm_plain(*a), _fake)
_gemm_ln_op = _lib.define_op('gemm_ln', _SCHEMA + '(Tensor, Tensor)',
                             _gemm_cuda, lambda *a: gemm_plain(*a), _fake)


def gemm(a: torch.Tensor, b: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None, gelu: bool = False,
         out_dtype: torch.dtype = torch.bfloat16, ln: bool = False,
         ln_s: Optional[torch.Tensor] = None,
         ln_b: Optional[torch.Tensor] = None):
    """The kernel on CUDA tensors (bf16 a and b; float32 bias, residual,
    ln_s, ln_b), the plain version on CPU tensors, through
    ``torch.ops.tps_pp.gemm`` (``gemm_ln`` with ``ln``). Same arguments as
    :func:`gemm_plain`. The kernel's limits (K a multiple of 64, N of 256,
    N = 512 with ``ln``) are checked at its entry point, ``csrc/gemm.cu``
    ``tpk_gemm``."""
    _lib.require_kernel_device(a.device, 'gemm')
    op = _gemm_ln_op if ln else _gemm_op
    return op(a, b, bias, residual, gelu, out_dtype, ln, ln_s, ln_b)


gemm.launches = 0
