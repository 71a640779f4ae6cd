"""Whole NRTR greedy decode with the all-rows-EOS early exit.

Counterpart of ``tps_pp_tpu/ops/pallas_full_decode.py``
(``full_greedy_decode``): ``full_decode`` runs the CUDA kernels of
``csrc/full_decode.cu`` on CUDA tensors; ``full_decode_plain`` is the same
function in plain PyTorch, used for CPU tensors and as the kernels'
reference. The encoder K/V projection of every layer is part of the function
(one GEMM over the encoder output), so both take the encoder output itself.
``enc_dtype`` is the encoder K/V's type: ``'bfloat16'`` (the JAX package's
``fused40_bf16``) or ``'int8'`` (``fused40``; see :func:`quantize_enc_kv`).
Weights come from :func:`fold_decoder_weights`, folded once when they are
loaded: LN affines and 1/sqrt(d_k) into the adjacent matmuls, the final LN
into the classifier.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import _lib
from .encoder import NEG_INF, ln_norm, mm


def fold_decoder_weights(raw: Dict[str, torch.Tensor], n_head: int,
                         compute_dtype: torch.dtype
                         ) -> Dict[str, torch.Tensor]:
    """raw: stacked per-layer weights in (in, out) layout, as the JAX kernel
    takes them: ln{1,2,3}_{s,b} (L, D), wqkv (L, D, 3HD), wfc1 (L, HD, D),
    wq2 (L, D, HD), wk2/wv2 (L, D, HD) (cross-attention K/V), wfc2
    (L, HD, D), w1 (L, D, DI), b1 (L, DI), w2 (L, DI, D), b2 (L, D),
    lnf_s/lnf_b (D), embed (C, D), wcls (D, C-1), bcls (C-1), pe (S, D).
    Returns matmul weights in ``compute_dtype`` (the embedding too: the TPU
    kernel reads it in bf16) and biases, pe in float32, all contiguous."""
    r = {k: v.detach().float() for k, v in raw.items()}
    L, _, HD = r['wq2'].shape
    qsc = 1.0 / (HD // n_head) ** 0.5
    colscale = torch.cat([torch.full((HD,), qsc),
                          torch.ones(2 * HD)]).to(r['wqkv'].device)

    def fold(wname, lnname):
        return (r[wname] * r[f'{lnname}_s'][:, :, None],
                torch.einsum('ld,lde->le', r[f'{lnname}_b'], r[wname]))

    wqkv, bqkv = fold('wqkv', 'ln1')
    wq2, bq2 = fold('wq2', 'ln2')
    w1, b1 = fold('w1', 'ln3')
    D = wqkv.shape[1]
    wkv_enc = torch.stack([r['wk2'], r['wv2']], dim=2)     # (L, D, 2, HD)
    wkv_enc = wkv_enc.permute(1, 0, 2, 3).reshape(D, L * 2 * HD)
    cdt = compute_dtype
    out = dict(
        wkv_enc=wkv_enc.to(cdt), embed=r['embed'].to(cdt), pe=r['pe'],
        wqkv=(wqkv * colscale).to(cdt), bqkv=bqkv * colscale,
        wfc1=r['wfc1'].to(cdt), wq2=(wq2 * qsc).to(cdt), bq2=bq2 * qsc,
        wfc2=r['wfc2'].to(cdt), w1=w1.to(cdt), b1=b1 + r['b1'],
        w2=r['w2'].to(cdt), b2=r['b2'],
        wcls=(r['wcls'] * r['lnf_s'][:, None]).to(cdt),
        bcls=r['bcls'] + r['lnf_b'] @ r['wcls'])
    return {k: v.contiguous() for k, v in out.items()}


def _dims(w, n_head):
    L, D, HD = w['wq2'].shape
    return dict(L=L, D=D, HD=HD, H=n_head, DK=HD // n_head,
                DI=w['w1'].shape[2], S=w['pe'].shape[0],
                NC=w['wcls'].shape[1])


def quantize_enc_kv(ekv: torch.Tensor, dk: int):
    """(rows, L*2*H*dk) encoder K/V, columns [K | V] per layer and heads of
    dk columns -> (int8 values, float32 scales (L*2*H,), index
    l*2H + {0: K, 1: V}*H + h). One absmax scale per column group over every
    row, max|x| / 127 + 1e-8; values round(x / scale), half to even,
    clipped to +-127 (``tps_pp_tpu/ops/pallas_full_decode.py:302-311``). The
    scales span the whole batch, so a row's values depend on the others."""
    x = ekv.float().reshape(ekv.shape[0], -1, dk)
    scales = x.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
    q = torch.round(x / scales[:, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(ekv.shape), scales


def full_decode_plain(out_enc: torch.Tensor, src_mask: torch.Tensor,
                      w: Dict[str, torch.Tensor], n_head: int,
                      start_idx: int, end_idx: Optional[int] = None,
                      enc_dtype: str = 'bfloat16') -> torch.Tensor:
    """out_enc (N, TE, D) encoder output; src_mask (N, TE), valid iff > 0;
    w from :func:`fold_decoder_weights`. Runs S greedy steps (or until every
    row has emitted ``end_idx``; rows with no valid source token count as
    finished, and skipped steps read 0). Returns (N, S, C-1) float32 per-step
    softmax probabilities. With ``enc_dtype='int8'`` the cross-attention
    takes q as ``bf16(q_f32 * k_scale)``, int8 K/V, the softmax weights
    rounded to bf16 before the V product and the result times
    ``v_scale``, as the TPU kernel's ``_attend_allheads`` does; elsewhere
    values are rounded to the weights' dtype."""
    cdt = w['wqkv'].dtype
    d = _dims(w, n_head)
    L, HD, H, DK, S, NC = d['L'], d['HD'], d['H'], d['DK'], d['S'], d['NC']
    N, TE, D = out_enc.shape
    dev = out_enc.device
    q8 = _check_enc_dtype(enc_dtype)
    bf16 = torch.bfloat16
    ekv = _project_enc_kv(out_enc, w['wkv_enc'])
    if q8:
        ekv, scales = quantize_enc_kv(ekv, DK)
        k_scale, v_scale = scales.reshape(L, 2, H).unbind(1)     # (L, H)
    ekv = ekv.reshape(N, TE, L, 2, H, DK).permute(2, 3, 0, 4, 1, 5).float()
    enc_k, enc_v = ekv[:, 0], ekv[:, 1]                  # (L, N, H, TE, DK)
    keep = (src_mask > 0)[:, None, :]
    cache_k = torch.zeros((L, N, H, S, DK), dtype=cdt, device=dev)
    cache_v = torch.zeros_like(cache_k)
    probs = torch.zeros((N, S, NC), dtype=torch.float32, device=dev)
    tok = torch.full((N,), start_idx, dtype=torch.long, device=dev)
    finished = ~(src_mask > 0).any(dim=1)

    def attend(q, k, v, keep=None, v_scale=None):
        """q (N, H, DK); k/v (N, H, J, DK); v_scale (H,): int8 K/V, whose
        softmax weights are rounded to bf16 whatever ``cdt``, as the TPU
        kernel's."""
        s = torch.einsum('nhd,nhjd->nhj', q.float(), k.float())
        if keep is not None:
            s = s.masked_fill(~keep, NEG_INF)
        p = torch.softmax(s, dim=-1).to(cdt if v_scale is None else bf16)
        a = torch.einsum('nhj,nhjd->nhd', p.float(), v.float())
        if v_scale is not None:
            a = a * v_scale[:, None]
        return a.to(cdt).reshape(N, HD)

    for t in range(S):
        if end_idx is not None and bool(finished.all()):
            break
        x = w['embed'][tok].float() + w['pe'][t]
        for l in range(L):
            qkv = (mm(ln_norm(x).to(cdt), w['wqkv'][l]) + w['bqkv'][l]).to(cdt)
            q, k, v = (a.reshape(N, H, DK) for a in qkv.split(HD, dim=1))
            cache_k[l, :, :, t] = k
            cache_v[l, :, :, t] = v
            a = attend(q, cache_k[l, :, :, :t + 1], cache_v[l, :, :, :t + 1])
            x = x + mm(a, w['wfc1'][l])
            q2 = (mm(ln_norm(x).to(cdt), w['wq2'][l]) + w['bq2'][l])
            q2 = q2.reshape(N, H, DK)
            if q8:
                a = attend((q2 * k_scale[l][:, None]).to(bf16), enc_k[l],
                           enc_v[l], keep, v_scale[l])
            else:
                a = attend(q2.to(cdt), enc_k[l], enc_v[l], keep)
            x = x + mm(a, w['wfc2'][l])
            h = F.gelu(mm(ln_norm(x).to(cdt), w['w1'][l]) + w['b1'][l])
            x = x + (mm(h.to(cdt), w['w2'][l]) + w['b2'][l])
        logits = mm(ln_norm(x, eps=1e-6).to(cdt), w['wcls']) + w['bcls']
        p = torch.softmax(logits, dim=-1)
        probs[:, t] = p
        tok = p.argmax(dim=-1)            # first index among ties
        if end_idx is not None:
            finished |= tok == end_idx
    return probs


def _project_enc_kv(out_enc: torch.Tensor,
                    wkv_enc: torch.Tensor) -> torch.Tensor:
    """Every layer's encoder K/V, (N*TE, L*2HD) in the weights' dtype: one
    float32 product of the operands rounded to that dtype."""
    cdt = wkv_enc.dtype
    return mm(out_enc.reshape(-1, out_enc.shape[-1]).to(cdt),
              wkv_enc).to(cdt)


def _check_enc_dtype(enc_dtype: str) -> bool:
    """True for int8 encoder K/V; raises on a type the kernel lacks."""
    if enc_dtype not in ('bfloat16', 'int8'):
        raise ValueError(f"enc_dtype {enc_dtype!r} not in ('bfloat16', "
                         f"'int8')")
    return enc_dtype == 'int8'


_WEIGHT_ORDER = ('wkv_enc', 'embed', 'pe', 'wqkv', 'bqkv', 'wfc1', 'wq2',
                 'bq2', 'wfc2', 'w1', 'b1', 'w2', 'b2', 'wcls', 'bcls')


def full_decode(out_enc: torch.Tensor, src_mask: torch.Tensor,
                w: Dict[str, torch.Tensor], n_head: int, start_idx: int,
                end_idx: Optional[int] = None,
                enc_dtype: str = 'bfloat16') -> torch.Tensor:
    """The kernels on CUDA tensors (bf16 encoder output and weights), the
    plain version on CPU tensors. Same arguments as
    :func:`full_decode_plain`. ``launches`` counts the bf16 branch's calls,
    ``launches_int8`` the int8 branch's."""
    if out_enc.device.type == 'cpu':
        return full_decode_plain(out_enc, src_mask, w, n_head, start_idx,
                                 end_idx, enc_dtype)
    dev = out_enc.device
    _lib.require_cuda(dev, 'full_decode')
    q8 = _check_enc_dtype(enc_dtype)
    d = _dims(w, n_head)
    L, D, HD, H, DK, DI, S, NC = (d[k] for k in
                                  ('L', 'D', 'HD', 'H', 'DK', 'DI', 'S',
                                   'NC'))
    N, TE = out_enc.shape[:2]
    bf, f32 = torch.bfloat16, torch.float32
    C = w['embed'].shape[0]
    _lib.check_args('full_decode', dev, {
        'out_enc': (out_enc, (N, TE, D), bf),
        'src_mask': (src_mask, (N, TE), f32),
        'wkv_enc': (w['wkv_enc'], (D, L * 2 * HD), bf),
        'embed': (w['embed'], (C, D), bf), 'pe': (w['pe'], (S, D), f32),
        'wqkv': (w['wqkv'], (L, D, 3 * HD), bf),
        'bqkv': (w['bqkv'], (L, 3 * HD), f32),
        'wfc1': (w['wfc1'], (L, HD, D), bf), 'wq2': (w['wq2'], (L, D, HD), bf),
        'bq2': (w['bq2'], (L, HD), f32), 'wfc2': (w['wfc2'], (L, HD, D), bf),
        'w1': (w['w1'], (L, D, DI), bf), 'b1': (w['b1'], (L, DI), f32),
        'w2': (w['w2'], (L, DI, D), bf), 'b2': (w['b2'], (L, D), f32),
        'wcls': (w['wcls'], (D, NC), bf), 'bcls': (w['bcls'], (NC,), f32)})
    if DK != 64 or D % 64 or DI % 64 or S > 256 or TE > 256 \
            or (D + NC) * 4 > 48 * 1024:
        raise ValueError(f'full_decode: needs d_k == 64, d_model and d_inner '
                         f'multiples of 64, at most 256 steps and source '
                         f'tokens; got d_k={DK}, D={D}, DI={DI}, S={S}, '
                         f'TE={TE}')
    i32 = torch.int32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    if q8:
        # the projection that the JAX package computes outside its kernel,
        # by the plain version's own op: quantization turns a one-ulp
        # difference of a K/V value, or of a group's max, into a whole
        # quantization step, so both paths quantize the same values
        enc_kv = _project_enc_kv(out_enc, w['wkv_enc'])
    else:
        enc_kv = empty((N * TE, L * 2 * HD), bf)
    cache = empty((L, N, S, 2 * HD), bf)
    x32, y = empty((N, D), f32), empty((N, D), bf)
    qkv, att, hid = empty((N, 3 * HD), bf), empty((N, HD), bf), \
        empty((N, DI), bf)
    tok, finished, remaining = empty((N,), i32), empty((N,), i32), \
        empty((1,), i32)
    probs = empty((N, S, NC), f32)
    # int8 branch: quantized K/V, per-group absmax bits and scales, f32 q2
    int8_scratch = ((empty((N * TE, L * 2 * HD), torch.int8),
                     empty((L * 2 * H,), i32), empty((L * 2 * H,), f32),
                     empty((N, HD), f32)) if q8 else None)
    ptrs = ([t.data_ptr() for t in int8_scratch] if q8 else [None] * 4)
    steps_run = ctypes.c_int(0)
    rc = _lib.load().tpk_full_decode(
        out_enc.data_ptr(), src_mask.data_ptr(),
        *(w[k].data_ptr() for k in _WEIGHT_ORDER),
        enc_kv.data_ptr(), cache.data_ptr(), x32.data_ptr(), y.data_ptr(),
        qkv.data_ptr(), att.data_ptr(), hid.data_ptr(), tok.data_ptr(),
        finished.data_ptr(), remaining.data_ptr(), probs.data_ptr(), *ptrs,
        N, TE, D, H, DK, DI, L, S, NC, start_idx,
        -1 if end_idx is None else end_idx,
        ctypes.addressof(steps_run), _lib.stream_ptr(dev))
    _lib.check(rc, 'full_decode')
    if q8:
        full_decode.launches_int8 += 1
    else:
        full_decode.launches += 1
    full_decode.last_steps = steps_run.value
    return probs


full_decode.launches = 0
full_decode.launches_int8 = 0
full_decode.last_steps = 0
