"""Whole NRTR greedy decode with the all-rows-EOS early exit.

Counterpart of ``tps_pp_tpu/ops/pallas_full_decode.py``
(``full_greedy_decode``, bf16 encoder K/V): ``full_decode`` runs the CUDA
kernels of ``csrc/full_decode.cu`` on CUDA tensors; ``full_decode_plain`` is
the same function in plain PyTorch, used for CPU tensors and as the kernels'
reference. The encoder K/V projection of every layer is part of the function
(one GEMM over the encoder output), so both take the encoder output itself.
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


def full_decode_plain(out_enc: torch.Tensor, src_mask: torch.Tensor,
                      w: Dict[str, torch.Tensor], n_head: int,
                      start_idx: int,
                      end_idx: Optional[int] = None) -> torch.Tensor:
    """out_enc (N, TE, D) encoder output; src_mask (N, TE), valid iff > 0;
    w from :func:`fold_decoder_weights`. Runs S greedy steps (or until every
    row has emitted ``end_idx``; rows with no valid source token count as
    finished, and skipped steps read 0). Returns (N, S, C-1) float32 per-step
    softmax probabilities."""
    cdt = w['wqkv'].dtype
    d = _dims(w, n_head)
    L, HD, H, DK, S, NC = d['L'], d['HD'], d['H'], d['DK'], d['S'], d['NC']
    N, TE, D = out_enc.shape
    dev = out_enc.device
    ekv = mm(out_enc.reshape(N * TE, D).to(cdt), w['wkv_enc']).to(cdt)
    ekv = ekv.reshape(N, TE, L, 2, H, DK).permute(2, 3, 0, 4, 1, 5).float()
    enc_k, enc_v = ekv[:, 0], ekv[:, 1]                  # (L, N, H, TE, DK)
    keep = (src_mask > 0)[:, None, :]
    cache_k = torch.zeros((L, N, H, S, DK), dtype=cdt, device=dev)
    cache_v = torch.zeros_like(cache_k)
    probs = torch.zeros((N, S, NC), dtype=torch.float32, device=dev)
    tok = torch.full((N,), start_idx, dtype=torch.long, device=dev)
    finished = ~(src_mask > 0).any(dim=1)

    def attend(q, k, v, keep=None):     # q (N,H,DK); k/v (N,H,J,DK)
        s = torch.einsum('nhd,nhjd->nhj', q.float(), k.float())
        if keep is not None:
            s = s.masked_fill(~keep, NEG_INF)
        p = torch.softmax(s, dim=-1).to(cdt)
        a = torch.einsum('nhj,nhjd->nhd', p.float(), v.float())
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
            q2 = (mm(ln_norm(x).to(cdt), w['wq2'][l]) + w['bq2'][l]).to(cdt)
            a = attend(q2.reshape(N, H, DK), enc_k[l], enc_v[l], keep)
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


_WEIGHT_ORDER = ('wkv_enc', 'embed', 'pe', 'wqkv', 'bqkv', 'wfc1', 'wq2',
                 'bq2', 'wfc2', 'w1', 'b1', 'w2', 'b2', 'wcls', 'bcls')


def full_decode(out_enc: torch.Tensor, src_mask: torch.Tensor,
                w: Dict[str, torch.Tensor], n_head: int, start_idx: int,
                end_idx: Optional[int] = None) -> torch.Tensor:
    """The kernels on CUDA tensors (bf16 encoder output and weights), the
    plain version on CPU tensors. Same arguments as
    :func:`full_decode_plain`."""
    if out_enc.device.type == 'cpu':
        return full_decode_plain(out_enc, src_mask, w, n_head, start_idx,
                                 end_idx)
    dev = out_enc.device
    _lib.require_cuda(dev, 'full_decode')
    d = _dims(w, n_head)
    L, D, HD, H, DK, DI, S, NC = (d[k] for k in
                                  ('L', 'D', 'HD', 'H', 'DK', 'DI', 'S',
                                   'NC'))
    N, TE = out_enc.shape[:2]
    bf, f32 = torch.bfloat16, torch.float32
    C = w['embed'].shape[0]
    expected = {
        'out_enc': (out_enc, (N, TE, D), bf), 'src_mask': (src_mask,
                                                          (N, TE), f32),
        'wkv_enc': (w['wkv_enc'], (D, L * 2 * HD), bf),
        'embed': (w['embed'], (C, D), bf), 'pe': (w['pe'], (S, D), f32),
        'wqkv': (w['wqkv'], (L, D, 3 * HD), bf),
        'bqkv': (w['bqkv'], (L, 3 * HD), f32),
        'wfc1': (w['wfc1'], (L, HD, D), bf), 'wq2': (w['wq2'], (L, D, HD), bf),
        'bq2': (w['bq2'], (L, HD), f32), 'wfc2': (w['wfc2'], (L, HD, D), bf),
        'w1': (w['w1'], (L, D, DI), bf), 'b1': (w['b1'], (L, DI), f32),
        'w2': (w['w2'], (L, DI, D), bf), 'b2': (w['b2'], (L, D), f32),
        'wcls': (w['wcls'], (D, NC), bf), 'bcls': (w['bcls'], (NC,), f32)}
    for name, (t, shape, dt) in expected.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f'full_decode: {name} must be a contiguous {dt} tensor of '
                f'shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on '
                f'{t.device}')
    if DK != 64 or D % 64 or DI % 64 or S > 256 or TE > 256 \
            or (D + NC) * 4 > 48 * 1024:
        raise ValueError(f'full_decode: needs d_k == 64, d_model and d_inner '
                         f'multiples of 64, at most 256 steps and source '
                         f'tokens; got d_k={DK}, D={D}, DI={DI}, S={S}, '
                         f'TE={TE}')
    i32 = torch.int32
    enc_kv = torch.empty((N * TE, L * 2 * HD), dtype=bf, device=dev)
    cache = torch.empty((L, N, S, 2 * HD), dtype=bf, device=dev)
    x32 = torch.empty((N, D), dtype=f32, device=dev)
    y = torch.empty((N, D), dtype=bf, device=dev)
    qkv = torch.empty((N, 3 * HD), dtype=bf, device=dev)
    att = torch.empty((N, HD), dtype=bf, device=dev)
    hid = torch.empty((N, DI), dtype=bf, device=dev)
    tok = torch.empty((N,), dtype=i32, device=dev)
    finished = torch.empty((N,), dtype=i32, device=dev)
    remaining = torch.empty((1,), dtype=i32, device=dev)
    probs = torch.empty((N, S, NC), dtype=f32, device=dev)
    steps_run = ctypes.c_int(0)
    lib = _lib.load()
    rc = lib.tpk_full_decode(
        out_enc.data_ptr(), src_mask.data_ptr(),
        *(w[k].data_ptr() for k in _WEIGHT_ORDER),
        enc_kv.data_ptr(), cache.data_ptr(), x32.data_ptr(), y.data_ptr(),
        qkv.data_ptr(), att.data_ptr(), hid.data_ptr(), tok.data_ptr(),
        finished.data_ptr(), remaining.data_ptr(), probs.data_ptr(),
        N, TE, D, H, DK, DI, L, S, NC, start_idx,
        -1 if end_idx is None else end_idx,
        ctypes.addressof(steps_run), _lib.stream_ptr(dev))
    _lib.check(rc, 'full_decode')
    full_decode.launches += 1
    full_decode.last_steps = steps_run.value
    return probs


full_decode.launches = 0
full_decode.last_steps = 0
