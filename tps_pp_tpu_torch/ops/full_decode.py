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
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

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

# ---- the step products' schedule ------------------------------------------
# csrc/full_decode.cu's step_gemm_kernel: tiles of GEMM_BM rows and BN in
# GEMM_BN columns, K split into `splits` parts of a multiple of 16, at most
# MAX_SPLITS (the parts of a tile are one cluster of blocks; part z starts at
# z * K / splits); the grid is (N / BN, ceil(M / GEMM_BM), splits).
GEMM_BM = 64
GEMM_BN = (64, 32, 16)
MAX_SPLITS = 8           # the portable cluster size (kMaxSplits)
MIN_BLOCKS = 132         # the H100's SMs: every product gets at least these
_RESIDENT = 4            # blocks an SM holds (~39 KB of shared memory each)
_LATENCY_BYTES = 8192    # what a dependent round trip to memory costs, in
                         # bytes an SM would stream meanwhile (~1 us)


def step_products(d) -> Tuple[Tuple[str, int, int], ...]:
    """The step products of one layer, in order, as (name, N_out, K)."""
    D, HD, DI = d['D'], d['HD'], d['DI']
    return (('qkv', 3 * HD, D), ('fc1', D, HD), ('q2', HD, D),
            ('fc2', D, HD), ('w1', DI, D), ('w2', D, DI))


def gemm_plan(M: int, N: int, K: int) -> Tuple[int, int]:
    """(BN, splits) of the step GEMM for (M, K) @ (K, N): at least
    MIN_BLOCKS blocks where some choice gives them, then the least estimated
    time of the slowest SM, in bytes: each wave of blocks costs a round trip
    and its A and B loads, and a split tile's blocks then each read their
    share of every part's partial from the cluster; fewer splits, then wider
    tiles, on a tie. Splits are powers of two up to MAX_SPLITS with
    K % (16 * splits) == 0."""
    m_tiles = -(-M // GEMM_BM)
    rows = min(M, GEMM_BM)
    best = None
    for bn in GEMM_BN:
        if N % bn:
            continue
        tiles = m_tiles * (N // bn)
        splits = 1
        while splits <= MAX_SPLITS and K % (16 * splits) == 0:
            blocks, part = tiles * splits, K // splits
            waves = -(-blocks // (MIN_BLOCKS * _RESIDENT))
            cost = waves * (_LATENCY_BYTES + 2 * rows * part + 2 * part * bn)
            if splits > 1:
                cost += _LATENCY_BYTES + 4 * rows * bn
            key = (max(0, MIN_BLOCKS - blocks), cost, splits, -bn)
            if best is None or key < best[0]:
                best = (key, (bn, splits))
            splits *= 2
    if best is None:
        raise ValueError(f'gemm_plan: N={N} is not a multiple of 16 or K={K} '
                         f'of 16')
    return best[1]


# ---- the captured decode ----------------------------------------------------
# The captured decodes of each weight set, keyed on its QKV weight tensor so
# that they go with it: for each (device, rows, source tokens, int8 K/V,
# heads, start, end), one graph. A graph reads every weight through the
# pointer it was captured with, so an in-place update is served by the next
# replay, and a weight set with another tensor in its place is captured
# again.
_GRAPHS = WeakTensorKeyDictionary()


def _weight_ptrs(w: Dict[str, torch.Tensor]) -> tuple:
    return tuple((w[k].data_ptr(), w[k].shape) for k in _WEIGHT_ORDER)


class _DecodeGraph:
    """The whole decode of one shape, captured once: its static inputs,
    scratch, outputs and graph. ``run`` copies a call's inputs in, replays
    the graph and returns (probs, steps run). It holds the weights'
    pointers, never the tensors, so that the cache entry dies with them."""

    def __init__(self, w, d, N, TE, q8, start_idx, end_idx, dev):
        L, D, HD, H, DI, S, NC = (d[k] for k in ('L', 'D', 'HD', 'H', 'DI',
                                                 'S', 'NC'))
        prods = step_products(d)
        plan = [gemm_plan(N, n, k) for _, n, k in prods]
        self.ptrs, self.q8 = _weight_ptrs(w), q8
        bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
        with torch.inference_mode(False):
            def empty(shape, dtype):
                return torch.empty(shape, dtype=dtype, device=dev)
            # the classifier transposed in the graph: the head reads it a
            # class row at a time
            self.wcls_t = empty((NC, D), bf)
            # (the int8 branch starts from the projection in enc_kv)
            self.out_enc = None if q8 else empty((N, TE, D), bf)
            self.src_mask = empty((N, TE), f32)
            self.enc_kv = empty((N * TE, L * 2 * HD), bf)
            self.probs = empty((N, S, NC), f32)
            self.steps_run = empty((1,), i32)
            # cache, x32, y, qkv, att, hid, tok, finished, remaining
            self.scratch = [empty((L, N, S, 2 * HD), bf), empty((N, D), f32),
                            empty((N, D), bf), empty((N, 3 * HD), bf),
                            empty((N, HD), bf), empty((N, DI), bf),
                            empty((N,), i32), empty((N,), i32),
                            empty((1,), i32)]
            # int8 branch: quantized K/V, per-group absmax bits and scales,
            # f32 q2
            self.int8 = ([empty((N * TE, L * 2 * HD), torch.int8),
                          empty((L * 2 * H,), i32), empty((L * 2 * H,), f32),
                          empty((N, HD), f32)] if q8 else [])
            # the gate's flag
            self.go = empty((1,), i32)
        self.args = (N, TE, D, H, d['DK'], DI, L, S, NC, start_idx,
                     -1 if end_idx is None else end_idx)
        self.c_plan = (ctypes.c_int * 12)(*[v for p in plan for v in p])
        self.graph = None

    @property
    def nbytes(self) -> int:
        """The device memory that the bucket holds: its static inputs,
        scratch and outputs (the capture allocates nothing)."""
        return sum(t.numel() * t.element_size() for t in
                   [self.wcls_t, self.out_enc, self.src_mask, self.enc_kv,
                    self.probs, self.steps_run, self.go] + self.scratch +
                   self.int8 if t is not None)

    def _enqueue(self, w, dev):
        self.wcls_t.copy_(w['wcls'].t())
        int8 = [t.data_ptr() for t in self.int8] if self.q8 else [None] * 4
        rc = _lib.load().tpk_full_decode(
            None if self.q8 else self.out_enc.data_ptr(),
            self.src_mask.data_ptr(),
            *(self.wcls_t.data_ptr() if k == 'wcls' else w[k].data_ptr()
              for k in _WEIGHT_ORDER),
            self.enc_kv.data_ptr(), *(t.data_ptr() for t in self.scratch),
            self.probs.data_ptr(), *int8,
            self.go.data_ptr(), self.steps_run.data_ptr(),
            self.c_plan, *self.args, _lib.stream_ptr(dev))
        _lib.check(rc, 'full_decode')

    def _capture(self, w, dev):
        """A first run on a side stream (it loads the kernels), then the
        capture."""
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._enqueue(w, dev)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._enqueue(w, dev)
        self.graph = graph
        full_decode.captures += 1

    def run(self, out_enc, src_mask, w):
        if self.q8:
            # the projection that the JAX package computes outside its
            # kernel, by the plain version's own op: quantization turns a
            # one-ulp difference of a K/V value, or of a group's max, into a
            # whole quantization step, so both paths quantize the same values
            self.enc_kv.copy_(_project_enc_kv(out_enc, w['wkv_enc']))
        else:
            self.out_enc.copy_(out_enc)
        self.src_mask.copy_(src_mask)
        if self.graph is None:
            self._capture(w, out_enc.device)
        self.graph.replay()
        return self.probs.clone(), int(self.steps_run.item())


def graph_bytes(w: Dict[str, torch.Tensor]) -> Dict[tuple, int]:
    """The device memory that each captured decode of the weights ``w``
    holds, by its key (device, rows, source tokens, int8 K/V, heads, start,
    end)."""
    return {k: g.nbytes for k, g in _GRAPHS.get(w['wqkv'], {}).items()}


def full_decode(out_enc: torch.Tensor, src_mask: torch.Tensor,
                w: Dict[str, torch.Tensor], n_head: int, start_idx: int,
                end_idx: Optional[int] = None,
                enc_dtype: str = 'bfloat16') -> torch.Tensor:
    """The kernels on CUDA tensors (bf16 encoder output and weights), the
    plain version on CPU tensors. Same arguments as
    :func:`full_decode_plain`. The decode of a shape is captured as a CUDA
    graph at its first call for a weight set and replayed from then on
    (``_GRAPHS``).
    ``launches`` counts the bf16 branch's calls, ``launches_int8`` the int8
    branch's, ``captures`` the graphs captured; ``last_steps`` is the steps
    the last call ran."""
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
    if DK != 64 or D % 64 or DI % 64 or D > 1024 or S > 256 or TE > 256 \
            or N < 1 or TE < 1 or (D + NC) * 4 > 48 * 1024:
        raise ValueError(f'full_decode: needs d_k == 64, d_model and d_inner '
                         f'multiples of 64, d_model <= 1024, at most 256 '
                         f'steps and source tokens, at least one row and '
                         f'token; got d_k={DK}, D={D}, DI={DI}, S={S}, N={N}, '
                         f'TE={TE}')
    key = (dev, N, TE, q8, n_head, start_idx, end_idx)
    graphs = _GRAPHS.setdefault(w['wqkv'], {})
    g = graphs.get(key)
    if g is None or g.ptrs != _weight_ptrs(w):
        # another tensor in a weight's place: the old bucket goes before the
        # new one is allocated
        graphs.pop(key, None)
        g = None
        g = graphs[key] = _DecodeGraph(w, d, N, TE, q8, start_idx, end_idx,
                                       dev)
    probs, full_decode.last_steps = g.run(out_enc, src_mask, w)
    if q8:
        full_decode.launches_int8 += 1
    else:
        full_decode.launches += 1
    return probs


full_decode.launches = 0
full_decode.launches_int8 = 0
full_decode.captures = 0
full_decode.last_steps = 0
