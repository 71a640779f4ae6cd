"""Whole NRTR encoder: all layers + the final LayerNorm.

Counterpart of ``tps_pp_tpu/ops/pallas_encoder.py``
(``fused_encoder_forward``): ``encoder_forward`` launches the CUDA kernels of
``csrc/encoder.cu`` (its products on the GEMM of ``csrc/gemm.cu``) on CUDA
tensors; ``encoder_forward_plain`` is the same function in plain PyTorch,
used for CPU tensors and as the kernel's reference. ``encoder_forward``
and ``encoder_attention`` are the operators
``torch.ops.tps_pp.encoder_forward`` and ``encoder_attention``
(``_lib.define_op``). Both take the weights as
folded by :func:`fold_encoder_weights` once, when the weights are loaded:
each LayerNorm affine goes into the matmul that consumes it (``y@W`` for
``y = norm*s + b`` equals ``norm@(s*W) + b@W``), and 1/sqrt(d_k) into the q
columns. ``encoder_attention`` is the encoder's attention kernel alone, for
the tests.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import _lib

NEG_INF = -1e9
# kernel 3's shape limits: the constants of csrc/encoder.cu (kMaxT, kDk)
# and csrc/gemm.cuh (kGemmLnWidth) that tpk_encoder_forward checks
KERNEL_MAX_TOKENS, KERNEL_DK, KERNEL_D = 512, 64, 512


def encoder_kernel_accepts(T: Optional[int], D: int, n_head: int, DK: int,
                           DI: int) -> bool:
    """Whether kernel 3 takes an encoder of these shapes: T tokens an image
    (None: not asked), d_model D, n_head heads of DK, FFN width DI. The
    check of ``csrc/encoder.cu`` ``tpk_encoder_forward``, which
    :func:`encoder_forward` makes before it launches."""
    HD = n_head * DK
    return ((T is None or 1 <= T <= KERNEL_MAX_TOKENS) and DK == KERNEL_DK
            and D == KERNEL_D and n_head >= 1 and (3 * HD) % 256 == 0
            and DI >= 256 and DI % 256 == 0)


def ln_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without affine, in float32."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 product of (possibly bf16-rounded) operands: the plain
    counterpart of a bf16 tensor-core product with f32 accumulation."""
    return a.float() @ b.float()


def fold_encoder_weights(raw: Dict[str, torch.Tensor], n_head: int,
                         compute_dtype: torch.dtype
                         ) -> Dict[str, torch.Tensor]:
    """raw: stacked per-layer weights in (in, out) layout, the JAX kernel's
    dict: ln1_s/ln1_b/ln2_s/ln2_b (L, D), wqkv (L, D, 3HD) (q|k|v), wfc
    (L, HD, D), w1 (L, D, DI), b1 (L, DI), w2 (L, DI, D), b2 (L, D),
    lnf_s/lnf_b (D). Returns matmul weights in ``compute_dtype`` and biases
    and the final LN in float32, all contiguous."""
    r = {k: v.detach().float() for k, v in raw.items()}
    HD = r['wfc'].shape[1]
    dk = HD // n_head
    colscale = torch.cat([torch.full((HD,), 1.0 / dk ** 0.5),
                          torch.ones(2 * HD)]).to(r['wqkv'].device)
    wqkv = r['wqkv'] * r['ln1_s'][:, :, None] * colscale
    bqkv = torch.einsum('ld,lde->le', r['ln1_b'], r['wqkv']) * colscale
    w1 = r['w1'] * r['ln2_s'][:, :, None]
    b1 = torch.einsum('ld,lde->le', r['ln2_b'], r['w1']) + r['b1']
    cdt = compute_dtype
    out = dict(wqkv=wqkv.to(cdt), bqkv=bqkv, wfc=r['wfc'].to(cdt),
               w1=w1.to(cdt), b1=b1, w2=r['w2'].to(cdt), b2=r['b2'],
               lnf_s=r['lnf_s'], lnf_b=r['lnf_b'])
    return {k: v.contiguous() for k, v in out.items()}


def encoder_attention_plain(qkv: torch.Tensor, mask: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """qkv (N*T, 3HD), the q|k|v column blocks (q already scaled by
    1/sqrt(d_k)), in the compute dtype; mask (N, T), key valid iff > 0. Per
    (image, head): scores in float32, masked ones -1e9, softmax in float32
    rounded to qkv's dtype, then the weighted sum of v in float32. Returns
    (N*T, HD) in qkv's dtype. An image with every key masked gets uniform
    weights over its own keys."""
    N, T = mask.shape
    HD = qkv.shape[1] // 3
    keep = (mask > 0)[:, None, None, :]

    def heads(a):                      # (N*T, HD) -> (N, H, T, DK)
        return a.reshape(N, T, n_head, HD // n_head).transpose(1, 2).float()

    q, k, v = (heads(a) for a in qkv.split(HD, dim=1))
    s = (q @ k.transpose(-1, -2)).masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return (p.float() @ v).to(qkv.dtype).transpose(1, 2).reshape(N * T, HD)


def _attention_cuda(qkv: torch.Tensor, mask: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    dev = qkv.device
    N, T = mask.shape
    HD = qkv.shape[1] // 3
    _lib.check_args('encoder_attention', dev, {
        'qkv': (qkv, (N * T, 3 * HD), torch.bfloat16),
        'mask': (mask, (N, T), torch.float32)})
    out = torch.empty((N * T, HD), dtype=torch.bfloat16, device=dev)
    rc = _lib.load().tpk_encoder_attention(
        qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), N, T, n_head,
        HD // n_head, _lib.stream_ptr(dev))
    _lib.check(rc, 'encoder_attention')
    _lib.count_launch(encoder_attention)
    return out


_attention_op = _lib.define_op(
    'encoder_attention', '(Tensor qkv, Tensor mask, int n_head) -> Tensor',
    _attention_cuda, lambda *a: encoder_attention_plain(*a),
    lambda qkv, mask, n_head: qkv.new_empty((qkv.shape[0],
                                             qkv.shape[1] // 3)))


def encoder_attention(qkv: torch.Tensor, mask: torch.Tensor,
                      n_head: int) -> torch.Tensor:
    """The encoder's attention kernel on CUDA tensors (bf16 qkv, f32 mask;
    1-512 tokens an image, d_k 64), the plain version on CPU tensors,
    through ``torch.ops.tps_pp.encoder_attention``. Same arguments as
    :func:`encoder_attention_plain`."""
    _lib.require_kernel_device(qkv.device, 'encoder_attention')
    return _attention_op(qkv, mask, n_head)


encoder_attention.launches = 0


def encoder_forward_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                          w: Dict[str, torch.Tensor],
                          n_head: int) -> torch.Tensor:
    """x (N, T, D) tokens; mask (N, T), key valid iff > 0 (None = all
    valid); w from :func:`fold_encoder_weights`. Products take operands in
    the weights' dtype and accumulate in float32; LayerNorm and softmax run
    in float32; the residual stream stays float32. Returns (N, T, D) in
    x's dtype."""
    cdt = w['wqkv'].dtype
    N, T, D = x.shape
    L = w['wqkv'].shape[0]
    x32 = x.reshape(N * T, D).float()
    if mask is None:
        mask = torch.ones((N, T), device=x.device)
    for l in range(L):
        qkv = (mm(ln_norm(x32).to(cdt), w['wqkv'][l]) + w['bqkv'][l]).to(cdt)
        att = encoder_attention_plain(qkv, mask, n_head)
        x32 = x32 + mm(att, w['wfc'][l])
        h = F.gelu(mm(ln_norm(x32).to(cdt), w['w1'][l]) + w['b1'][l]).to(cdt)
        x32 = x32 + (mm(h, w['w2'][l]) + w['b2'][l])
    out = ln_norm(x32) * w['lnf_s'] + w['lnf_b']
    return out.to(x.dtype).reshape(N, T, D)


# the order of the folded weights in the operator's Tensor[] argument
WEIGHT_ORDER = ('wqkv', 'bqkv', 'wfc', 'w1', 'b1', 'w2', 'b2', 'lnf_s',
                'lnf_b')


def _forward_cuda(x, mask, ws, n_head):
    w = dict(zip(WEIGHT_ORDER, ws))
    dev = x.device
    N, T, D = x.shape
    L, HD, DI = w['wqkv'].shape[0], w['wfc'].shape[1], w['w1'].shape[2]
    DK = HD // n_head
    bf, f32 = torch.bfloat16, torch.float32
    if mask is None:
        mask = torch.ones((N, T), dtype=f32, device=dev)
    _lib.check_args('encoder_forward', dev, {
        'x': (x, (N, T, D), bf), 'mask': (mask, (N, T), f32),
        'wqkv': (w['wqkv'], (L, D, 3 * HD), bf),
        'bqkv': (w['bqkv'], (L, 3 * HD), f32),
        'wfc': (w['wfc'], (L, HD, D), bf), 'w1': (w['w1'], (L, D, DI), bf),
        'b1': (w['b1'], (L, DI), f32), 'w2': (w['w2'], (L, DI, D), bf),
        'b2': (w['b2'], (L, D), f32), 'lnf_s': (w['lnf_s'], (D,), f32),
        'lnf_b': (w['lnf_b'], (D,), f32)})
    if HD != n_head * DK:
        raise ValueError(f'encoder_forward: n_head {n_head} does not divide '
                         f'the attention width {HD}')
    if not encoder_kernel_accepts(T, D, n_head, DK, DI):
        raise ValueError(f'encoder_forward: needs 1-{KERNEL_MAX_TOKENS} '
                         f'tokens an image, d_k {KERNEL_DK}, d_model '
                         f'{KERNEL_D}, 3 x '
                         f'the attention width and d_inner multiples of 256; '
                         f'got T={T}, d_k={DK}, D={D}, H={n_head}, DI={DI}')
    M = N * T
    x32 = torch.empty((M, D), dtype=f32, device=dev)
    y = torch.empty((M, D), dtype=bf, device=dev)
    qkv = torch.empty((M, 3 * HD), dtype=bf, device=dev)
    att = torch.empty((M, HD), dtype=bf, device=dev)
    hid = torch.empty((M, DI), dtype=bf, device=dev)
    out = torch.empty((N, T, D), dtype=bf, device=dev)
    lib = _lib.load()
    rc = lib.tpk_encoder_forward(
        x.data_ptr(), mask.data_ptr(), w['wqkv'].data_ptr(),
        w['bqkv'].data_ptr(), w['wfc'].data_ptr(), w['w1'].data_ptr(),
        w['b1'].data_ptr(), w['w2'].data_ptr(), w['b2'].data_ptr(),
        w['lnf_s'].data_ptr(), w['lnf_b'].data_ptr(), x32.data_ptr(),
        y.data_ptr(), qkv.data_ptr(), att.data_ptr(), hid.data_ptr(),
        out.data_ptr(), N, T, D, n_head, DK, DI, L, _lib.stream_ptr(dev))
    _lib.check(rc, 'encoder_forward')
    _lib.count_launch(encoder_forward)
    return out


_forward_op = _lib.define_op(
    'encoder_forward', '(Tensor x, Tensor? mask, Tensor[] w, int n_head) '
    '-> Tensor', _forward_cuda,
    lambda x, mask, ws, n_head: encoder_forward_plain(
        x, mask, dict(zip(WEIGHT_ORDER, ws)), n_head),
    lambda x, mask, ws, n_head: torch.empty_like(x))


def encoder_forward(x: torch.Tensor, mask: Optional[torch.Tensor],
                    w: Dict[str, torch.Tensor], n_head: int) -> torch.Tensor:
    """The kernels on CUDA tensors (bf16 tokens and weights), the plain
    version on CPU tensors, through ``torch.ops.tps_pp.encoder_forward``
    (the weights as a list in ``WEIGHT_ORDER``). Same arguments as
    :func:`encoder_forward_plain`. The kernels' limits (1-512 tokens an
    image, d_k 64, d_model 512, ...; :func:`encoder_kernel_accepts`) raise a
    ``ValueError`` here, and are checked again at their entry point,
    ``csrc/encoder.cu`` ``tpk_encoder_forward``."""
    _lib.require_kernel_device(x.device, 'encoder_forward')
    return _forward_op(x, mask, [w[k] for k in WEIGHT_ORDER], n_head)


encoder_forward.launches = 0
