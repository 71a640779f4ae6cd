"""Transformer primitives (counterpart of
``tps_pp_tpu/models/transformer.py``).

Reference ``transformer_module.py`` / ``transformer_layers.py`` semantics:
separate q/k/v linears, scores scaled by ``1/sqrt(d_k)``, masked scores set
to -1e9 (mask == 0 is masked), softmax in float32, exact-erf GELU, pre-norm
layers with LayerNorm eps 1e-5. Tokens are (N, T, D). Module and parameter
names are the reference's, so ``state_dict`` keys match its checkpoints.

Dropout sits where the JAX package has it: on the attention weights after
the softmax, on each attention's output projection and on the FFN output
(``tps_pp_tpu/models/transformer.py:103,121,182``). It applies in train
mode only, with masks drawn from the ``torch.Generator`` passed as ``rng``.
``attend`` keeps its scores, softmax and weighted sum out of autocast: the
JAX package takes them in float32 from the compute-dtype operands.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability 1 - rate and
    scale it by 1 / (1 - rate). The mask comes from ``rng`` (a generator on
    x's device; torch's default one when None). Identity at rate 0."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """(1, n_position, d_hid) float32 table, the reference's formula
    (transformer_module.py:142-154)."""
    denom = np.array([
        1.0 / np.power(10000, 2 * (j // 2) / d_hid) for j in range(d_hid)
    ], dtype=np.float64).reshape(1, -1)
    pos = np.arange(n_position, dtype=np.float64).reshape(-1, 1)
    table = pos * denom
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table[None].astype(np.float32)


class PositionalEncoding(nn.Module):
    """Adds the sinusoid table, then dropout at rate ``dropout`` in train
    mode (JAX ``transformer.py:43-57``); ``position_table`` is a buffer, as
    in the reference."""

    def __init__(self, d_hid: int = 512, n_position: int = 200,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.register_buffer('position_table', torch.from_numpy(
            sinusoid_position_table(n_position, d_hid)))

    def forward(self, x: torch.Tensor, offset: int = 0,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        pe = self.position_table[:, offset:offset + x.shape[1]]
        return dropout(x + pe.to(x.dtype),
                       self.dropout if self.training else 0.0, rng)


def attend(q, k, v, mask: Optional[torch.Tensor], scale: float,
           drop: float = 0.0, rng: Optional[torch.Generator] = None):
    """q (N, H, Tq, dk); k/v (N, H, Tk, d); mask broadcastable to
    (N, H, Tq, Tk), 0 = masked. Scores and softmax in float32; the weights
    (then dropout at rate ``drop``) and the output are rounded to q's
    dtype. Returns (N, Tq, H*d)."""
    with torch.autocast(q.device.type, enabled=False):
        s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(mask == 0, NEG_INF)
        p = dropout(torch.softmax(s, dim=-1).to(q.dtype), drop, rng)
        out = torch.matmul(p.float(), v.float()).to(q.dtype)
    N, H, Tq, d = out.shape
    return out.transpose(1, 2).reshape(N, Tq, H * d)


class MultiHeadAttention(nn.Module):
    """NRTR's attention: q/k/v and output linears without bias; dropout
    (train mode) on the attention weights and on the output."""

    def __init__(self, n_head: int = 8, d_model: int = 512, d_k: int = 64,
                 d_v: int = 64, dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.linear_q = nn.Linear(d_model, n_head * d_k, bias=False)
        self.linear_k = nn.Linear(d_model, n_head * d_k, bias=False)
        self.linear_v = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)

    def split(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """(N, T, H*d) -> (N, H, T, d)."""
        N, T, _ = x.shape
        return x.reshape(N, T, self.n_head, d).transpose(1, 2)

    def project_kv(self, kv: torch.Tensor):
        return (self.split(self.linear_k(kv), self.d_k),
                self.split(self.linear_v(kv), self.d_v))

    def attend_cached(self, q_in, k, v, mask=None, rng=None):
        """Attention of ``q_in`` (N, Tq, D) over projected, split K/V."""
        rate = self.dropout if self.training else 0.0
        q = self.split(self.linear_q(q_in), self.d_k)
        out = attend(q, k, v, mask, self.d_k ** -0.5, rate, rng)
        return dropout(self.fc(out), rate, rng)

    def forward(self, q, k, v, mask=None, rng=None):
        return self.attend_cached(q, self.split(self.linear_k(k), self.d_k),
                                  self.split(self.linear_v(v), self.d_v),
                                  mask, rng)


class PackedMultiheadAttention(nn.Module):
    """The JAX package's ``MultiHeadAttention(qkv_bias=True)`` with
    ``d_k = d_model / n_head`` (``tps_pp_tpu/models/transformer.py:60-121``)
    under torch ``nn.MultiheadAttention``'s parameter names: ``in_proj_weight``
    holds the q, k and v rows in that order, ``in_proj_bias`` their biases,
    ``out_proj`` the output linear, so that the reference's checkpoints of
    mmcv's attention load. The rest is ``attend``; dropout (train mode, masks
    from ``rng``) on the weights and on the output."""

    def __init__(self, d_model: int = 512, n_head: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.d_model, self.n_head = d_model, n_head
        self.d_k = d_model // n_head
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, D) -> (N, H, T, d_k)."""
        N, T, _ = x.shape
        return x.reshape(N, T, self.n_head, self.d_k).transpose(1, 2)

    def forward(self, q, kv=None, mask=None, rng=None):
        """Attention of q (N, Tq, D) over kv (N, Tk, D), itself when None;
        ``mask`` broadcastable to (N, H, Tq, Tk), 0 = masked."""
        D, w, b = self.d_model, self.in_proj_weight, self.in_proj_bias
        if kv is None:
            q, k, v = F.linear(q, w, b).split(D, dim=-1)
        else:
            q = F.linear(q, w[:D], b[:D])
            k, v = F.linear(kv, w[D:], b[D:]).split(D, dim=-1)
        rate = self.dropout if self.training else 0.0
        out = attend(self.split(q), self.split(k), self.split(v), mask,
                     self.d_k ** -0.5, rate, rng)
        return dropout(self.out_proj(out), rate, rng)


class PositionwiseFeedForward(nn.Module):
    """w_2(GELU(w_1(x))), exact erf GELU, then dropout (train mode)."""

    def __init__(self, d_in: int, d_hid: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = nn.Linear(d_in, d_hid)
        self.w_2 = nn.Linear(d_hid, d_in)
        self.dropout = dropout

    def forward(self, x, rng=None):
        return dropout(self.w_2(F.gelu(self.w_1(x))),
                       self.dropout if self.training else 0.0, rng)


class TFEncoderLayer(nn.Module):
    """Pre-norm self-attention + FFN (reference transformer_layers.py:9-73)."""

    def __init__(self, d_model=512, d_inner=256, n_head=8, d_k=64, d_v=64,
                 dropout=0.1):
        super().__init__()
        self.attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.mlp = PositionwiseFeedForward(d_model, d_inner, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, mask=None, rng=None):
        y = self.norm1(x)
        x = x + self.attn(y, y, y, mask, rng)
        return x + self.mlp(self.norm2(x), rng)


class TFDecoderLayer(nn.Module):
    """Pre-norm self-attention + cross-attention + FFN (reference
    transformer_layers.py:76-167)."""

    def __init__(self, d_model=512, d_inner=256, n_head=8, d_k=64, d_v=64,
                 dropout=0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                            dropout)
        self.enc_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.mlp = PositionwiseFeedForward(d_model, d_inner, dropout)

    def forward(self, x, enc, self_mask=None, enc_mask=None, rng=None):
        """The teacher-forced pass: x (N, T, D) over enc (N, TE, D)."""
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y, self_mask, rng)
        x = x + self.enc_attn(self.norm2(x), enc, enc, enc_mask, rng)
        return x + self.mlp(self.norm3(x), rng)
