"""Transformer primitives (counterpart of
``tps_pp_tpu/models/transformer.py``).

Reference ``transformer_module.py`` / ``transformer_layers.py`` semantics:
separate q/k/v linears, scores scaled by ``1/sqrt(d_k)``, masked scores set
to -1e9 (mask == 0 is masked), softmax in float32, exact-erf GELU, pre-norm
layers with LayerNorm eps 1e-5. Tokens are (N, T, D). Module and parameter
names are the reference's, so ``state_dict`` keys match its checkpoints.
Inference only: dropout is not applied.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9


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
    """Adds the sinusoid table; ``position_table`` is a buffer, as in the
    reference."""

    def __init__(self, d_hid: int = 512, n_position: int = 200):
        super().__init__()
        self.register_buffer('position_table', torch.from_numpy(
            sinusoid_position_table(n_position, d_hid)))

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        pe = self.position_table[:, offset:offset + x.shape[1]]
        return x + pe.to(x.dtype)


def attend(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """q (N, H, Tq, dk); k/v (N, H, Tk, d); mask broadcastable to
    (N, H, Tq, Tk), 0 = masked. Scores and softmax in float32; the weights
    and the output are rounded to q's dtype. Returns (N, Tq, H*d)."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(mask == 0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.matmul(p.float(), v.float()).to(q.dtype)
    N, H, Tq, d = out.shape
    return out.transpose(1, 2).reshape(N, Tq, H * d)


class MultiHeadAttention(nn.Module):
    """NRTR's attention: q/k/v and output linears without bias."""

    def __init__(self, n_head: int = 8, d_model: int = 512, d_k: int = 64,
                 d_v: int = 64):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
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

    def attend_cached(self, q_in, k, v, mask=None):
        """Attention of ``q_in`` (N, Tq, D) over projected, split K/V."""
        q = self.split(self.linear_q(q_in), self.d_k)
        return self.fc(attend(q, k, v, mask, self.d_k ** -0.5))

    def forward(self, q, k, v, mask=None):
        return self.attend_cached(q, self.split(self.linear_k(k), self.d_k),
                                  self.split(self.linear_v(v), self.d_v),
                                  mask)


class PositionwiseFeedForward(nn.Module):
    """w_2(GELU(w_1(x))), exact erf GELU."""

    def __init__(self, d_in: int, d_hid: int):
        super().__init__()
        self.w_1 = nn.Linear(d_in, d_hid)
        self.w_2 = nn.Linear(d_hid, d_in)

    def forward(self, x):
        return self.w_2(F.gelu(self.w_1(x)))


class TFEncoderLayer(nn.Module):
    """Pre-norm self-attention + FFN (reference transformer_layers.py:9-73)."""

    def __init__(self, d_model=512, d_inner=256, n_head=8, d_k=64, d_v=64):
        super().__init__()
        self.attn = MultiHeadAttention(n_head, d_model, d_k, d_v)
        self.mlp = PositionwiseFeedForward(d_model, d_inner)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, mask=None):
        y = self.norm1(x)
        x = x + self.attn(y, y, y, mask)
        return x + self.mlp(self.norm2(x))


class TFDecoderLayer(nn.Module):
    """Pre-norm self-attention + cross-attention + FFN (reference
    transformer_layers.py:76-167)."""

    def __init__(self, d_model=512, d_inner=256, n_head=8, d_k=64, d_v=64):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = MultiHeadAttention(n_head, d_model, d_k, d_v)
        self.enc_attn = MultiHeadAttention(n_head, d_model, d_k, d_v)
        self.mlp = PositionwiseFeedForward(d_model, d_inner)
