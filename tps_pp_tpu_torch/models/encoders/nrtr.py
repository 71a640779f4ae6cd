"""NRTR transformer encoder (counterpart of
``tps_pp_tpu/models/encoders/nrtr.py``).

Self-attention over the flattened (N, H*W, C) feature with a valid_ratio
mask. The reference's quirk is kept: the mask is built over the *flattened
token index* (``valid = ceil(H*W * valid_ratio)``), not over the width axis.

``forward(..., fused=True)`` runs the whole encoder through
``ops.encoder`` in eval mode (``SUPPORTS_FUSED_FORWARD``, which the
recognizer's fused path routes by, as JAX's does): the CUDA kernels on
CUDA tensors, their plain version on CPU tensors (or everywhere with
``plain=True``). Its weights are
stacked and folded once per (device, dtype) and cached until a weight
changes (``layers.weights_stamp``). Train mode takes the module path, with
dropout, as the JAX package does (``encoders/nrtr.py:59-62``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops.encoder import (encoder_forward, encoder_forward_plain,
                            encoder_kernel_accepts, fold_encoder_weights)
from ...registry import ENCODERS
from ..layers import cached_per_weights
from ..transformer import TFEncoderLayer


def valid_steps(valid_ratio: torch.Tensor, T: int) -> torch.Tensor:
    """(N,) ratios -> (N,) long ``min(T, ceil(T * ratio))``, the valid
    length of each row on an axis of T (a float32 product, as JAX)."""
    return torch.clamp(torch.ceil(T * valid_ratio.float()), max=T).long()


def sequence_mask(valid_ratio: Optional[torch.Tensor], T: int):
    """(N,) ratios -> (N, T) float 0/1 mask, ``idx < min(T, ceil(T*r))``;
    None passes through."""
    if valid_ratio is None:
        return None
    idx = torch.arange(T, device=valid_ratio.device)[None, :]
    return (idx < valid_steps(valid_ratio, T)[:, None]).float()


@ENCODERS.register_module()
class NRTREncoder(nn.Module):
    SUPPORTS_FUSED_FORWARD = True

    def __init__(self, n_layers=6, n_head=8, d_k=64, d_v=64, d_model=512,
                 d_inner=256, dropout=0.1):
        super().__init__()
        self.n_head = n_head
        self.layer_stack = nn.ModuleList([
            TFEncoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout)
            for _ in range(n_layers)])
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self._folded: Dict = {}

    def kernel_accepts(self, tokens: Optional[int] = None) -> bool:
        """Whether kernel 3 takes this encoder over ``tokens`` tokens an
        image (None: not asked) (``ops.encoder.encoder_kernel_accepts``)."""
        first = self.layer_stack[0]
        D = first.norm1.normalized_shape[0]
        HD = first.attn.linear_q.out_features
        return encoder_kernel_accepts(tokens, D, self.n_head,
                                      HD // self.n_head,
                                      first.mlp.w_1.out_features)

    def folded_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """All layers' weights stacked in (in, out) layout with the
        LayerNorm affines and 1/sqrt(d_k) folded in, matmul weights in
        ``dtype``; computed once per (device, dtype) and weights stamp."""
        def make():
            def lin(m):
                return m.weight.t()
            raw = {k: [] for k in ('ln1_s', 'ln1_b', 'ln2_s', 'ln2_b',
                                   'wqkv', 'wfc', 'w1', 'b1', 'w2', 'b2')}
            for layer in self.layer_stack:
                a = layer.attn
                for k, v in (('ln1_s', layer.norm1.weight),
                             ('ln1_b', layer.norm1.bias),
                             ('ln2_s', layer.norm2.weight),
                             ('ln2_b', layer.norm2.bias),
                             ('wqkv', torch.cat([lin(a.linear_q),
                                                 lin(a.linear_k),
                                                 lin(a.linear_v)], dim=1)),
                             ('wfc', lin(a.fc)),
                             ('w1', lin(layer.mlp.w_1)),
                             ('b1', layer.mlp.w_1.bias),
                             ('w2', lin(layer.mlp.w_2)),
                             ('b2', layer.mlp.w_2.bias)):
                    raw[k].append(v)
            raw = {k: torch.stack(v) for k, v in raw.items()}
            raw['lnf_s'] = self.layer_norm.weight
            raw['lnf_b'] = self.layer_norm.bias
            return fold_encoder_weights(raw, self.n_head, dtype)
        return cached_per_weights(
            self._folded, (self.layer_norm.weight.device, dtype), self, make)

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                fused: bool = False, plain: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat (N, H, W, C) NHWC -> (N, H*W, C) tokens, row-major like the
        reference's ``view(n, c, h*w).permute``. ``fused`` applies in eval
        mode only; ``rng`` draws the dropout masks in train mode."""
        n, h, w, c = feat.shape
        x = feat.reshape(n, h * w, c)
        mask = sequence_mask(valid_ratio, h * w)
        if fused and not self.training:
            fn = encoder_forward_plain if plain else encoder_forward
            return fn(x, mask, self.folded_weights(x.dtype), self.n_head)
        attn_mask = None if mask is None else mask[:, None, None, :]
        for layer in self.layer_stack:
            x = layer(x, attn_mask, rng)
        return self.layer_norm(x)
