"""NRTR transformer encoder (counterpart of
``tps_pp_tpu/models/encoders/nrtr.py``).

Self-attention over the flattened (N, H*W, C) feature with a valid_ratio
mask. The reference's quirk is kept: the mask is built over the *flattened
token index* (``valid = ceil(H*W * valid_ratio)``), not over the width axis.

``forward(..., fused=True)`` runs the whole encoder through
``ops.encoder``: the CUDA kernels on CUDA tensors, their plain version on
CPU tensors (or everywhere with ``plain=True``). Its weights are stacked and
folded once and cached per (device, dtype); loading a state dict drops the
cache.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops.encoder import (encoder_forward, encoder_forward_plain,
                            fold_encoder_weights)
from ...registry import ENCODERS
from ..transformer import TFEncoderLayer


def sequence_mask(valid_ratio: Optional[torch.Tensor], T: int):
    """(N,) ratios -> (N, T) float 0/1 mask, ``idx < min(T, ceil(T*r))``;
    None passes through."""
    if valid_ratio is None:
        return None
    vr = valid_ratio.float()
    valid = torch.clamp(torch.ceil(T * vr), max=T)
    idx = torch.arange(T, device=vr.device)[None, :]
    return (idx < valid[:, None]).float()


@ENCODERS.register_module()
class NRTREncoder(nn.Module):

    def __init__(self, n_layers=6, n_head=8, d_k=64, d_v=64, d_model=512,
                 d_inner=256, dropout=0.1):
        # dropout: a training setting of the config; inference applies none
        super().__init__()
        self.n_head = n_head
        self.layer_stack = nn.ModuleList([
            TFEncoderLayer(d_model, d_inner, n_head, d_k, d_v)
            for _ in range(n_layers)])
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self._folded: Dict = {}
        self.register_load_state_dict_post_hook(
            lambda module, _: module._folded.clear())

    def folded_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """All layers' weights stacked in (in, out) layout with the
        LayerNorm affines and 1/sqrt(d_k) folded in, matmul weights in
        ``dtype``; computed once per (device, dtype)."""
        key = (self.layer_norm.weight.device, dtype)
        if key not in self._folded:
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
            self._folded[key] = fold_encoder_weights(raw, self.n_head, dtype)
        return self._folded[key]

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                fused: bool = False, plain: bool = False) -> torch.Tensor:
        """feat (N, H, W, C) NHWC -> (N, H*W, C) tokens, row-major like the
        reference's ``view(n, c, h*w).permute``."""
        n, h, w, c = feat.shape
        x = feat.reshape(n, h * w, c)
        mask = sequence_mask(valid_ratio, h * w)
        if fused:
            fn = encoder_forward_plain if plain else encoder_forward
            return fn(x, mask, self.folded_weights(x.dtype), self.n_head)
        attn_mask = None if mask is None else mask[:, None, None, :]
        for layer in self.layer_stack:
            x = layer(x, attn_mask)
        return self.layer_norm(x)
