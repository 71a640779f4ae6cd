"""TFCommonDecoder, the fork's generic positional-query transformer decoder
(counterpart of ``tps_pp_tpu/models/decoders/tf_common.py``; reference
``decoders/transformer_frame.py:194-289``).

Non-autoregressive: ``max_seq_len`` queries, the sinusoid table alone,
cross-attend to the flattened encoder memory through ``n_layers`` post-norm
blocks (x = LN(q + attn(q, mem, mem)); LN(x + FFN(x))) and a linear
classifier: one pass for training and test. The reference's
``ifmask=True`` branch needs modules deleted upstream and is not carried,
as in JAX. Parameter names mirror the flax modules (``layer_stack.{i}``
for flax's ``layer{i}``; ``utils.convert.tf_common_rules``): the
reference's own could not be checked.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...registry import DECODERS
from ..transformer import (MultiHeadAttention, PositionalEncoding,
                           PositionwiseFeedForward)


class TFCommonDecoderLayer(nn.Module):
    """Post-norm cross-attention block (transformer_frame.py:158-191)."""

    def __init__(self, d_model=512, d_inner=1024, n_head=8, d_k=64, d_v=64,
                 dropout=0.1):
        super().__init__()
        self.attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = PositionwiseFeedForward(d_model, d_inner, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, q, k, v, rng: Optional[torch.Generator] = None):
        x = self.norm1(q + self.attn(q, k, v, None, rng))
        return self.norm2(x + self.mlp(x, rng))


@DECODERS.register_module()
class TFCommonDecoder(nn.Module):
    IS_AUTOREGRESSIVE = False
    READS_FEAT = True

    def __init__(self, max_seq_len=64, n_layers=3, n_head=8, d_k=64, d_v=64,
                 d_model=512, d_inner=1024, dropout=0.1, num_classes=37,
                 **kwargs):
        super().__init__()
        self.max_seq_len, self.d_model = max_seq_len, d_model
        self.pos_encoder = PositionalEncoding(d_model, max_seq_len)
        self.layer_stack = nn.ModuleList([
            TFCommonDecoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout)
            for _ in range(n_layers)])
        self.cls = nn.Linear(d_model, num_classes)

    def forward(self, feat, out_enc=None, targets=None, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, max_seq_len, num_classes) logits over ``out_enc`` (N, T, E),
        or over ``feat`` (N, H, W, C) flattened row-major where there is no
        encoder output. ``targets`` and ``valid_ratio`` are not read."""
        mem = feat if out_enc is None else out_enc
        if mem.dim() == 4:
            n, h, w, c = mem.shape
            mem = mem.reshape(n, h * w, c)
        zeros = mem.new_zeros((mem.shape[0], self.max_seq_len, self.d_model))
        q = self.pos_encoder(zeros, rng=rng)
        for layer in self.layer_stack:
            q = layer(q, mem, mem, rng)
        return self.cls(q)

    def forward_test_nar(self, feat, out_enc=None, valid_ratio=None):
        return self(feat, out_enc, valid_ratio=valid_ratio)
