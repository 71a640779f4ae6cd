"""ABINet's vision side (counterpart of
``tps_pp_tpu/models/encoders/abi.py``).

* ``PostNormTransformerLayer``: mmcv's BaseTransformerLayer with operation
  order ('self_attn', 'norm', 'ffn', 'norm') or, given ``kv``, cross
  attention in its place (the language decoder's): post-norm, attention
  with q/k/v and output biases, a ReLU FFN, dropout (train mode) after the
  ReLU and after the FFN's second linear. Module names are mmcv's
  (``attentions.0.attn``, ``norms.0/1``, ``ffns.0.layers.0.0``,
  ``ffns.0.layers.1``), so the reference's checkpoints load.
* ``TransformerEncoder`` (reference encoders/transformer.py:12-82): the
  feature's H*W tokens, row-major, plus the sinusoid table, through
  ``n_layers`` such layers; back to (N, H, W, C).
* ``ABIVisionModel`` (reference encoders/abinet_vision_model.py:7-45): the
  encoder, then ``ABIVisionDecoder`` on its output; returns the decoder's
  ``{'feature', 'logits', 'attn_scores'}``.

Tokens and features are NHWC at these boundaries; the dropout masks come
from the ``torch.Generator`` passed as ``rng``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import DECODERS, ENCODERS
from ..transformer import (PackedMultiheadAttention, PositionalEncoding,
                           dropout)


class _Attention(nn.Module):
    """mmcv's attention wrapper: the attention itself is ``attn``."""

    def __init__(self, d_model: int, n_head: int, dropout: float):
        super().__init__()
        self.attn = PackedMultiheadAttention(d_model, n_head, dropout)


class _FFN(nn.Module):
    """mmcv's FFN: ``layers`` = ((Linear, ReLU), Linear)."""

    def __init__(self, d_model: int, d_inner: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(d_model, d_inner), nn.ReLU()),
            nn.Linear(d_inner, d_model))


class PostNormTransformerLayer(nn.Module):

    def __init__(self, d_model: int = 512, d_inner: int = 2048,
                 n_head: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attentions = nn.ModuleList([_Attention(d_model, n_head,
                                                    dropout)])
        self.norms = nn.ModuleList([nn.LayerNorm(d_model, eps=1e-5)
                                    for _ in range(2)])
        self.ffns = nn.ModuleList([_FFN(d_model, d_inner)])

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, T, D); attention over ``kv`` (N, Tk, D), x itself when
        None; ``mask`` broadcastable to (N, H, T, Tk), 0 = masked."""
        rate = self.dropout if self.training else 0.0
        x = self.norms[0](x + self.attentions[0].attn(x, kv, mask, rng))
        (fc1, _), fc2 = self.ffns[0].layers
        y = dropout(F.relu(fc1(x)), rate, rng)
        y = dropout(fc2(y), rate, rng)
        return self.norms[1](x + y)


@ENCODERS.register_module()
class TransformerEncoder(nn.Module):

    def __init__(self, n_layers: int = 2, n_head: int = 8,
                 d_model: int = 512, d_inner: int = 2048,
                 dropout: float = 0.1, max_len: int = 8 * 32):
        super().__init__()
        self.pos_encoder = PositionalEncoding(d_model, max_len)
        self.transformer = nn.ModuleList([
            PostNormTransformerLayer(d_model, d_inner, n_head, dropout)
            for _ in range(n_layers)])

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat (N, H, W, C) -> (N, H, W, C); ``valid_ratio`` is unused, as
        in the reference."""
        n, h, w, c = feat.shape
        x = self.pos_encoder(feat.reshape(n, h * w, c))
        for layer in self.transformer:
            x = layer(x, rng=rng)
        return x.reshape(n, h, w, c)


@ENCODERS.register_module()
class ABIVisionModel(nn.Module):

    def __init__(self, encoder: Optional[Dict] = None,
                 decoder: Optional[Dict] = None):
        super().__init__()
        # registers ABIVisionDecoder (a module-level import would cycle:
        # the decoders import this module's layer)
        from ..decoders import abi  # noqa: F401
        self.encoder = ENCODERS.build(encoder or
                                      dict(type='TransformerEncoder'))
        self.decoder = DECODERS.build(decoder or
                                      dict(type='ABIVisionDecoder'))

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> Dict:
        return self.decoder(self.encoder(feat, valid_ratio, rng=rng))
