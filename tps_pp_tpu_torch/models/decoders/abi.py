"""ABINet's decoders (counterpart of ``tps_pp_tpu/models/decoders/abi.py``).

* ``ABIVisionDecoder`` (reference decoders/abinet_vision_decoder.py:12-170):
  a mini U-Net over the feature (four stride-(1,2)/(2,2)/(2,2)/(2,2)
  ConvModules down, three nearest x2 upsamples with ConvModules and skips
  up, then a nearest resize to the feature's (H, W) and a ConvModule to
  its width) makes the attention keys; the queries are the projected
  sinusoid table of ``max_seq_len`` positions. q.k and the weighted sum of
  the feature accumulate in float32, the softmax runs in float32, and the
  weights are rounded to the compute dtype before the product (JAX
  ``abi.py:66-75``).
* ``ABILanguageDecoder`` (reference decoders/abinet_language_decoder.py:
  15-181), the BCN: the softmax of the logits (float32, detached with
  ``detach_tokens``) projected, plus the sinusoid table and dropout 0.1
  (``token_encoder``), are the keys and values of ``n_layers`` post-norm
  cross-attention layers whose queries start as the sinusoid table. The
  mask hides each position from itself and the keys at or past the
  length: the first EOS (``pad_idx``) + 1, the full length without one,
  clamped to [2, T].

Module names are the reference's (``k_encoder.{i}``, ``k_decoder.{i}.1``,
``project``, ``cls``; ``proj``, ``token_encoder``, ``pos_encoder``,
``decoder_layers.{i}``). The BatchNorms are ``layers.BatchNorm2d``. Dropout
(train mode) draws from the ``torch.Generator`` passed as ``rng``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...registry import DECODERS
from ..encoders.abi import PostNormTransformerLayer
from ..layers import ConvModule, nhwc_to_nchw, resize_nearest
from ..transformer import PositionalEncoding


class _UpConv(nn.Sequential):
    """The reference's decoder_layer, Sequential(nn.Upsample, ConvModule).
    The upsample holds no weights; index 0 only keeps the ConvModule at
    index 1 for the checkpoints, and ``forward`` resizes to ``size`` with
    JAX's nearest rule (``layers.resize_nearest``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Identity(), ConvModule(
            in_channels, out_channels, 3, stride=1, padding=1,
            use_norm=True))

    def forward(self, x: torch.Tensor, size: Tuple[int, int]):
        return self[1](resize_nearest(x, size))


@DECODERS.register_module()
class ABIVisionDecoder(nn.Module):

    def __init__(self, in_channels: int = 512, num_channels: int = 64,
                 attn_height: int = 8, attn_width: int = 32,
                 max_seq_len: int = 40, num_chars: int = 90):
        """``attn_height`` / ``attn_width`` are taken and unused: the keys
        are resized to the feature's own (H, W), as in JAX."""
        super().__init__()
        self.max_seq_len = max_seq_len
        self.k_encoder = nn.ModuleList([
            ConvModule(in_channels if i == 0 else num_channels,
                       num_channels, 3, stride=s, padding=1, use_norm=True)
            for i, s in enumerate([(1, 2), (2, 2), (2, 2), (2, 2)])])
        self.k_decoder = nn.ModuleList(
            [_UpConv(num_channels, num_channels) for _ in range(3)]
            + [_UpConv(num_channels, in_channels)])
        self.pos_encoder = PositionalEncoding(in_channels, max_seq_len)
        self.project = nn.Linear(in_channels, in_channels)
        self.cls = nn.Linear(in_channels, num_chars)

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """feat (N, H, W, E) -> ``feature`` (N, T, E), ``logits`` (N, T,
        num_chars) and ``attn_scores`` (N, T, H, W), float32."""
        N, H, W, E = feat.shape
        k = nhwc_to_nchw(feat)
        feats = []
        for layer in self.k_encoder:
            k = layer(k)
            feats.append(k)
        for i in range(3):
            k = self.k_decoder[i](k, (2 * k.shape[2], 2 * k.shape[3]))
            k = k + feats[2 - i]
        k = self.k_decoder[3](k, (H, W))

        q = self.project(self.pos_encoder(
            feat.new_zeros((N, self.max_seq_len, E))))
        with torch.autocast(feat.device.type, enabled=False):
            attn = torch.matmul(q.float(), k.float().reshape(N, E, H * W))
            attn = torch.softmax(attn / (E ** 0.5), dim=-1)
            vecs = torch.matmul(attn.to(q.dtype).float(),
                                feat.float().reshape(N, H * W, E))
        vecs = vecs.to(q.dtype)
        return {'feature': vecs, 'logits': self.cls(vecs),
                'attn_scores': attn.reshape(N, -1, H, W)}


@DECODERS.register_module()
class ABILanguageDecoder(nn.Module):

    def __init__(self, d_model: int = 512, n_head: int = 8,
                 d_inner: int = 2048, n_layers: int = 4,
                 max_seq_len: int = 40, dropout: float = 0.1,
                 detach_tokens: bool = True, num_chars: int = 90,
                 use_self_attn: bool = False, pad_idx: int = 0):
        super().__init__()
        if use_self_attn:
            # as the JAX package: the BCN's optional self-attention is not
            # implemented, rather than build another model
            raise NotImplementedError('use_self_attn is not implemented')
        self.max_seq_len, self.pad_idx = max_seq_len, pad_idx
        self.detach_tokens = detach_tokens
        self.proj = nn.Linear(num_chars, d_model, bias=False)
        self.token_encoder = PositionalEncoding(d_model, max_seq_len,
                                                dropout=0.1)
        self.pos_encoder = PositionalEncoding(d_model, max_seq_len)
        self.decoder_layers = nn.ModuleList([
            PostNormTransformerLayer(d_model, d_inner, n_head, dropout)
            for _ in range(n_layers)])
        self.cls = nn.Linear(d_model, num_chars)

    def get_length(self, logits: torch.Tensor) -> torch.Tensor:
        """(N,) the index of the first ``pad_idx`` argmax + 1, T where
        there is none, clamped to [2, max_seq_len]; argmax takes the first
        of tied maxima, as in JAX."""
        is_end = logits.argmax(-1) == self.pad_idx
        first = is_end.to(torch.uint8).argmax(1) + 1
        length = torch.where(is_end.any(1), first,
                             torch.full_like(first, logits.shape[1]))
        return length.clamp(2, self.max_seq_len)

    def forward(self, logits: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """logits (N, T, num_chars) -> ``feature`` (N, T, d_model) and
        ``logits`` (N, T, num_chars)."""
        N, T, _ = logits.shape
        lengths = self.get_length(logits)
        tokens = torch.softmax(logits.float(), dim=-1)
        if self.detach_tokens:
            tokens = tokens.detach()
        embed = self.token_encoder(
            self.proj(tokens.to(self.proj.weight.dtype)), rng=rng)
        x = self.pos_encoder(torch.zeros_like(embed))
        idx = torch.arange(T, device=logits.device)
        not_pad = idx[None, :] < lengths[:, None]                # (N, T)
        loc = idx[:, None] != idx[None, :]                       # (T, T)
        mask = (loc[None] & not_pad[:, None, :])[:, None]    # (N, 1, T, T)
        for layer in self.decoder_layers:
            x = layer(x, embed, mask, rng)
        return {'feature': x, 'logits': self.cls(x)}
