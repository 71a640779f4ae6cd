"""SATRN encoder: adaptive 2D positional encoding + locality-aware FFN
(counterpart of ``tps_pp_tpu/models/encoders/satrn.py``; reference
``encoders/satrn_encoder.py`` and ``layers/satrn_layers.py``).

Features are NHWC at the boundaries, tokens (N, H*W, C) row-major. Two
behaviours of the reference that the JAX package keeps, kept here:

* the positional encoding's output already holds its input, and the
  encoder adds it to that input again: ``feat + pe(feat)`` is
  ``2 feat + h_pos + w_pos`` (``tps_pp_tpu/models/encoders/satrn.py:
  121-123``);
* the mask is built per width column, ``col < min(W, ceil(W * ratio))``,
  then repeated over the height, unlike NRTR's mask over the flattened
  tokens.

The encoder has no fused forward (``SUPPORTS_FUSED_FORWARD`` is False):
the whole decodes run after it as after a module. Dropout (train mode, masks
from the caller's ``rng``) on the positional encoding's output and in the
attention, as in JAX; train-mode BatchNorm keeps flax's statistics
(``layers.BatchNorm2d``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...registry import ENCODERS
from ..layers import ConvModule, nchw_to_nhwc, nhwc_to_nchw
from ..transformer import MultiHeadAttention, dropout, sinusoid_position_table
from .nrtr import valid_steps


class Adaptive2DPositionalEncoding(nn.Module):
    """x + sigmoid-gated height and width sinusoids, the gates two 1x1 conv
    stacks over the feature's spatial mean (``h_scale`` / ``w_scale``, the
    reference's ``Sequential(conv, ReLU, conv, Sigmoid)``), then dropout.
    The tables are the reference's buffers, (1, d_hid, n_height, 1) and
    (1, d_hid, 1, n_width)."""

    def __init__(self, d_hid: int = 512, n_height: int = 100,
                 n_width: int = 100, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        for name, n, shape in (
                ('h_position_encoder', n_height, (1, d_hid, n_height, 1)),
                ('w_position_encoder', n_width, (1, d_hid, 1, n_width))):
            table = torch.from_numpy(sinusoid_position_table(n, d_hid)[0])
            self.register_buffer(name, table.t().reshape(shape).contiguous())
        self.h_scale = self._scale(d_hid)
        self.w_scale = self._scale(d_hid)

    @staticmethod
    def _scale(d_hid: int) -> nn.Sequential:
        return nn.Sequential(nn.Conv2d(d_hid, d_hid, 1), nn.ReLU(),
                             nn.Conv2d(d_hid, d_hid, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, H, W, C) -> (N, H, W, C)."""
        _, H, W, _ = x.shape
        pooled = nhwc_to_nchw(x.mean(dim=(1, 2), keepdim=True))
        h_pos = self.h_scale(pooled) * self.h_position_encoder[:, :, :H]
        w_pos = self.w_scale(pooled) * self.w_position_encoder[:, :, :, :W]
        out = (x + nchw_to_nhwc(h_pos).to(x.dtype)
               + nchw_to_nhwc(w_pos).to(x.dtype))
        return dropout(out, self.dropout if self.training else 0.0, rng)


class LocalityAwareFeedforward(nn.Module):
    """1x1 ConvModule -> depthwise 3x3 ConvModule -> 1x1 ConvModule, each
    conv + BatchNorm + ReLU, over (N, H, W, C)."""

    def __init__(self, d_in: int, d_hid: int):
        super().__init__()
        self.conv1 = ConvModule(d_in, d_hid, 1, use_norm=True)
        self.depthwise_conv = ConvModule(d_hid, d_hid, 3, padding=1,
                                         use_norm=True, groups=d_hid)
        self.conv2 = ConvModule(d_hid, d_in, 1, use_norm=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.depthwise_conv(self.conv1(nhwc_to_nchw(x))))
        return nchw_to_nhwc(x)


class SatrnEncoderLayer(nn.Module):
    """Pre-norm self-attention, then the locality-aware FFN on the tokens
    laid out as the (h, w) map, each with a residual."""

    def __init__(self, d_model: int = 512, d_inner: int = 512,
                 n_head: int = 8, d_k: int = 64, d_v: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.feed_forward = LocalityAwareFeedforward(d_model, d_inner)

    def forward(self, x: torch.Tensor, h: int, w: int, mask=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        n, hw, c = x.shape
        y = self.norm1(x)
        x = x + self.attn(y, y, y, mask, rng)
        y = self.feed_forward(self.norm2(x).reshape(n, h, w, c))
        return x + y.reshape(n, hw, c)


def width_mask(valid_ratio: Optional[torch.Tensor], h: int, w: int):
    """(N,) ratios -> (N, h*w) float 0/1 mask: column ``j < min(w,
    ceil(w * ratio))`` of every row; None passes through."""
    if valid_ratio is None:
        return None
    col = torch.arange(w, device=valid_ratio.device)[None, :]
    mask = (col < valid_steps(valid_ratio, w)[:, None]).float()
    return mask[:, None, :].expand(-1, h, -1).reshape(-1, h * w)


@ENCODERS.register_module()
class SatrnEncoder(nn.Module):
    SUPPORTS_FUSED_FORWARD = False

    def __init__(self, n_layers: int = 12, n_head: int = 8, d_k: int = 64,
                 d_v: int = 64, d_model: int = 512, n_position: int = 100,
                 d_inner: int = 256, dropout: float = 0.1):
        super().__init__()
        self.position_enc = Adaptive2DPositionalEncoding(
            d_model, n_position, n_position, dropout)
        self.layer_stack = nn.ModuleList([
            SatrnEncoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout)
            for _ in range(n_layers)])
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat (N, H, W, C) -> (N, H*W, C); ``rng`` draws the dropout
        masks in train mode."""
        n, h, w, c = feat.shape
        feat = feat + self.position_enc(feat, rng)
        mask = width_mask(valid_ratio, h, w)
        attn_mask = None if mask is None else mask[:, None, None, :]
        x = feat.reshape(n, h * w, c)
        for layer in self.layer_stack:
            x = layer(x, h, w, attn_mask, rng)
        return self.layer_norm(x)
