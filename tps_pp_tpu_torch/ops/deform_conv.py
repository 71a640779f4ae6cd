"""Modulated deformable convolution, DCNv2 (counterpart of
``tps_pp_tpu/ops/deform_conv.py:29-109``).

The JAX package computes it as plain XLA, with no Pallas kernel: nine
zero-padded bilinear gathers, one per 3x3 tap, each at the tap's base
position plus a learned (dy, dx) and scaled by the sigmoided mask, then one
product of the (N, Ho, Wo, 9 Cin) columns with the (9 Cin, Cout) kernel.
The port computes the same, in float32, with PyTorch's gather and
``torch.matmul``. Semantics are mmcv's ``ModulatedDeformConv2dPack``: zero
outside the image, the offset channels (dy, dx) for each tap, the taps
row-major, ``conv_offset`` zero-initialised, so the layer starts as half a
plain 3x3 convolution (mask = sigmoid(0)).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def _bilinear_zeros(img: torch.Tensor, gy: torch.Tensor,
                    gx: torch.Tensor) -> torch.Tensor:
    """Samples of ``img`` (N, H, W, C) at pixel coordinates ``gy``, ``gx``
    (N, Ho, Wo), zero outside [0, H-1] x [0, W-1]: (N, Ho, Wo, C)."""
    n, h, w, c = img.shape
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy, wx = (gy - y0)[..., None], (gx - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    flat = img.reshape(n * h * w, c)
    base = (torch.arange(n, device=img.device) * (h * w)).view(n, 1, 1)

    def tap(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = flat.index_select(0, idx.reshape(-1)).view(*yi.shape, c)
        return torch.where(valid, v, v.new_zeros(()))

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1) -> torch.Tensor:
    """DCNv2 forward, 3x3, padding 1, dilation 1, in float32. ``x`` (N, Cin,
    H, W); ``offset`` (N, 18, Ho, Wo), (dy, dx) for each row-major tap;
    ``mask`` (N, 9, Ho, Wo), already sigmoided; ``weight`` (Cout, Cin, 3, 3).
    Returns (N, Cout, Ho, Wo) in ``x``'s dtype."""
    n, cin, _, _ = x.shape
    ho, wo = offset.shape[2], offset.shape[3]
    f32 = torch.float32
    img = x.to(f32).permute(0, 2, 3, 1)                         # NHWC
    base_y = (torch.arange(ho, device=x.device, dtype=f32)
              * stride).view(1, ho, 1)
    base_x = (torch.arange(wo, device=x.device, dtype=f32)
              * stride).view(1, 1, wo)
    off = offset.to(f32).view(n, 9, 2, ho, wo)
    m = mask.to(f32)
    cols = []
    for k in range(9):
        kh, kw = divmod(k, 3)
        gy = base_y + (kh - 1) + off[:, k, 0]
        gx = base_x + (kw - 1) + off[:, k, 1]
        cols.append(_bilinear_zeros(img, gy, gx) * m[:, k, :, :, None])
    col = torch.cat(cols, dim=-1).view(n, ho * wo, 9 * cin)
    w = weight.to(f32).permute(2, 3, 1, 0).reshape(9 * cin, -1)
    out = torch.matmul(col, w).view(n, ho, wo, -1)
    if bias is not None:
        out = out + bias.to(f32)
    return out.permute(0, 3, 1, 2).to(x.dtype)


class ModulatedDeformConv(nn.Module):
    """The DCNv2 layer without a bias, as the trunks use it (mmcv's
    ``ModulatedDeformConv2dPack``): a 3x3 ``conv_offset`` with bias
    predicts 27 channels, 18 offsets and 9 mask logits, then
    :func:`deform_conv2d` applies ``weight``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv_offset = nn.Conv2d(in_channels, 27, 3, stride=stride,
                                     padding=1, bias=True)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        nn.init.kaiming_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.conv_offset(x)
        mask = torch.sigmoid(om[:, 18:].float())
        return deform_conv2d(x, om[:, :18], mask, self.weight,
                             stride=self.stride)
