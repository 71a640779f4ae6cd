"""TPS++ attention-enhanced thin-plate-spline rectifier (counterpart of
``tps_pp_tpu/models/rectifiers/tps_pp.py``).

The reference's semantics are kept, quirks included:

* the control points and the sampling grid live in [0, 1] but go unchanged
  into a sampler with the [-1, 1] convention, ``border`` padding and
  ``align_corners=True``;
* the pixel-to-fiducial score is ``tanh(f @ p^T * C^-0.5)``;
* DGAB's Linears act on the width axis, and its LayerNorms span (H, W) with
  eps 1e-5;
* ``localization_fc2`` starts at zero weight and a meshgrid bias;
* the reference's second warp (``mp_img``) is never read, so it is not
  computed.

The convolutional parts run NCHW; the public ``forward`` takes and returns
NHWC like the JAX module. In eval mode the grid generation and the warp go
through ``ops.tps_sampler`` (the serving kernel). In train mode, as in the
JAX module (``tps_pp.py:312-343``), the grid is built with ``build_P_prime``
in float32 under autograd, out of autocast, and the warp is the
differentiable ``ops.grid_sample`` (the training kernels). Either way the
kernels run on CUDA tensors and their plain versions on CPU tensors or with
``plain=True``. Module names are the reference's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import tps as tps_ops
from ...ops.grid_sample import grid_sample
from ...ops.tps_sampler import tps_sampler, tps_sampler_plain
from ...registry import RECTIFIERS
from ..layers import (ConvModule, nchw_to_nhwc, nhwc_to_nchw,
                      upsample_nearest)


class ChannelAttention(nn.Module):
    """CBAM channel gate (reference tps_pp.py:27-50)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(1, channels // ratio)
        self.shared_MLP = nn.Sequential(
            nn.Conv2d(channels, hidden, 1, bias=False), nn.ReLU(),
            nn.Conv2d(hidden, channels, 1, bias=False))

    def forward(self, x):                                   # (N, C, H, W)
        avg = self.shared_MLP(x.mean(dim=(2, 3), keepdim=True))
        mx = self.shared_MLP(x.amax(dim=(2, 3), keepdim=True))
        return torch.sigmoid(avg + mx)


class SpatialAttention(nn.Module):
    """CBAM spatial gate: 3x3 conv over the [mean, max] channel maps."""

    def __init__(self):
        super().__init__()
        self.conv2d = nn.Conv2d(2, 1, 3, padding=1)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv2d(s))


class CBAM(nn.Module):

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.channel_attention = ChannelAttention(channels, ratio)
        self.spatial_attention = SpatialAttention()

    def forward(self, x):
        x = self.channel_attention(x) * x
        return self.spatial_attention(x) * x


class _MSFAConv(nn.Module):
    """The U-Net of MSFA (reference module ``MSFA.conv``): strides
    (1, 2, p_stride, (2, 1)) down to the fiducial grid, CBAM at the
    bottleneck, nearest upsampling and additive skips back up."""

    def __init__(self, in_channels: int, num_channels: int, u_channel: int,
                 stride: int):
        super().__init__()
        c = num_channels
        enc_strides = (1, 2, stride, (2, 1))
        self.k_encoder = nn.ModuleList([
            ConvModule(in_channels * u_channel if i == 0 else c, c, 3,
                       stride=s, padding=1)
            for i, s in enumerate(enc_strides)])
        self.atten = CBAM(c)
        ups = ((2, 1), stride, 2)
        self.k_decoder = nn.ModuleList([
            nn.Sequential(nn.Upsample(scale_factor=s, mode='nearest'),
                          ConvModule(c, c, 3, padding=1)) for s in ups] + [
            nn.Sequential(nn.Identity(),
                          ConvModule(c, in_channels, 3, padding=1))])

    def forward(self, x):
        feats = []
        for conv in self.k_encoder:
            x = conv(x)
            feats.append(x)
        point = feats[-1]
        k = self.atten(point)
        for i, dec in enumerate(self.k_decoder[:-1]):
            k = dec(k) + feats[len(self.k_decoder) - 2 - i]
        return self.k_decoder[-1](k), point


class MSFA(nn.Module):
    """Multi-Scale Feature Aggregation (reference tps_pp.py:84-229)."""

    def __init__(self, in_channels=64, num_channels=64, u_channel=3,
                 stride=2):
        super().__init__()
        self.conv = _MSFAConv(in_channels, num_channels, u_channel, stride)

    def forward(self, x):                                   # NCHW
        de_feat, en_feat = self.conv(x)
        return {'de_feat': de_feat, 'en_feat': en_feat}


class DGABBlock(nn.Module):
    """Dual gated attention (reference DGAB.py:25-55), in (N, C, H, W)
    order; ``proj`` acts on the width axis."""

    def __init__(self, point: int, height: int, width: int):
        super().__init__()
        self.mlp_w = nn.Sequential(nn.Linear(width + point, width + 1,
                                             bias=False))
        self.mlp_h = nn.Sequential(nn.Linear(height + point, height + 1,
                                             bias=False))
        self.proj = nn.Linear(width, width)

    def forward(self, x, y):
        # x (N, C, H, W); y (N, T, C) fiducial tokens
        y = y.transpose(1, 2)                               # (N, C, T)
        w = self.mlp_w(torch.cat([x.mean(dim=2), y], dim=2))
        v_w = torch.softmax(w[:, :, :-1], dim=-1)[:, :, None, :]
        h = self.mlp_h(torch.cat([x.mean(dim=3), y], dim=2))
        v_h = torch.softmax(h[:, :, :-1], dim=-1)[:, :, :, None]
        x = (v_h * x * h[:, :, -1][..., None, None] +
             v_w * x * w[:, :, -1][..., None, None])
        return self.proj(x)


class _DGABMlp(nn.Module):

    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DGAB(nn.Module):
    """Pre-norm DGAB (reference DGAB.py:58-77): LayerNorm over (H, W),
    gated attention, then a width-axis MLP."""

    def __init__(self, point: int, height: int, width: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm((height, width), eps=1e-5)
        self.norm2 = nn.LayerNorm((height, width), eps=1e-5)
        self.attn = DGABBlock(point, height, width)
        self.mlp = _DGABMlp(width, int(width * mlp_ratio))

    def forward(self, x, y):
        x = x + self.attn(self.norm1(x), y)
        return x + self.mlp(self.norm2(x))


class TPE(nn.Module):
    """Transformation Parameter Estimation (reference tps_pp.py:231-325)."""

    def __init__(self, num_img_channel=64, point_size=(2, 16),
                 img_size=(16, 64)):
        super().__init__()
        py, px = point_size
        self.point_size = (py, px)
        self.num_fiducial = F_ = py * px
        self.C = C = num_img_channel
        self.atten = nn.ModuleList([DGAB(F_, img_size[0], img_size[1])])
        self.localization_fc1 = nn.Sequential(
            nn.Linear(C, 256), nn.ReLU(), nn.Linear(256, 2), nn.ReLU())
        self.localization_fc2 = nn.Linear(2 * F_, 2 * F_)
        self.p_linear = nn.Sequential(nn.Linear(C, 32), nn.Linear(32, 128))
        self.feat_linear = nn.Sequential(nn.Linear(C, 32),
                                         nn.Linear(32, 128))
        self.reset_localization()

    def reset_localization(self):
        """fc2 at zero weight and the meshgrid bias (tps_pp.py:278-285)."""
        py, px = self.point_size
        ctrl_x = np.linspace(0.1, px - 0.1, num=px) / px
        ctrl_y = np.linspace(0.1, py - 0.1, num=py) / py
        bias = np.stack(np.meshgrid(ctrl_x, ctrl_y), axis=2).reshape(-1)
        with torch.no_grad():
            self.localization_fc2.weight.zero_()
            self.localization_fc2.bias.copy_(torch.from_numpy(bias))

    def forward(self, en_feat, de_feat):
        """en_feat (N, C, py, px), de_feat (N, C, H, W), both NCHW.
        Returns control points (N, F, 2) and pixel scores (N, H*W, F) in
        the input dtype."""
        N = en_feat.shape[0]
        tokens = en_feat.flatten(2).transpose(1, 2)        # (N, F, C)
        x = self.atten[0](de_feat, tokens)                  # (N, C, H, W)
        h = self.localization_fc1(tokens)
        cp = self.localization_fc2(h.reshape(N, -1))
        control_point = cp.reshape(N, self.num_fiducial, 2)
        p1 = self.p_linear(tokens)                          # (N, F, 128)
        f = self.feat_linear(x.flatten(2).transpose(1, 2))  # (N, HW, 128)
        with torch.autocast(f.device.type, enabled=False):
            score = torch.matmul(f.float(), p1.float().transpose(1, 2))
        pc_score = torch.tanh(score * self.C ** -0.5).to(en_feat.dtype)
        return control_point, pc_score


@RECTIFIERS.register_module()
class TPS_PP(nn.Module):
    """TPS++ top module (reference tps_pp.py:499-626).

    ``in_channels`` are the channel counts of the two skips (stem output,
    first stage output) and of the stage feature; by default
    (C/2, C/2, C) with C = ``num_img_channel``, the flagship's geometry.
    """

    def __init__(self, img_size=(16, 64), rectified_img_size=(16, 64),
                 num_img_channel=64, point_size=(2, 16), p_stride=2,
                 in_channels: Sequence[int] = None,
                 sample_mode='gather', pallas_tile=1024):
        # sample_mode / pallas_tile pick the JAX-side sampler; the port has
        # one (ops.tps_sampler) and accepts them so that the JAX package's
        # configs build unchanged.
        super().__init__()
        C = num_img_channel
        c0, c1, c2 = in_channels or (C // 2, C // 2, C)
        self.rectified_img_size = tuple(rectified_img_size)
        self.down0 = ConvModule(c0, C, 1)
        self.down1 = ConvModule(c1, C, 1)
        self.down2 = ConvModule(c2, C, 1)
        self.down0_1 = ConvModule(C, C, 3, stride=2, padding=1)
        self.down1_1 = ConvModule(C, C, 3, stride=2, padding=1)
        self.down_feat = ConvModule(3 * C, C, 1)
        self.MSFA = MSFA(C, C, 3, p_stride)
        self.TPE = TPE(C, point_size, img_size)
        # the static TPS matrices stay float32 whatever dtype the module is
        # cast to, so they are kept out of the buffers
        fid_C = tps_ops.build_C_cell_centers(point_size)
        P = tps_ops.build_P_cell_centers(rectified_img_size[1],
                                         rectified_img_size[0])
        self._tps_np = tuple(np.asarray(a, np.float32) for a in (
            tps_ops.build_inv_delta_C(fid_C),
            tps_ops.build_P_hat(fid_C, P, eps=1e-6), P))
        self._tps_on = {}

    def tps_matrices(self, device) -> Tuple[torch.Tensor, ...]:
        """(inv_delta_C, P_hat, P) as float32 tensors on ``device``; made
        outside inference mode, so that training can use them after
        ``predict`` made them."""
        if device not in self._tps_on:
            with torch.inference_mode(False):
                self._tps_on[device] = tuple(torch.from_numpy(a).to(device)
                                             for a in self._tps_np)
        return self._tps_on[device]

    def forward(self, batch_img, skips, plain: bool = False):
        """batch_img (N, h, w, c2) stage feature; skips [stem (N, H, W, c0),
        stage-1 output (N, H, W, c1)], all NHWC. Returns the rectified
        (N, Hr, Wr, C) feature (NHWC, batch_img's dtype), the control points
        and the pixel scores."""
        feat0 = self.down0(nhwc_to_nchw(skips[0]))
        feat1 = self.down1(nhwc_to_nchw(skips[1]))
        feat2 = self.down2(nhwc_to_nchw(batch_img))
        feat_cat = torch.cat([self.down0_1(feat0), self.down1_1(feat1),
                              feat2], dim=1)
        feat_grid = self.down_feat(torch.cat(
            [feat0, feat1, upsample_nearest(feat2, 2)], dim=1))
        logits = self.MSFA(feat_cat)
        control_point, pc_score = self.TPE(logits['en_feat'],
                                           logits['de_feat'])
        feat_nhwc = nchw_to_nhwc(feat_grid).contiguous()
        mats = self.tps_matrices(feat_grid.device)
        if self.training:
            # the grid in float64, rounded once to the float32 the sampler
            # takes (as JAX's does, grid_sample.py:44-45): in float32 its
            # 35-term sums cancel (inv_delta_C holds entries near 56), two
            # implementations part by ~1e-6, and through the trunk's ReLUs
            # such noise can flip whole gradients downstream
            with torch.autocast(feat_grid.device.type, enabled=False):
                grid = tps_ops.build_P_prime(
                    control_point.double(), pc_score.double(),
                    *(m.double() for m in mats)).float()
            rect = grid_sample(feat_nhwc, grid.reshape(
                -1, *self.rectified_img_size, 2), plain=plain)
        else:
            sampler = tps_sampler_plain if plain else tps_sampler
            rect = sampler(feat_nhwc, control_point.float().contiguous(),
                           pc_score.float().contiguous(), *mats,
                           self.rectified_img_size)
        return {'output': rect.to(batch_img.dtype),
                'pc_score': pc_score, 'control_point': control_point}
