"""Task-agnostic modules (counterpart of ``tps_pp_tpu/models/common.py``;
the reference's ``mmocr/models/common``): the UNet backbone of SDMGR's
visual modality, and the Dice and focal losses."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONES, LOSSES
from .layers import BatchNorm2d, max_pool, resize_bilinear


class _DoubleConv(nn.Module):
    """Two (3x3 conv without bias, BatchNorm with flax's statistics,
    ReLU); ``conv{i}`` / ``bn{i}`` as the flax module names them."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        for i in range(2):
            setattr(self, f'conv{i}', nn.Conv2d(
                in_channels if i == 0 else channels, channels, 3, padding=1,
                bias=False))
            # flax momentum 0.9, eps 1e-5
            setattr(self, f'bn{i}', BatchNorm2d(channels, eps=1e-5,
                                                momentum=0.1))

    def forward(self, x):
        for i in range(2):
            x = F.relu(getattr(self, f'bn{i}')(getattr(self, f'conv{i}')(x)))
        return x


@BACKBONES.register_module()
class UNet(nn.Module):
    """The UNet of the JAX package (the reference's
    ``common/backbones/unet.py`` with its default blocks): ``num_stages``
    double convolutions, each stage after the first behind a 2x2 max pool
    and doubling the channels; then, from the deepest skip up, a bilinear
    upsample to the skip's size (``jax.image.resize``'s half-pixel rule),
    a 1x1 convolution (with bias) to the skip's channels, the skip
    concatenated in front, and a double convolution. NHWC in, NHWC out
    (views of NCHW tensors): (B, H, W, 3) -> (B, H, W, base_channels).
    Module names mirror the flax ones (``enc{i}``, ``up{i}``,
    ``dec{i}``)."""

    def __init__(self, base_channels: int = 64, num_stages: int = 5,
                 in_channels: int = 3):
        super().__init__()
        self.num_stages = num_stages
        chans, ch = [], base_channels
        for i in range(num_stages):
            chans.append(ch)
            self.add_module(f'enc{i}', _DoubleConv(
                in_channels if i == 0 else chans[i - 1], ch))
            if i < num_stages - 1:
                ch *= 2
        cur = chans[-1]
        for i in range(num_stages - 2, -1, -1):
            self.add_module(f'up{i}', nn.Conv2d(cur, chans[i], 1))
            self.add_module(f'dec{i}', _DoubleConv(2 * chans[i], chans[i]))
            cur = chans[i]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(self.num_stages):
            if i:
                x = max_pool(x, 2, 2)
            x = getattr(self, f'enc{i}')(x)
            skips.append(x)
        for i in range(self.num_stages - 2, -1, -1):
            x = resize_bilinear(x, skips[i].shape[2:])
            x = getattr(self, f'up{i}')(x)
            x = getattr(self, f'dec{i}')(torch.cat([skips[i], x], dim=1))
        return x.permute(0, 2, 3, 1)


@LOSSES.register_module()
class DiceLoss:
    """1 - 2 sum(p t) / (sum(p^2) + sum(t^2) + eps) over probabilities,
    in float32, the ``mask`` multiplied into both."""

    def __init__(self, eps=1e-6, **kwargs):
        self.eps = eps

    def __call__(self, pred, target, mask=None):
        pred = pred.float()
        target = target.float()
        if mask is not None:
            pred = pred * mask
            target = target * mask
        inter = torch.sum(pred * target)
        union = torch.sum(pred * pred) + torch.sum(target * target) + \
            self.eps
        return 1.0 - 2.0 * inter / union


@LOSSES.register_module()
class FocalLoss:
    """The mean binary focal loss of logits against 0/1 targets of the
    same shape, in float32."""

    def __init__(self, gamma=2.0, alpha=0.25, **kwargs):
        self.gamma = gamma
        self.alpha = alpha

    def __call__(self, logits, targets):
        p = torch.sigmoid(logits.float())
        t = targets.float()
        pt = p * t + (1 - p) * (1 - t)
        alpha_t = self.alpha * t + (1 - self.alpha) * (1 - t)
        loss = -alpha_t * (1 - pt) ** self.gamma * torch.log(
            torch.clamp(pt, 1e-8, 1.0))
        return torch.mean(loss)
