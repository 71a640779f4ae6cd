"""FCENet's and TextSnake's necks, heads and losses (counterpart of
``tps_pp_tpu/models/textdet/fce_textsnake.py:34-334``).

* ``FPNDet`` (mmdet's ``FPN`` as the FCENet configs use it): 1x1 laterals
  with biases, top-down nearest adds (``jax.image.resize``'s rule,
  ``models/layers.py`` ``resize_nearest``), a 3x3 smooth with bias on each
  level, all levels returned (``lateral_convs.{i}.conv``,
  ``fpn_convs.{i}.conv``).
* ``FCEHead``: one 3x3 convolution to the 4 classification logits (text
  region and centre region, two classes each, ``out_conv_cls``) and one to
  the ``2 (2k + 1)`` Fourier coefficients (``out_conv_reg``), shared by
  the levels; a (cls, reg) pair a level.
* ``FCELoss``: OHEM cross entropy on the text region (all positives and
  the ``ohem_ratio * #pos`` largest negative losses, 100 only where a
  level has no positive, summed from a descending sort as JAX does, so
  that no count leaves the card), the centre region's cross entropy (text
  pixels, then 0.5 of the rest), and smooth L1 between the contours that
  the predicted and the true coefficients reconstruct through the cos /
  sin Fourier matrices, weighted by (tr + tcl) / 2; float32, a sum over
  the levels p3-p5.
* ``UpBlock``, ``FPN_UNet`` (MMOCR's ``fpn_unet.py``): ``up4`` a stride-2
  transposed 4x4 convolution on C5, then ``up_block3 .. 0`` (1x1 ReLU,
  3x3 ReLU, transposed 4x4 stride 2: ``conv1x1``, ``conv3x3``,
  ``deconv``), each on the concatenation with the next finer level; the
  output is at the image's size. flax's ``ConvTranspose`` with ``'SAME'``
  padding is torch's ``ConvTranspose2d(k=4, s=2, p=1)`` with the kernel
  flipped (``utils/convert.py``, kind ``'conv_transpose'``).
* ``TextSnakeHead``: a 1x1 convolution to the 5 maps [text, centre, sin,
  cos, radius] (``out_conv``); ``in_channels`` defaults to the neck's
  output (``build_detector_module``).
* ``TextSnakeLoss``: balanced BCE with the same OHEM rule on the text map,
  BCE on the centre map over the text pixels, and smooth L1 on the radius
  (relative to the true one), sin and cos over the centre pixels, the
  predicted sin and cos normalised to the unit circle first; float32.

Modules take and give NHWC at the detector's boundary (``FCENetModule``:
a tuple of (cls, reg) a level; ``TextSnakeModule``: (N, H, W, 5)) and run
NCHW inside.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import HEADS, LOSSES, NECKS
from ..layers import resize_nearest
from .dbnet import _Conv


@NECKS.register_module()
class FPNDet(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, **kwargs):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.out_channels = out_channels
        self.lateral_convs = nn.ModuleList(
            _Conv(c, out_channels, 1, bias=True) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            _Conv(out_channels, out_channels, 3, bias=True)
            for _ in in_channels)

    def forward(self, inputs):
        """NCHW levels -> as many smoothed levels, NCHW."""
        lat = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_nearest(lat[i],
                                                     lat[i - 1].shape[2:])
        return tuple(conv(x) for conv, x in zip(self.fpn_convs, lat))


@HEADS.register_module()
class FCEHead(nn.Module):
    def __init__(self, in_channels: int = 256, fourier_degree: int = 5,
                 **kwargs):
        super().__init__()
        k = 2 * fourier_degree + 1
        self.out_conv_cls = nn.Conv2d(in_channels, 4, 3, padding=1)
        self.out_conv_reg = nn.Conv2d(in_channels, 2 * k, 3, padding=1)

    def forward(self, feats):
        """NCHW levels -> a (cls (N, 4, H, W), reg (N, 2(2k+1), H, W))
        pair a level."""
        return tuple((self.out_conv_cls(f), self.out_conv_reg(f))
                     for f in feats)


def _fourier2poly_mats(fourier_degree: int, num_sample: int):
    """The cos / sin matrices (2k + 1, num_sample), float32 (reference
    ``fce_loss.py:167-207``)."""
    k_vect = np.arange(-fourier_degree, fourier_degree + 1,
                       dtype=np.float32).reshape(-1, 1)
    i_vect = np.arange(0, num_sample, dtype=np.float32).reshape(1, -1)
    t = 2 * np.pi / num_sample * (k_vect @ i_vect)
    return (torch.from_numpy(np.cos(t).astype(np.float32)),
            torch.from_numpy(np.sin(t).astype(np.float32)))


def _masked_mean(x, mask, eps=1e-6):
    return (x * mask).sum() / torch.clamp(mask.sum(), min=eps)


def _smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _top_negatives(losses, neg, n_neg):
    """The sum of the ``n_neg`` largest ``losses`` where ``neg``, from a
    descending sort (``n_neg`` a 0-d tensor, never above ``neg``'s
    count)."""
    ranked = torch.sort(torch.where(neg, losses,
                                    torch.full_like(losses, -float('inf'))),
                        descending=True).values
    keep = torch.arange(ranked.numel(), device=losses.device) < n_neg
    return torch.where(keep, ranked, torch.zeros_like(ranked)).sum()


def _ohem_ce(logits2, target, train_mask, ohem_ratio):
    """OHEM cross entropy over 2-class logits (reference
    ``fce_loss.py:142-165``): all positives and the ``ohem_ratio * #pos``
    largest negative losses (100 where there is no positive), over their
    count."""
    ce = -F.log_softmax(
        logits2.to(torch.promote_types(logits2.dtype, torch.float32)),
        dim=-1).gather(1, target[:, None]).squeeze(1)
    pos = (target > 0) & (train_mask > 0)
    neg = (target == 0) & (train_mask > 0)
    n_pos = pos.sum()
    n_keep = torch.where(n_pos > 0, (ohem_ratio * n_pos.float()).int(),
                         torch.full_like(n_pos, 100, dtype=torch.int32))
    n_neg = torch.minimum(neg.sum().int(), n_keep)
    return ((ce * pos).sum() + _top_negatives(ce, neg, n_neg)) / torch.clamp(
        (n_pos + n_neg).float(), min=1.0)


@LOSSES.register_module()
class FCELoss:
    """The JAX ``FCELoss``: targets per level (N, H, W, 4k + 5) maps [tr,
    tcl, effective, x (2k + 1), y (2k + 1)] under ``p3_maps`` ..
    ``p5_maps``."""

    def __init__(self, fourier_degree=5, num_sample=50, ohem_ratio=3.0,
                 **kwargs):
        self.fourier_degree = fourier_degree
        self.num_sample = num_sample
        self.ohem_ratio = ohem_ratio
        self._mats = _fourier2poly_mats(fourier_degree, num_sample)

    def _forward_single(self, cls_pred, reg_pred, gt):
        k = 2 * self.fourier_degree + 1
        tr_pred = cls_pred[..., :2].reshape(-1, 2)
        tcl_pred = cls_pred[..., 2:].reshape(-1, 2)
        # float32, or float64 for a float64 model
        wide = torch.promote_types(reg_pred.dtype, torch.float32)
        x_pred = reg_pred[..., :k].reshape(-1, k).to(wide)
        y_pred = reg_pred[..., k:].reshape(-1, k).to(wide)
        gt = gt.to(wide)
        tr_mask = gt[..., 0].reshape(-1).long()
        tcl_mask = gt[..., 1].reshape(-1).long()
        train_mask = gt[..., 2].reshape(-1).long()
        x_map = gt[..., 3:3 + k].reshape(-1, k)
        y_map = gt[..., 3 + k:].reshape(-1, k)

        tr_train = (tr_mask * train_mask).to(wide)
        loss_tr = _ohem_ce(tr_pred, tr_mask, train_mask, self.ohem_ratio)
        ce = -F.log_softmax(tcl_pred.to(wide), dim=-1).gather(
            1, tcl_mask[:, None]).squeeze(1)
        has_pos = tr_train.sum() > 0
        zero = torch.zeros((), device=cls_pred.device)
        loss_tcl = torch.where(
            has_pos, _masked_mean(ce, tr_train)
            + 0.5 * _masked_mean(ce, 1 - tr_train), zero)

        cos_m, sin_m = (m.to(cls_pred.device, wide) for m in self._mats)

        def f2p(real, imag):
            return real @ cos_m - imag @ sin_m, real @ sin_m + imag @ cos_m

        ft_x, ft_y = f2p(x_map, y_map)
        ft_xp, ft_yp = f2p(x_pred, y_pred)
        weight = (tr_mask.to(wide) + tcl_mask.to(wide)) / 2
        wm = (weight * tr_train)[:, None]
        denom = torch.clamp(tr_train.sum() * self.num_sample, min=1.0)
        loss_reg_x = torch.where(
            has_pos, (_smooth_l1(ft_xp, ft_x) * wm).sum() / denom, zero)
        loss_reg_y = torch.where(
            has_pos, (_smooth_l1(ft_yp, ft_y) * wm).sum() / denom, zero)
        return loss_tr, loss_tcl, loss_reg_x, loss_reg_y

    def __call__(self, preds, targets) -> Dict[str, torch.Tensor]:
        """preds: a (cls (N, H, W, 4), reg (N, H, W, 2(2k+1))) pair a
        level, p3 first."""
        keys = ['p3_maps', 'p4_maps', 'p5_maps'][:len(preds)]
        tot = [0.0, 0.0, 0.0, 0.0]
        for (cls_p, reg_p), key in zip(preds, keys):
            parts = self._forward_single(cls_p, reg_p, targets[key])
            tot = [a + b for a, b in zip(tot, parts)]
        return {'loss_text': tot[0], 'loss_center': tot[1],
                'loss_reg_x': tot[2], 'loss_reg_y': tot[3]}


class UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_channels, in_channels, 1)
        self.conv3x3 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.deconv = nn.ConvTranspose2d(out_channels, out_channels, 4,
                                         stride=2, padding=1)

    def forward(self, x):
        x = F.relu(self.conv1x1(x))
        return self.deconv(F.relu(self.conv3x3(x)))


@NECKS.register_module()
class FPN_UNet(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 32, **kwargs):
        super().__init__()
        outs = [out_channels] + [min(out_channels * 2 ** i, 256)
                                 for i in range(4)]
        self.out_channels = out_channels
        self.up4 = nn.ConvTranspose2d(in_channels[3], outs[4], 4, stride=2,
                                      padding=1)
        self.up_block3 = UpBlock(outs[4] + in_channels[2], outs[3])
        self.up_block2 = UpBlock(outs[3] + in_channels[1], outs[2])
        self.up_block1 = UpBlock(outs[2] + in_channels[0], outs[1])
        self.up_block0 = UpBlock(outs[1], outs[0])

    def forward(self, inputs):
        """NCHW C2-C5 -> (N, out_channels, 2 H2, 2 W2), NCHW."""
        c2, c3, c4, c5 = inputs
        x = F.relu(self.up4(c5))
        x = F.relu(self.up_block3(torch.cat([x, c4], dim=1)))
        x = F.relu(self.up_block2(torch.cat([x, c3], dim=1)))
        x = F.relu(self.up_block1(torch.cat([x, c2], dim=1)))
        return self.up_block0(x)


@HEADS.register_module()
class TextSnakeHead(nn.Module):
    def __init__(self, in_channels: int = 32, out_channels: int = 5,
                 **kwargs):
        super().__init__()
        self.out_conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.out_conv(x)


@LOSSES.register_module()
class TextSnakeLoss:
    """The JAX ``TextSnakeLoss``: targets ``gt_text_mask``,
    ``gt_center_region_mask``, ``gt_mask``, ``gt_radius_map``,
    ``gt_sin_map``, ``gt_cos_map``, each (N, H, W) at the maps' size."""

    def __init__(self, ohem_ratio=3.0, **kwargs):
        self.ohem_ratio = ohem_ratio

    def _balanced_bce(self, prob, gt, mask):
        gt, mask, prob = gt.reshape(-1), mask.reshape(-1), prob.reshape(-1)
        eps = 1e-6
        loss = -(gt * torch.log(prob + eps)
                 + (1 - gt) * torch.log(1 - prob + eps))
        pos = gt * mask
        neg = (1 - gt) * mask
        n_pos = pos.sum()
        n_keep = torch.where(n_pos > 0, n_pos * self.ohem_ratio,
                             torch.full_like(n_pos, 100.0))
        n_neg = torch.minimum(neg.sum(), n_keep).int()
        return ((loss * pos).sum() + _top_negatives(loss, neg > 0, n_neg)) / (
            n_pos + n_neg.float() + 1e-5)

    def __call__(self, preds, targets) -> Dict[str, torch.Tensor]:
        """preds: (N, H, W, 5) raw maps [text, centre, sin, cos,
        radius]."""
        # float32, or float64 for a float64 model
        preds = preds.to(torch.promote_types(preds.dtype, torch.float32))
        pred_text = torch.sigmoid(preds[..., 0])
        pred_center = torch.sigmoid(preds[..., 1])
        pred_sin, pred_cos, pred_radius = preds[..., 2], preds[..., 3], \
            preds[..., 4]
        scale = torch.sqrt(1.0 / (pred_sin ** 2 + pred_cos ** 2 + 1e-8))
        pred_sin, pred_cos = pred_sin * scale, pred_cos * scale
        gt_text = targets['gt_text_mask'].to(preds.dtype)
        gt_center = targets['gt_center_region_mask'].to(preds.dtype)
        gt_mask = targets['gt_mask'].to(preds.dtype)
        gt_radius = targets['gt_radius_map'].to(preds.dtype)
        gt_sin = targets['gt_sin_map'].to(preds.dtype)
        gt_cos = targets['gt_cos_map'].to(preds.dtype)

        loss_text = self._balanced_bce(pred_text, gt_text, gt_mask)
        text_mask = gt_text * gt_mask
        eps = 1e-6
        bce_center = -(gt_center * torch.log(pred_center + eps)
                       + (1 - gt_center) * torch.log(1 - pred_center + eps))
        loss_center = _masked_mean(bce_center, text_mask)
        center_mask = gt_center * gt_mask
        loss_radius = _masked_mean(
            _smooth_l1(pred_radius / (gt_radius + 1e-2),
                       torch.ones_like(pred_radius)), center_mask)
        loss_sin = _masked_mean(_smooth_l1(pred_sin, gt_sin), center_mask)
        loss_cos = _masked_mean(_smooth_l1(pred_cos, gt_cos), center_mask)
        return {'loss_text': loss_text, 'loss_center': loss_center,
                'loss_radius': loss_radius, 'loss_sin': loss_sin,
                'loss_cos': loss_cos}


class FCENetModule(nn.Module):
    """backbone -> FPNDet on its last ``len(neck.in_channels)`` levels ->
    FCEHead; NHWC image in, a (cls, reg) NHWC pair a level out."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, img: torch.Tensor):
        feats = self.backbone(img)[-len(self.neck.in_channels):]
        return tuple((c.permute(0, 2, 3, 1), r.permute(0, 2, 3, 1))
                     for c, r in self.head(self.neck(feats)))


class TextSnakeModule(nn.Module):
    """backbone -> FPN_UNet -> TextSnakeHead; NHWC image in, NHWC maps
    (N, H, W, 5) out."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.neck(self.backbone(img))).permute(0, 2, 3, 1)
