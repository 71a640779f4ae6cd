"""PANet's and PSENet's trunk, necks, heads and losses (counterpart of
``tps_pp_tpu/models/textdet/pan.py:38-429``).

* ``ResNetDet50`` and its ``Bottleneck`` (mmdet's: 1x1 -> 3x3 with the
  stride -> 1x1 x 4, names ``conv1..3`` / ``bn1..3`` /
  ``downsample.{0,1}``); with ``dcn`` its 3x3 is a DCNv2 layer
  (``ops/deform_conv.py``, mmcv's names ``conv2.weight`` and
  ``conv2.conv_offset.*``).
* ``FPEM_FFM`` (MMOCR's ``fpem_ffm.py``): C2-C5 reduced to ``conv_out``
  channels (``reduce_conv_c{2..5}``: 1x1 conv with bias, BN, ReLU), then
  ``fpem_repeat`` FPEMs (``fpems.{r}``: three top-down and three bottom-up
  ``SeparableConv``s, each a depthwise 3x3 and a pointwise 1x1 with biases,
  BN, ReLU), summed level by level (FFM) and the coarser three resized to
  C2's size (bilinear, ``align_corners=False``). The FPEM's adds resize
  the first operand to the second's size with ``jax.image.resize``'s
  nearest (half-pixel) rule, in the down pass too (``up_add`` of the finer
  level onto the coarser's stride-2 input, as JAX writes it).
* ``FPNF`` (MMOCR's ``fpnf.py``): ``lateral_convs`` and ``fpn_convs``
  (``ConvModule``s with BN and ReLU), the top-down nearest adds, every
  level resized to the first's size, concatenated (or summed) and fused by
  ``output_convs``.
* ``PANHead`` (and its name ``PSEHead``): the neck's levels concatenated,
  one 1x1 convolution (``out_conv``) to the raw logits; ``in_channels``
  defaults to what the neck gives (``build_detector_module``).
* ``PANLoss`` and ``PSELoss``: dice on sigmoided logits with the OHEM
  mask (threshold form: the negatives scoring at least the k-th largest,
  k = min(3 #pos, #neg), or the whole effective mask where there is no
  positive or no negative), PAN's aggregation and discrimination losses
  over a static ``max_instances`` axis (instances past it get no embedding
  loss, as in JAX; ``train_detector`` warns), PSE's kernel dice with the
  ``'adaptive'`` or ``'hard'`` mask. float32.

Modules take and give NHWC at the detector's boundary (``PANetModule``)
and run NCHW inside.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.deform_conv import ModulatedDeformConv
from ...registry import BACKBONES, HEADS, LOSSES, NECKS
from ..layers import (BatchNorm2d, ConvModule, resize_bilinear,
                      resize_nearest)
from .dbnet import _ResNetStem


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dcn: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = (ModulatedDeformConv(planes, planes, stride=stride)
                      if dcn else nn.Conv2d(planes, planes, 3, stride=stride,
                                            padding=1, bias=False))
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4, eps=1e-5)) if use_downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNetDet50(_ResNetStem):
    """ResNet-50 trunk emitting C2-C5 with (256, 512, 1024, 2048) channels;
    with a ``dcn`` config, the stages flagged in ``stage_with_dcn`` take
    DCNv2 3x3s (only DCNv2 semantics exist, as in JAX)."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 base_channels: int = 64,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dcn: Any = None, **kwargs):
        super().__init__(base_channels)
        cin, ch = base_channels, base_channels
        for si, blocks in enumerate(stage_blocks):
            use_dcn = bool(stage_with_dcn[si]) if dcn else False
            layers = []
            for b in range(blocks):
                s = 2 if (si > 0 and b == 0) else 1
                layers.append(Bottleneck(
                    cin, ch, stride=s,
                    use_downsample=s != 1 or cin != ch * 4, dcn=use_dcn))
                cin = ch * 4
            setattr(self, f'layer{si + 1}', nn.Sequential(*layers))
            ch *= 2


class SeparableConv(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, both with biases, + BN + ReLU
    (MMOCR's ``SeparableConv2d``)."""

    def __init__(self, channels: int, stride: int = 1):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(channels, channels, 3, stride=stride,
                                        padding=1, groups=channels)
        self.pointwise_conv = nn.Conv2d(channels, channels, 1)
        self.bn = BatchNorm2d(channels, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.pointwise_conv(self.depthwise_conv(x))))


class FPEM(nn.Module):
    """One feature pyramid enhancement: three top-down upsample-adds, then
    three bottom-up adds through stride-2 separable convolutions."""

    def __init__(self, channels: int = 128):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f'up_add{i}', SeparableConv(channels, 1))
            setattr(self, f'down_add{i}', SeparableConv(channels, 2))

    @staticmethod
    def _add(x, y):
        return resize_nearest(x, y.shape[2:]) + y

    def forward(self, c2, c3, c4, c5):
        c4 = self.up_add1(self._add(c5, c4))
        c3 = self.up_add2(self._add(c4, c3))
        c2 = self.up_add3(self._add(c3, c2))
        c3 = self.down_add1(self._add(c3, c2))
        c4 = self.down_add2(self._add(c4, c3))
        c5 = self.down_add3(self._add(c5, c4))
        return c2, c3, c4, c5


def _reduce(cin: int, cout: int) -> nn.Sequential:
    """1x1 conv with bias, BN, ReLU: MMOCR's ``reduce_conv_c*``."""
    return nn.Sequential(nn.Conv2d(cin, cout, 1), BatchNorm2d(cout, eps=1e-5),
                         nn.ReLU())


@NECKS.register_module()
class FPEM_FFM(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 256, 512),
                 conv_out: int = 128, fpem_repeat: int = 2, **kwargs):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f'reduce_conv_c{i + 2}', _reduce(c, conv_out))
        self.fpems = nn.ModuleList(FPEM(conv_out) for _ in range(fpem_repeat))
        self.out_channels = conv_out * len(in_channels)

    def forward(self, inputs):
        """NCHW C2-C5 -> the fused levels at C2's size (a tuple, NCHW)."""
        cs = [getattr(self, f'reduce_conv_c{i + 2}')(x)
              for i, x in enumerate(inputs)]
        ffm = None
        for fpem in self.fpems:
            cs = fpem(*cs)
            ffm = cs if ffm is None else tuple(a + b
                                               for a, b in zip(ffm, cs))
        size = ffm[0].shape[2:]
        return (ffm[0],) + tuple(resize_bilinear(f, size) for f in ffm[1:])


@NECKS.register_module()
class FPNF(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, fusion_type: str = 'concat',
                 **kwargs):
        super().__init__()
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, use_norm=True)
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       use_norm=True) for _ in range(n - 1))
        self.fusion_type = fusion_type
        fused = out_channels * n if fusion_type == 'concat' else out_channels
        self.output_convs = ConvModule(fused, out_channels, 3, padding=1,
                                       use_norm=True)
        self.out_channels = out_channels

    def forward(self, inputs):
        lat = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = self.fpn_convs[i - 1](
                lat[i - 1] + resize_nearest(lat[i], lat[i - 1].shape[2:]))
        size = lat[0].shape[2:]
        ups = [lat[0]] + [resize_nearest(la, size) for la in lat[1:]]
        out = torch.cat(ups, dim=1) if self.fusion_type == 'concat' \
            else sum(ups)
        return self.output_convs(out)


@HEADS.register_module()
class PANHead(nn.Module):
    """The neck's levels concatenated, a 1x1 convolution to the raw
    logits: 6 for PANet (text, kernel, a 4-d embedding), 7 for PSENet
    (text and six kernels)."""

    def __init__(self, in_channels: int = 512, out_channels: int = 6,
                 **kwargs):
        super().__init__()
        if isinstance(in_channels, (list, tuple)):
            in_channels = sum(in_channels)
        self.out_conv = nn.Conv2d(int(in_channels), out_channels, 1)

    def forward(self, inputs):
        x = torch.cat(inputs, dim=1) if isinstance(inputs, (tuple, list)) \
            else inputs
        return self.out_conv(x)


HEADS.register_module(name='PSEHead')(PANHead)


class PANetModule(nn.Module):
    """backbone -> FPEM_FFM or FPNF -> PANHead; NHWC image in, NHWC logits
    (N, H / 4, W / 4, C) out."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.neck(self.backbone(img))).permute(0, 2, 3, 1)


def _dice_loss_with_logits(pred, target, mask, smooth=0.001):
    """Each image's dice on sigmoided logits (reference
    ``pan_loss.py:258-276``)."""
    n = pred.shape[0]
    pred = torch.sigmoid(pred.float()).reshape(n, -1)
    target = (target > 0.5).float().reshape(n, -1)
    mask = mask.reshape(n, -1)
    pred = pred * mask
    target = target * mask
    a = (pred * target).sum(1) + smooth
    b = (pred * pred).sum(1) + smooth
    c = (target * target).sum(1) + smooth
    return 1 - 2 * a / (b + c)


def _ohem_mask(score, gt_text, gt_mask, ohem_ratio):
    """The OHEM mask (reference ``pan_loss.py:278-311``) in JAX's threshold
    form: the negatives scoring at least the k-th largest negative score,
    k = min(ratio #pos, #neg), with the positives, inside the effective
    mask; the whole effective mask where there is no positive or no
    negative. ``score`` carries no gradient."""
    n = score.shape[0]
    score = score.reshape(n, -1)
    gt_text = gt_text.reshape(n, -1)
    gt_mask = gt_mask.reshape(n, -1)
    pos = (gt_text > 0.5).float()
    pos_num = (pos * (gt_mask > 0.5).float()).sum(1)
    neg = 1.0 - pos
    neg_num = torch.minimum(pos_num * ohem_ratio, neg.sum(1))
    neg_scores = torch.where(neg > 0, score,
                             torch.full_like(score, float('-inf')))
    sorted_neg = torch.sort(neg_scores, dim=1, descending=True).values
    idx = (neg_num.long() - 1).clamp(0, sorted_neg.shape[1] - 1)
    thr = sorted_neg.gather(1, idx[:, None])
    sampled = (((score >= thr) & (neg > 0)) | (pos > 0)) & (gt_mask > 0.5)
    degen = (pos_num < 1) | (neg_num < 1)
    return torch.where(degen[:, None], gt_mask > 0.5,
                       sampled).float()


@LOSSES.register_module()
class PANLoss:
    """Reference ``losses/pan_loss.py`` over a static instance axis, as
    JAX: targets ``gt_texts`` and ``gt_kernels`` (instance labels) and
    ``gt_mask``, (N, H, W) at the logits' size."""

    def __init__(self, alpha=0.5, beta=0.25, delta_aggregation=0.5,
                 delta_discrimination=3, ohem_ratio=3, reduction='mean',
                 max_instances=24, **kwargs):
        self.alpha = alpha
        self.beta = beta
        self.delta_aggregation = delta_aggregation
        self.delta_discrimination = delta_discrimination
        self.ohem_ratio = ohem_ratio
        self.reduction = reduction
        self.max_instances = max_instances

    @staticmethod
    def _safe_norm(x, dim):
        # a norm whose gradient stays bounded at 0 (masked-out instances
        # sit at exactly 0)
        return torch.sqrt(torch.clamp((x * x).sum(dim), min=1e-12))

    def _aggr_discr(self, texts, kernels, embed):
        """texts / kernels: (N, P) instance labels; embed: (N, P, 4)."""
        imax = self.max_instances
        inst = torch.arange(1, imax + 1, device=embed.device,
                            dtype=texts.dtype)
        t_mask = (texts[:, None, :] == inst[None, :, None]).float()
        k_mask = (kernels[:, None, :] == inst[None, :, None]).float()
        t_cnt = t_mask.sum(-1)
        k_cnt = k_mask.sum(-1)
        vf = ((t_cnt > 0) & (k_cnt > 0)).float()
        avg = torch.einsum('nip,npc->nic', k_mask, embed) / torch.clamp(
            k_cnt, min=1.0)[..., None]
        dist = self._safe_norm(embed[:, None] - avg[:, :, None], -1)
        hinge = torch.clamp(dist - self.delta_aggregation, min=0.0) ** 2
        lg = torch.log(hinge + 1.0) * t_mask
        aggr_i = lg.sum(-1) / torch.clamp(t_cnt, min=1.0)
        n_inst = vf.sum(-1)
        loss_aggr = (aggr_i * vf).sum(-1) / torch.clamp(n_inst, min=1.0)
        pair_d = self._safe_norm(avg[:, :, None] - avg[:, None], -1)
        pair_hinge = torch.clamp(self.delta_discrimination - pair_d,
                                 min=0.0) ** 2
        eye = torch.eye(imax, device=embed.device)
        pair_valid = vf[:, :, None] * vf[:, None] * (1 - eye[None])
        discr_sum = (torch.log(pair_hinge + 1.0) * pair_valid).sum(
            (-2, -1)) / 2
        denom = torch.clamp(n_inst * (n_inst - 1), min=1.0)
        loss_discr = torch.where(n_inst > 1, 2 * discr_sum / denom,
                                 torch.zeros_like(discr_sum))
        return loss_aggr, loss_discr

    def __call__(self, preds: torch.Tensor, targets) -> Dict:
        """preds: (N, H, W, 6) raw logits."""
        preds = preds.float()
        pred_text, pred_kernel = preds[..., 0], preds[..., 1]
        embed = preds[..., 2:]
        gt_texts = targets['gt_texts']
        gt_kernels = targets['gt_kernels']
        gt_mask = targets['gt_mask'].float()
        n = pred_text.shape[0]
        loss_aggr, loss_discr = self._aggr_discr(
            gt_texts.reshape(n, -1), gt_kernels.reshape(n, -1),
            embed.reshape(n, -1, embed.shape[-1]))
        text_bin = (gt_texts > 0.5).float()
        sampled = _ohem_mask(pred_text.detach(), text_bin, gt_mask,
                             self.ohem_ratio)
        loss_text = _dice_loss_with_logits(pred_text, text_bin, sampled)
        loss_kernel = _dice_loss_with_logits(
            pred_kernel, (gt_kernels > 0.5).float(), text_bin * gt_mask)
        red = torch.mean if self.reduction == 'mean' else torch.sum
        return {
            'loss_text': red(loss_text),
            'loss_kernel': self.alpha * red(loss_kernel),
            'loss_aggregation': self.beta * red(loss_aggr),
            'loss_discrimination': self.beta * red(loss_discr),
        }


@LOSSES.register_module()
class PSELoss:
    """Reference ``losses/pse_loss.py``: the OHEM text dice and the mean
    kernel dice; targets ``gt_kernels`` (N, K + 1, H, W) binary, level 0
    the text, and ``gt_mask``."""

    def __init__(self, alpha=0.7, ohem_ratio=3, reduction='mean',
                 kernel_sample_type='adaptive', **kwargs):
        self.alpha = alpha
        self.ohem_ratio = ohem_ratio
        self.reduction = reduction
        self.kernel_sample_type = kernel_sample_type

    def __call__(self, preds: torch.Tensor, targets) -> Dict:
        """preds: (N, H, W, K + 1) raw logits."""
        preds = preds.float()
        pred_text = preds[..., 0]
        gt_kernels = targets['gt_kernels'].float()
        gt_mask = targets['gt_mask'].float()
        sampled = _ohem_mask(pred_text.detach(), gt_kernels[:, 0], gt_mask,
                             self.ohem_ratio)
        loss_text = _dice_loss_with_logits(pred_text, gt_kernels[:, 0],
                                           sampled)
        if self.kernel_sample_type == 'hard':
            k_mask = (gt_kernels[:, 0] > 0.5).float() * gt_mask
        else:                       # 'adaptive' (pse_loss.py:82-84)
            k_mask = (pred_text > 0).float() * gt_mask
        num_kernel = preds.shape[-1] - 1
        loss_k = 0.
        for i in range(num_kernel):
            loss_k = loss_k + _dice_loss_with_logits(
                preds[..., 1 + i], gt_kernels[:, 1 + i], k_mask)
        loss_k = loss_k / num_kernel
        red = torch.mean if self.reduction == 'mean' else torch.sum
        return {'loss_text': self.alpha * red(loss_text),
                'loss_kernel': (1 - self.alpha) * red(loss_k)}
