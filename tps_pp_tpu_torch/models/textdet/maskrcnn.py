"""OCRMaskRCNN, the two-stage instance-mask text detector (counterpart of
``tps_pp_tpu/models/textdet/maskrcnn.py``; the reference subclasses
mmdet's ``MaskRCNN`` with the anchors of
``configs/_base_/det_models/ocr_mask_rcnn_r50_fpn_ohem.py``: one scale, 4,
five text-shaped ratios, one class-agnostic text class).

Split as in the JAX package:

* on the card (``nn.Module``, mmdet's names): ``MaskRCNNModule`` is
  backbone -> ``FPNDet`` -> a fifth, stride-64 level (``max_pool2d(P5, 1,
  2)``) -> ``RPNHead`` (``rpn_conv`` 3x3 shared by the levels, then
  ``rpn_cls`` to A logits and ``rpn_reg`` to 4A deltas, each a (N, H, W,
  A) / (N, H, W, 4A) NHWC map, so that flattening it gives JAX's pixel-major,
  anchor-minor order with the 4 deltas innermost); ``roi_head.bbox_head``
  (``shared_fcs.0/1`` of ``fc_out``, ``fc_cls`` to [background, text],
  ``fc_reg`` to 4 class-agnostic deltas) over a 7x7 RoI flattened (C, 7,
  7) as mmdet flattens it (JAX flattens (7, 7, C): ``utils/convert.py``
  permutes the first layer's rows, kind ``'linear_hwc7'``); and
  ``roi_head.mask_head`` (``convs.0-3.conv`` 3x3, ``upsample`` a 2x2
  stride-2 transposed convolution, ``conv_logits`` 1x1) from 14x14 RoIs
  to (n, 28, 28) logits. ``layers.roi_align`` (shared with SDMGR) pools
  RoIs from the (B, C, H, W) levels with bin-centre bilinear samples, one
  gather of the four taps (JAX's ``roi_align_jax``), differentiable
  through autograd: the serving path and training pool on the card.
* on the host (numpy, copies of JAX's): the anchors (``generate_anchors``,
  centres at ``stride * i + stride / 2``, JAX's choice, not mmdet's offset
  0), the box coders (``delta2bbox`` with ``dw`` / ``dh`` clipped at 4,
  ``bbox2delta``), ``bbox_iou_matrix``, ``nms_xyxy``, the proposals
  (``MaskRCNNDetector.proposals``: sigmoid, a per-level top
  ``pre_nms_top_n`` by ``argpartition``, decode, clip, ``wh > 2``, NMS at
  0.7 to ``post_nms_top_n``), each RoI's level (``roi_levels``:
  ``clip(floor(log2(sqrt(area) / 56 + 1e-6)) + 2, 0, L - 2)``), the
  detections (softmax's text score over ``score_thr``, decoded with stds
  (0.1, 0.1, 0.2, 0.2), NMS at 0.5), the paste (the mask's sigmoid resized
  to its box by ``cv_ops.resize_f32``, cut at ``mask_thr``,
  ``points2boundary``), and training's targets: ``rpn_targets``,
  ``sample_rois`` (mmdet's ``RandomSampler`` from a
  ``numpy.random.Generator``), ``make_mask_targets``
  (``cv_ops.resize_inter_nearest`` of float32 crops). ``roi_align_np`` is
  the host oracle (``drrg.roi_align_rotated_np`` at angle 0).

``MaskRCNNDetector`` serves a batch of pages from one forward: only the
RPN maps come to the host (3.4 MB a 640 x 640 page), the proposals and
their NMS run there, the pooling and both heads run on the card over every
page's RoIs at once, and only the heads' outputs come back (the masks as
(n, 28, 28)); the levels never leave the card. Training is JAX's
``_train_maskrcnn`` step: an eval-mode forward whose RPN maps give the
proposals, the host's targets and RoI sample, then the train-mode forward
(BatchNorm over one page), each RoI pooled from its own level only (JAX
sums the four levels' poolings times a one-hot of the level: the same
values and gradients), and the five losses.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...datasets.pipelines import cv_ops
from ...registry import HEADS
from ..layers import roi_align
from .dbnet import _Conv
from .drrg import roi_align_rotated_np
from .postprocess import points2boundary

STRIDES = (4, 8, 16, 32, 64)
BOX_STDS = (0.1, 0.1, 0.2, 0.2)


# ----------------------------------------------------------- host: boxes --

def generate_anchors(feat_shapes: Sequence[Tuple[int, int]],
                     strides=STRIDES, scales=(4,),
                     ratios=(0.17, 0.44, 1.13, 2.90, 7.46)
                     ) -> List[np.ndarray]:
    """Per-level (H*W*A, 4) xyxy anchors, pixel-major, anchor-minor."""
    out = []
    for (h, w), stride in zip(feat_shapes, strides):
        base = []
        for scale in scales:
            size = scale * stride
            for r in ratios:
                aw = size / np.sqrt(r)
                ah = size * np.sqrt(r)
                base.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
        base = np.asarray(base, np.float32)              # (A, 4)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        centers = np.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4) * stride \
            + stride / 2
        out.append((centers + base[None]).reshape(-1, 4).astype(np.float32))
    return out


@functools.lru_cache(maxsize=8)
def cached_anchors(feat_shapes: Tuple[Tuple[int, int], ...],
                   strides: Tuple[int, ...]) -> Tuple[np.ndarray, ...]:
    """``generate_anchors`` of one input size, kept (read-only) for the
    next image of that size."""
    out = tuple(generate_anchors(feat_shapes, strides))
    for a in out:
        a.flags.writeable = False
    return out


def delta2bbox(anchors: np.ndarray, deltas: np.ndarray,
               stds=(1., 1., 1., 1.)) -> np.ndarray:
    """mmdet's ``DeltaXYWHBBoxCoder`` decode."""
    w = anchors[:, 2] - anchors[:, 0]
    h = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + w / 2
    cy = anchors[:, 1] + h / 2
    dx, dy, dw, dh = (deltas[:, i] * stds[i] for i in range(4))
    dw = np.clip(dw, -4.0, 4.0)
    dh = np.clip(dh, -4.0, 4.0)
    ncx, ncy = cx + dx * w, cy + dy * h
    nw, nh = w * np.exp(dw), h * np.exp(dh)
    return np.stack([ncx - nw / 2, ncy - nh / 2,
                     ncx + nw / 2, ncy + nh / 2], -1)


def bbox2delta(anchors: np.ndarray, gts: np.ndarray,
               stds=(1., 1., 1., 1.)) -> np.ndarray:
    """The deltas that ``delta2bbox`` decodes ``anchors`` to ``gts`` with
    (widths at least 1e-3)."""
    w = np.maximum(anchors[:, 2] - anchors[:, 0], 1e-3)
    h = np.maximum(anchors[:, 3] - anchors[:, 1], 1e-3)
    cx = anchors[:, 0] + w / 2
    cy = anchors[:, 1] + h / 2
    gw = np.maximum(gts[:, 2] - gts[:, 0], 1e-3)
    gh = np.maximum(gts[:, 3] - gts[:, 1], 1e-3)
    gcx = gts[:, 0] + gw / 2
    gcy = gts[:, 1] + gh / 2
    d = np.stack([(gcx - cx) / w, (gcy - cy) / h,
                  np.log(gw / w), np.log(gh / h)], -1)
    return d / np.asarray(stds, np.float32)


def bbox_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area_a = np.prod(a[:, 2:] - a[:, :2], -1)
    area_b = np.prod(b[:, 2:] - b[:, :2], -1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-6)


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, thr: float,
             max_out: int) -> np.ndarray:
    """Greedy NMS: the indices kept, best first, at most ``max_out``."""
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0 and len(keep) < max_out:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = bbox_iou_matrix(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= thr]
    return np.asarray(keep, np.int64)


def roi_levels(boxes: np.ndarray, n_levels: int) -> np.ndarray:
    """Each box's FPN level (mmdet's ``SingleRoIExtractor`` with
    ``finest_scale`` 56), never the last (stride-64) level."""
    areas = np.prod(np.maximum(boxes[:, 2:] - boxes[:, :2], 1), -1)
    return np.clip(np.floor(np.log2(np.sqrt(areas) / 56 + 1e-6)) + 2,
                   0, n_levels - 2).astype(int)


def roi_align_np(feat: np.ndarray, boxes: np.ndarray,
                 out_size: Tuple[int, int]) -> np.ndarray:
    """Axis-aligned RoIAlign over one level's (H, W, C) map, boxes xyxy in
    the level's coordinates: (N, out_h, out_w, C) (the host oracle of
    ``roi_align``)."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    w = np.maximum(boxes[:, 2] - boxes[:, 0], 1.0)
    h = np.maximum(boxes[:, 3] - boxes[:, 1], 1.0)
    rois = np.stack([cx, cy, w, h, np.zeros_like(cx)], -1)
    return roi_align_rotated_np(feat, rois, out_size)


# ---------------------------------------------------------- the card --

@HEADS.register_module()
class RPNHead(nn.Module):
    """mmdet's ``RPNHead``: ``rpn_conv`` (3x3, ReLU) shared by the levels,
    then ``rpn_cls`` (A objectness logits) and ``rpn_reg`` (4A deltas),
    1x1; ``in_channels`` defaults to the neck's."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 5):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats):
        """NCHW levels -> a (cls (N, H, W, A), reg (N, H, W, 4A)) NHWC pair
        a level."""
        outs = []
        for f in feats:
            x = F.relu(self.rpn_conv(f))
            outs.append((self.rpn_cls(x).permute(0, 2, 3, 1),
                         self.rpn_reg(x).permute(0, 2, 3, 1)))
        return tuple(outs)


class BoxHead(nn.Module):
    """mmdet's ``Shared2FCBBoxHead``, class-agnostic: a (C, 7, 7) RoI
    flattened, ``shared_fcs.0/1`` (ReLU), ``fc_cls`` to [background,
    text] logits, ``fc_reg`` to 4 deltas."""

    def __init__(self, in_channels: int = 256, fc_out: int = 1024):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * 49, fc_out),
            nn.Linear(fc_out, fc_out)])
        self.fc_cls = nn.Linear(fc_out, 2)
        self.fc_reg = nn.Linear(fc_out, 4)

    def forward(self, rois):
        """(n, C, 7, 7) -> (cls (n, 2), deltas (n, 4))."""
        x = rois.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class MaskHead(nn.Module):
    """mmdet's ``FCNMaskHead``, class-agnostic: ``convs.0-3.conv`` (3x3,
    ReLU), ``upsample`` (2x2 stride-2 transposed, ReLU; flax's
    ``ConvTranspose`` with ``'SAME'`` padding, its kernel flipped),
    ``conv_logits`` (1x1 to one map)."""

    def __init__(self, in_channels: int = 256, channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            _Conv(in_channels if i == 0 else channels, channels, 3,
                  bias=True) for i in range(4))
        self.upsample = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(channels, 1, 1)

    def forward(self, rois):
        """(n, C, 14, 14) -> (n, 28, 28) logits."""
        x = rois
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.conv_logits(F.relu(self.upsample(x)))[:, 0]


class RoIHead(nn.Module):
    """mmdet's ``StandardRoIHead``'s two heads (``bbox_head``,
    ``mask_head``); the pooling is ``roi_align``."""

    def __init__(self, bbox_head: BoxHead, mask_head: MaskHead):
        super().__init__()
        self.bbox_head = bbox_head
        self.mask_head = mask_head


class MaskRCNNModule(nn.Module):
    """backbone -> FPN (+ a stride-64 level) -> RPN; the RoI heads are
    called on pooled RoIs (``MaskRCNNDetector``)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: RPNHead, roi_head: RoIHead):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = roi_head

    def features(self, img: torch.Tensor):
        """NHWC image -> the five NCHW levels (strides 4-64)."""
        levels = list(self.neck(self.backbone(img)))
        levels.append(F.max_pool2d(levels[-1], 1, 2))
        return tuple(levels)

    def forward(self, img: torch.Tensor):
        """NHWC image -> (levels, ``rpn_head``'s pairs)."""
        levels = self.features(img)
        return levels, self.rpn_head(levels)


# ------------------------------------------------------------ the losses --

def rpn_loss(rpn_outs, labels: torch.Tensor, deltas: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """Objectness BCE over the assigned anchors (label >= 0) and L1 of the
    deltas over the positive ones (labels (M,) 1 / 0 / -1 ignored, in the
    anchors' order)."""
    cls = torch.cat([c.reshape(-1) for c, _ in rpn_outs])
    reg = torch.cat([r.reshape(-1, 4) for _, r in rpn_outs])
    valid = (labels >= 0).to(cls.dtype)
    pos = (labels == 1).to(cls.dtype)
    bce = -(pos * F.logsigmoid(cls) + (1 - pos) * F.logsigmoid(-cls)) * valid
    loss_cls = bce.sum() / torch.clamp(valid.sum(), min=1.0)
    l1 = (reg - deltas).abs().sum(-1) * pos
    loss_box = l1.sum() / torch.clamp(pos.sum(), min=1.0)
    return {'loss_rpn_cls': loss_cls, 'loss_rpn_bbox': loss_box}


def roi_head_losses(cls_logits, pred_deltas, mask_logits, labels, deltas,
                    mask_targets) -> Dict[str, torch.Tensor]:
    """Second-stage losses (mmdet's ``Shared2FCBBoxHead`` and
    ``FCNMaskHead``): cross entropy over [background, text], L1 of the
    deltas on the positives, per-pixel BCE of the (n, 28, 28) masks
    averaged a RoI, over the positives."""
    pos = (labels == 1).to(cls_logits.dtype)
    logp = F.log_softmax(cls_logits, -1)
    loss_cls = -logp.gather(1, labels.long()[:, None]).mean()
    l1 = (pred_deltas - deltas).abs().sum(-1)
    npos = torch.clamp(pos.sum(), min=1.0)
    loss_bbox = (l1 * pos).sum() / npos
    m, t = mask_logits, mask_targets
    bce = torch.clamp(m, min=0) - m * t + torch.log1p(torch.exp(-m.abs()))
    loss_mask = (bce.mean(dim=(1, 2)) * pos).sum() / npos
    return {'loss_cls': loss_cls, 'loss_bbox': loss_bbox,
            'loss_mask': loss_mask}


# ------------------------------------------------ host: training targets --

def sample_rois(proposals, gt_boxes, num=64, pos_fraction=0.25,
                pos_thr=0.5, rng=None):
    """The second stage's RoIs (mmdet's ``RandomSampler``): the proposals
    and the gt boxes, at most ``num * pos_fraction`` positives (IoU >=
    ``pos_thr``), negatives for the rest (drawn with replacement where too
    few; the first positive repeated where there is none); (rois (num, 4),
    labels (num,), target deltas (num, 4), matched gt (num,)), or None
    without a candidate."""
    rng = rng or np.random.default_rng(0)
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    cand = np.concatenate([proposals, gt_boxes], axis=0) \
        if len(gt_boxes) else proposals
    if len(cand) == 0:
        return None
    if len(gt_boxes):
        iou = bbox_iou_matrix(cand, gt_boxes)
        best, arg = iou.max(1), iou.argmax(1)
    else:
        best = np.zeros(len(cand))
        arg = np.zeros(len(cand), np.int64)
    pos_inds = np.nonzero(best >= pos_thr)[0]
    neg_inds = np.nonzero(best < pos_thr)[0]
    n_pos = min(len(pos_inds), int(num * pos_fraction))
    pos_pick = rng.choice(pos_inds, n_pos, replace=False) if n_pos else \
        np.zeros(0, np.int64)
    n_neg = num - n_pos
    neg_pick = (rng.choice(neg_inds, n_neg,
                           replace=len(neg_inds) < n_neg)
                if len(neg_inds) else
                np.repeat(pos_pick[:1] if n_pos else np.zeros(1, np.int64),
                          n_neg))
    pick = np.concatenate([pos_pick, neg_pick]).astype(np.int64)
    rois = cand[pick]
    labels = (best[pick] >= pos_thr).astype(np.int32)
    deltas = np.zeros((num, 4), np.float32)
    if len(gt_boxes):
        deltas = bbox2delta(rois, gt_boxes[arg[pick]], stds=BOX_STDS)
    return rois, labels, deltas, arg[pick]


def make_mask_targets(rois, gt_masks, matched_idx, out_size=28):
    """Each RoI's matched gt mask (index < 0: none) cropped to the RoI and
    resized to ``out_size`` square, nearest: (n, out_size, out_size)."""
    out = np.zeros((len(rois), out_size, out_size), np.float32)
    for i, (roi, gi) in enumerate(zip(rois, matched_idx)):
        if gi < 0 or gi >= len(gt_masks):
            continue
        x0, y0, x1, y1 = [int(v) for v in roi]
        H, W = gt_masks[gi].shape
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(max(x1, x0 + 1), W), min(max(y1, y0 + 1), H)
        crop = gt_masks[gi][y0:y1, x0:x1].astype(np.float32)
        if crop.size:
            out[i] = cv_ops.resize_inter_nearest(crop, out_size, out_size)
    return out


def poly_boxes_masks(polys, h: int, w: int):
    """gt polygons -> their xyxy boxes (n, 4) and (h, w) uint8 masks
    (``cv_ops.fill_poly`` of the int32 points); polygons of fewer than 3
    points left out (JAX's ``apis/train_det.py`` ``_poly_boxes_masks``)."""
    boxes, masks = [], []
    for p in polys:
        pts = np.asarray(p, np.float32).reshape(-1, 2)
        if len(pts) < 3:
            continue
        boxes.append([pts[:, 0].min(), pts[:, 1].min(),
                      pts[:, 0].max(), pts[:, 1].max()])
        m = np.zeros((h, w), np.uint8)
        cv_ops.fill_poly(m, [pts.astype(np.int32)], 1)
        masks.append(m)
    return np.asarray(boxes, np.float32).reshape(-1, 4), masks


# ------------------------------------------------------- the detector --

class MaskRCNNDetector:
    """Serving and training around a ``MaskRCNNModule`` (the reference's
    ``OCRMaskRCNN.simple_test`` / ``forward_train``): the host's stages
    and the card's pooling and heads, each a method (the JAX
    ``MaskRCNNDetector``'s options)."""

    def __init__(self, model: MaskRCNNModule, strides=STRIDES,
                 pre_nms_top_n=1000, post_nms_top_n=100, rpn_nms_thr=0.7,
                 score_thr=0.5, mask_thr=0.5, text_repr_type='quad',
                 num_train_rois=64):
        self.model = model
        self.strides = strides
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.rpn_nms_thr = rpn_nms_thr
        self.score_thr = score_thr
        self.mask_thr = mask_thr
        self.text_repr_type = text_repr_type
        self.num_train_rois = num_train_rois

    # ---------------------------------------------------------- serving
    @staticmethod
    def host_rpn(rpn_outs) -> List[List[Tuple[np.ndarray, np.ndarray]]]:
        """The RPN's maps on the host, one list of (cls (H, W, A), reg (H,
        W, 4A)) a level for each image."""
        levels = [(c.cpu().numpy(), r.cpu().numpy()) for c, r in rpn_outs]
        return [[(c[b], r[b]) for c, r in levels]
                for b in range(len(levels[0][0]))]

    def proposals(self, rpn_np, img_hw) -> Tuple[np.ndarray, np.ndarray]:
        """One image's RPN maps -> its NMS'd proposals (n, 4) in image
        coordinates and their scores."""
        H, W = img_hw
        anchors = cached_anchors(tuple(c.shape[:2] for c, _ in rpn_np),
                                 tuple(self.strides))
        boxes_all, scores_all = [], []
        for (cls_map, reg_map), anc in zip(rpn_np, anchors):
            scores = 1 / (1 + np.exp(-cls_map.reshape(-1)))
            deltas = reg_map.reshape(-1, 4)
            k = min(self.pre_nms_top_n, len(scores))
            top = np.argpartition(-scores, k - 1)[:k]
            boxes = delta2bbox(anc[top], deltas[top])
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
            boxes_all.append(boxes)
            scores_all.append(scores[top])
        boxes = np.concatenate(boxes_all)
        scores = np.concatenate(scores_all)
        wh = boxes[:, 2:] - boxes[:, :2]
        valid = (wh > 2).all(-1)
        boxes, scores = boxes[valid], scores[valid]
        if len(boxes) == 0:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        keep = nms_xyxy(boxes, scores, self.rpn_nms_thr, self.post_nms_top_n)
        return boxes[keep], scores[keep]

    def pool(self, levels, boxes: Sequence[np.ndarray],
             out_size: Tuple[int, int]) -> torch.Tensor:
        """Each image's boxes (image coordinates, on the host) pooled from
        its own level (``roi_levels``) of the card's ``levels``: (sum n, C,
        out_h, out_w) in the boxes' order, on the levels' device."""
        dev = levels[0].device
        rois = np.concatenate(boxes).astype(np.float32)
        image = np.concatenate([np.full(len(b), i, np.int64)
                                for i, b in enumerate(boxes)])
        return self.pool_rois(levels, torch.from_numpy(rois).to(dev),
                              roi_levels(rois, len(levels)),
                              torch.from_numpy(image).to(dev), out_size)

    def pool_rois(self, levels, rois: torch.Tensor, lvl: np.ndarray,
                  image: Optional[torch.Tensor],
                  out_size: Tuple[int, int]) -> torch.Tensor:
        """``rois`` (N, 4) on the card, RoI i pooled from level ``lvl[i]``
        (host ints) of image ``image[i]`` (0 where None)."""
        order = np.argsort(lvl, kind='stable')
        parts = []
        for li in np.unique(lvl):
            sel = torch.from_numpy(order[lvl[order] == li]).to(rois.device)
            parts.append(roi_align(
                levels[li], rois[sel] / self.strides[li], out_size,
                None if image is None else image[sel]))
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        return torch.cat(parts).index_select(
            0, torch.from_numpy(inverse).to(rois.device))

    @torch.inference_mode()
    def box_outputs(self, levels, proposals: Sequence[np.ndarray]
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """The box head on every image's proposals at once: each image's
        softmax (n, 2) and deltas (n, 4) on the host."""
        cls, deltas = self.model.roi_head.bbox_head(
            self.pool(levels, proposals, (7, 7)))
        out = torch.cat([torch.softmax(cls, -1), deltas], -1).cpu().numpy()
        cuts = np.cumsum([len(p) for p in proposals])[:-1]
        parts = np.split(out, cuts)
        return [p[:, :2] for p in parts], [p[:, 2:] for p in parts]

    def detections(self, proposals: np.ndarray, probs: np.ndarray,
                   deltas: np.ndarray, img_hw) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """One image's boxes and scores: text scores above ``score_thr``,
        decoded, clipped, NMS at 0.5."""
        H, W = img_hw
        scores = probs[:, 1]
        keep = scores > self.score_thr
        if not keep.any():
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        boxes = delta2bbox(proposals[keep], deltas[keep], stds=BOX_STDS)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
        scores = scores[keep]
        k2 = nms_xyxy(boxes, scores, 0.5, self.post_nms_top_n)
        return boxes[k2], scores[k2]

    @torch.inference_mode()
    def mask_outputs(self, levels, boxes: Sequence[np.ndarray]
                     ) -> List[np.ndarray]:
        """The mask head on every image's boxes at once: each image's (n,
        28, 28) logits on the host."""
        logits = self.model.roi_head.mask_head(
            self.pool(levels, boxes, (14, 14))).cpu().numpy()
        return np.split(logits, np.cumsum([len(b) for b in boxes])[:-1])

    def paste(self, boxes: np.ndarray, scores: np.ndarray,
              mask_logits: np.ndarray, img_hw) -> List[np.ndarray]:
        """One image's boundaries: each mask's sigmoid resized to its box
        (``cv_ops.resize_f32``), cut at ``mask_thr``, its pixels in raster
        order through ``points2boundary`` (JAX pastes into a page-sized
        mask and reads it back: the same points; a box on the right or
        bottom edge keeps the part of its mask on the page)."""
        H, W = img_hw
        out = []
        for box, score, mlog in zip(boxes, scores, mask_logits):
            x0, y0, x1, y1 = box.astype(int)
            bw, bh = max(x1 - x0, 1), max(y1 - y0, 1)
            m = cv_ops.resize_f32(1 / (1 + np.exp(-mlog)), bw, bh)
            m = m[:max(min(bh, H - y0), 0), :max(min(bw, W - x0), 0)]
            pts = np.argwhere(m > self.mask_thr)[:, ::-1] + (x0, y0)
            if len(pts) == 0:
                continue
            b = points2boundary(pts, self.text_repr_type, float(score))
            if b is not None:
                out.append(b)
        return out

    def __call__(self, levels, rpn_np, img_hw) -> List[List[np.ndarray]]:
        """The card's levels of a batch and each image's host RPN maps ->
        each image's boundaries [x1, y1, ..., score] at the input's
        scale."""
        props = [self.proposals(r, img_hw)[0] for r in rpn_np]
        n = len(props)
        if not any(len(p) for p in props):
            return [[] for _ in range(n)]
        probs, deltas = self.box_outputs(levels, props)
        dets = [self.detections(p, c, d, img_hw)
                for p, c, d in zip(props, probs, deltas)]
        boxes = [b for b, _ in dets]
        if not any(len(b) for b in boxes):
            return [[] for _ in range(n)]
        masks = self.mask_outputs(levels, boxes)
        return [self.paste(b, s, m, img_hw)
                for (b, s), m in zip(dets, masks)]

    # --------------------------------------------------------- training
    def rpn_targets(self, feat_shapes, gt_boxes, img_hw, pos_thr=0.7,
                    neg_thr=0.3) -> Tuple[np.ndarray, np.ndarray]:
        """Every anchor's label (1 positive, 0 negative, -1 ignored; each
        gt's best anchor positive) and target deltas (M, 4)."""
        anchors = np.concatenate(cached_anchors(
            tuple(tuple(s) for s in feat_shapes), tuple(self.strides)))
        labels = np.full((len(anchors),), -1, np.int32)
        deltas = np.zeros((len(anchors), 4), np.float32)
        if len(gt_boxes):
            iou = bbox_iou_matrix(anchors, np.asarray(gt_boxes, np.float32))
            best = iou.max(1)
            arg = iou.argmax(1)
            labels[best < neg_thr] = 0
            labels[best >= pos_thr] = 1
            labels[iou.argmax(0)] = 1          # each gt's best anchor
            pos = labels == 1
            deltas[pos] = bbox2delta(anchors[pos],
                                     np.asarray(gt_boxes)[arg[pos]])
        else:
            labels[:] = 0
        return labels, deltas

    def train_targets(self, rpn_np, img_hw, gt_boxes, gt_masks, rng
                      ) -> Optional[Dict[str, np.ndarray]]:
        """The host half of a training step from one page's RPN maps (an
        eval-mode forward of the current weights): anchor targets, the
        proposals, the sampled RoIs with their labels, deltas, levels and
        mask targets; None without a candidate."""
        feat_shapes = [c.shape[:2] for c, _ in rpn_np]
        rpn_labels, rpn_deltas = self.rpn_targets(feat_shapes, gt_boxes,
                                                  img_hw)
        proposals, _ = self.proposals(rpn_np, img_hw)
        sampled = sample_rois(proposals, gt_boxes, num=self.num_train_rois,
                              rng=rng)
        if sampled is None:
            return None
        rois, labels, deltas, midx = sampled
        mask_targets = make_mask_targets(
            rois, gt_masks, np.where(labels == 1, midx, -1), out_size=28)
        return dict(rpn_labels=rpn_labels, rpn_deltas=rpn_deltas,
                    rois=rois.astype(np.float32),
                    lvl=roi_levels(rois, len(feat_shapes)), labels=labels,
                    deltas=deltas, mask_targets=mask_targets)

    def eval_rpn(self, img: torch.Tensor):
        """The RPN maps of the page ``img`` (1, H, W, 3) on the host, from
        an eval-mode forward without gradients (the model's mode kept)."""
        was = self.model.training
        self.model.eval()
        with torch.no_grad():
            rpn_np = self.host_rpn(self.model(img)[1])[0]
        self.model.train(was)
        return rpn_np

    def sample_train_batch(self, img: torch.Tensor, gt_boxes, gt_masks,
                           rng) -> Optional[Dict[str, np.ndarray]]:
        """``train_targets`` of the page ``img`` (1, H, W, 3) on the
        model's device: only its RPN maps (``eval_rpn``) reach the host."""
        return self.train_targets(self.eval_rpn(img), tuple(img.shape[1:3]),
                                  gt_boxes, gt_masks, rng)

    def train_losses(self, img: torch.Tensor, batch: Dict
                     ) -> Dict[str, torch.Tensor]:
        """The device half: the model's forward on ``img`` in the mode it
        is in, the RPN losses, each RoI pooled from its level, both heads
        and their losses (``batch``: ``train_targets``' arrays, numpy or
        on the device; ``lvl`` numpy)."""
        dev = img.device

        def on_dev(k, dtype=None):
            return torch.as_tensor(batch[k], device=dev, dtype=dtype)
        levels, rpn_outs = self.model(img)
        dt = levels[0].dtype
        losses = rpn_loss(rpn_outs, on_dev('rpn_labels'),
                          on_dev('rpn_deltas', dt))
        rois = on_dev('rois', dt)
        lvl = np.asarray(batch['lvl'])
        heads = self.model.roi_head
        cls, deltas = heads.bbox_head(self.pool_rois(levels, rois, lvl, None,
                                                     (7, 7)))
        masks = heads.mask_head(self.pool_rois(levels, rois, lvl, None,
                                               (14, 14)))
        losses.update(roi_head_losses(
            cls, deltas, masks, on_dev('labels'), on_dev('deltas', dt),
            on_dev('mask_targets', dt)))
        return losses
