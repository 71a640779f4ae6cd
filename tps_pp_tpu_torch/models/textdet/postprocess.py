"""The map detectors' postprocessing and the hmean-IoU detection metric,
on the host (counterpart of ``tps_pp_tpu/models/textdet/postprocess.py``).

``DBPostprocessor`` is the JAX package's, with its cv2 calls taken by the
numpy copies in ``datasets/pipelines/cv_ops.py`` (the machine with the
card has no cv2): binarise the probability map, find the contours (holes
included, in cv2's order, cut at ``max_candidates``), score each on its
bounding-box crop, and unclip. Quads grow the min-area rectangle by the DB
offset ``d = A r / L`` on each side; polys dilate the filled contour by
``round(d)`` and take its largest outer border (pyclipper is absent in the
JAX package too).

``PSEPostprocessor`` (progressive scale expansion) and
``PANPostprocessor`` (pixel aggregation) decode the raw logits of PSENet
and PANet at the head's 1/4 scale: the smallest kernel's 4-connected
components (``cv_ops.connected_components``) grown by ``contour_expand``
or ``pixel_group`` (``pixel_ops.py``, copies of the JAX package's native
C++), each text instance then a boundary by ``points2boundary``: the
min-area rectangle's corners (quad) or the outer border of its pixels
(poly). PAN also draws its kernels' outlines (``CHAIN_APPROX_NONE``
contours, thickness 1), which ``pixel_group`` takes and, as the C++ does,
does not read.

``FCEPostprocessor`` (reference ``fce_postprocessor.py``) scores each
level's pixels by ``tr ** alpha * tcl ** beta``, fills the holes of the
mask above ``score_thr`` (``sidelines.fill_hole``), and for each of its
contours (``RETR_TREE``, in cv2's order) turns every scored pixel's
Fourier coefficients into a 50-point polygon (``fourier2poly``: inverse
FFT, truncated to int32) at the level's scale, ``poly_nms`` over them
(greedy, exact polygon IoU: a Python loop), then ``poly_nms`` over all
levels; ``'quad'`` takes each polygon's min-area rectangle.
``TextSnakePostprocessor`` (reference ``textsnake_postprocessor.py``)
takes the centre mask's contours of at least ``min_center_area``, the
skeleton of each (``sidelines.skeletonize``, the JAX package's thinning),
slides its points to the local centre along the predicted normal
(``centralize``, float64, with JAX's cap on the walk), merges the disks
(``merge_disks``), draws them (``cv_ops.circle``) and keeps the first
contour of their union. Both are the JAX package's, their cv2 calls taken
by ``cv_ops``.

``eval_hmean_iou`` is the reference's hmean-IoU protocol
(``core/evaluation/hmean_iou.py:8-120``) with exact polygon areas
(``evaluation/polygon.py``); ``evaluation`` exports it too.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ...datasets.pipelines import cv_ops
from ...evaluation.polygon import (poly_intersection_area, poly_iou,
                                   polygon_area)
from .pixel_ops import contour_expand, pixel_group
from .sidelines import centralize, fill_hole, merge_disks, skeletonize


class DBPostprocessor:
    def __init__(self, text_repr_type='quad', mask_thr=0.3, min_text_score=0.3,
                 min_text_width=5, unclip_ratio=1.5, max_candidates=3000,
                 **kwargs):
        self.text_repr_type = text_repr_type
        self.mask_thr = mask_thr
        self.min_text_score = min_text_score
        self.min_text_width = min_text_width
        self.unclip_ratio = unclip_ratio
        self.max_candidates = max_candidates

    def __call__(self, prob_map: np.ndarray) -> List[np.ndarray]:
        """prob_map: (H, W) in [0, 1]. Returns the boundaries
        [x1, y1, ..., score] in float32."""
        prob_map = np.asarray(prob_map, np.float32)
        mask = (prob_map > self.mask_thr).astype(np.uint8)
        contours = cv_ops.find_contours(mask, cv_ops.RETR_LIST)
        boundaries = []
        for contour in contours[:self.max_candidates]:
            if len(contour) < 3:
                continue
            # the score on the bounding-box crop (reference box_score_fast)
            bx, by, bw, bh = cv_ops.bounding_rect(contour)
            comp_c = np.zeros((bh, bw), np.uint8)
            cv_ops.draw_contours(comp_c, contour - [bx, by], 1)
            crop = prob_map[by:by + bh, bx:bx + bw]
            score = float((crop * comp_c).sum() / max(comp_c.sum(), 1))
            if score < self.min_text_score:
                continue
            area = cv_ops.contour_area(contour)
            length = cv_ops.arc_length(contour, True)
            d = area * self.unclip_ratio / max(length, 1.0)
            if self.text_repr_type == 'quad':
                # offsetting a rotated rectangle by d grows each side by 2d
                (cx, cy), (rw, rh), ang = cv_ops.min_area_rect(contour)
                rect = ((cx, cy), (rw + 2 * d, rh + 2 * d), ang)
                if min(rect[1]) < self.min_text_width:
                    continue
                points = cv_ops.box_points(rect)
            else:
                di = int(round(d))
                if di > 0:
                    kernel = cv_ops.get_structuring_element(
                        (2 * di + 1, 2 * di + 1))
                    comp = np.zeros_like(mask)
                    cv_ops.draw_contours(comp, contour, 1)
                    comp = cv_ops.dilate(comp, kernel)
                    cs = cv_ops.find_contours(comp, cv_ops.RETR_EXTERNAL)
                    if not cs:
                        continue
                    contour = max(cs, key=cv_ops.contour_area)
                points = contour.reshape(-1, 2)
                if len(points) < 4:
                    continue
            boundaries.append(
                np.concatenate([points.reshape(-1), [score]]).astype(
                    np.float32))
        return boundaries


def _row_ends(points: np.ndarray) -> np.ndarray:
    """The first and last point of each row of a point set in raster
    order, in that order: the same convex hull (every point lies between
    its row's ends), far fewer points for ``convex_hull``'s loop."""
    y = points[:, 1]
    first = np.r_[True, y[1:] != y[:-1]]
    last = np.r_[y[1:] != y[:-1], True]
    return points[first | last]


def points2boundary(points: np.ndarray, text_repr_type: str,
                    score: float, min_width: int = -1):
    """An instance's pixels (x, y) in raster order -> its boundary
    ``[x1, y1, ..., score]`` (reference ``core/mask.py:8-52``): the
    corners of the min-area rectangle (quad), or the first outer border
    of its pixels drawn on a mask (poly); None when too thin or too
    short."""
    points = np.asarray(points)
    if text_repr_type == 'quad':
        rect = cv_ops.min_area_rect(_row_ends(points.astype(np.int32)))
        if min(rect[1]) <= min_width:
            return None
        boundary = cv_ops.box_points(rect).flatten().tolist()
    else:
        height = int(points[:, 1].max()) + 10
        width = int(points[:, 0].max()) + 10
        mask = np.zeros((height, width), np.uint8)
        mask[points[:, 1].astype(int), points[:, 0].astype(int)] = 255
        contours = cv_ops.find_contours(mask, cv_ops.RETR_EXTERNAL)
        if not contours:
            return None
        boundary = contours[0].flatten().tolist()
    boundary = boundary + [score]
    if len(boundary) < 8 + 1:
        return None
    return np.asarray(boundary, np.float32)


class PSEPostprocessor:
    """Progressive scale expansion (reference
    ``pse_postprocessor.py:13-91``)."""

    def __init__(self, text_repr_type='poly', min_kernel_confidence=0.5,
                 min_text_avg_confidence=0.85, min_kernel_area=0,
                 min_text_area=16, **kwargs):
        self.text_repr_type = text_repr_type
        self.min_kernel_confidence = min_kernel_confidence
        self.min_text_avg_confidence = min_text_avg_confidence
        self.min_kernel_area = min_kernel_area
        self.min_text_area = min_text_area

    def __call__(self, preds: np.ndarray) -> List[np.ndarray]:
        """preds: (H, W, K + 1) raw logits [text, kernels large to
        small]."""
        preds = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float32)))
        score = preds[..., 0]
        masks = preds > self.min_kernel_confidence
        text_mask = masks[..., 0]
        kernel_masks = (masks * text_mask[..., None]).astype(
            np.uint8).transpose(2, 0, 1)
        region_num, labels = cv_ops.connected_components(kernel_masks[-1])
        labels = contour_expand(kernel_masks, labels, self.min_kernel_area,
                                region_num - 1)
        boundaries = []
        for i in range(1, labels.max() + 1):
            points = np.array(np.where(labels == i)).T[:, ::-1]
            area = points.shape[0]
            score_i = float(score[labels == i].mean()) if area else 0.0
            if area < self.min_text_area or \
                    score_i < self.min_text_avg_confidence:
                continue
            vb = points2boundary(points, self.text_repr_type, score_i)
            if vb is not None:
                boundaries.append(vb)
        return boundaries


class PANPostprocessor:
    """Pixel aggregation (reference ``pan_postprocessor.py:13-89``)."""

    def __init__(self, text_repr_type='poly', min_text_confidence=0.5,
                 min_kernel_confidence=0.5, min_text_avg_confidence=0.85,
                 min_text_area=16, **kwargs):
        self.text_repr_type = text_repr_type
        self.min_text_confidence = min_text_confidence
        self.min_kernel_confidence = min_kernel_confidence
        self.min_text_avg_confidence = min_text_avg_confidence
        self.min_text_area = min_text_area

    def __call__(self, preds: np.ndarray) -> List[np.ndarray]:
        """preds: (H, W, 6) raw logits [text, kernel, 4-d embedding]."""
        preds = np.asarray(preds, np.float32)
        text_score = 1.0 / (1.0 + np.exp(-preds[..., 0]))
        kernel_score = 1.0 / (1.0 + np.exp(-preds[..., 1]))
        text = text_score > self.min_text_confidence
        kernel = (kernel_score > self.min_kernel_confidence) & text
        embeddings = preds[..., 2:]
        region_num, labels = cv_ops.connected_components(kernel)
        contours = cv_ops.find_contours((kernel * 255).astype(np.uint8),
                                        cv_ops.RETR_LIST,
                                        cv_ops.CHAIN_APPROX_NONE)
        kernel_contours = cv_ops.draw_contour_lines(
            np.zeros(text.shape, np.uint8), contours, 255)
        # the reference passes the average-confidence threshold as the
        # embedding distance threshold; so do JAX and this port
        text_points = pixel_group(text_score, text, embeddings, labels,
                                  kernel_contours, region_num - 1,
                                  self.min_text_avg_confidence)
        boundaries = []
        for tp in text_points:
            score_i, count = tp[0], tp[1]
            if count < self.min_text_area or \
                    score_i < self.min_text_avg_confidence:
                continue
            points = np.asarray(tp[2:], dtype=int).reshape(-1, 2)
            vb = points2boundary(points, self.text_repr_type,
                                 float(score_i))
            if vb is not None:
                boundaries.append(vb)
        return boundaries


def poly_nms(polygons: List, threshold: float) -> List:
    """Greedy polygon NMS by score (reference postprocess/utils.py:117-138);
    exact polygon IoU (evaluation/polygon.py) like the reference's shapely."""
    polygons = sorted(polygons, key=lambda x: x[-1])
    keep = []
    index = list(range(len(polygons)))
    while index:
        i = index.pop()
        a = np.asarray(polygons[i][:-1], np.float32)
        keep.append(list(polygons[i]))
        index = [j for j in index
                 if poly_iou(a.reshape(-1, 2),
                             np.asarray(polygons[j][:-1],
                                        np.float32).reshape(-1, 2))
                 <= threshold]
    return keep


def fourier2poly(fourier_coeff: np.ndarray,
                 num_reconstr_points: int = 50) -> np.ndarray:
    """Inverse Fourier transform of (n, 2k+1) complex coefficients to
    (n, 2*num_points) polygons (reference postprocess/utils.py:141-162)."""
    a = np.zeros((len(fourier_coeff), num_reconstr_points), dtype=complex)
    k = (fourier_coeff.shape[1] - 1) // 2
    a[:, 0:k + 1] = fourier_coeff[:, k:]
    a[:, -k:] = fourier_coeff[:, :k]
    poly_complex = np.fft.ifft(a) * num_reconstr_points
    polygon = np.zeros((len(fourier_coeff), num_reconstr_points, 2))
    polygon[:, :, 0] = poly_complex.real
    polygon[:, :, 1] = poly_complex.imag
    return polygon.astype('int32').reshape((len(fourier_coeff), -1))


class FCEPostprocessor:
    """Fourier contour decode + poly NMS (reference
    textdet/postprocess/fce_postprocessor.py:11-120). Operates on our NHWC
    head outputs: call with a list of per-level (cls (H,W,4),
    reg (H,W,2(2k+1))) plus the level scales."""

    def __init__(self, fourier_degree=5, num_reconstr_points=50,
                 text_repr_type='poly', alpha=1.0, beta=2.0, score_thr=0.3,
                 nms_thr=0.1, scales=(8, 16, 32), **kwargs):
        self.fourier_degree = fourier_degree
        self.num_reconstr_points = num_reconstr_points
        self.text_repr_type = text_repr_type
        self.alpha = alpha
        self.beta = beta
        self.score_thr = score_thr
        self.nms_thr = nms_thr
        self.scales = scales

    def candidates(self, cls_pred, reg_pred, scale) -> List[np.ndarray]:
        """One level's polygons before NMS: an (n, 2 * num_reconstr_points
        + 1) array [vertices, score] for each contour of the filled score
        mask, a row for each of its pixels."""
        def softmax2(x):
            e = np.exp(x - x.max(-1, keepdims=True))
            return e / e.sum(-1, keepdims=True)

        k = 2 * self.fourier_degree + 1
        cls_pred = np.asarray(cls_pred, np.float32)
        reg_pred = np.asarray(reg_pred, np.float32)
        tr_pred = softmax2(cls_pred[..., 0:2])
        tcl_pred = softmax2(cls_pred[..., 2:4])
        x_pred, y_pred = reg_pred[..., :k], reg_pred[..., k:]

        score_pred = (tr_pred[..., 1] ** self.alpha) * \
            (tcl_pred[..., 1] ** self.beta)
        tr_pred_mask = score_pred > self.score_thr
        tr_mask = fill_hole(tr_pred_mask)
        contours = cv_ops.find_contours(tr_mask.astype(np.uint8),
                                        cv_ops.RETR_TREE)
        mask = np.zeros_like(tr_mask, np.uint8)
        out = []
        for cont in contours:
            deal_map = mask.copy()
            cv_ops.draw_contours(deal_map, cont, 1)
            score_map = score_pred * deal_map
            score_mask = score_map > 0
            if not score_mask.any():
                continue
            xy_text = np.argwhere(score_mask)
            dxy = xy_text[:, 1] + xy_text[:, 0] * 1j
            x, y = x_pred[score_mask], y_pred[score_mask]
            c = x + y * 1j
            c[:, self.fourier_degree] = c[:, self.fourier_degree] + dxy
            c *= scale
            polygons = fourier2poly(c, self.num_reconstr_points)
            score = score_map[score_mask].reshape(-1, 1)
            out.append(np.hstack((polygons, score)))
        return out

    def __call__(self, preds, scales=None) -> List[np.ndarray]:
        scales = scales or self.scales
        boundaries = []
        for (cls_pred, reg_pred), scale in zip(preds, scales):
            for polys in self.candidates(cls_pred, reg_pred, scale):
                boundaries += poly_nms(polys.tolist(), self.nms_thr)
        boundaries = poly_nms(boundaries, self.nms_thr)
        if self.text_repr_type == 'quad':
            out = []
            for b in boundaries:
                poly = np.array(b[:-1]).reshape(-1, 2).astype(np.float32)
                points = cv_ops.box_points(cv_ops.min_area_rect(poly))
                out.append(points.reshape(-1).tolist() + [b[-1]])
            boundaries = out
        return [np.asarray(b, np.float32) for b in boundaries]


class TextSnakePostprocessor:
    """Skeleton + disk reconstruction (reference
    textdet/postprocess/textsnake_postprocessor.py:13-120)."""

    def __init__(self, text_repr_type='poly', min_text_region_confidence=0.6,
                 min_center_region_confidence=0.2, min_center_area=30,
                 disk_overlap_thr=0.03, radius_shrink_ratio=1.03, **kwargs):
        self.min_text_region_confidence = min_text_region_confidence
        self.min_center_region_confidence = min_center_region_confidence
        self.min_center_area = min_center_area
        self.disk_overlap_thr = disk_overlap_thr
        self.radius_shrink_ratio = radius_shrink_ratio

    def __call__(self, preds: np.ndarray) -> List[np.ndarray]:
        """preds: (H, W, 5) raw maps [text, center, sin, cos, radius]."""
        preds = np.asarray(preds, np.float32)
        text_score = 1 / (1 + np.exp(-preds[..., 0]))
        center_score = 1 / (1 + np.exp(-preds[..., 1])) * text_score
        sin_p, cos_p, radius_p = preds[..., 2], preds[..., 3], preds[..., 4]
        scale = np.sqrt(1.0 / (sin_p ** 2 + cos_p ** 2 + 1e-8))
        sin_p, cos_p = sin_p * scale, cos_p * scale

        center_mask = fill_hole(
            center_score > self.min_center_region_confidence).astype(np.uint8)
        contours = cv_ops.find_contours(center_mask, cv_ops.RETR_TREE)
        boundaries = []
        for contour in contours:
            if cv_ops.contour_area(contour) < self.min_center_area:
                continue
            inst = np.zeros_like(center_mask)
            cv_ops.draw_contours(inst, contour, 1)
            skel_yx = np.argwhere(skeletonize(inst))
            if len(skel_yx) == 0:
                continue
            y, x = skel_yx[:, 0], skel_yx[:, 1]
            cos = cos_p[y, x].reshape(-1, 1)
            sin = sin_p[y, x].reshape(-1, 1)
            radius = radius_p[y, x].reshape(-1, 1)
            center_yx = centralize(skel_yx, cos, -sin, radius, inst)
            y, x = center_yx[:, 0], center_yx[:, 1]
            radius = (radius_p[y, x] * self.radius_shrink_ratio).reshape(-1, 1)
            score = center_score[y, x].reshape(-1, 1)
            disks = merge_disks(
                np.hstack([np.fliplr(center_yx), radius, score]),
                self.disk_overlap_thr)
            inst_mask = np.zeros_like(center_mask)
            for dx, dy, r, _s in disks:
                if r > 1:
                    cv_ops.circle(inst_mask, (int(dx), int(dy)), int(r), 1)
            cs = cv_ops.find_contours(inst_mask, cv_ops.RETR_TREE)
            sc = float(np.sum(inst_mask * text_score) /
                       (np.sum(inst_mask) + 1e-8))
            if cs and cv_ops.contour_area(cs[0]) > 0 and cs[0].size > 8:
                boundaries.append(np.asarray(
                    cs[0].flatten().tolist() + [sc], np.float32))
        return boundaries


def eval_hmean_iou(pred_boundaries: Sequence[Sequence[np.ndarray]],
                   gt_polygons: Sequence[Sequence[np.ndarray]],
                   iou_thr: float = 0.5, gt_ignore=None,
                   ignore_thr: float = 0.5) -> Dict[str, float]:
    """The reference's hmean-iou with exact polygon areas:

      * a prediction is ignored where inter(det, ignored gt) / area(det) >
        ``ignore_thr`` for any ignored gt (eval_utils.ignore_pred);
      * matching is greedy in (gt index, pred index) order with strict
        ``iou > iou_thr``, not best-match (hmean_iou.py:82-90);
      * no gts gives recall 1.0, and precision 1.0 iff there are no preds
        (eval_utils.compute_hmean:83-88).
    """
    n_gt = n_pred = n_match = 0
    if gt_ignore is None:
        gt_ignore = [[] for _ in pred_boundaries]
    for preds, gts, ignores in zip(pred_boundaries, gt_polygons, gt_ignore):
        # a boundary may carry a trailing score (odd length): strip it
        preds = [np.asarray(p, np.float32).reshape(-1) for p in preds]
        preds = [p[:-1] if len(p) % 2 else p for p in preds]
        gts = [np.asarray(g, np.float32).reshape(-1, 2) for g in gts]
        ignores = [np.asarray(g, np.float32).reshape(-1, 2)
                   for g in ignores]
        pred_ignored = set()
        if ignores:
            for j, p in enumerate(preds):
                area = polygon_area(p)
                for ig in ignores:
                    inter = poly_intersection_area(p, ig)
                    prec = 0.0 if area == 0 else inter / area
                    if prec > ignore_thr:
                        pred_ignored.add(j)
                        break
        gt_hit = [False] * len(gts)
        pred_hit = [False] * len(preds)
        for gi, g in enumerate(gts):
            for j, p in enumerate(preds):
                if gt_hit[gi] or pred_hit[j] or j in pred_ignored:
                    continue
                if poly_iou(p, g) > iou_thr:
                    gt_hit[gi] = True
                    pred_hit[j] = True
                    n_match += 1
        n_gt += len(gts)
        n_pred += len(preds) - len(pred_ignored)
    if n_gt == 0:
        recall = 1.0
        precision = 0.0 if n_pred > 0 else 1.0
    else:
        recall = n_match / n_gt
        precision = 0.0 if n_pred == 0 else n_match / n_pred
    denom = recall + precision
    hmean = 0.0 if denom == 0 else 2 * precision * recall / denom
    return {'precision': round(precision, 4), 'recall': round(recall, 4),
            'hmean': round(hmean, 4)}
