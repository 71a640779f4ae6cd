"""DBNet's postprocessing and the hmean-IoU detection metric, on the host
(counterpart of ``tps_pp_tpu/models/textdet/postprocess.py:19-147``).

``DBPostprocessor`` is the JAX package's, with its cv2 calls taken by the
numpy copies in ``datasets/pipelines/cv_ops.py`` (the machine with the
card has no cv2): binarise the probability map, find the contours (holes
included, in cv2's order, cut at ``max_candidates``), score each on its
bounding-box crop, and unclip. Quads grow the min-area rectangle by the DB
offset ``d = A r / L`` on each side; polys dilate the filled contour by
``round(d)`` and take its largest outer border (pyclipper is absent in the
JAX package too).

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
