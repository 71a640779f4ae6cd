"""ICDAR-2013 detection hmean (counterpart of
``tps_pp_tpu/evaluation/hmean_ic13.py``; the reference's
``core/evaluation/hmean_ic13.py:1-217`` and its matchers in
``core/evaluation/utils.py:262-434``): one-to-one, one-to-many and
many-to-one matching with recall / precision thresholds (0.8 / 0.4), a 0.8
score for one-to-many, 1.0 for many-to-one, and a normalised
centre-distance gate on one-to-one matches. Areas are counted on a raster
(``cv_ops.fill_poly``, the copy of the ``cv2.fillPoly`` the JAX package
calls), exact to the pixel.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..datasets.pipelines.cv_ops import fill_poly


def _rasterize(polys, shape):
    masks = []
    for p in polys:
        m = np.zeros(shape, np.uint8)
        fill_poly(m, [np.asarray(p, np.float32).reshape(-1, 2).astype(
            np.int32)], 1)
        masks.append(m)
    return masks


def _center(points: np.ndarray) -> np.ndarray:
    return points.reshape(-1, 2).mean(axis=0)


def _diag(points: np.ndarray) -> float:
    pts = points.reshape(-1, 2)
    # reference box_diag (utils.py:429-434): distance point0 -> point2
    return float(np.linalg.norm(pts[2] - pts[0]))


def eval_hmean_ic13(pred_boundaries: Sequence[Sequence],
                    gt_polygons: Sequence[Sequence],
                    precision_thr: float = 0.4, recall_thr: float = 0.8,
                    center_dist_thr: float = 1.0,
                    one2one_score: float = 1.0,
                    one2many_score: float = 0.8,
                    many2one_score: float = 1.0,
                    gt_ignore=None) -> Dict[str, float]:
    """``gt_ignore``: per-image don't-care polygons. They join the gt list
    for the recall/precision matrices (so they participate in the
    one-to-one uniqueness counts, reference hmean_ic13.py:114-117) but are
    skipped by every matcher, and a prediction whose overlap ratio with
    any of them exceeds ``precision_thr`` is discarded from scoring
    (reference ``ignore_pred``, utils.py:8-55)."""
    if gt_ignore is None:
        gt_ignore = [[] for _ in pred_boundaries]

    dataset_gt = dataset_pred = 0
    dataset_hit_recall = dataset_hit_prec = 0.0
    for preds, gts, ignores in zip(pred_boundaries, gt_polygons, gt_ignore):
        preds = [np.asarray(p, np.float32).reshape(-1) for p in preds]
        preds = [p[:-1] if len(p) % 2 else p for p in preds]
        gts = [np.asarray(g, np.float32).reshape(-1) for g in gts]
        ignores = [np.asarray(g, np.float32).reshape(-1) for g in ignores]

        all_gts: List[np.ndarray] = list(gts) + list(ignores)
        n_care_gt = len(gts)
        gt_ignored = set(range(len(gts), len(all_gts)))

        accum_recall = accum_prec = 0.0
        pred_ignored = set()
        if preds and all_gts:
            all_pts = np.concatenate(
                [p.reshape(-1, 2) for p in all_gts + preds])
            shape = (int(all_pts[:, 1].max()) + 2,
                     int(all_pts[:, 0].max()) + 2)
            gm = _rasterize(all_gts, shape)
            pm = _rasterize(preds, shape)
            g_area = np.asarray([m.sum() for m in gm], np.float64)
            p_area = np.asarray([m.sum() for m in pm], np.float64)
            inter = np.zeros((len(gm), len(pm)))
            for i, g in enumerate(gm):
                for j, p in enumerate(pm):
                    inter[i, j] = np.logical_and(g, p).sum()
            # a det mostly covering an ignored gt is itself ignored
            # (strict > precision_thr like the reference)
            for j in range(len(pm)):
                for i in gt_ignored:
                    ratio = inter[i, j] / p_area[j] if p_area[j] else 0.0
                    if ratio > precision_thr:
                        pred_ignored.add(j)
                        break
            recall_mat = inter / np.maximum(g_area[:, None], 1)
            prec_mat = inter / np.maximum(p_area[None, :], 1)

            gt_hit = np.zeros(len(gm), bool)
            pred_hit = np.zeros(len(pm), bool)
            # one-to-one: strict > thresholds, uniqueness over ALL rows and
            # columns (ignored entries included), then the normalized
            # center-distance gate (reference hmean_ic13.py:131-156)
            qual = (recall_mat > recall_thr) & (prec_mat > precision_thr)
            row_cnt = qual.sum(axis=1)
            col_cnt = qual.sum(axis=0)
            for i in range(len(gm)):
                for j in range(len(pm)):
                    if (gt_hit[i] or pred_hit[j] or i in gt_ignored or
                            j in pred_ignored):
                        continue
                    if not (qual[i, j] and row_cnt[i] == 1 and
                            col_cnt[j] == 1):
                        continue
                    norm_dist = np.linalg.norm(
                        _center(preds[j]) - _center(all_gts[i]))
                    norm_dist /= _diag(preds[j]) + _diag(all_gts[i])
                    norm_dist *= 2.0
                    if norm_dist < center_dist_thr:
                        gt_hit[i] = pred_hit[j] = True
                        accum_recall += one2one_score
                        accum_prec += one2one_score
            # one gt -> many preds (reference one2many_match_ic13,
            # utils.py:309-352: non-strict >= thresholds, no minimum
            # candidate count)
            for i in range(len(gm)):
                if i in gt_ignored or gt_hit[i]:
                    continue
                js = [j for j in range(len(pm))
                      if not pred_hit[j] and j not in pred_ignored and
                      prec_mat[i, j] >= precision_thr]
                if js and recall_mat[i, js].sum() >= recall_thr:
                    gt_hit[i] = True
                    pred_hit[js] = True
                    accum_recall += one2many_score
                    accum_prec += one2many_score * len(js)
            # many gts -> one pred (utils.py:355-398)
            for j in range(len(pm)):
                if j in pred_ignored or pred_hit[j]:
                    continue
                is_ = [i for i in range(len(gm))
                       if not gt_hit[i] and i not in gt_ignored and
                       recall_mat[i, j] >= recall_thr]
                if is_ and prec_mat[is_, j].sum() >= precision_thr:
                    pred_hit[j] = True
                    gt_hit[is_] = True
                    accum_recall += many2one_score * len(is_)
                    accum_prec += many2one_score
        dataset_gt += n_care_gt
        dataset_pred += len(preds) - len(pred_ignored)
        dataset_hit_recall += accum_recall
        dataset_hit_prec += accum_prec

    # reference compute_hmean (utils.py:57-95)
    if dataset_gt == 0:
        recall = 1.0
        precision = 0.0 if dataset_pred > 0 else 1.0
    else:
        recall = dataset_hit_recall / dataset_gt
        precision = (dataset_hit_prec / dataset_pred if dataset_pred
                     else 0.0)
    denom = recall + precision
    hmean = 0.0 if denom == 0 else 2.0 * precision * recall / denom
    return {'precision': round(precision, 4), 'recall': round(recall, 4),
            'hmean': round(hmean, 4)}
