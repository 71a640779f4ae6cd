"""Ground truth of the segmentation detectors on the host (counterpart of
``tps_pp_tpu/models/textdet/targets.py:24-180``): DBNet's shrunk text and
threshold maps, PANet's and PSENet's shrunk instance kernels.

The JAX package rasterises each polygon (``cv2.fillPoly`` of its vertices
cast to int32, which truncates) and measures offsets with
``cv2.distanceTransform``; the port runs ``cv_ops.fill_poly`` and
``cv_ops.distance_transform`` in their place, and ``min_area_rect``,
``contour_area`` and ``arc_length`` of ``cv_ops``. The distance transforms
run on the polygon's bounding box, widened by the farthest a value below
the offset ``d`` can reach (``d / 0.955`` pixels, the horizontal step)
plus a margin and clipped to the image, its left edge at a multiple of 4
(the column blocks of cv2's vector code): every value the targets read (a
distance below ``d``, or which side of ``d`` it lies) is then the full
image's (``tests/test_torch_det_train.py``). The maps are
the JAX package's: float32, ``gt_shrink`` 1 where the polygon's inner
distance reaches ``d``, ``gt_thr`` the ramp ``thr_min + (thr_max -
thr_min) (1 - |signed| / d)`` in the band ``|signed| < d``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ...datasets.pipelines import cv_ops
from ...registry import PIPELINES

_MARGIN = 8     # columns and rows past the farthest read pixel


def _poly_mask(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    mask = np.zeros((h, w), np.uint8)
    cv_ops.fill_poly(mask, [poly.astype(np.int32).reshape(-1, 2)], 1)
    return mask


def _offset_distance(poly: np.ndarray, shrink_ratio: float) -> float:
    p = poly.astype(np.float32).reshape(-1, 2)
    area = cv_ops.contour_area(p)
    length = cv_ops.arc_length(p, True)
    return area * (1 - shrink_ratio ** 2) / max(length, 1.0)


def _box(mask: np.ndarray, d: float) -> Tuple[slice, slice]:
    """The window of ``mask``'s pixels widened by ``d / 0.955 +
    _MARGIN``, clipped to the image, its left edge at a multiple of 4."""
    ys, xs = np.nonzero(mask.any(1))[0], np.nonzero(mask.any(0))[0]
    pad = int(d / 0.955) + _MARGIN
    h, w = mask.shape
    x0 = max(0, int(xs[0]) - pad) // 4 * 4
    return (slice(max(0, int(ys[0]) - pad), min(h, int(ys[-1]) + pad + 1)),
            slice(x0, min(w, int(xs[-1]) + pad + 1)))


@PIPELINES.register_module()
class DBNetTargets:
    def __init__(self, shrink_ratio=0.4, thr_min=0.3, thr_max=0.7,
                 min_short_size=8):
        self.shrink_ratio = shrink_ratio
        self.thr_min = thr_min
        self.thr_max = thr_max
        self.min_short_size = min_short_size

    def generate(self, polygons: Sequence[np.ndarray], h: int, w: int,
                 polygons_ignore: Sequence[np.ndarray] = ()
                 ) -> Dict[str, np.ndarray]:
        gt_shrink = np.zeros((h, w), np.float32)
        gt_shrink_mask = np.ones((h, w), np.float32)
        gt_thr = np.zeros((h, w), np.float32)
        gt_thr_mask = np.zeros((h, w), np.float32)
        # don't-care regions train as neither positives nor negatives
        for poly in polygons_ignore:
            mask = _poly_mask(np.asarray(poly, np.float32).reshape(-1, 2),
                              h, w)
            gt_shrink_mask[mask > 0] = 0
        for poly in polygons:
            poly = np.asarray(poly, np.float32).reshape(-1, 2)
            rect = cv_ops.min_area_rect(poly)
            mask = _poly_mask(poly, h, w)
            if min(rect[1]) < self.min_short_size:
                gt_shrink_mask[mask > 0] = 0      # tiny instances ignored
                continue
            if not mask.any():                     # wholly outside
                continue
            d = max(int(round(_offset_distance(poly, self.shrink_ratio))), 1)
            box = _box(mask, d)
            m = mask[box]
            inside, outside = cv_ops.distance_transform(np.stack([m, 1 - m]))
            signed = np.where(m > 0, inside, -outside)
            gt_shrink[box][signed >= d] = 1.0
            band = np.abs(signed) < d
            gt_thr_mask[box][band] = 1.0
            ramp = np.clip(1.0 - np.abs(signed) / d, 0, 1)
            thr_val = self.thr_min + (self.thr_max - self.thr_min) * ramp
            gt_thr[box] = np.where(band, np.maximum(gt_thr[box], thr_val),
                                   gt_thr[box])
        return {
            'gt_shrink': gt_shrink,
            'gt_shrink_mask': gt_shrink_mask,
            'gt_thr': gt_thr,
            'gt_thr_mask': gt_thr_mask,
        }

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img'].shape[:2]
        results.update(self.generate(
            results.get('gt_polygons', []), h, w,
            polygons_ignore=results.get('gt_polygons_ignore', [])))
        return results


def _shrink_distance(poly: np.ndarray, ratio: float, max_shrink: int) -> int:
    """``d = area (1 - r^2) / (perimeter + 1e-3)``, rounded half up and
    capped (reference ``base_textdet_targets.py:105-118``)."""
    p = poly.astype(np.float32).reshape(-1, 2)
    area = cv_ops.contour_area(p)
    peri = cv_ops.arc_length(p, True)
    return min(int(area * (1 - ratio * ratio) / (peri + 0.001) + 0.5),
               max_shrink)


def _shrunk_instance_maps(polygons, h, w, ratios, max_shrink):
    """An instance-labelled kernel map for each shrink ratio: each polygon
    eroded by its offset distance and filled with its index + 1, a later
    polygon over an earlier one (``_shrunk_instance_map`` of JAX, one map a
    ratio; here each polygon's inner distance serves every ratio)."""
    kernels = [np.zeros((h, w), np.float32) for _ in ratios]
    for ind, poly in enumerate(polygons):
        poly = np.asarray(poly, np.float32).reshape(-1, 2)
        ds = [_shrink_distance(poly, r, max_shrink) for r in ratios]
        mask = _poly_mask(poly, h, w)
        inside = box = None
        if max(ds) > 0 and mask.any():
            box = _box(mask, max(ds))
            inside = cv_ops.distance_transform(mask[box])
        for kernel, d in zip(kernels, ds):
            if d <= 0:
                kernel[mask > 0] = ind + 1
            elif inside is not None:
                kernel[box][inside >= d] = ind + 1   # none: over-shrunk
    return kernels


@PIPELINES.register_module()
class PANetTargets:
    """PANet's ground truth (reference ``panet_targets.py``): instance
    kernels at the shrink ratios (1.0, 0.5) and the effective mask."""

    def __init__(self, shrink_ratio=(1.0, 0.5), max_shrink=20):
        self.shrink_ratio = shrink_ratio
        self.max_shrink = max_shrink

    def generate(self, polygons, polygons_ignore, h, w):
        gt_kernels = _shrunk_instance_maps(polygons, h, w, self.shrink_ratio,
                                           self.max_shrink)
        gt_mask = np.ones((h, w), np.float32)
        for poly in polygons_ignore:
            cv_ops.fill_poly(gt_mask, [np.asarray(poly, np.float32).astype(
                np.int32).reshape(-1, 2)], 0)
        return gt_kernels, gt_mask

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img'].shape[:2]
        kernels, gt_mask = self.generate(
            results.get('gt_polygons', []),
            results.get('gt_polygons_ignore', []), h, w)
        results['gt_texts'] = kernels[0]
        results['gt_kernels'] = kernels[1]
        results['gt_mask'] = gt_mask
        return results


@PIPELINES.register_module()
class PSENetTargets(PANetTargets):
    """PSENet's ground truth (reference ``psenet_targets.py``): binary
    kernels at the ratios 1.0 ... 0.4 stacked (K, H, W) as ``gt_kernels``,
    and the effective mask."""

    def __init__(self,
                 shrink_ratio=(1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4),
                 max_shrink=20):
        super().__init__(shrink_ratio=shrink_ratio, max_shrink=max_shrink)

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img'].shape[:2]
        kernels, gt_mask = self.generate(
            results.get('gt_polygons', []),
            results.get('gt_polygons_ignore', []), h, w)
        results['gt_kernels'] = np.stack(
            [(k > 0).astype(np.float32) for k in kernels])
        results['gt_mask'] = gt_mask
        return results
