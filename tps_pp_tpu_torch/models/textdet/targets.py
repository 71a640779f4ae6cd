"""Ground truth of the segmentation detectors on the host (counterpart of
``tps_pp_tpu/models/textdet/targets.py:24-560``): DBNet's shrunk text and
threshold maps, PANet's and PSENet's shrunk instance kernels, TextSnake's
text and centre-region masks with their radius / sin / cos maps, and
FCENet's per-level maps (text region, centre region, effective mask and
the Fourier signature of each polygon, its constant term relative to each
pixel), and DRRG's masks, height and angle maps and text components.

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

``TextSnakeTargets``, ``FCENetTargets`` and ``DRRGTargets`` are the JAX
package's, over the sideline geometry of ``sidelines.py`` and ``cv_ops``'
fills; FCENet's Fourier signature (``resample_polygon``,
``normalize_polygon``, ``poly2fourier``, ``clockwise``) runs in float64
with ``np.fft``, and each polygon goes to the levels whose proportion
range holds the larger side of its ``bounding_rect`` over the image's
height.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ...datasets.pipelines import cv_ops
from ...registry import PIPELINES
from . import sidelines as sl

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


@PIPELINES.register_module()
class TextSnakeTargets:
    """TextSnake gt generation (reference
    textdet_targets/textsnake_targets.py:26-483): text region mask, center
    region mask, radius/sin/cos attribute maps + effective mask."""

    def __init__(self, orientation_thr=2.0, resample_step=4.0,
                 center_region_shrink_ratio=0.3):
        self.orientation_thr = orientation_thr
        self.resample_step = resample_step
        self.center_region_shrink_ratio = center_region_shrink_ratio

    def generate(self, polygons, polygons_ignore, h, w):
        gt_text = sl.generate_text_region_mask((h, w), polygons)
        center, radius, sin_m, cos_m = sl.generate_center_mask_attrib_maps(
            (h, w), polygons, self.resample_step,
            self.center_region_shrink_ratio)
        gt_mask = sl.generate_effective_mask((h, w), polygons_ignore)
        return {
            'gt_text_mask': gt_text.astype(np.float32),
            'gt_center_region_mask': center.astype(np.float32),
            'gt_mask': gt_mask.astype(np.float32),
            'gt_radius_map': radius,
            'gt_sin_map': sin_m,
            'gt_cos_map': cos_m,
        }

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img'].shape[:2]
        results.update(self.generate(results.get('gt_polygons', []),
                                     results.get('gt_polygons_ignore', []),
                                     h, w))
        return results


@PIPELINES.register_module()
class FCENetTargets:
    """FCENet gt generation (reference textdet_targets/fcenet_targets.py:
    20-368): per-pyramid-level (4k+5)-channel maps [text region, center
    region, effective mask, Fourier real, Fourier imag]."""

    def __init__(self, fourier_degree=5, resample_step=4.0,
                 center_region_shrink_ratio=0.3,
                 level_size_divisors=(8, 16, 32),
                 level_proportion_range=((0, 0.4), (0.3, 0.7), (0.6, 1.0))):
        self.fourier_degree = fourier_degree
        self.resample_step = resample_step
        self.center_region_shrink_ratio = center_region_shrink_ratio
        self.level_size_divisors = tuple(level_size_divisors)
        self.level_proportion_range = tuple(level_proportion_range)

    # --- Fourier signature (fcenet_targets.py:107-221) ---
    def resample_polygon(self, polygon, n=400):
        length = []
        for i in range(len(polygon)):
            p1 = polygon[i]
            p2 = polygon[(i + 1) % len(polygon)]
            length.append(((p1[0] - p2[0]) ** 2 +
                           (p1[1] - p2[1]) ** 2) ** 0.5)
        total = sum(length)
        n_per = (np.array(length) / (total + 1e-8)) * n
        n_per = n_per.astype(np.int32)
        out = []
        for i in range(len(polygon)):
            num = n_per[i]
            if num == 0:
                continue
            p1 = polygon[i]
            p2 = polygon[(i + 1) % len(polygon)]
            dxdy = (p2 - p1) / num
            for j in range(num):
                out.append(p1 + dxdy * j)
        return np.array(out)

    @staticmethod
    def normalize_polygon(polygon):
        temp = polygon - polygon.mean(axis=0)
        x = np.abs(temp[:, 0])
        y = temp[:, 1]
        index_x = np.argsort(x)
        index_y = np.argmin(y[index_x[:8]])
        index = index_x[index_y]
        return np.concatenate([polygon[index:], polygon[:index]])

    def poly2fourier(self, polygon, k):
        points = polygon[:, 0] + polygon[:, 1] * 1j
        c_fft = np.fft.fft(points) / len(points)
        return np.hstack((c_fft[-k:], c_fft[:k + 1]))

    @staticmethod
    def clockwise(c, k):
        if np.abs(c[k + 1]) > np.abs(c[k - 1]):
            return c
        if np.abs(c[k + 1]) < np.abs(c[k - 1]):
            return c[::-1]
        return c if np.abs(c[k + 2]) > np.abs(c[k - 2]) else c[::-1]

    def cal_fourier_signature(self, polygon, k):
        poly = self.resample_polygon(polygon)
        poly = self.normalize_polygon(poly)
        c = self.clockwise(self.poly2fourier(poly, k), k)
        return np.hstack([np.real(c).reshape(-1, 1),
                          np.imag(c).reshape(-1, 1)])

    def generate_fourier_maps(self, img_size, text_polys):
        h, w = img_size
        k = self.fourier_degree
        real_map = np.zeros((h, w, 2 * k + 1), np.float32)
        imag_map = np.zeros((h, w, 2 * k + 1), np.float32)
        for poly in text_polys:
            pts = np.asarray(poly, np.float32).reshape(-1, 2)
            mask = np.zeros((h, w), np.uint8)
            cv_ops.fill_poly(mask, [pts.astype(np.int32)], 1)
            coeff = self.cal_fourier_signature(pts, k)
            sel = mask > 0
            for i in range(2 * k + 1):
                if i != k:
                    real_map[sel, i] = coeff[i, 0]
                    imag_map[sel, i] = coeff[i, 1]
            yx = np.argwhere(sel)
            real_map[yx[:, 0], yx[:, 1], k] = coeff[k, 0] - yx[:, 1]
            imag_map[yx[:, 0], yx[:, 1], k] = coeff[k, 1] - yx[:, 0]
        return real_map, imag_map

    def generate_level_targets(self, img_size, text_polys, ignore_polys):
        h, w = img_size
        lv_polys = [[] for _ in self.level_size_divisors]
        lv_ignore = [[] for _ in self.level_size_divisors]
        for poly in text_polys:
            pts = np.asarray(poly, np.float32).reshape(-1, 2)
            _, _, bw, bh = cv_ops.bounding_rect(pts.astype(np.int32))
            proportion = max(bh, bw) / (h + 1e-8)
            for ind, rng in enumerate(self.level_proportion_range):
                if rng[0] < proportion < rng[1]:
                    lv_polys[ind].append(
                        pts / self.level_size_divisors[ind])
        for poly in ignore_polys:
            pts = np.asarray(poly, np.float32).reshape(-1, 2)
            _, _, bw, bh = cv_ops.bounding_rect(pts.astype(np.int32))
            proportion = max(bh, bw) / (h + 1e-8)
            for ind, rng in enumerate(self.level_proportion_range):
                if rng[0] < proportion < rng[1]:
                    lv_ignore[ind].append(
                        pts / self.level_size_divisors[ind])
        level_maps = []
        for ind, div in enumerate(self.level_size_divisors):
            size = (h // div, w // div)
            tr = sl.generate_text_region_mask(size, lv_polys[ind])
            tcl = sl.generate_center_region_mask(
                size, lv_polys[ind], self.resample_step,
                self.center_region_shrink_ratio)
            eff = sl.generate_effective_mask(size, lv_ignore[ind])
            real_map, imag_map = self.generate_fourier_maps(size,
                                                            lv_polys[ind])
            level_maps.append(np.concatenate([
                tr[..., None].astype(np.float32),
                tcl[..., None].astype(np.float32),
                eff[..., None].astype(np.float32),
                real_map, imag_map], axis=-1))
        return level_maps

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img'].shape[:2]
        maps = self.generate_level_targets(
            (h, w), results.get('gt_polygons', []),
            results.get('gt_polygons_ignore', []))
        for i, m in enumerate(maps):
            results[f'p{i + 3}_maps'] = m
        return results


@PIPELINES.register_module()
class DRRGTargets:
    """DRRG gt generation (reference textdet_targets/drrg_targets.py:
    17-534): text and centre masks, the top / bottom height and sin / cos
    maps, and the text components' attributes (n, 7) [x, y, h, w, cos,
    sin, label] that supervise the GCN: components sampled at every pixel
    of the centre lines (``cv_ops.polylines`` within the centre mask),
    ``poly_nms``, labelled by the centre mask's 8-connected components in
    cv2's order, jittered, then topped up with random label-0 components
    off the text up to ``num_min_comps``. JAX draws from numpy's global
    generator; the port from ``rng``, a ``np.random.RandomState`` of
    ``seed``, which draws numpy's global stream for the same seed
    (``train_detector`` seeds it and keeps its state in checkpoints)."""

    def __init__(self, orientation_thr=2.0, resample_step=8.0,
                 num_min_comps=9, num_max_comps=600, min_width=8.0,
                 max_width=24.0, center_region_shrink_ratio=0.3,
                 comp_shrink_ratio=1.0, comp_w_h_ratio=0.3,
                 text_comp_nms_thr=0.25, min_rand_half_height=8.0,
                 max_rand_half_height=24.0, jitter_level=0.2, seed=None):
        self.orientation_thr = orientation_thr
        self.resample_step = resample_step
        self.num_min_comps = num_min_comps
        self.num_max_comps = num_max_comps
        self.min_width = min_width
        self.max_width = max_width
        self.center_region_shrink_ratio = center_region_shrink_ratio
        self.comp_shrink_ratio = comp_shrink_ratio
        self.comp_w_h_ratio = comp_w_h_ratio
        self.text_comp_nms_thr = text_comp_nms_thr
        self.min_rand_half_height = min_rand_half_height
        self.max_rand_half_height = max_rand_half_height
        self.jitter_level = jitter_level
        self.rng = np.random.RandomState(seed)

    def jitter_comp_attribs(self, attribs, jitter_level):
        """Jitter (x, y, h, w, cos, sin) of the true components so that the
        GCN trains on imperfect proposals (reference drrg_targets.py:
        320-369); labels kept, cos / sin back on the unit circle."""
        if len(attribs) == 0 or jitter_level <= 0:
            return attribs
        x, y, h, w, cos, sin, labels = np.split(attribs, 7, axis=1)

        def u():
            return (self.rng.random_sample((len(attribs), 1)) - 0.5) \
                * jitter_level
        x = x + u() * (h * np.abs(cos) + w * np.abs(sin))
        y = y + u() * (h * np.abs(sin) + w * np.abs(cos))
        h = h + u() * h
        w = w + u() * w
        cos = cos + u() * 2
        sin = sin + u() * 2
        scale = np.sqrt(1.0 / (cos ** 2 + sin ** 2 + 1e-8))
        return np.hstack([x, y, h, w, cos * scale, sin * scale,
                          labels]).astype(np.float32)

    def generate_rand_comp_attribs(self, num, center_sample_mask):
        """``num`` random label-0 components in the non-text region, so
        that every image has ``num_min_comps`` (the k-NN graph needs k
        neighbours; reference drrg_targets.py:238-318)."""
        h, w = center_sample_mask.shape
        max_hh, min_hh = self.max_rand_half_height, self.min_rand_half_height
        max_rand_width = np.clip(2 * max_hh * self.comp_w_h_ratio,
                                 self.min_width, self.max_width)
        margin = int(np.sqrt(max_hh ** 2 + (max_rand_width / 2) ** 2)) + 1
        if 2 * margin + 1 > min(h, w):
            max_hh = max(min(h, w) / 4, self.min_width / 2 + 1)
            min_hh = max(max_hh / 4, self.min_width / 2)
            max_rand_width = np.clip(2 * max_hh * self.comp_w_h_ratio,
                                     self.min_width, self.max_width)
            margin = int(np.sqrt(max_hh ** 2 + (max_rand_width / 2) ** 2)) + 1
        inner = np.zeros_like(center_sample_mask, np.uint8)
        lo = min(margin, min(h, w) // 2)
        inner[lo:h - lo, lo:w - lo] = \
            (center_sample_mask[lo:h - lo, lo:w - lo] > 0)
        k = int(np.clip(max_hh, 7, 21))
        inner = cv_ops.erode(inner, np.ones((k, k), np.uint8), border=None)
        candidates = np.argwhere(inner > 0)
        rng = self.rng
        if len(candidates) == 0:            # degenerate mask: anywhere
            candidates = np.stack([rng.randint(0, h, 64),
                                   rng.randint(0, w, 64)], axis=1)
        centers = candidates[rng.choice(len(candidates), num)]
        top_hh = rng.randint(int(min_hh), max(int(max_hh), int(min_hh) + 1),
                             (num, 1))
        bot_hh = rng.randint(int(min_hh), max(int(max_hh), int(min_hh) + 1),
                             (num, 1))
        cos = 2 * rng.random_sample((num, 1)) - 1
        sin = 2 * rng.random_sample((num, 1)) - 1
        scale = np.sqrt(1.0 / (cos ** 2 + sin ** 2 + 1e-8))
        height = (top_hh + bot_hh).astype(np.float32)
        width = np.clip(height * self.comp_w_h_ratio, self.min_width,
                        self.max_width)
        return np.hstack([centers[:, ::-1], height, width, cos * scale,
                          sin * scale, np.zeros((num, 1))]).astype(np.float32)

    def _attrib_maps(self, polygons, h, w):
        """The centre mask and the top / bottom height and sin / cos maps,
        drawn a centre-line segment at a time (reference drrg_targets.py
        draw_center_region_maps), and the centre lines."""
        center_mask = np.zeros((h, w), np.uint8)
        top_map = np.zeros((h, w), np.float32)
        bot_map = np.zeros((h, w), np.float32)
        sin_map = np.zeros((h, w), np.float32)
        cos_map = np.zeros((h, w), np.float32)
        center_lines = []
        for poly in polygons:
            pts = np.asarray(poly, np.float32).reshape(-1, 2)
            if len(pts) < 4:
                continue
            top, bot, center = sl.sideline_center(pts, self.resample_step)
            top, bot, center = sl.shrink_ends(top, bot, center,
                                              self.resample_step)
            center_lines.append(center.astype(np.int32))
            for i in range(len(center) - 1):
                th = np.linalg.norm((top[i] + top[i + 1]) / 2 -
                                    (center[i] + center[i + 1]) / 2)
                bh = np.linalg.norm((bot[i] + bot[i + 1]) / 2 -
                                    (center[i] + center[i + 1]) / 2)
                d = center[i + 1] - center[i]
                s, c = sl.vector_sin(d), sl.vector_cos(d)
                r = self.center_region_shrink_ratio
                quad = np.vstack([
                    center[i] + (top[i] - center[i]) * r,
                    center[i + 1] + (top[i + 1] - center[i + 1]) * r,
                    center[i + 1] + (bot[i + 1] - center[i + 1]) * r,
                    center[i] + (bot[i] - center[i]) * r,
                ]).astype(np.int32)
                cv_ops.fill_poly(center_mask, [quad], 1)
                cv_ops.fill_poly(top_map, [quad], float(max(th, 1.0)))
                cv_ops.fill_poly(bot_map, [quad], float(max(bh, 1.0)))
                cv_ops.fill_poly(sin_map, [quad], float(s))
                cv_ops.fill_poly(cos_map, [quad], float(c))
        return center_mask, top_map, bot_map, sin_map, cos_map, center_lines

    def generate_comp_attribs(self, center_lines, center_mask, top_map,
                              bot_map, sin_map, cos_map):
        """Components at the centre lines' pixels (reference
        drrg_targets.py:368-480)."""
        from .postprocess import poly_nms
        h, w = center_mask.shape
        lines_mask = np.zeros_like(center_mask)
        if center_lines:
            cv_ops.polylines(lines_mask, center_lines, False, 1, 1)
        lines_mask = lines_mask * center_mask
        centers = np.argwhere(lines_mask > 0)
        comps = []
        for y, x in centers:
            th = top_map[y, x] * self.comp_shrink_ratio
            bh = bot_map[y, x] * self.comp_shrink_ratio
            s, c = sin_map[y, x], cos_map[y, x]
            # sin / cos are the centre line's tangent (c, s): the top at
            # +th (s, -c), the bottom at -bh (s, -c) (y points down), the
            # corners +-r (c, s) along the tangent
            top_mid = np.array([x + th * s, y - th * c])
            bot_mid = np.array([x - bh * s, y + bh * c])
            width = np.clip((th + bh) * self.comp_w_h_ratio,
                            self.min_width, self.max_width)
            r = width / 2
            dx, dy = c * r, s * r
            quad = np.array([top_mid + [-dx, -dy], top_mid + [dx, dy],
                             bot_mid + [dx, dy], bot_mid + [-dx, -dy]])
            comps.append(np.hstack([quad.reshape(-1), [1.0]]))
        if not comps:
            return np.zeros((0, 8), np.float32)
        comps = np.asarray(
            poly_nms([cp.tolist() for cp in comps], self.text_comp_nms_thr),
            np.float32)[:self.num_max_comps]
        centers2 = comps[:, 0:8].reshape(-1, 4, 2).mean(axis=1)
        cx = np.clip(centers2[:, 0].astype(np.int32), 0, w - 1)
        cy = np.clip(centers2[:, 1].astype(np.int32), 0, h - 1)
        height = np.maximum(top_map[cy, cx] + bot_map[cy, cx], 2.0)
        width = np.clip(height * self.comp_w_h_ratio, self.min_width,
                        self.max_width)
        _, label_mask = cv_ops.connected_components(center_mask,
                                                    connectivity=8)
        labels = label_mask[cy, cx].astype(np.float32)
        attribs = np.stack([
            centers2[:, 0], centers2[:, 1], height, width,
            cos_map[cy, cx], sin_map[cy, cx], labels], axis=1)
        return attribs.astype(np.float32)

    def generate(self, polygons, polygons_ignore, h, w):
        gt_text = sl.generate_text_region_mask((h, w), polygons)
        gt_mask = sl.generate_effective_mask((h, w), polygons_ignore)
        (center_mask, top_map, bot_map, sin_map, cos_map,
         center_lines) = self._attrib_maps(polygons, h, w)
        comp_attribs = self.generate_comp_attribs(
            center_lines, center_mask, top_map, bot_map, sin_map, cos_map)
        # the true components jittered, then topped up with random label-0
        # ones off the text (reference drrg_targets.py:460-476)
        comp_attribs = self.jitter_comp_attribs(comp_attribs,
                                                self.jitter_level)
        if len(comp_attribs) < self.num_min_comps:
            rand = self.generate_rand_comp_attribs(
                self.num_min_comps - len(comp_attribs),
                (1 - gt_text).astype(np.uint8))
            comp_attribs = (np.vstack([comp_attribs, rand])
                            if len(comp_attribs) else rand)
        return {
            'gt_text_mask': gt_text.astype(np.float32),
            'gt_center_region_mask': center_mask.astype(np.float32),
            'gt_mask': gt_mask.astype(np.float32),
            'gt_top_height_map': top_map,
            'gt_bot_height_map': bot_map,
            'gt_sin_map': sin_map,
            'gt_cos_map': cos_map,
            'gt_comp_attribs': comp_attribs,
        }

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img'].shape[:2]
        results.update(self.generate(results.get('gt_polygons', []),
                                     results.get('gt_polygons_ignore', []),
                                     h, w))
        return results
