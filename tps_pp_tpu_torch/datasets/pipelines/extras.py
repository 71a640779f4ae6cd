"""The remaining recognition pipeline transforms (counterpart of
``tps_pp_tpu/datasets/pipelines/extras.py``; reference
``pipelines/ocr_transforms.py``): OnlineCropOCR, FancyPCA,
RandomPaddingOCR, RandomRotateImageBox, OpencvToPil / PilToOpencv.

The draws come from the sample's generators (``results['rng']``,
``results['np_rng']``), the JAX transforms' from the global ``random`` /
``np.random`` seeded alike, in the same order. cv2's
``copyMakeBorder(BORDER_REPLICATE)`` is ``np.pad(mode='edge')``. The card's
machine has no PIL, so ``OpencvToPil`` hands on the RGB ``ndarray`` that
PIL's image would hold, ``RandomRotateImageBox`` rotates it with
``cv_ops.pil_rotate_nearest`` (PIL's nearest-neighbour ``rotate``, bit for
bit) and ``PilToOpencv`` takes it back to BGR.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ...registry import PIPELINES
from . import cv_ops
from .transforms import _rngs


@PIPELINES.register_module()
class OnlineCropOCR:
    """Crop a text region from a whole image by the box keys of its
    annotation, the corners jittered with probability ``jitter_prob``."""

    def __init__(self, box_keys=('x1', 'y1', 'x2', 'y2', 'x3', 'y3', 'x4',
                                 'y4'), jitter_prob=0.5,
                 max_jitter_ratio_x=0.05, max_jitter_ratio_y=0.02):
        self.box_keys = box_keys
        self.jitter_prob = jitter_prob
        self.max_jitter_ratio_x = max_jitter_ratio_x
        self.max_jitter_ratio_y = max_jitter_ratio_y

    def __call__(self, results: Dict) -> Dict:
        rng, np_rng = _rngs(results)
        img_info = results.get('img_info', {})
        if not all(k in img_info for k in self.box_keys):
            return results
        pts = np.array([float(img_info[k]) for k in self.box_keys],
                       np.float32).reshape(-1, 2)
        if rng.random() < self.jitter_prob:
            w = pts[:, 0].max() - pts[:, 0].min()
            h = pts[:, 1].max() - pts[:, 1].min()
            pts[:, 0] += np_rng.uniform(
                -self.max_jitter_ratio_x, self.max_jitter_ratio_x,
                len(pts)) * w
            pts[:, 1] += np_rng.uniform(
                -self.max_jitter_ratio_y, self.max_jitter_ratio_y,
                len(pts)) * h
        img = results['img']
        x0 = min(max(int(pts[:, 0].min()), 0), img.shape[1] - 1)
        x1 = min(int(math.ceil(pts[:, 0].max())), img.shape[1])
        y0 = min(max(int(pts[:, 1].min()), 0), img.shape[0] - 1)
        y1 = min(int(math.ceil(pts[:, 1].max())), img.shape[0])
        crop = img[y0:max(y1, y0 + 1), x0:max(x1, x0 + 1)]
        results['img'] = crop
        results['img_shape'] = crop.shape
        return results


@PIPELINES.register_module()
class FancyPCA:
    """AlexNet-style PCA colour jitter on ImageNet's RGB eigenvectors (the
    columns of ``_EIG_VEC``; column 0 is the luminance direction)."""

    _EIG_VEC = np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], np.float32)
    _EIG_VAL = np.array([0.2175, 0.0188, 0.0045], np.float32)

    def __init__(self, alpha_std=0.1):
        self.alpha_std = alpha_std

    def __call__(self, results: Dict) -> Dict:
        _, np_rng = _rngs(results)
        img = results['img'].astype(np.float32)
        if img.shape[-1] != 3:
            return results
        alpha = np_rng.normal(0, self.alpha_std, 3).astype(np.float32)
        noise = (self._EIG_VEC @ (alpha * self._EIG_VAL))[::-1]  # RGB->BGR
        scale = 255.0 if results['img'].dtype == np.uint8 else 1.0
        img = img + noise[None, None, :] * scale
        results['img'] = np.clip(img, 0, scale if scale > 1 else None
                                 ).astype(results['img'].dtype)
        return results


@PIPELINES.register_module()
class RandomPaddingOCR:
    """Random border padding, edges replicated (reference
    ocr_transforms.py:261-315). ``max_ratio`` is [left, top, right, bottom]
    (the horizontal ratios of the width, the vertical of the height); with
    ``box_type`` the character boxes shift by the (left, top) pad."""

    def __init__(self, max_ratio=(0.1, 0.2, 0.1, 0.2), box_type=None):
        assert box_type in (None, 'char_rects', 'char_quads')
        self.max_ratio = max_ratio
        self.box_type = box_type

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        img = results['img']
        h, w = img.shape[:2]
        left = round(rng.uniform(0, self.max_ratio[0]) * w)
        top = round(rng.uniform(0, self.max_ratio[1]) * h)
        right = round(rng.uniform(0, self.max_ratio[2]) * w)
        bottom = round(rng.uniform(0, self.max_ratio[3]) * h)
        pad = ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2)
        out = np.pad(img, pad, mode='edge')
        if out.ndim == 2:
            out = out[:, :, None]
        results['img'] = out
        results['img_shape'] = out.shape
        if self.box_type is not None and 'ann_info' in results:
            boxes = results['ann_info'].get(self.box_type, [])
            results['ann_info'][self.box_type] = [
                [v + (left if i % 2 == 0 else top)
                 for i, v in enumerate(box)] for box in boxes]
        return results


def _clip_poly_to_rect(pts, w, h):
    """Sutherland-Hodgman clip of a simple polygon to [0, w] x [0, h]; the
    clipped vertices (possibly none)."""
    def clip_edge(poly, inside, intersect):
        out = []
        n = len(poly)
        for i in range(n):
            cur, nxt = poly[i], poly[(i + 1) % n]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def x_cross(a, b, x):
        t = (x - a[0]) / (b[0] - a[0])
        return (x, a[1] + t * (b[1] - a[1]))

    def y_cross(a, b, y):
        t = (y - a[1]) / (b[1] - a[1])
        return (a[0] + t * (b[0] - a[0]), y)

    poly = list(pts)
    for inside, intersect in (
            (lambda p: p[0] >= 0, lambda a, b: x_cross(a, b, 0.0)),
            (lambda p: p[0] <= w, lambda a, b: x_cross(a, b, float(w))),
            (lambda p: p[1] >= 0, lambda a, b: y_cross(a, b, 0.0)),
            (lambda p: p[1] <= h, lambda a, b: y_cross(a, b, float(h)))):
        if not poly:
            return []
        poly = clip_edge(poly, inside, intersect)
    return poly


def _shoelace_area(pts):
    if len(pts) < 3:
        return 0.0
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


@PIPELINES.register_module()
class RandomRotateImageBox:
    """Rotate the RGB image (``OpencvToPil``'s) and its character boxes
    together (reference ocr_transforms.py:323-417, the seg recipe). The
    angle is clamped to +-arctan(h / w); the boxes rotate about the centre
    and are kept when at least 70% of a rotated box stays in the image."""

    def __init__(self, min_angle=-10, max_angle=10, box_type='char_quads'):
        assert box_type in ('char_rects', 'char_quads')
        self.min_angle = min_angle
        self.max_angle = max_angle
        self.box_type = box_type

    def __call__(self, results: Dict) -> Dict:
        _, np_rng = _rngs(results)
        img = results['img']
        h, w = img.shape[:2]
        cx, cy = w / 2.0, h / 2.0
        cap = math.degrees(math.atan2(cy, cx))
        angle = np_rng.uniform(max(self.min_angle, -cap),
                               min(self.max_angle, cap))
        rad = math.radians(angle)
        results['img'] = cv_ops.pil_rotate_nearest(img, angle, (cx, cy))

        chars = results['ann_info']['chars']
        boxes = results['ann_info'][self.box_type]
        out_boxes, out_chars = [], []
        # the image turns by `angle` counter-clockwise, its content points
        # by -angle about the centre
        cos_t, sin_t = math.cos(-rad), math.sin(-rad)
        for box, ch in zip(boxes, chars):
            pts = [((px - cx) * cos_t - (py - cy) * sin_t + cx,
                    (px - cx) * sin_t + (py - cy) * cos_t + cy)
                   for px, py in zip(box[0::2], box[1::2])]
            area = _shoelace_area(pts)
            if area <= 0:
                continue
            inter = _shoelace_area(_clip_poly_to_rect(pts, w, h))
            if inter / area >= 0.7:
                out_boxes.append([v for p in pts for v in p])
                out_chars.append(ch)
        results['ann_info']['chars'] = out_chars
        results['ann_info'][self.box_type] = out_boxes
        return results


@PIPELINES.register_module()
class OpencvToPil:
    """BGR -> the RGB array a PIL image would hold ((H, W) for one
    channel)."""

    def __call__(self, results: Dict) -> Dict:
        img = results['img'][..., ::-1]
        results['img'] = np.ascontiguousarray(
            img.squeeze() if img.shape[-1] == 1 else img)
        return results


@PIPELINES.register_module()
class PilToOpencv:
    """``OpencvToPil``'s array (or a PIL image) -> BGR (H, W, C)."""

    def __call__(self, results: Dict) -> Dict:
        img = np.asarray(results['img'])
        if img.ndim == 2:
            img = img[:, :, None]
        else:
            img = img[..., ::-1]
        results['img'] = np.ascontiguousarray(img)
        return results
