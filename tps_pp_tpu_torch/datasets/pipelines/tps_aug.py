"""Data-side TPS warping augmentations: Stretch / Distort / Curve
(counterpart of ``tps_pp_tpu/datasets/pipelines/tps_aug.py``; reference
``pipelines/tps_transform.py:22-383``).

Control points on an image-border grid are jittered (x for Stretch, x and
y for Distort, a parabolic vertical shift for Curve), the TPS system from
the jittered points to the grid is solved with numpy in float64, and the
image is warped through ``cv_ops.remap_linear``, the copy of
``cv2.remap(INTER_LINEAR, BORDER_REPLICATE)`` that the JAX transform calls.
The draws come from the sample's generators (``results['rng']``,
``results['np_rng']``, ``datasets.seeded_rngs``), the JAX transform's from
the global ``random`` / ``np.random`` seeded alike, in the same order.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...registry import PIPELINES
from . import cv_ops
from .transforms import _hwc, _rngs


def _tps_warp(img: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Warp ``img`` so that the ``dst`` control points map to ``src`` (an
    inverse warp); (K, 2) pixel coordinates. The kernel is r^2 log r^2 (the
    reference's D2 * log(D2 + eps))."""
    H, W = img.shape[:2]
    K = src.shape[0]
    X = dst.astype(np.float64)          # control points in output space
    Y = src.astype(np.float64)          # where they come from in input space

    eps = 1e-9
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    Kmat = d2 * np.log(d2 + eps)
    P = np.concatenate([np.ones((K, 1)), X], axis=1)
    L = np.zeros((K + 3, K + 3))
    L[:K, :K] = Kmat
    L[:K, K:] = P
    L[K:, :K] = P.T
    Z = np.zeros((K + 3, 2))
    Z[:K] = Y
    Q = np.linalg.solve(L + np.eye(K + 3) * 1e-9, Z)
    Wc, A = Q[:K], Q[K:]

    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)
    d2g = ((grid[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    U = d2g * np.log(d2g + eps)
    Pg = np.concatenate([np.ones((grid.shape[0], 1)), grid], axis=1)
    mapped = Pg @ A + U @ Wc
    map_x = mapped[:, 0].reshape(H, W).astype(np.float32)
    map_y = mapped[:, 1].reshape(H, W).astype(np.float32)
    src_img = img[:, :, 0] if img.ndim == 3 and img.shape[2] == 1 else img
    return _hwc(cv_ops.remap_linear(src_img, map_x, map_y))


def _border_grid(W: int, H: int, nx: int = 4) -> List[List[float]]:
    """Control points along the top, middle and bottom rows at ``nx``
    columns."""
    pts = []
    for fx in np.linspace(0, 1, nx):
        x = fx * (W - 1)
        pts += [[x, 0.0], [x, (H - 1) / 2.0], [x, float(H - 1)]]
    return pts


@PIPELINES.register_module()
class Stretch:
    """Horizontal squeeze / stretch by x-jittered column control points."""

    def __init__(self, mag=-1, prob=0.5):
        self.mag = mag
        self.prob = prob

    def __call__(self, results: Dict) -> Dict:
        rng, np_rng = _rngs(results)
        if rng.random() > self.prob:
            return results
        img = results['img']
        H, W = img.shape[:2]
        frac = [0.2, 0.3, 0.4][self.mag if 0 <= self.mag < 3 else 2]
        src = np.asarray(_border_grid(W, H), np.float32)
        dst = src.copy()
        cell = 0.33 * W
        for col in range(4):
            dx = np_rng.uniform(-frac, frac) * cell
            if col == 0:
                dx = abs(dx)
            if col == 3:
                dx = -abs(dx)
            dst[col * 3:(col + 1) * 3, 0] += dx
        results['img'] = _tps_warp(img, src, dst)
        return results


@PIPELINES.register_module()
class Distort:
    """Free-form x and y jitter of the border control points."""

    def __init__(self, mag=-1, prob=0.5):
        self.mag = mag
        self.prob = prob

    def __call__(self, results: Dict) -> Dict:
        rng, np_rng = _rngs(results)
        if rng.random() > self.prob:
            return results
        img = results['img']
        H, W = img.shape[:2]
        frac = [0.2, 0.3, 0.4][self.mag if 0 <= self.mag < 3 else 2]
        src = np.asarray(_border_grid(W, H), np.float32)
        dst = src + np_rng.uniform(
            -frac, frac, src.shape).astype(np.float32) * \
            np.asarray([0.33 * W, 0.33 * H], np.float32)
        results['img'] = _tps_warp(img, src, dst)
        return results


@PIPELINES.register_module()
class Curve:
    """Vertical parabolic bend, 0 at the left and right edges."""

    def __init__(self, mag=-1, prob=0.5):
        self.mag = mag
        self.prob = prob

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        if rng.random() > self.prob:
            return results
        img = results['img']
        H, W = img.shape[:2]
        frac = [0.15, 0.25, 0.35][self.mag if 0 <= self.mag < 3 else 2]
        amp = frac * H * rng.choice([-1.0, 1.0])
        src = np.asarray(_border_grid(W, H, nx=5), np.float32)
        dst = src.copy()
        for i, (x, _) in enumerate(src):
            t = x / max(W - 1, 1)
            dst[i, 1] += amp * (4 * t * (1 - t))
        results['img'] = _tps_warp(img, src, dst)
        return results
