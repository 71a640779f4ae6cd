"""Exact polygon area, intersection and IoU without shapely (a copy of
``tps_pp_tpu/evaluation/polygon.py``, which imports no JAX; the port keeps
its own so that it loads without the JAX package).

The reference computes the hmean-iou protocol's areas with shapely
(``mmocr/core/evaluation/utils.py:152-259``). For simple polygons:

  * convex with convex: a Sutherland-Hodgman clip and the shoelace (exact);
  * otherwise: an ear-clipping triangulation of each polygon, and the sum
    of the exact triangle-with-triangle areas; the triangulations
    partition each polygon, so the pairwise sum partitions the
    intersection (exact for simple, non-self-intersecting polygons).

Degenerate or self-intersecting inputs fall back to |shoelace| semantics.
"""
from __future__ import annotations

from typing import List

import numpy as np


def polygon_area(pts) -> float:
    """|shoelace| area of a simple polygon given as (k, 2) or flat (2k,)."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return abs(0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _signed_area(p) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _ccw(p) -> np.ndarray:
    return p if _signed_area(p) >= 0 else p[::-1]


def clip_convex(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip ``subject`` by CONVEX ``clip`` (both CCW).
    Returns the clipped polygon's vertices ((0, 2) if empty)."""
    poly = [tuple(pt) for pt in subject]
    cl = [tuple(pt) for pt in clip]
    n = len(cl)
    for k in range(n):
        if not poly:
            break
        ax, ay = cl[k]
        bx, by = cl[(k + 1) % n]
        out = []
        m = len(poly)
        for i in range(m):
            cx, cy = poly[i]
            dx, dy = poly[(i + 1) % m]
            cin = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax) >= 0
            nin = (bx - ax) * (dy - ay) - (by - ay) * (dx - ax) >= 0
            ix = iy = 0.0
            if cin != nin:
                den = (bx - ax) * (dy - cy) - (by - ay) * (dx - cx)
                t = (((cx - ax) * (dy - cy) - (cy - ay) * (dx - cx)) / den
                     if den else 0.0)
                ix, iy = ax + t * (bx - ax), ay + t * (by - ay)
            if cin:
                out.append((cx, cy))
                if not nin:
                    out.append((ix, iy))
            elif nin:
                out.append((ix, iy))
        poly = out
    return np.asarray(poly, np.float64).reshape(-1, 2)


def is_convex(p: np.ndarray) -> bool:
    """All cross products of consecutive edges share a sign (CCW input)."""
    if len(p) < 4:
        return True
    a = np.roll(p, -1, axis=0) - p
    b = np.roll(a, -1, axis=0)
    cross = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    return bool((cross >= -1e-12).all() or (cross <= 1e-12).all())


def triangulate(p: np.ndarray) -> List[np.ndarray]:
    """Ear-clipping triangulation of a simple CCW polygon. O(n^2); text
    boundaries are small. Collinear duplicate points are tolerated."""
    pts = list(range(len(p)))
    tris = []

    def cross(o, a, b):
        return ((p[a, 0] - p[o, 0]) * (p[b, 1] - p[o, 1]) -
                (p[a, 1] - p[o, 1]) * (p[b, 0] - p[o, 0]))

    def inside_tri(q, a, b, c):
        # CLOSED containment: a reflex vertex exactly on the candidate
        # ear's boundary must block it (e.g. an L-shape notch corner on
        # the ear's hypotenuse), else the remainder self-intersects
        d1 = (p[b, 0] - p[a, 0]) * (q[1] - p[a, 1]) - \
             (p[b, 1] - p[a, 1]) * (q[0] - p[a, 0])
        d2 = (p[c, 0] - p[b, 0]) * (q[1] - p[b, 1]) - \
             (p[c, 1] - p[b, 1]) * (q[0] - p[b, 0])
        d3 = (p[a, 0] - p[c, 0]) * (q[1] - p[c, 1]) - \
             (p[a, 1] - p[c, 1]) * (q[0] - p[c, 0])
        return d1 >= -1e-9 and d2 >= -1e-9 and d3 >= -1e-9

    guard = 0
    while len(pts) > 3 and guard < 10000:
        guard += 1
        n = len(pts)
        ear_found = False
        for i in range(n):
            a, b, c = pts[(i - 1) % n], pts[i], pts[(i + 1) % n]
            if cross(a, b, c) <= 1e-12:
                continue   # reflex or degenerate corner
            if any(inside_tri(p[j], a, b, c) for j in pts
                   if j not in (a, b, c)):
                continue
            tris.append(np.asarray([p[a], p[b], p[c]]))
            pts.pop(i)
            ear_found = True
            break
        if not ear_found:   # numerically stuck (near-degenerate input)
            break
    if len(pts) == 3:
        a, b, c = pts
        tris.append(np.asarray([p[a], p[b], p[c]]))
    return tris


def poly_intersection_area(a, b) -> float:
    """Exact intersection area of two simple polygons."""
    pa = _ccw(np.asarray(a, np.float64).reshape(-1, 2))
    pb = _ccw(np.asarray(b, np.float64).reshape(-1, 2))
    if len(pa) < 3 or len(pb) < 3:
        return 0.0
    if is_convex(pa) and is_convex(pb):
        return polygon_area(clip_convex(pa, pb))
    total = 0.0
    for ta in (triangulate(pa) if not is_convex(pa) else [pa]):
        for tb in (triangulate(pb) if not is_convex(pb) else [pb]):
            total += polygon_area(clip_convex(_ccw(ta), _ccw(tb)))
    return total


def poly_iou(a, b, zero_division: float = 0.0) -> float:
    """Exact polygon IoU (reference eval_utils.poly_iou semantics:
    union = area_a + area_b - intersection; 0-union returns
    ``zero_division``)."""
    inter = poly_intersection_area(a, b)
    union = polygon_area(a) + polygon_area(b) - inter
    return inter / union if union != 0 else zero_division
