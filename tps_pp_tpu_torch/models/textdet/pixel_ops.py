"""PSENet's and PANet's label growth on the host (counterparts of the JAX
package's native ``contour_expand`` and ``pixel_group``,
``native/tps_native.cpp:134-245``, wrapped at
``tps_pp_tpu/native.py:196-303``; the reference's ``mmcv.ops``).

Both are a breadth-first search from the labelled pixels in raster order,
a pixel's neighbours tried left, right, up, down; a pixel takes the label
of the first queued pixel that reaches it. The search runs here a level at
a time: a level's pixels in queue order, each neighbour claimed by the
smallest (queue rank, direction) that reaches it, the claims in that
order making the next level. That is the C++ queue's order, so ties
between labels fall as they do there. (The JAX package's numpy fallbacks,
which it runs only without its library, grow every label one step at a
time in a fixed direction order and can break ties otherwise.)
"""
from __future__ import annotations

from typing import List

import numpy as np

# the C++ order of the neighbours: (dy, dx) left, right, up, down
_STEPS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def _claims(frontier: np.ndarray, h: int, w: int, free: np.ndarray,
            accept=None):
    """The pixels the level ``frontier`` (flat indices in queue order)
    claims: (claimed pixels in claim order, the frontier index that claimed
    each). ``free`` is a flat bool of the claimable pixels; ``accept(src,
    dst)`` may refuse a claim (the embedding test)."""
    ys, xs = np.divmod(frontier, w)
    dst, key = [], []
    rank = np.arange(len(frontier))
    for d, (dy, dx) in enumerate(_STEPS):
        ny, nx = ys + dy, xs + dx
        ok = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        q = np.where(ok, ny * w + nx, 0)
        ok &= free[q]
        if accept is not None and ok.any():
            ok[ok] = accept(frontier[ok], q[ok])
        dst.append(q[ok])
        key.append(rank[ok] * 4 + d)
    dst = np.concatenate(dst)
    key = np.concatenate(key)
    order = np.argsort(key, kind='stable')
    dst, key = dst[order], key[order]
    _, first = np.unique(dst, return_index=True)
    first = np.sort(first)
    return dst[first], key[first] // 4


def _grow(labels: np.ndarray, mask: np.ndarray, h: int, w: int,
          accept=None) -> None:
    """Breadth-first growth of ``labels`` (flat int32 of an (h, w) map, in
    place) into the unlabelled pixels where ``mask`` (flat bool) is
    set."""
    frontier = np.flatnonzero(labels > 0)
    while len(frontier):
        free = (labels == 0) & mask
        dst, src = _claims(frontier, h, w, free, accept)
        labels[dst] = labels[frontier[src]]
        frontier = dst


def contour_expand(kernel_masks: np.ndarray, labels: np.ndarray,
                   min_kernel_area: int, region_num: int) -> np.ndarray:
    """PSENet's progressive scale expansion: the labels of the smallest
    kernel's components (``labels``, (H, W)), those of fewer than
    ``min_kernel_area`` pixels dropped, grown through each larger kernel
    in turn (``kernel_masks`` (K, H, W), index 0 the text mask and K-1 the
    smallest). Returns the (H, W) int32 labels."""
    kernel_masks = np.asarray(kernel_masks, np.uint8)
    k, h, w = kernel_masks.shape
    out = np.array(labels, np.int32).reshape(-1)
    if min_kernel_area > 0:
        known = (out > 0) & (out <= region_num)
        area = np.bincount(out[known], minlength=region_num + 1)
        out[known & (area[np.where(known, out, 0)] < min_kernel_area)] = 0
    for level in range(k - 2, -1, -1):
        _grow(out, kernel_masks[level].reshape(-1) != 0, h, w)
    return out.reshape(h, w)


def pixel_group(score: np.ndarray, mask: np.ndarray, embedding: np.ndarray,
                kernel_label: np.ndarray, kernel_contour: np.ndarray,
                kernel_region_num: int,
                distance_threshold: float) -> List[list]:
    """PANet's pixel aggregation: each kernel's label (``kernel_label``,
    its components) grown through the text pixels (``mask``) whose
    embedding lies within ``distance_threshold`` of the kernel's mean
    embedding (float32, the squares summed channel by channel as the C++
    does; the means summed in float64 in raster order). ``kernel_contour``
    is taken and not read, as in the C++ (its distance test covers the
    reference's contour case). Returns, for each label 1..region_num,
    ``[mean text score, pixel count, x0, y0, x1, y1, ...]``, or ``[0, 0]``
    for a label with no pixel."""
    score = np.asarray(score, np.float32)
    h, w = score.shape
    emb = np.asarray(embedding, np.float32).reshape(h * w, -1)
    labels = np.array(kernel_label, np.int32).reshape(-1)
    n = int(kernel_region_num)
    means = np.zeros((n + 1, emb.shape[1]), np.float32)
    sel = (labels > 0) & (labels <= n)
    counts = np.bincount(labels[sel], minlength=n + 1)
    for c in range(emb.shape[1]):
        sums = np.bincount(labels[sel], weights=emb[sel, c].astype(np.float64),
                           minlength=n + 1)
        means[:, c] = np.where(counts > 0, sums / np.maximum(counts, 1),
                               0.0).astype(np.float32)
    thr2 = np.float32(distance_threshold) * np.float32(distance_threshold)

    def near(src, dst):
        diff = emb[dst] - means[labels[src]]
        sq = diff * diff
        dist2 = sq[:, 0]
        for c in range(1, sq.shape[1]):
            dist2 = dist2 + sq[:, c]
        return dist2 <= thr2

    _grow(labels, np.asarray(mask).reshape(-1) != 0, h, w, near)
    labels = labels.reshape(h, w)
    out = []
    for r in range(1, n + 1):
        ys, xs = np.nonzero(labels == r)
        if len(ys) == 0:
            out.append([0.0, 0.0])
            continue
        avg = float(score[ys, xs].mean())
        pts = np.stack([xs, ys], axis=1).reshape(-1).astype(np.float32)
        out.append([avg, float(len(ys))] + pts.tolist())
    return out
