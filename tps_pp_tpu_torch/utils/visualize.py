"""Drawing the results (counterpart of ``tps_pp_tpu/utils/visualize.py``,
the reference's ``mmocr/core/visualize.py`` ``imshow_text_label``,
``imshow_pred_boundary``, ``det_recog_show_result``, ``imshow_edge`` and
the fork's TPS++ feature and point maps).

The same cv2 calls as the JAX package's, so the same pixels. Text is drawn
with ``cv2.putText``'s Hershey font, which has no numpy copy, so each
function imports cv2 when it is called, and raises an ``ImportError`` that
says so where cv2 is absent (the rest of the port runs without it).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            'utils.visualize draws with cv2 (cv2.putText\'s Hershey font, '
            'cv2.imwrite), and cv2 is not installed; the results '
            'themselves need no cv2') from e
    return cv2


def imshow_text_label(img: np.ndarray, pred_label: str, gt_label: str = '',
                      out_file: Optional[str] = None) -> np.ndarray:
    """Stack the crop above its predicted (and optional gt) text."""
    cv2 = _cv2()
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        img = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
    if img.ndim == 2 or img.shape[-1] == 1:
        img = cv2.cvtColor(img.squeeze(-1) if img.ndim == 3 else img,
                           cv2.COLOR_GRAY2BGR)
    h, w = img.shape[:2]
    bar_h = 24 * (2 if gt_label else 1)
    canvas = np.full((h + bar_h, max(w, 120), 3), 255, np.uint8)
    canvas[:h, :w] = img
    cv2.putText(canvas, f'pred: {pred_label}', (2, h + 16),
                cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 0, 255), 1)
    if gt_label:
        cv2.putText(canvas, f'gt: {gt_label}', (2, h + 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 128, 0), 1)
    if out_file:
        os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
        cv2.imwrite(out_file, canvas)
    return canvas


def draw_feature_map(feat: np.ndarray, out_file: Optional[str] = None,
                     size=(128, 32)) -> np.ndarray:
    """Mean-channel heat-map of an NHWC (or HWC) feature
    (fork visual_feat.py equivalent)."""
    cv2 = _cv2()
    f = np.asarray(feat, np.float32)
    if f.ndim == 4:
        f = f[0]
    heat = f.mean(-1)
    heat = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-6)
    heat = (heat * 255).astype(np.uint8)
    heat = cv2.resize(heat, size)
    heat = cv2.applyColorMap(heat, cv2.COLORMAP_JET)
    if out_file:
        os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
        cv2.imwrite(out_file, heat)
    return heat


def draw_point_map(img: np.ndarray, control_points: np.ndarray,
                   out_file: Optional[str] = None) -> np.ndarray:
    """Overlay predicted TPS++ fiducials ([0,1] coords) on a crop."""
    cv2 = _cv2()
    canvas = np.ascontiguousarray(img)
    if canvas.dtype != np.uint8:
        lo, hi = float(canvas.min()), float(canvas.max())
        canvas = ((canvas - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
    if canvas.shape[-1] == 1:
        canvas = cv2.cvtColor(canvas.squeeze(-1), cv2.COLOR_GRAY2BGR)
    h, w = canvas.shape[:2]
    for x, y in np.asarray(control_points).reshape(-1, 2):
        cv2.circle(canvas, (int(x * (w - 1)), int(y * (h - 1))), 2,
                   (0, 0, 255), -1)
    if out_file:
        os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
        cv2.imwrite(out_file, canvas)
    return canvas


def imshow_pred_boundary(img: np.ndarray, boundaries,
                         out_file: Optional[str] = None,
                         show_score: bool = True,
                         color=(0, 255, 0)) -> np.ndarray:
    """Draw detection boundaries ``[x1, y1, ..., score]`` on the image
    (reference core/visualize.py imshow_pred_boundary)."""
    cv2 = _cv2()
    vis = np.ascontiguousarray(img).copy()
    for b in boundaries:
        b = np.asarray(b, np.float32)
        pts = b[:-1].reshape(-1, 2).astype(np.int32)
        cv2.polylines(vis, [pts], True, color, 2)
        if show_score:
            cv2.putText(vis, f'{float(b[-1]):.2f}',
                        (int(pts[:, 0].min()), max(12, int(pts[:, 1].min()))),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    if out_file:
        cv2.imwrite(out_file, vis)
    return vis


def det_recog_show_result(img: np.ndarray, end2end_res: dict,
                          out_file: Optional[str] = None) -> np.ndarray:
    """Draw det boxes + recognized texts side by side (reference
    core/visualize.py:643 det_recog_show_result): left = image with green
    polygons, right = white canvas with the texts at box positions."""
    cv2 = _cv2()
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    canvas = np.full((h, w, 3), 255, np.uint8)
    boxed = img.copy()
    for r in end2end_res.get('result', []):
        box = np.asarray(r['box'], np.float32).reshape(-1, 2).astype(np.int32)
        cv2.polylines(boxed, [box], True, (0, 255, 0), 2)
        org = (int(box[:, 0].min()), max(12, int(box[:, 1].min())))
        cv2.putText(canvas, str(r.get('text', '')), org,
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    out = np.concatenate([boxed, canvas], axis=1)
    if out_file:
        cv2.imwrite(out_file, out)
    return out


_EDGE_COLORS = [(196, 32, 32), (32, 160, 32), (32, 32, 224), (160, 96, 0),
                (128, 0, 160), (0, 160, 160)]


def imshow_edge(img: np.ndarray, boxes: Sequence, texts: Sequence[str],
                nodes: np.ndarray, edges: np.ndarray, edge_thr: float = 0.5,
                out_file: Optional[str] = None) -> np.ndarray:
    """KIE node/edge visualization (reference core/visualize.py:822
    imshow_edge + draw_edge_result): left = image with per-node-class
    colored boxes, right = white panel listing extracted key -> value
    pairs with their edge scores.

    boxes: (n, 4) xyxy or (n, 8) quads; nodes: (n, C) class scores;
    edges: (n, n) link scores.
    """
    cv2 = _cv2()
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    nodes = np.asarray(nodes, np.float32)
    edges = np.asarray(edges, np.float32)
    edges = np.maximum(edges, edges.T)
    labels = nodes.argmax(-1)
    boxed = img.copy()
    for i, box in enumerate(boxes):
        b = np.asarray(box, np.float32).reshape(-1)
        if len(b) == 4:
            pts = np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                            [b[0], b[3]]], np.int32)
        else:
            pts = b.reshape(-1, 2).astype(np.int32)
        color = _EDGE_COLORS[int(labels[i]) % len(_EDGE_COLORS)]
        cv2.polylines(boxed, [pts], True, color, 1)
    panel = np.full((h, max(w, 240), 3), 255, np.uint8)
    y = 18
    n = min(len(boxes), len(edges))
    for i in range(n):
        for j in range(n):
            if i == j or edges[i, j] <= edge_thr:
                continue
            ti = texts[i] if i < len(texts) else str(i)
            tj = texts[j] if j < len(texts) else str(j)
            cv2.putText(panel, f'{ti} -> {tj}  {edges[i, j]:.2f}',
                        (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 0, 0), 1)
            y += 18
            if y > h - 6:
                break
        if y > h - 6:
            break
    out = np.concatenate([boxed, panel[:, :panel.shape[1]]], axis=1)
    if out_file:
        os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
        cv2.imwrite(out_file, out)
    return out
