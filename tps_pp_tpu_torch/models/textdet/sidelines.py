"""Host-side text-polygon sideline geometry of the TextSnake and FCENet
target generators and postprocessors (a copy of
``tps_pp_tpu/models/textdet/sidelines.py``, which imports cv2; the port
keeps its own, its cv2 calls taken by ``datasets/pipelines/cv_ops.py``).

Re-implements reference ``datasets/pipelines/textdet_targets/
textsnake_targets.py:37-350`` (head/tail scoring, sideline reorder,
arc-length resampling, center-region attribute rasterization) and
``models/textdet/postprocess/utils.py`` (fill_hole :43-53, centralize
:56-83, merge_disks :86-114, skeletonize: the JAX package's morphological
thinning, not scikit-image's, which the reference calls).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ...datasets.pipelines import cv_ops

EPS = 1e-8


def _norm(v, axis=None):
    return np.linalg.norm(v, axis=axis)


def vector_angle(vec1, vec2):
    u1 = vec1 / (np.linalg.norm(vec1, axis=-1, keepdims=vec1.ndim > 1) + EPS)
    u2 = vec2 / (np.linalg.norm(vec2, axis=-1, keepdims=vec2.ndim > 1) + EPS)
    return np.arccos(np.clip(np.sum(u1 * u2, axis=-1), -1.0, 1.0))


def vector_slope(vec):
    return abs(vec[1] / (vec[0] + EPS))


def vector_sin(vec):
    return vec[1] / (_norm(vec) + EPS)


def vector_cos(vec):
    return vec[0] / (_norm(vec) + EPS)


def find_head_tail(points: np.ndarray, orientation_thr: float = 2.0):
    """Score-based head/tail edge localization
    (reference textsnake_targets.py:63-160)."""
    assert points.ndim == 2 and points.shape[0] >= 4 and points.shape[1] == 2
    if len(points) > 4:
        pad_points = np.vstack([points, points[0]])
        edge_vec = pad_points[1:] - pad_points[:-1]
        theta_sum, adjacent_vec_theta = [], []
        for i, ev in enumerate(edge_vec):
            adjacent_ind = [x % len(edge_vec) for x in [i - 1, i + 1]]
            adj = edge_vec[adjacent_ind]
            theta_sum.append(np.sum(vector_angle(ev, adj)))
            adjacent_vec_theta.append(vector_angle(adj[0], adj[1]))
        theta_sum_score = np.array(theta_sum) / np.pi
        adjacent_theta_score = np.array(adjacent_vec_theta) / np.pi
        poly_center = np.mean(points, axis=0)
        edge_dist = np.maximum(
            _norm(pad_points[1:] - poly_center, axis=-1),
            _norm(pad_points[:-1] - poly_center, axis=-1))
        dist_score = edge_dist / (np.max(edge_dist) + EPS)
        position_score = np.zeros(len(edge_vec))
        score = (0.5 * theta_sum_score + 0.15 * adjacent_theta_score +
                 0.35 * dist_score)
        if len(points) % 2 == 0:
            position_score[(len(score) // 2 - 1)] += 1
            position_score[-1] += 1
        score += 0.1 * position_score
        pad_score = np.concatenate([score, score])
        score_matrix = np.zeros((len(score), len(score) - 3))
        x = np.arange(len(score) - 3) / float(max(len(score) - 4, 1))
        gaussian = (1. / (np.sqrt(2. * np.pi) * 0.5) *
                    np.exp(-np.power((x - 0.5) / 0.5, 2.) / 2))
        gaussian = gaussian / np.max(gaussian)
        for i in range(len(score)):
            score_matrix[i, :] = score[i] + pad_score[
                (i + 2):(i + len(score) - 1)] * gaussian * 0.3
        head_start, tail_increment = np.unravel_index(score_matrix.argmax(),
                                                      score_matrix.shape)
        tail_start = (head_start + tail_increment + 2) % len(points)
        head_end = (head_start + 1) % len(points)
        tail_end = (tail_start + 1) % len(points)
        if head_end > tail_end:
            head_start, tail_start = tail_start, head_start
            head_end, tail_end = tail_end, head_end
        return [head_start, head_end], [tail_start, tail_end]
    # quadrangle: pick the shorter (vertical) edge pair as head/tail
    if vector_slope(points[1] - points[0]) + vector_slope(
            points[3] - points[2]) < vector_slope(
                points[2] - points[1]) + vector_slope(points[0] - points[3]):
        horizontal_edge_inds = [[0, 1], [2, 3]]
        vertical_edge_inds = [[3, 0], [1, 2]]
    else:
        horizontal_edge_inds = [[3, 0], [1, 2]]
        vertical_edge_inds = [[0, 1], [2, 3]]
    vertical_len_sum = (
        _norm(points[vertical_edge_inds[0][0]] -
              points[vertical_edge_inds[0][1]]) +
        _norm(points[vertical_edge_inds[1][0]] -
              points[vertical_edge_inds[1][1]]))
    horizontal_len_sum = (
        _norm(points[horizontal_edge_inds[0][0]] -
              points[horizontal_edge_inds[0][1]]) +
        _norm(points[horizontal_edge_inds[1][0]] -
              points[horizontal_edge_inds[1][1]]))
    if vertical_len_sum > horizontal_len_sum * orientation_thr:
        return horizontal_edge_inds[0], horizontal_edge_inds[1]
    return vertical_edge_inds[0], vertical_edge_inds[1]


def reorder_poly_edge(points: np.ndarray, orientation_thr: float = 2.0):
    """-> (head_edge, tail_edge, top_sideline, bot_sideline)
    (reference textsnake_targets.py:162-202)."""
    head_inds, tail_inds = find_head_tail(points, orientation_thr)
    head_edge, tail_edge = points[head_inds], points[tail_inds]
    pad_points = np.vstack([points, points])
    if tail_inds[1] < 1:
        tail_inds[1] = len(points)
    sideline1 = pad_points[head_inds[1]:tail_inds[1]]
    sideline2 = pad_points[tail_inds[1]:(head_inds[1] + len(points))]
    shift = np.mean(sideline1, axis=0) - np.mean(sideline2, axis=0)
    if shift[1] > 0:
        top_sideline, bot_sideline = sideline2, sideline1
    else:
        top_sideline, bot_sideline = sideline1, sideline2
    return head_edge, tail_edge, top_sideline, bot_sideline


def cal_curve_length(line: np.ndarray):
    edges = np.sqrt((line[1:, 0] - line[:-1, 0]) ** 2 +
                    (line[1:, 1] - line[:-1, 1]) ** 2)
    return edges, float(np.sum(edges))


def resample_line(line: np.ndarray, n: int) -> np.ndarray:
    """Arc-length-uniform resample (reference textsnake_targets.py:227-261)."""
    assert n > 2
    edges_length, total_length = cal_curve_length(line)
    t_org = np.insert(np.cumsum(edges_length), 0, 0)
    unit_t = total_length / (n - 1)
    t_eq = np.arange(1, n - 1, dtype=np.float32) * unit_t
    edge_ind = 0
    points = [line[0]]
    for t in t_eq:
        while edge_ind < len(edges_length) - 1 and t > t_org[edge_ind + 1]:
            edge_ind += 1
        t_l, t_r = t_org[edge_ind], t_org[edge_ind + 1]
        w = np.array([t_r - t, t - t_l], np.float32) / (t_r - t_l + EPS)
        points.append(np.dot(w, line[[edge_ind, edge_ind + 1]]))
    points.append(line[-1])
    return np.vstack(points)


def resample_sidelines(sideline1, sideline2, resample_step: float):
    _, l1 = cal_curve_length(sideline1)
    _, l2 = cal_curve_length(sideline2)
    n = max(int(float((l1 + l2) / 2) / resample_step) + 1, 3)
    return resample_line(sideline1, n), resample_line(sideline2, n)


def sideline_center(points: np.ndarray, resample_step: float = 4.0):
    """Common preamble: reorder + resample + midline, with degenerate-point
    dropping and direction normalization
    (reference textsnake_targets.py:377-420)."""
    n = len(points)
    keep = [i for i in range(n)
            if _norm(points[i] - points[(i + 1) % n]) > 1e-5]
    if len(keep) >= 4:
        # dropping duplicated consecutive vertices must not push a valid
        # polygon below the 4 points find_head_tail requires
        points = points[keep]
    _, _, top_line, bot_line = reorder_poly_edge(points)
    top, bot = resample_sidelines(top_line, bot_line, resample_step)
    bot = bot[::-1]
    center = (top + bot) / 2
    if vector_slope(center[-1] - center[0]) > 0.9:
        if (center[-1] - center[0])[1] < 0:
            center, top, bot = center[::-1], top[::-1], bot[::-1]
    else:
        if (center[-1] - center[0])[0] < 0:
            center, top, bot = center[::-1], top[::-1], bot[::-1]
    return top, bot, center


def shrink_ends(top, bot, center, resample_step: float):
    """Trim head/tail by a quarter of the end heights
    (reference textsnake_targets.py:408-420 / fcenet_targets.py:76-85)."""
    head = _norm(top[0] - bot[0]) / 4.0
    tail = _norm(top[-1] - bot[-1]) / 4.0
    hn, tn = int(head // resample_step), int(tail // resample_step)
    if len(center) > hn + tn + 2:
        center = center[hn:len(center) - tn]
        top = top[hn:len(top) - tn]
        bot = bot[hn:len(bot) - tn]
    return top, bot, center


def draw_center_region_maps(top, bot, center, center_region_mask, radius_map,
                            sin_map, cos_map, region_shrink_ratio: float):
    """(reference textsnake_targets.py:296-348)"""
    for i in range(0, len(center) - 1):
        top_mid = (top[i] + top[i + 1]) / 2
        bot_mid = (bot[i] + bot[i + 1]) / 2
        radius = _norm(top_mid - bot_mid) / 2
        direction = center[i + 1] - center[i]
        sin_theta, cos_theta = vector_sin(direction), vector_cos(direction)
        tl = center[i] + (top[i] - center[i]) * region_shrink_ratio
        tr = center[i + 1] + (top[i + 1] - center[i + 1]) * \
            region_shrink_ratio
        br = center[i + 1] + (bot[i + 1] - center[i + 1]) * \
            region_shrink_ratio
        bl = center[i] + (bot[i] - center[i]) * region_shrink_ratio
        box = np.vstack([tl, tr, br, bl]).astype(np.int32)
        cv_ops.fill_poly(center_region_mask, [box], 1)
        if sin_map is not None:
            cv_ops.fill_poly(sin_map, [box], float(sin_theta))
        if cos_map is not None:
            cv_ops.fill_poly(cos_map, [box], float(cos_theta))
        if radius_map is not None:
            cv_ops.fill_poly(radius_map, [box], float(radius))


def generate_center_mask_attrib_maps(img_size: Tuple[int, int], text_polys,
                                     resample_step=4.0,
                                     center_region_shrink_ratio=0.3):
    """TextSnake gt: center mask + radius/sin/cos maps
    (reference textsnake_targets.py:350-429)."""
    h, w = img_size
    center_region_mask = np.zeros((h, w), np.uint8)
    radius_map = np.zeros((h, w), np.float32)
    sin_map = np.zeros((h, w), np.float32)
    cos_map = np.zeros((h, w), np.float32)
    for poly in text_polys:
        pts = np.asarray(poly, np.float32).reshape(-1, 2)
        if len(pts) < 4:
            continue
        top, bot, center = sideline_center(pts, resample_step)
        top, bot, center = shrink_ends(top, bot, center, resample_step)
        draw_center_region_maps(top, bot, center, center_region_mask,
                                radius_map, sin_map, cos_map,
                                center_region_shrink_ratio)
    return center_region_mask, radius_map, sin_map, cos_map


def generate_center_region_mask(img_size, text_polys, resample_step=4.0,
                                center_region_shrink_ratio=0.3):
    """FCENet variant: center mask only (reference fcenet_targets.py:47-105,
    which does NOT direction-normalize the center line)."""
    h, w = img_size
    mask = np.zeros((h, w), np.uint8)
    for poly in text_polys:
        pts = np.asarray(poly, np.float32).reshape(-1, 2)
        if len(pts) < 4:
            continue
        _, _, top_line, bot_line = reorder_poly_edge(pts)
        top, bot = resample_sidelines(top_line, bot_line, resample_step)
        bot = bot[::-1]
        center = (top + bot) / 2
        top, bot, center = shrink_ends(top, bot, center, resample_step)
        draw_center_region_maps(top, bot, center, mask, None, None, None,
                                center_region_shrink_ratio)
    return mask


def generate_text_region_mask(img_size, text_polys):
    h, w = img_size
    mask = np.zeros((h, w), np.uint8)
    for poly in text_polys:
        pts = np.asarray(poly, np.float32).reshape(-1, 2)
        cv_ops.fill_poly(mask, [pts.astype(np.int32)], 1)
    return mask


def generate_effective_mask(img_size, ignore_polys):
    h, w = img_size
    mask = np.ones((h, w), np.uint8)
    for poly in ignore_polys:
        pts = np.asarray(poly, np.float32).reshape(-1, 2)
        cv_ops.fill_poly(mask, [pts.astype(np.int32)], 0)
    return mask


# ------------------------------------------------ postprocess geometry ----

def fill_hole(input_mask: np.ndarray) -> np.ndarray:
    """(reference postprocess/utils.py:43-53)"""
    h, w = input_mask.shape
    canvas = np.zeros((h + 2, w + 2), np.uint8)
    canvas[1:h + 1, 1:w + 1] = input_mask.copy()
    cv_ops.flood_fill(canvas, (0, 0), 1)
    canvas = canvas[1:h + 1, 1:w + 1].astype(bool)
    return (~canvas) | input_mask.astype(bool)


def skeletonize(mask: np.ndarray) -> np.ndarray:
    """Morphological thinning, the JAX package's (scikit-image is absent
    there; this iterative erode/open skeleton plays the part of
    skimage.morphology.skeletonize in the reference postprocessor)."""
    img = (mask > 0).astype(np.uint8)
    skel = np.zeros_like(img)
    kernel = cv_ops.get_structuring_element((3, 3), cv_ops.MORPH_CROSS)
    # a border of 0: cv2's default erosion border is +inf, so a mask
    # touching the image edge would never erode to empty (infinite loop)
    while True:
        opened = cv_ops.morphology_open(img, kernel)
        skel |= img - opened           # opened <= img: no saturation
        img = cv_ops.erode(img, kernel)
        if not img.any():
            break
    return skel > 0


def centralize(points_yx, normal_sin, normal_cos, radius, contour_mask,
               step_ratio=0.03):
    """Slide skeleton points to the local width center
    (reference postprocess/utils.py:56-83)."""
    h, w = contour_mask.shape
    top_yx = bot_yx = points_yx.astype(np.float64)
    step = step_ratio * radius * np.hstack([normal_sin, normal_cos])
    # points whose step is ~0 (degenerate/untrained radius prediction)
    # could never leave the mask — the reference assumes trained positive
    # radii; freeze them instead of spinning forever, and hard-cap the walk
    # at the worst-case mask crossing
    step_sizes = np.abs(step).max(axis=1, keepdims=True)
    alive = step_sizes > 1e-6
    # cap the walk so the SMALLEST live step can still cross the mask: a
    # single garbage huge radius must not freeze normal points mid-walk
    live = step_sizes[alive]
    min_step = float(live.min()) if live.size else 1.0
    max_iters = min(int(np.ceil((h + w) / max(min_step, 1e-3))) + 8, 4096)
    for sign in (1.0, -1.0):
        cur = top_yx if sign > 0 else bot_yx
        step_flags = alive.copy()
        for _ in range(max_iters):
            if not np.any(step_flags):
                break
            next_yx = np.array(cur + sign * step, dtype=np.int32)
            ny, nx = next_yx[:, 0], next_yx[:, 1]
            inside = ((ny >= 0) & (ny < h) & (nx >= 0) & (nx < w) &
                      contour_mask[np.clip(ny, 0, h - 1),
                                   np.clip(nx, 0, w - 1)].astype(bool))
            step_flags = step_flags & inside.reshape(-1, 1)
            cur = cur + step_flags * sign * step
        if sign > 0:
            top_yx = cur
        else:
            bot_yx = cur
    return np.array((top_yx + bot_yx) * 0.5, dtype=np.int32)


def merge_disks(disks: np.ndarray, disk_overlap_thr: float) -> np.ndarray:
    """Greedy score-ordered disk merging
    (reference postprocess/utils.py:86-114)."""
    xy, radius, scores = disks[:, 0:2], disks[:, 2], disks[:, 3]
    order = scores.argsort()[::-1]
    merged: List[np.ndarray] = []
    while order.size > 0:
        if order.size == 1:
            merged.append(disks[order[0]])
            break
        i = order[0]
        d = _norm(xy[i] - xy[order[1:]], axis=1)
        d_thr = (radius[i] + radius[order[1:]]) * disk_overlap_thr
        merge_inds = np.where(d <= d_thr)[0] + 1
        if merge_inds.size > 0:
            merge_order = np.hstack([i, order[merge_inds]])
            merged.append(np.mean(disks[merge_order], axis=0))
        else:
            merged.append(disks[i])
        inds = np.where(d > d_thr)[0] + 1
        order = order[inds]
    return np.vstack(merged)
