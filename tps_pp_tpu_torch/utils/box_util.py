"""Box utilities of the end-to-end OCR (a copy of
``tps_pp_tpu/utils/box_util.py:16-101``, the reference's
``mmocr/utils/box_util.py`` and ``datasets/pipelines/crop.py``).

* ``is_on_same_line`` / ``stitch_boxes_into_lines``: word boxes merged into
  text lines by y-overlap and x-gap (box_util.py:5-119).
* ``crop_img``: the padded axis-aligned crop of a quadrangle (crop.py:
  87-125).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def is_on_same_line(box_a, box_b, min_y_overlap_ratio=0.8) -> bool:
    """True if the two quads overlap vertically by at least
    ``min_y_overlap_ratio`` of either box's height (box_util.py:5-40)."""
    a_y_min, a_y_max = np.min(box_a[1::2]), np.max(box_a[1::2])
    b_y_min, b_y_max = np.min(box_b[1::2]), np.max(box_b[1::2])
    if a_y_min > b_y_min:
        a_y_min, b_y_min = b_y_min, a_y_min
        a_y_max, b_y_max = b_y_max, a_y_max
    if b_y_min <= a_y_max:
        if min_y_overlap_ratio is None:
            return True
        sorted_y = sorted([b_y_min, b_y_max, a_y_max])
        overlap = sorted_y[1] - sorted_y[0]
        return (overlap >= (a_y_max - a_y_min) * min_y_overlap_ratio or
                overlap >= (b_y_max - b_y_min) * min_y_overlap_ratio)
    return False


def stitch_boxes_into_lines(boxes: List[Dict], max_x_dist=10,
                            min_y_overlap_ratio=0.8) -> List[Dict]:
    """Merge word boxes ({'box': [8 floats], 'text': str}) into line boxes
    (box_util.py:43-119): group left-to-right by same-line test, split on
    x-gaps > max_x_dist, join texts with spaces."""
    if len(boxes) <= 1:
        return boxes
    merged_boxes = []
    x_sorted = sorted(boxes, key=lambda x: np.min(x['box'][::2]))
    skip = set()
    for i in range(len(x_sorted)):
        if i in skip:
            continue
        rightmost = i
        line = [rightmost]
        for j in range(i + 1, len(x_sorted)):
            if j in skip:
                continue
            if is_on_same_line(x_sorted[rightmost]['box'],
                               x_sorted[j]['box'], min_y_overlap_ratio):
                line.append(j)
                skip.add(j)
                rightmost = j
        # split on large horizontal gaps
        lines = [[line[0]]]
        for k in range(1, len(line)):
            cur, prev = x_sorted[line[k]], x_sorted[line[k - 1]]
            dist = np.min(cur['box'][::2]) - np.max(prev['box'][::2])
            if dist > max_x_dist:
                lines.append([])
            lines[-1].append(line[k])
        for group in lines:
            text = ' '.join(x_sorted[idx]['text'] for idx in group)
            xs = np.concatenate([np.asarray(x_sorted[idx]['box'][::2])
                                 for idx in group])
            ys = np.concatenate([np.asarray(x_sorted[idx]['box'][1::2])
                                 for idx in group])
            x_min, x_max = float(xs.min()), float(xs.max())
            y_min, y_max = float(ys.min()), float(ys.max())
            merged_boxes.append({
                'text': text,
                'box': [x_min, y_min, x_max, y_min, x_max, y_max, x_min,
                        y_max],
            })
    return merged_boxes


def crop_img(src_img: np.ndarray, box: Sequence[float],
             long_edge_pad_ratio=0.4, short_edge_pad_ratio=0.2) -> np.ndarray:
    """Axis-aligned crop of an 8-point quad with font-size-proportional
    padding (crop.py:87-125)."""
    assert len(box) == 8
    h, w = src_img.shape[:2]
    xs = np.clip(np.asarray(box[0::2], np.float32), 0, w)
    ys = np.clip(np.asarray(box[1::2], np.float32), 0, h)
    bw, bh = xs.max() - xs.min(), ys.max() - ys.min()
    font_size = min(bh, bw)
    if bh < bw:
        hp, vp = long_edge_pad_ratio * font_size, \
            short_edge_pad_ratio * font_size
    else:
        hp, vp = short_edge_pad_ratio * font_size, \
            long_edge_pad_ratio * font_size
    left = int(np.clip(xs.min() - hp, 0, w))
    top = int(np.clip(ys.min() - vp, 0, h))
    right = int(np.clip(xs.max() + hp, 0, w))
    bottom = int(np.clip(ys.max() + vp, 0, h))
    return src_img[top:bottom, left:right]
