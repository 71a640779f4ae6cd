"""Character-kernel targets of the segmentation recognizer (counterpart of
``tps_pp_tpu/datasets/pipelines/ocr_seg_targets.py:22-140``; reference
``datasets/pipelines/ocr_seg_targets.py``).

Each character box, scaled to the resized image, is shrunk (a rect about
its centre, a quad corner by corner towards its neighbours) and filled
into an attention kernel (1s, ``attn_shrink_ratio``) and a segmentation
kernel (the character's index, ``seg_shrink_ratio``), int32 maps of the
padded shape whose right and bottom padding strips hold ``pad_val``; the
mask is 1 but on the right padding. The fill is ``cv_ops.
fill_convex_poly``, ``cv2.fillConvexPoly``'s pixels without cv2.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ...registry import CONVERTORS, PIPELINES
from .cv_ops import fill_convex_poly


def shrink_char_rect(char_rect: Sequence[float], shrink_ratio: float):
    """Centred rectangle shrink (reference ocr_seg_targets.py:89-108)."""
    x_min, y_min, x_max, y_max = char_rect
    w, h = x_max - x_min, y_max - y_min
    x_min_s = round((x_min + x_max - w * shrink_ratio) / 2)
    y_min_s = round((y_min + y_max - h * shrink_ratio) / 2)
    x_max_s = round((x_min + x_max + w * shrink_ratio) / 2)
    y_max_s = round((y_min + y_max + h * shrink_ratio) / 2)
    return np.array([[x_min_s, y_min_s], [x_max_s, y_min_s],
                     [x_max_s, y_max_s], [x_min_s, y_max_s]])


def shrink_char_quad(char_quad: Sequence[float], shrink_ratio: float):
    """Corner-wise quadrangle shrink (reference ocr_seg_targets.py:48-87)."""
    points = [[char_quad[0], char_quad[1]], [char_quad[2], char_quad[3]],
              [char_quad[4], char_quad[5]], [char_quad[6], char_quad[7]]]

    def dist(p, q):
        return ((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2) ** 0.5

    shrink_points = []
    for idx, point in enumerate(points):
        p1 = points[(idx + 3) % 4]
        p2 = points[(idx + 1) % 4]
        d1, d2 = dist(p1, point), dist(p2, point)
        md = min(d1, d2)
        v1 = [p1[0] - point[0], p1[1] - point[1]]
        v2 = [p2[0] - point[0], p2[1] - point[1]]
        t1 = shrink_ratio * md / d1 if md != 0 else 0.
        t2 = shrink_ratio * md / d2 if md != 0 else 0.
        shrink_points.append([
            round(point[0] + v1[0] * t1 + v2[0] * t2),
            round(point[1] + v1[1] * t1 + v2[1] * t2),
        ])
    return np.array(shrink_points)


@PIPELINES.register_module()
class OCRSegTargets:
    """Pipeline step: char boxes + chars -> ``gt_attn``, ``gt_seg``,
    ``gt_mask`` and ``gt_kernels`` (the three as a list)."""

    def __init__(self, label_convertor=None, attn_shrink_ratio=0.5,
                 seg_shrink_ratio=0.25, box_type='char_rects', pad_val=255):
        assert 0. < attn_shrink_ratio < 1.0
        assert 0. < seg_shrink_ratio < 1.0
        assert box_type in ('char_rects', 'char_quads')
        assert label_convertor is not None
        self.attn_shrink_ratio = attn_shrink_ratio
        self.seg_shrink_ratio = seg_shrink_ratio
        self.box_type = box_type
        self.pad_val = pad_val
        if isinstance(label_convertor, dict):
            from ... import convertors  # noqa: F401 (registration)
            self.label_convertor = CONVERTORS.build(label_convertor)
        else:
            self.label_convertor = label_convertor

    def generate_kernels(self, resize_shape, pad_shape, char_boxes,
                         char_inds, shrink_ratio, binary):
        """One (pad_h, pad_w) int32 kernel; the right and bottom padding
        strips get ``pad_val`` (reference ocr_seg_targets.py:110-153)."""
        char_kernel = np.zeros(pad_shape, dtype=np.int32)
        char_kernel[:, resize_shape[1]:] = self.pad_val
        char_kernel[resize_shape[0]:, :] = self.pad_val
        for box, ind in zip(char_boxes, char_inds):
            if self.box_type == 'char_rects':
                poly = shrink_char_rect(box, shrink_ratio)
            else:
                poly = shrink_char_quad(box, shrink_ratio)
            fill_convex_poly(char_kernel, poly.astype(np.int32),
                             1 if binary else ind)
        return char_kernel

    def __call__(self, results: Dict) -> Dict:
        resize_shape = tuple(results['resize_shape'][:2])
        pad_shape = tuple(results['pad_shape'][:2])
        # the boxes are in the coordinates of the image ResizeOCR took
        # (its pre_resize_shape), else of the original
        src_shape = tuple(results.get('pre_resize_shape') or
                          results.get('ori_shape',
                                      results['img_shape']))[:2]
        h_scale = resize_shape[0] / src_shape[0]
        w_scale = resize_shape[1] / src_shape[1]

        char_boxes: List[List[float]] = []
        char_inds: List[int] = []
        ann = results['ann_info']
        npts = 2 if self.box_type == 'char_rects' else 4
        for i, box in enumerate(ann[self.box_type]):
            box = list(box)
            for j in range(npts):
                box[j * 2] = round(box[j * 2] * w_scale)
                box[j * 2 + 1] = round(box[j * 2 + 1] * h_scale)
            char_boxes.append(box)
            char_inds.append(
                self.label_convertor.str2idx([ann['chars'][i]])[0][0])

        attn = self.generate_kernels(resize_shape, pad_shape, char_boxes,
                                     char_inds, self.attn_shrink_ratio,
                                     binary=True)
        seg = self.generate_kernels(resize_shape, pad_shape, char_boxes,
                                    char_inds, self.seg_shrink_ratio,
                                    binary=False)
        mask = np.ones(pad_shape, dtype=np.int32)
        mask[:resize_shape[0], resize_shape[1]:] = 0
        results['gt_attn'] = attn
        results['gt_seg'] = seg
        results['gt_mask'] = mask
        results['gt_kernels'] = [attn, seg, mask]
        results['mask_fields'] = ['gt_kernels']
        return results
