"""The segmentation recognizer's dataset (counterpart of
``tps_pp_tpu/datasets/ocr_seg_dataset.py:26-118``; reference
``datasets/ocr_seg_dataset.py``).

JSON lines, one object an image: ``{"file_name": ..., "text"?: ...,
"annotations": [{"char_box": [...], "char_text": "a",
"char_box_type"?: "xyxy" | "xywh"}, ...]}``, a ``char_box`` of 4 numbers
(a rect) or 8 (a quad). An item is the image decoded by ``cv2.imread``
(imported in the call, as ``LoadImageFromFile`` does), resized with the
aspect ratio kept to ``img_size``'s height (``cv_ops.resize_u8``,
``cv2.resize``'s bilinear) and padded on the right to its width, in
[0, 1]; outside test mode also ``OCRSegTargets``' kernels, resized by
``seg_downsample_ratio`` with ``cv_ops.resize_inter_nearest`` (exact).
``evaluate`` is ``eval_ocr_metric`` against the annotations' texts.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..evaluation import eval_ocr_metric
from ..registry import DATASETS
from .pipelines.cv_ops import resize_inter_nearest, resize_u8
from .pipelines.ocr_seg_targets import OCRSegTargets


def parse_char_anno(annotations: List[Dict]) -> Dict:
    """char_box (4 numbers, xyxy or xywh, or 8, a quad) -> rects and quads
    (reference ocr_seg_dataset.py:14-70)."""
    chars, char_rects, char_quads = [], [], []
    for ann in annotations:
        box = list(ann['char_box'])
        if len(box) == 4:
            if ann.get('char_box_type', 'xyxy') == 'xywh':
                x1, y1, w, h = box
                box = [x1, y1, x1 + w, y1 + h]
            x1, y1, x2, y2 = box
            char_rects.append([x1, y1, x2, y2])
            char_quads.append([x1, y1, x2, y1, x2, y2, x1, y2])
        elif len(box) == 8:
            xs, ys = box[0::2], box[1::2]
            char_rects.append([min(xs), min(ys), max(xs), max(ys)])
            char_quads.append(box)
        else:
            raise ValueError(f'invalid char box length {len(box)}')
        chars.append(ann['char_text'])
    return dict(chars=chars, char_rects=char_rects, char_quads=char_quads)


def _text(line: Dict) -> str:
    return line.get('text') or ''.join(
        a['char_text'] for a in line.get('annotations', []))


@DATASETS.register_module()
class OCRSegDataset:
    def __init__(self, ann_file: str, img_prefix: str = '',
                 img_size=(64, 256), label_convertor=None,
                 attn_shrink_ratio=0.5, seg_shrink_ratio=0.25,
                 box_type='char_rects', seg_downsample_ratio=0.5,
                 test_mode: bool = False, **kwargs):
        self.ann_file = ann_file
        with open(ann_file, encoding='utf-8') as f:
            self.lines = [json.loads(line) for line in f if line.strip()]
        self.img_prefix = img_prefix
        self.img_size = tuple(img_size)
        self.test_mode = test_mode
        self.seg_downsample_ratio = seg_downsample_ratio
        self.targets = OCRSegTargets(
            label_convertor=label_convertor or dict(type='SegConvertor'),
            attn_shrink_ratio=attn_shrink_ratio,
            seg_shrink_ratio=seg_shrink_ratio, box_type=box_type)
        self.label_convertor = self.targets.label_convertor

    def __len__(self):
        return len(self.lines)

    def __getitem__(self, index: int) -> Dict:
        import cv2
        line = self.lines[index]
        path = os.path.join(self.img_prefix, line['file_name'])
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        h0, w0 = img.shape[:2]
        H, W = self.img_size
        # keep-aspect resize to the target height, right-padded
        new_w = min(max(1, int(round(w0 * H / h0))), W)
        canvas = np.zeros((H, W, 3), np.uint8)
        canvas[:, :new_w] = resize_u8(img, new_w, H)
        out = {
            'img': canvas.astype(np.float32) / 255.0,
            'text': _text(line),
            'img_metas': {'filename': line['file_name'],
                          'valid_ratio': new_w / W,
                          'resize_shape': (H, new_w)},
        }
        if not self.test_mode and line.get('annotations'):
            results = self.targets({
                'img_shape': (h0, w0),
                'resize_shape': (H, new_w),
                'pad_shape': (H, W),
                'ann_info': parse_char_anno(line['annotations']),
            })
            r = self.seg_downsample_ratio
            w, h = int(W * r), int(H * r)
            for k in ('gt_seg', 'gt_attn', 'gt_mask'):
                out[k] = resize_inter_nearest(results[k], w, h)
        return out

    def evaluate(self, results: List[Dict], metric='acc', **kwargs) -> Dict:
        return eval_ocr_metric([r['text'] for r in results],
                               [_text(ln) for ln in self.lines])
