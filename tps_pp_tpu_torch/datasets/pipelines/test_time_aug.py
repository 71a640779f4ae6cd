"""Rotation test-time augmentation for tall crops (counterpart of
``tps_pp_tpu/datasets/pipelines/test_time_aug.py``, the reference's
``pipelines/test_time_aug.py``).

A crop taller than wide (or any crop with ``force_rotate``) is also read
rotated; ``merge_aug_results`` keeps the hypothesis of the highest mean
score (reference ``encode_decode_recognizer.py:227-236``). The 90, 180 and
270 degree variants are ``np.rot90``; any other angle is cv2's
``warpAffine``, and only that imports cv2, inside the call.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...registry import PIPELINES
from .transforms import Compose


@PIPELINES.register_module()
class MultiRotateAugOCR:
    def __init__(self, rotate_degrees=(0, 90, 270), force_rotate=False,
                 transforms=(), **kwargs):
        self.rotate_degrees = list(rotate_degrees)
        self.force_rotate = force_rotate
        # the rest of the test pipeline, applied to every variant
        self.transforms = Compose(transforms) if transforms else None

    def should_rotate(self, img: np.ndarray) -> bool:
        h, w = img.shape[:2]
        return self.force_rotate or h > w

    def expand(self, img: np.ndarray) -> List[np.ndarray]:
        if not self.should_rotate(img):
            return [img]
        out = []
        for deg in self.rotate_degrees:
            if deg in (0, 90, 180, 270):
                # the reference's mapping: 90 is one counter-clockwise
                # np.rot90, 180 two, 270 three
                out.append(np.ascontiguousarray(np.rot90(img, k=deg // 90)))
            else:
                import cv2
                h, w = img.shape[:2]
                M = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
                out.append(cv2.warpAffine(img, M, (w, h)))
        return out

    def __call__(self, results: Dict) -> Dict:
        variants = self.expand(results['img'])
        if self.transforms is None:
            results['aug_imgs'] = variants
            results['aug_n'] = len(variants)
            results['aug_total'] = len(self.rotate_degrees)
            return results
        processed = []
        for v in variants:
            r = dict(results)
            r['img'] = v
            p = self.transforms(r)
            if p is None:   # a filtered sample drops the whole item
                return None
            processed.append(p)
        out = dict(processed[0])
        out['aug_imgs'] = [p['img'] for p in processed]
        out['aug_metas'] = [p.get('img_metas', {}) for p in processed]
        out['aug_n'] = len(processed)
        out['aug_total'] = len(self.rotate_degrees)
        return out


def merge_aug_results(aug_results: List[Dict]) -> Dict:
    """The hypothesis of the highest mean score."""
    out_text, out_score = '', -1.0
    for result in aug_results:
        text = result['text']
        score = sum(result['score']) / max(1, len(text))
        if score > out_score:
            out_text, out_score = text, score
    return dict(text=out_text, score=out_score)
