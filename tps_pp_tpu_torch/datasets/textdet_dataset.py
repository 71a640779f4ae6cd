"""The text-detection dataset (counterpart of
``tps_pp_tpu/datasets/textdet_dataset.py:21-90``; the reference's
``TextDetDataset`` / ``IcdarDataset``).

Annotations are JSON lines, ``{'file_name', 'annotations': [{'polygon':
[x1, y1, ...], 'ignore'?}]}``. An item is the image resized to
``img_size`` (``cv_ops.resize_u8``, within one grey level of
``cv2.resize``) as float32 in [0, 1], its polygons scaled with it, and the
don't-care polygons apart. Images are decoded with ``cv2.imread`` inside
the call (``LoadImageFromFile``). Out of test mode an item also carries
DBNet's maps (``DBNetTargets(**target_cfg)``, as JAX's does for every
detector; ``train_detector`` makes another family's targets from the
polygons). No augmentation runs: JAX's ``train_detector`` never runs a
config's ``train_pipeline``. ``evaluate`` scores boundaries in the resized
coordinates with hmean-iou or hmean-ic13.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..registry import DATASETS
from .pipelines.cv_ops import resize_u8
from .pipelines.transforms import LoadImageFromFile


@DATASETS.register_module()
class TextDetDataset:
    def __init__(self, ann_file: str, img_prefix: str = '',
                 img_size=(640, 640), target_cfg: Optional[Dict] = None,
                 test_mode: bool = False, **kwargs):
        from ..models.textdet.targets import DBNetTargets
        self.targets = DBNetTargets(**(target_cfg or {}))
        self.ann_file = ann_file
        with open(ann_file, encoding='utf-8') as f:
            self.lines = [json.loads(line) for line in f if line.strip()]
        self.img_prefix = img_prefix
        self.img_size = tuple(img_size)
        self.test_mode = test_mode
        self._sizes: Dict[int, tuple] = {}   # index -> the image's (h, w)

    def __len__(self):
        return len(self.lines)

    def _read(self, index: int) -> np.ndarray:
        path = os.path.join(self.img_prefix, self.lines[index]['file_name'])
        img = LoadImageFromFile()(dict(img_path=path))['img']
        self._sizes[index] = img.shape[:2]
        return img

    def _polygons(self, index: int, h0: int, w0: int):
        """The annotation's polygons scaled to ``img_size``: (cared,
        don't-care)."""
        H, W = self.img_size
        sx, sy = W / w0, H / h0
        polys, polys_ignore = [], []
        for ann in self.lines[index].get('annotations', []):
            p = np.asarray(ann['polygon'], np.float32).reshape(-1, 2)
            p[:, 0] *= sx
            p[:, 1] *= sy
            (polys_ignore if ann.get('ignore') else polys).append(p)
        return polys, polys_ignore

    def __getitem__(self, index: int) -> Dict:
        img = self._read(index)
        H, W = self.img_size
        polys, polys_ignore = self._polygons(index, *img.shape[:2])
        out = {
            'img': resize_u8(img, W, H).astype(np.float32) / 255.0,
            'gt_polygons': polys,
            'gt_polygons_ignore': polys_ignore,
            'img_metas': {'filename': self.lines[index]['file_name'],
                          'valid_ratio': 1.0},
            'text': '',
        }
        if not self.test_mode:
            out.update(self.targets.generate(polys, H, W,
                                             polygons_ignore=polys_ignore))
        return out

    def sample(self, index: int, key: Optional[int] = None) -> Dict:
        return self[index]

    def evaluate(self, results: List[List[np.ndarray]], metric='hmean-iou',
                 **kwargs) -> Dict:
        """results: each image's boundaries, in ``img_size``
        coordinates."""
        gts, gts_ignore = [], []
        for i in range(len(self)):
            if i not in self._sizes:
                self._read(i)
            polys, polys_ignore = self._polygons(i, *self._sizes[i])
            gts.append(polys)
            gts_ignore.append(polys_ignore)
        if metric == 'hmean-ic13':
            from ..evaluation.hmean_ic13 import eval_hmean_ic13
            return eval_hmean_ic13(results, gts, gt_ignore=gts_ignore)
        from ..evaluation import eval_hmean_iou
        return eval_hmean_iou(results, gts, gt_ignore=gts_ignore)


# the reference's COCO-style wrapper: the same JSON-lines loader
DATASETS.register_module(name='IcdarDataset')(TextDetDataset)
