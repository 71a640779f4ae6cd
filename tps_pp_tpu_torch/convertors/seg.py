"""Segmentation-recognition codec (counterpart of
``tps_pp_tpu/convertors/seg.py:17-74``; reference ``convertors/seg.py``).

``<BG>`` at index 0 and, with ``with_unknown``, ``<UKN>`` last. Decoding:
the per-pixel argmax over the row's valid width (``int(W * vr + 1)``
columns), the connected components of the non-background pixels
(8-connectivity), each component's class by majority vote (the first index
on a tie), the components left to right by centroid x (a stable sort),
those under 20 pixels dropped after the sort, ``<UKN>`` as ``''``, and a
character's score ``counts[cls] / size``.

JAX labels with ``cv2.connectedComponentsWithStats``; the port labels with
``cv_ops.connected_components``, in cv2's order (its 2 x 2 block scan at
8-connectivity). The order matters only where two components' centroids
tie in x.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..registry import CONVERTORS
from .base import BaseConvertor

MIN_AREA = 20


def label_components(mask: np.ndarray):
    """(count, labels, areas, centroid x) of the 8-connected components of
    ``mask`` (H, W) bool, numbered from 1 in cv2's order
    (``cv_ops.connected_components``); label 0 is the background, as in
    cv2, with its own area and centroid."""
    from ..datasets.pipelines.cv_ops import connected_components
    n, lab = connected_components(mask, connectivity=8)
    lab = lab.astype(np.int64)
    areas = np.bincount(lab.ravel(), minlength=n)
    xs = np.broadcast_to(np.arange(mask.shape[1]), mask.shape)
    cx = np.bincount(lab.ravel(), weights=xs.ravel().astype(np.float64),
                     minlength=n) / np.maximum(areas, 1)
    return n, lab, areas, cx


@CONVERTORS.register_module()
class SegConvertor(BaseConvertor):

    def __init__(self, dict_type='DICT36', dict_file=None, dict_list=None,
                 with_unknown=True, lower=False, **kwargs):
        super().__init__(dict_type, dict_file, dict_list)
        self.with_unknown = bool(with_unknown)
        self.lower = bool(lower)
        self.update_dict()

    def update_dict(self):
        self.idx2char.insert(0, '<BG>')
        self.unknown_idx = None
        if self.with_unknown:
            self.idx2char.append('<UKN>')
            self.unknown_idx = len(self.idx2char) - 1
        self._rebuild_char2idx()

    def tensor2str(self, output, img_metas=None):
        """output: (N, H, W, C) seg logits (NHWC), an array or a tensor.
        Returns (texts, scores), a list of per-character scores a row."""
        output = np.asarray(output)
        N, H, W, C = output.shape
        n_cls = len(self.idx2char)
        texts, scores = [], []
        for b in range(N):
            vr = (img_metas[b].get('valid_ratio', 1.0)
                  if img_metas else 1.0)
            valid_width = int(W * vr + 1)
            seg = output[b, :, :min(valid_width, W)].argmax(-1).astype(
                np.int64)
            n, lab, areas, cx = label_components(seg != 0)
            # each component's class histogram, as np.bincount of its
            # pixels with minlength n_cls (a class past it widens it)
            width = max(n_cls, int(seg.max()) + 1)
            counts = np.bincount((lab * width + seg).ravel(),
                                 minlength=n * width).reshape(n, width)
            all_res = []
            for i in range(n):
                if areas[i] == 0:
                    continue
                cls = int(counts[i].argmax())
                if cls == 0:
                    continue
                all_res.append((cls, cx[i], int(counts[i, cls]),
                                counts[i, cls] / max(int(areas[i]), 1)))
            all_res.sort(key=lambda r: r[1])
            chars: List[str] = []
            char_scores: List[float] = []
            for cls, _, area, score in all_res:
                if area < MIN_AREA:
                    continue
                if cls <= 0 or cls >= n_cls or cls == self.unknown_idx:
                    ch = ''
                else:
                    ch = self.idx2char[cls]
                chars.append(ch)
                char_scores.append(float(score))
            texts.append(''.join(chars))
            scores.append(char_scores)
        return texts, scores
