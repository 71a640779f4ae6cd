"""The test pipeline's transforms (counterpart of the test-time part of
``tps_pp_tpu/datasets/pipelines/transforms.py``): load, resize and pad with
``valid_ratio``, scale to [0, 1], normalise, collect. The training
augmentations of that file are not ported yet.

Host-side numpy, as in the JAX package. Where the port differs:

* cv2 is imported only by ``LoadImageFromFile`` (``cv2.imread``), inside
  its call: the machine that serves on the card may lack cv2, and a
  serving path fed with ndarrays never needs it. No other decoder stands
  in, because another JPEG decoder gives other pixels.
* ``ResizeOCR`` resizes with its own bilinear interpolation: cv2
  ``INTER_LINEAR``'s taps (half-pixel centres, clamped at the edges), in
  float32. cv2 rounds uint8 images through 11-bit fixed-point weights;
  this rounds the float32 value to nearest, so a uint8 pixel is within one
  grey level of cv2's (float32 images within float32 rounding).
* ``LoadImageFromNdarray`` converts grey <-> BGR in numpy with
  ``cv2.cvtColor``'s weights (uint8 in its 14-bit fixed point).

``tests/test_torch_pipeline.py`` holds each transform against its JAX
original.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ...registry import PIPELINES

# cv2.cvtColor's BGR -> grey weights (B, G, R): float, and uint8's 14-bit
# fixed point
_GRAY_W = (0.114, 0.587, 0.299)
_GRAY_W_FIXED, _GRAY_SHIFT = (1868, 9617, 4899), 14


def _bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR -> (H, W) grey, as ``cv2.COLOR_BGR2GRAY``."""
    if img.dtype == np.uint8:
        b, g, r = (img[..., i].astype(np.int32) for i in range(3))
        wb, wg, wr = _GRAY_W_FIXED
        y = (b * wb + g * wg + r * wr + (1 << (_GRAY_SHIFT - 1))) \
            >> _GRAY_SHIFT
        return y.astype(np.uint8)
    f = img.astype(np.float32)
    wb, wg, wr = (np.float32(w) for w in _GRAY_W)
    return (f[..., 0] * wb + f[..., 1] * wg + f[..., 2] * wr).astype(
        img.dtype)


def _linear_taps(src: int, dst: int):
    """cv2 ``INTER_LINEAR``'s taps along one axis: for each output index
    the two source indices and the float32 weight of the second; centres
    at half pixels, clamped at both edges."""
    if dst < 1 or src < 1:
        raise ValueError(f'cannot resize {src} pixels to {dst}')
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    below, above = i0 < 0, i0 >= src - 1
    i0[below], f[below] = 0, 0.0
    i0[above], f[above] = src - 1, 0.0
    return i0, np.minimum(i0 + 1, src - 1), f


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` with ``INTER_LINEAR``, without
    cv2: (H, W[, C]) -> (height, width[, C]), the input's dtype. Rows first,
    then columns, in float32; integer images rounded to nearest and
    clipped to their range."""
    x0, x1, fx = _linear_taps(img.shape[1], width)
    y0, y1, fy = _linear_taps(img.shape[0], height)
    src = img.astype(np.float32)
    if img.ndim == 3:
        fx, fy = fx[:, None], fy[:, None]
    one = np.float32(1.0)
    rows = src[:, x0] * (one - fx) + src[:, x1] * fx
    out = rows[y0] * (one - fy)[:, None] + rows[y1] * fy[:, None]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.floor(out + np.float32(0.5)), info.min, info.max)
    return out.astype(img.dtype)


@PIPELINES.register_module()
class LoadImageFromFile:
    """Decode ``img_prefix/img_info['filename']`` (or ``img_path``) with
    ``cv2.imread``: BGR, or grey with ``color_type='grayscale'``
    (``tps_pp_tpu/datasets/pipelines/transforms.py:31-53``)."""

    def __init__(self, color_type='color', **kwargs):
        self.color_type = color_type

    def __call__(self, results: Dict) -> Dict:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                'LoadImageFromFile decodes images with cv2.imread, and cv2 '
                'is not installed; pass decoded BGR ndarrays instead '
                '(LoadImageFromNdarray needs no cv2)') from e
        path = results.get('img_path')
        if path is None:
            prefix = results.get('img_prefix') or ''
            path = os.path.join(prefix, results['img_info']['filename'])
        flag = (cv2.IMREAD_GRAYSCALE if self.color_type == 'grayscale'
                else cv2.IMREAD_COLOR)
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 2:
            img = img[:, :, None]
        results['filename'] = path
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results


@PIPELINES.register_module()
class LoadImageFromNdarray(LoadImageFromFile):
    """An image already decoded, BGR or grey
    (``tps_pp_tpu/datasets/pipelines/transforms.py:56-72``); converted to
    ``color_type`` in numpy."""

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        if img.ndim == 2:   # 2-D grey: shape[-1] would be the width
            img = img[:, :, None]
        if self.color_type == 'grayscale' and img.shape[-1] == 3:
            img = _bgr_to_gray(img)[:, :, None]
        elif self.color_type == 'color' and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=2)
        results['filename'] = None
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results


@PIPELINES.register_module()
class ResizeOCR:
    """Resize to ``height``; with ``keep_aspect_ratio`` the width follows
    the aspect ratio, rounded to a multiple of 1 / ``width_downsample_ratio``
    and held within ``min_width`` and ``max_width``, and a crop narrower
    than ``max_width`` is padded on the right with ``img_pad_value``;
    ``valid_ratio`` is then its share of ``max_width``. Without it the crop
    is resized to ``max_width`` and ``valid_ratio`` stays 1.0
    (``tps_pp_tpu/datasets/pipelines/transforms.py:75-137``; the resize is
    :func:`resize_bilinear`)."""

    def __init__(self, height, min_width=None, max_width=None,
                 keep_aspect_ratio=True, img_pad_value=0,
                 width_downsample_ratio=1.0 / 16, backend=None):
        if not isinstance(height, int):
            raise ValueError('multi-scale (tuple) heights are not supported')
        if not keep_aspect_ratio and max_width is None:
            raise ValueError('keep_aspect_ratio=False needs max_width')
        self.height = height
        self.min_width = min_width
        self.max_width = max_width
        self.keep_aspect_ratio = keep_aspect_ratio
        self.img_pad_value = img_pad_value
        self.width_downsample_ratio = width_downsample_ratio

    def _resize(self, img, width):
        out = resize_bilinear(img, width, self.height)
        return out[:, :, None] if out.ndim == 2 else out

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        ori_height, ori_width = img.shape[:2]
        valid_ratio = 1.0
        if self.keep_aspect_ratio:
            new_width = math.ceil(float(self.height) / ori_height * ori_width)
            width_divisor = int(1 / self.width_downsample_ratio)
            if new_width % width_divisor != 0:
                new_width = round(new_width / width_divisor) * width_divisor
            if self.min_width is not None:
                new_width = max(self.min_width, new_width)
            if self.max_width is not None:
                valid_ratio = min(1.0, 1.0 * new_width / self.max_width)
                img_resize = self._resize(img, min(self.max_width, new_width))
                resize_shape = img_resize.shape
                if new_width < self.max_width:
                    pad = np.full(
                        (self.height, self.max_width, img_resize.shape[2]),
                        self.img_pad_value, dtype=img_resize.dtype)
                    pad[:, :img_resize.shape[1]] = img_resize
                    img_resize = pad
            else:
                img_resize = self._resize(img, new_width)
                resize_shape = img_resize.shape
        else:
            img_resize = self._resize(img, self.max_width)
            resize_shape = img_resize.shape
        results['img'] = img_resize
        results['pre_resize_shape'] = (ori_height, ori_width)
        results['img_shape'] = img_resize.shape
        results['resize_shape'] = resize_shape
        results['pad_shape'] = img_resize.shape
        results['valid_ratio'] = valid_ratio
        return results


@PIPELINES.register_module()
class ToTensorOCR:
    """uint8 HWC -> float32 in [0, 1]; other dtypes cast to float32
    (``tps_pp_tpu/datasets/pipelines/transforms.py:140-152``)."""

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
            results['img_scaled_01'] = True
        else:
            img = img.astype(np.float32)
        results['img'] = img
        return results


@PIPELINES.register_module()
class NormalizeOCR:
    """(img - mean) / std per channel; stats on the 0-255 scale over an
    image ``ToTensorOCR`` scaled to [0, 1] are scaled with it
    (``tps_pp_tpu/datasets/pipelines/transforms.py:155-172``)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results: Dict) -> Dict:
        img = results['img'].astype(np.float32)
        mean, std = self.mean, self.std
        if mean.max() > 1.5 and results.get('img_scaled_01'):
            mean, std = mean / 255.0, std / 255.0
        results['img'] = (img - mean) / std
        results['img_norm_cfg'] = dict(mean=self.mean.tolist(),
                                       std=self.std.tolist())
        return results


@PIPELINES.register_module()
class Collect:
    """Keep ``keys`` and gather ``meta_keys`` into ``img_metas``
    (``tps_pp_tpu/datasets/pipelines/transforms.py:213-226``)."""

    def __init__(self, keys=('img',),
                 meta_keys=('filename', 'ori_shape', 'resize_shape',
                            'valid_ratio')):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results: Dict) -> Dict:
        data = {k: results[k] for k in self.keys}
        data['img_metas'] = {k: results.get(k) for k in self.meta_keys}
        if 'text' in results:
            data['text'] = results['text']
        return data


class Compose:
    """Apply the transforms in turn; a transform that returns None drops
    the sample (``tps_pp_tpu/datasets/pipelines/transforms.py:491-501``)."""

    def __init__(self, transforms: Sequence):
        self.transforms = [PIPELINES.build(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, results: Dict) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results
