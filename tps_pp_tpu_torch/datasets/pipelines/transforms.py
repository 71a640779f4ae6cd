"""The recognition pipeline's transforms (counterpart of
``tps_pp_tpu/datasets/pipelines/transforms.py``): load, resize and pad with
``valid_ratio``, scale to [0, 1], normalise, collect; and the flagship's
training augmentations (``configs/_base_/recog_pipelines/
crnn_pp_pipeline.py``): rotate, affine, perspective, pyramid rescale,
Gaussian noise, motion blur, colour jitter, and the ``OneOf`` / ``Random``
/ ``TorchVision`` wrappers.

Host-side numpy, as in the JAX package. Where the port differs:

* cv2 is imported only by ``LoadImageFromFile`` (``cv2.imread``), inside
  its call: the machine that serves on the card may lack cv2, and a
  serving path fed with ndarrays never needs it. No other decoder stands
  in, because another JPEG decoder gives other pixels.
* ``ResizeOCR`` resizes with its own bilinear interpolation: cv2
  ``INTER_LINEAR``'s taps (half-pixel centres, clamped at the edges); a
  uint8 image in cv2's fixed point, bit for bit (``cv_ops.resize_u8``),
  other images in float32 (within float32 rounding of cv2's).
* ``LoadImageFromNdarray`` converts grey <-> BGR in numpy with
  ``cv2.cvtColor``'s weights (uint8 in its 14-bit fixed point).
* The augmentations compute on ``cv_ops``, the port's copies of the cv2
  calls the JAX transforms make. They draw their parameters, in the JAX
  transforms' order call for call, from the generators the loader puts
  into ``results``: ``results['rng']`` (a ``random.Random``) for what JAX
  draws from ``random``, and ``results['np_rng']`` (a
  ``np.random.RandomState``) for what it draws from ``np.random``. Seeded
  with the JAX loader's per-sample key, they give a sample the JAX
  parameters; without them a transform draws from the global modules, as
  in JAX.

``tests/test_torch_pipeline.py`` holds each transform against its JAX
original.
"""
from __future__ import annotations

import math
import os
import random
from typing import Dict, Optional, Sequence

import numpy as np

from ...registry import PIPELINES
from . import cv_ops

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
    cv2: (H, W[, C]) -> (height, width[, C]), the input's dtype. uint8 in
    cv2's fixed point (``cv_ops.resize_u8``); other types rows first, then
    columns, in float32, integers rounded to nearest and clipped to their
    range."""
    if img.dtype == np.uint8:
        return cv_ops.resize_u8(img, width, height)
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
class Normalize:
    """mmcv's normalize: (img - mean) / std with 0-255 statistics over the
    raw image, BGR flipped to RGB first where ``to_rgb`` and the image has
    three channels (``tps_pp_tpu/datasets/pipelines/transforms.py:
    174-194``; the seg test pipeline's)."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: Dict) -> Dict:
        img = results['img'].astype(np.float32)
        if self.to_rgb and img.shape[-1] == 3:
            img = img[..., ::-1]
        results['img'] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean.tolist(),
                                       std=self.std.tolist(),
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """mmdet's formatting stage, a passthrough here: arrays stay NHWC numpy
    and ``Collect`` picks them (``tps_pp_tpu/datasets/pipelines/
    transforms.py:229-240``)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, results: Dict) -> Dict:
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


# ---------------------------------------------------------------------------
# The training augmentations (tps_pp_tpu/datasets/pipelines/transforms.py:
# 263-488), on cv_ops
# ---------------------------------------------------------------------------


def _rngs(results: Dict):
    """(``random``-like, ``np.random``-like) generators of the sample."""
    return results.get('rng', random), results.get('np_rng', np.random)


def _hwc(img: np.ndarray) -> np.ndarray:
    return img[:, :, None] if img.ndim == 2 else img


@PIPELINES.register_module()
class RandomRotateTextDet:
    """With probability ``rotate_ratio``, rotate about the centre by a
    uniform angle in [-max_angle, max_angle] degrees, edges replicated."""

    def __init__(self, rotate_ratio=1.0, max_angle=15):
        self.rotate_ratio = rotate_ratio
        self.max_angle = max_angle

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        if rng.random() < self.rotate_ratio:
            img = results['img']
            h, w = img.shape[:2]
            angle = rng.uniform(-self.max_angle, self.max_angle)
            m = cv_ops.get_rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
            results['img'] = _hwc(cv_ops.warp_affine(img, m, (w, h)))
        return results


@PIPELINES.register_module()
class RandomAffine:
    """torchvision-style random affine about the centre: rotation within
    ``degrees``, x-shear within ``shear``, ``scale`` and ``translate``
    (fractions of the size), edges replicated."""

    def __init__(self, degrees=15, translate=(0.3, 0.3), scale=(0.5, 2.0),
                 shear=(-45, 45), **kwargs):
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear if isinstance(shear, (tuple, list)) else (-shear,
                                                                     shear)

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        img = results['img']
        h, w = img.shape[:2]
        angle = math.radians(rng.uniform(-self.degrees, self.degrees))
        sx = math.radians(rng.uniform(self.shear[0], self.shear[1]))
        scale = rng.uniform(self.scale[0], self.scale[1])
        tx = rng.uniform(-self.translate[0], self.translate[0]) * w
        ty = rng.uniform(-self.translate[1], self.translate[1]) * h
        ca, sa = math.cos(angle), math.sin(angle)
        m = np.array([[scale * ca, scale * (-sa + math.tan(sx) * ca), tx],
                      [scale * sa, scale * (ca + math.tan(sx) * sa), ty]],
                     np.float32)
        cx, cy = w / 2, h / 2
        m[:, 2] += np.array([cx, cy]) - m[:, :2] @ np.array([cx, cy])
        results['img'] = _hwc(cv_ops.warp_affine(img, m, (w, h)))
        return results


@PIPELINES.register_module()
class RandomPerspective:
    """With probability ``p``, move each corner by up to
    ``distortion_scale / 2`` of the size along each axis and warp the
    image onto the moved corners, edges replicated."""

    def __init__(self, distortion_scale=0.5, p=1.0, **kwargs):
        self.distortion_scale = distortion_scale
        self.p = p

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        if rng.random() >= self.p:
            return results
        img = results['img']
        h, w = img.shape[:2]
        dx = w * self.distortion_scale / 2
        dy = h * self.distortion_scale / 2
        src = np.float32([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]])
        dst = np.float32([[x + rng.uniform(-dx, dx), y + rng.uniform(-dy, dy)]
                          for x, y in src])
        m = cv_ops.get_perspective_transform(src, dst)
        results['img'] = _hwc(cv_ops.warp_perspective(img, m, (w, h)))
        return results


@PIPELINES.register_module()
class ColorJitter:
    """Brightness, contrast, saturation (towards the channel mean) and, on
    BGR images, a hue shift in cv2's HSV (H in [0, 180)), in float32."""

    def __init__(self, brightness=0.5, saturation=0.5, contrast=0.5,
                 hue=0.1, **kwargs):
        self.brightness = brightness
        self.saturation = saturation
        self.contrast = contrast
        self.hue = hue

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        img = results['img'].astype(np.float32)
        if self.brightness:
            img *= rng.uniform(1 - self.brightness, 1 + self.brightness)
        if self.contrast:
            f = rng.uniform(1 - self.contrast, 1 + self.contrast)
            img = img.mean() + f * (img - img.mean())
        if self.saturation and img.shape[-1] == 3:
            f = rng.uniform(1 - self.saturation, 1 + self.saturation)
            gray = img.mean(axis=-1, keepdims=True)
            img = gray + f * (img - gray)
        if self.hue and img.shape[-1] == 3:
            shift = rng.uniform(-self.hue, self.hue) * 180.0
            hsv = cv_ops.bgr_to_hsv(np.clip(img, 0, 255).astype(
                np.uint8)).astype(np.float32)
            hsv[..., 0] = (hsv[..., 0] + shift) % 180.0
            img = cv_ops.hsv_to_bgr(hsv.astype(np.uint8)).astype(np.float32)
        results['img'] = np.clip(img, 0, 255).astype(results['img'].dtype)
        return results


@PIPELINES.register_module()
class GaussNoise:
    """With probability ``p``, add Gaussian noise of a variance uniform in
    ``var_limit``; the result is uint8."""

    def __init__(self, var_limit=(10.0, 50.0), p=1.0, **kwargs):
        self.var_limit = var_limit
        self.p = p

    def __call__(self, results: Dict) -> Dict:
        rng, np_rng = _rngs(results)
        if rng.random() >= self.p:
            return results
        img = results['img'].astype(np.float32)
        sigma = math.sqrt(rng.uniform(*self.var_limit))
        img = img + np_rng.randn(*img.shape).astype(np.float32) * sigma
        results['img'] = np.clip(img, 0, 255).astype(np.uint8)
        return results


@PIPELINES.register_module()
class MotionBlur:
    """With probability ``p``, a horizontal or vertical box blur of an odd
    length in [3, blur_limit]."""

    def __init__(self, blur_limit=6, p=1.0, **kwargs):
        self.blur_limit = blur_limit
        self.p = p

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        if rng.random() >= self.p:
            return results
        k = rng.choice(range(3, max(4, self.blur_limit + 1), 2))
        kernel = np.zeros((k, k), np.float32)
        if rng.random() < 0.5:
            kernel[k // 2, :] = 1.0
        else:
            kernel[:, k // 2] = 1.0
        kernel /= kernel.sum()
        results['img'] = _hwc(cv_ops.filter2d(results['img'], kernel))
        return results


@PIPELINES.register_module()
class PyramidRescale:
    """Blur by resizing to ``base_shape``, ``factor`` (uniform in [0,
    factor] with ``randomize_factor``) pyramid steps down and up, and back
    to the image's size."""

    def __init__(self, factor=4, base_shape=(128, 512), randomize_factor=True,
                 **kwargs):
        self.factor = factor
        self.base_shape = base_shape
        self.randomize_factor = randomize_factor

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        img = results['img']
        factor = (rng.randint(0, self.factor) if self.randomize_factor
                  else self.factor)
        if factor == 0:
            return results
        h, w = img.shape[:2]
        scaled = resize_bilinear(img, self.base_shape[1], self.base_shape[0])
        for _ in range(factor):
            scaled = cv_ops.pyr_down(scaled)
        for _ in range(factor):
            scaled = cv_ops.pyr_up(scaled)
        results['img'] = _hwc(resize_bilinear(scaled, w, h))
        return results


@PIPELINES.register_module()
class OneOfWrapper:
    """Apply one of ``transforms``, picked uniformly."""

    def __init__(self, transforms: Sequence):
        self.transforms = [PIPELINES.build(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        return rng.choice(self.transforms)(results)


@PIPELINES.register_module()
class RandomWrapper:
    """Apply ``transforms`` in turn with probability ``p``."""

    def __init__(self, transforms: Sequence, p=0.5):
        self.transforms = [PIPELINES.build(t) if isinstance(t, dict) else t
                           for t in transforms]
        self.p = p

    def __call__(self, results: Dict) -> Dict:
        rng, _ = _rngs(results)
        if rng.random() > self.p:
            return results
        for t in self.transforms:
            results = t(results)
        return results


@PIPELINES.register_module()
class TorchVisionWrapper:
    """The reference configs' torchvision ops by name: ``op`` is built as
    the transform of that name registered here."""

    def __init__(self, op: str, **kwargs):
        self.transform = PIPELINES.build(dict(type=op, **kwargs))

    def __call__(self, results: Dict) -> Dict:
        return self.transform(results)


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
