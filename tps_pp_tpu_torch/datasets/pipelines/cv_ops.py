"""numpy copies of the cv2 calls the training augmentations make
(``tps_pp_tpu/datasets/pipelines/transforms.py:263-488`` calls cv2; the port
runs where cv2 is absent).

Each function computes what cv2 5.0 computes, down to its rounding where
that is cheap to follow:

* ``warp_affine`` / ``warp_perspective`` (``INTER_LINEAR``,
  ``BORDER_REPLICATE``): cv2 inverts ``M`` (the affine case by its 2x2
  formula, the perspective case by the adjugate in float64), casts it to
  float32 and maps every output pixel in float32: the row offset
  ``y * M[1] + M[2]`` rounded twice, then one fused multiply-add per
  coordinate (and a division by the third coordinate in perspective).
  The two taps of each axis are clamped to the image, and the blend is
  ``p00 + a (p01 - p00)`` per row, then ``+ b (v1 - v0)``, each a fused
  multiply-add in float32, rounded half to even for uint8. The fused
  operations are emulated in float64, which holds the products exactly.
* ``resize_u8``: ``cv2.resize`` with ``INTER_LINEAR`` of a uint8 image,
  in cv2's fixed point: 11-bit weights from float32 positions (a column's
  weight pinned at the edges, a row's not, its taps clamped), the row pass
  in integers, the column pass as cv2's vector code does it (each row
  shifted right by 4, multiplied by its weight, the high 16 bits kept,
  then ``(sum + 2) >> 2``). A downscale by exactly 2 on both axes is
  cv2's area average.
* ``filter2d``: a float32 kernel over ``BORDER_REFLECT_101`` borders,
  summed in float32 tap by tap, rounded half to even for uint8.
* ``pyr_down`` / ``pyr_up``: the 5-tap [1 4 6 4 1] kernel in integers,
  ``(s + 128) >> 8`` and ``(s + 32) >> 6``; ``pyr_down`` reflects (101)
  at both ends; ``pyr_up`` reflects at the start and replicates at the
  end, as cv2's ``pyrUp`` does.
* ``bgr_to_hsv`` / ``hsv_to_bgr`` (uint8, H in [0, 180)): cv2's 12-bit
  division tables one way, its float32 sector formula the other. cv2's
  vector loop converts blocks of ``HSV_BLOCK`` (32) pixels of a row to
  uint8 by truncation and the row's tail, in scalar code, by rounding;
  the copy does the same. The block is the vector width of the x86 build
  the copy was held against: another build's blocks would move some
  pixels by one grey level.

* ``resize_inter_nearest``: ``cv2.resize`` with ``INTER_NEAREST`` of any
  dtype (the seg kernels are int32): source index
  ``floor(x * (1 / (dst / src)))`` in float64, clamped.
* ``fill_convex_poly``: ``cv2.fillConvexPoly`` of integer corners (shift
  0, ``LINE_8``): the polygon's edges drawn by cv2's 8-connected line
  iterator (left to right, ``clipLine`` where an end lies outside), then
  cv2's scanline fill in 16-bit fixed point, its edge slopes divided with
  C's truncation and each span rounded half up at both ends.

``tests/test_torch_augment.py`` holds each against cv2 on seeded images
(``fill_convex_poly`` and ``resize_inter_nearest``:
``tests/test_torch_seg.py``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(np.float32)


def _to_dtype(out: np.ndarray, dtype) -> np.ndarray:
    """float32 result -> ``dtype``: uint8 rounded half to even and
    saturated, as cv2's ``saturate_cast``."""
    if dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(dtype)


def get_rotation_matrix_2d(center: Sequence[float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, ``angle`` in degrees,
    counter-clockwise."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = float(center[0]), float(center[1])
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the (3, 3) float64 homography
    taking the four ``src`` points to ``dst``, from its 8x8 system, whose
    coordinate products cv2 takes in float32."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i, 0:3] = a[i + 4, 3:6] = (x, y, 1.0)
        # cv2 multiplies the float32 coordinates in float32
        a[i, 6:8] = (-(x * u), -(y * u))
        a[i + 4, 6:8] = (-(x * v), -(y * v))
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _invert_affine(m) -> np.ndarray:
    """cv2 ``warpAffine``'s inverse of a (2, 3) map, flattened."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = (-m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5])
    return m


def _invert_3x3(s) -> np.ndarray:
    """cv2 ``invert``'s 3x3 inverse (the adjugate over the determinant),
    flattened."""
    s = np.asarray(s, np.float64).reshape(3, 3)
    det = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
           - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
           + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    d = 1.0 / det if det != 0 else 0.0
    return np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
        (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
        (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
        (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
        (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d])


def _source_coords(m: np.ndarray, width: int, height: int,
                   perspective: bool) -> Tuple[np.ndarray, np.ndarray]:
    """float32 source coordinates (height, width) of every output pixel
    under the inverted map ``m`` (float32, 6 or 9 entries)."""
    xs = np.arange(width, dtype=np.float32)[None]
    ys = np.arange(height, dtype=np.float32)[:, None]

    def row(i):     # y * m[i] + m[i + 1], rounded twice
        return _f32(_f32(ys * m[i]) + m[i + 1])

    sx, sy = _fma(m[0], xs, row(1)), _fma(m[3], xs, row(4))
    if perspective:
        w = _fma(m[6], xs, row(7)).astype(np.float64)
        sx, sy = _f32(sx / w), _f32(sy / w)
    return sx, sy


def _remap_linear(img: np.ndarray, sx: np.ndarray,
                  sy: np.ndarray) -> np.ndarray:
    """Bilinear sample of ``img`` at float32 (sx, sy), taps clamped to the
    image (``BORDER_REPLICATE``), blended with float32 fused operations."""
    h, w = img.shape[:2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    a, b = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    src = img.astype(np.float32)
    p00, p01 = src[ya, xa], src[ya, xb]
    p10, p11 = src[yb, xa], src[yb, xb]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return _to_dtype(_fma(b, v1 - v0, v0), img.dtype)


def warp_affine(img: np.ndarray, m, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderMode=cv2.BORDER_REPLICATE)``
    with ``INTER_LINEAR``: (H, W[, C]) -> (dsize[1], dsize[0][, C])."""
    inv = _invert_affine(m).astype(np.float32)
    sx, sy = _source_coords(inv, dsize[0], dsize[1], perspective=False)
    return _remap_linear(img, sx, sy)


def warp_perspective(img: np.ndarray, m,
                     dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize,
    borderMode=cv2.BORDER_REPLICATE)`` with ``INTER_LINEAR``."""
    inv = _invert_3x3(m).astype(np.float32)
    sx, sy = _source_coords(inv, dsize[0], dsize[1], perspective=True)
    return _remap_linear(img, sx, sy)


def _resize_weights(src: int, dst: int, pin_edges: bool):
    """cv2 ``INTER_LINEAR``'s taps along one axis in its fixed point: the
    two source indices and their 11-bit weights for each output index."""
    if dst < 1 or src < 1:
        raise ValueError(f'cannot resize {src} pixels to {dst}')
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if pin_edges:
        out = (i0 < 0) | (i0 >= src - 1)
        i0 = np.clip(i0, 0, src - 1)
        f[out] = 0.0
    w1 = np.rint(f * 2048).astype(np.int32)
    w0 = np.rint((np.float32(1.0) - f) * 2048).astype(np.int32)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of a uint8 (H, W[, C]) image
    with ``INTER_LINEAR``, bit for bit."""
    h, w = img.shape[:2]
    if (w, h) == (2 * width, 2 * height):     # cv2 takes the area path
        s = img.astype(np.uint16)
        total = s[0::2, 0::2] + s[0::2, 1::2]
        total += s[1::2, 0::2]
        total += s[1::2, 1::2]
        total += 2
        return (total >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _resize_weights(w, width, pin_edges=True)
    y0, y1, b0, b1 = _resize_weights(h, height, pin_edges=False)
    if img.ndim == 3:
        a0, a1 = a0[:, None], a1[:, None]
    rows = img[:, x0] * a0                      # int32: up to 255 * 2048
    rows += img[:, x1] * a1
    rows >>= 4
    shape = (-1,) + (1,) * (rows.ndim - 1)
    out = rows[y0]
    out *= b0.reshape(shape)
    out >>= 16
    lower = rows[y1]
    lower *= b1.reshape(shape)
    lower >>= 16
    out += lower
    out += 2
    out >>= 2                                   # within [0, 255]
    return out.astype(np.uint8)


def reflect_101(index: np.ndarray, n: int) -> np.ndarray:
    """cv2 ``BORDER_REFLECT_101`` of indices into an axis of ``n``
    (``gfedcb|abcdefgh|gfedcba``)."""
    if n == 1:
        return np.zeros_like(index)
    period = 2 * (n - 1)
    index = np.abs(index) % period
    return np.where(index >= n, period - index, index)


def filter2d(img: np.ndarray, kernel) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` (anchor at the centre,
    ``BORDER_REFLECT_101``): the float32 kernel's taps summed in float32,
    in row-major order of the kernel's nonzero taps."""
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    h, w = img.shape[:2]
    rows = reflect_101(np.arange(h)[:, None] + np.arange(kh) - kh // 2, h)
    cols = reflect_101(np.arange(w)[:, None] + np.arange(kw) - kw // 2, w)
    src = img.astype(np.float32)
    acc = np.zeros(img.shape, np.float32)
    for i, j in zip(*np.nonzero(k)):
        acc += k[i, j] * src[rows[:, i]][:, cols[:, j]]
    return _to_dtype(acc, img.dtype)


def _pyr_down_axis(a: np.ndarray, n: int) -> np.ndarray:
    """[1 4 6 4 1] at every other index of axis 0 of a padded array."""
    out = a[0:2 * n:2] + a[4:4 + 2 * n:2]
    mid = a[1:1 + 2 * n:2] + a[3:3 + 2 * n:2]
    mid <<= 2
    out += mid
    out += a[2:2 + 2 * n:2] * 6
    return out


def pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown`` of a uint8 image: ((H + 1) // 2, (W + 1) // 2),
    the [1 4 6 4 1]^2 / 256 kernel at every other pixel, reflect-101; in
    uint16, which holds the 256 x 255 sums."""
    h, w = img.shape[:2]
    pad = [(2, 2), (2, 2)] + [(0, 0)] * (img.ndim - 2)
    src = np.pad(img, pad, mode='reflect' if min(h, w) > 1
                 else 'edge').astype(np.uint16)
    horiz = _pyr_down_axis(src.swapaxes(0, 1), (w + 1) // 2).swapaxes(0, 1)
    out = _pyr_down_axis(horiz, (h + 1) // 2)
    out += 128
    return (out >> 8).astype(np.uint8)


def _pyr_up_axis(s: np.ndarray, axis: int) -> np.ndarray:
    """``pyrUp`` along ``axis`` (x8): even outputs ``s[i-1] + 6 s[i] +
    s[i+1]``, odd ``4 (s[i] + s[i+1])``; reflect at the start, replicate
    at the end. The two outputs of ``s[i]`` are written side by side into
    a new axis after ``axis``, which the result folds in."""
    n = s.shape[axis]
    shape = list(s.shape)
    shape[axis] = 2 * n
    if n == 1:
        return np.repeat(s * 8, 2, axis=axis)
    pairs = np.empty(s.shape[:axis + 1] + (2,) + s.shape[axis + 1:], s.dtype)
    lead = (slice(None),) * (axis + 1)
    even = np.moveaxis(pairs[lead + (0,)], axis, 0)
    odd = np.moveaxis(pairs[lead + (1,)], axis, 0)
    s = np.moveaxis(s, axis, 0)
    np.multiply(s, 6, out=even)
    even[1:] += s[:-1]
    even[0] += s[1]
    even[:-1] += s[1:]
    even[-1] += s[-1]
    np.add(s[:-1], s[1:], out=odd[:-1])
    np.multiply(s[-1], 2, out=odd[-1])
    odd <<= 2
    return pairs.reshape(shape)


def pyr_up(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrUp`` of a uint8 image: (2H, 2W), ``(s + 32) >> 6``; in
    uint16, which holds the 64 x 255 sums."""
    out = _pyr_up_axis(_pyr_up_axis(img.astype(np.uint16), 1), 0)
    out += 32
    return (out >> 6).astype(np.uint8)


_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV = np.zeros(256, np.int64)
_HDIV[1:] = np.rint((180 << _HSV_SHIFT)
                    / (6.0 * np.arange(1, 256, dtype=np.float64)))
HSV_BLOCK = 32
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` for uint8 (H, W, 3): H in
    [0, 180), through cv2's 12-bit division tables."""
    b, g, r = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` for uint8 (H, W, 3) with H
    in [0, 180): cv2's float32 sector formula, ``1 - s h`` and
    ``1 - s (1 - h)`` as fused operations; truncated to uint8 in whole
    blocks of ``HSV_BLOCK`` pixels of a row, rounded in the row's tail."""
    one = np.float32(1.0)
    inv255 = np.float32(1.0 / 255.0)
    h = img[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = img[..., 1].astype(np.float32) * inv255
    v = img[..., 2].astype(np.float32) * inv255
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    h = np.where((sector < 0) | (sector >= 6), np.float32(0.0), h)
    sector = np.where((sector < 0) | (sector >= 6), 0, sector)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr) * np.float32(255)
    out = np.rint(bgr)
    cut = bgr.shape[1] // HSV_BLOCK * HSV_BLOCK
    out[:, :cut] = np.floor(bgr[:, :cut])
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_inter_nearest(img: np.ndarray, width: int,
                         height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    output (y, x) reads ``floor(y * h / height), floor(x * w / width)``
    as cv2 computes them (``1 / (dst / src)`` in float64), clamped."""
    h, w = img.shape[:2]

    def taps(src, dst):
        i = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
        return np.minimum(i, src - 1)
    return img[taps(h, height)][:, taps(w, width)]


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` to the (w, h) image: the clipped ends, or None
    where the segment misses it."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _draw_line(img: np.ndarray, p1, p2, value) -> None:
    """cv2's ``Line`` with 8-connectivity: ``LineIterator(img, p1, p2, 8,
    leftToRight=True)`` sets ``dx + 1`` pixels (dx the longer axis)."""
    h, w = img.shape[:2]
    x1, y1 = p1
    x2, y2 = p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ends = _clip_line(w, h, x1, y1, x2, y2)
        if ends is None:
            return
        x1, y1, x2, y2 = ends
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    if dy > dx:            # the major axis is y
        major, minor, step_major, step_minor = dy, dx, (0, sy), (1, 0)
    else:
        major, minor, step_major, step_minor = dx, dy, (1, 0), (0, sy)
    err = major - 2 * minor
    x, y = x1, y1
    for _ in range(major + 1):
        img[y, x] = value
        if err < 0:
            x, y = x + step_minor[0], y + step_minor[1]
            err += 2 * major
        err -= 2 * minor
        x, y = x + step_major[0], y + step_major[1]


def _div_trunc(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_convex_poly(img: np.ndarray, pts, value) -> np.ndarray:
    """``cv2.fillConvexPoly(img, pts, value)`` in place for integer
    corners ``pts`` (n, 2) of (x, y), shift 0, ``LINE_8``; returns img."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    n = len(v)
    h, w = img.shape[:2]
    for i in range(n):
        _draw_line(img, v[i - 1], v[i], value)
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    ymin, ymax, xmin, xmax = min(ys), max(ys), min(xs), max(xs)
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return img
    imin = ys.index(ymin)
    ymax = min(ymax, h - 1)
    half = _XY_ONE >> 1
    # (idx, di, x, dx, ye) of the left-going and right-going edges
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                go = edges > 0
                edges -= 1
                if not go:
                    break
                ty = v[idx][1]
                if ty > y:
                    xs0, xe = v[idx0][0] << _XY_SHIFT, v[idx][0] << _XY_SHIFT
                    e[4] = ty
                    e[3] = _div_trunc((xe - xs0) * 2 + (ty - y),
                                      2 * (ty - y))
                    e[2] = xs0
                    e[0] = idx
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = ((edge[1], edge[0]) if edge[0][2] > edge[1][2]
                           else (edge[0], edge[1]))
            x1 = (left[2] + half) >> _XY_SHIFT
            x2 = (right[2] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break
    return img
