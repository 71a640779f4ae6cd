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
  ``remap_linear`` (``cv2.remap``, the TPS augmentations' warp) samples
  float32 maps through the same blend, bit for bit on uint8.
* ``pil_rotate_nearest``: PIL's ``rotate(angle, resample=NEAREST,
  expand=False, center=...)`` (the seg recipe's ``RandomRotateImageBox``;
  the card's machine has no PIL): PIL's inverse affine map in its 16.16
  fixed point, sampled at pixel centres, 0 outside.
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
  dtype (the seg kernels are int32, Mask R-CNN's mask crops float32):
  source index ``floor(x * (1 / (dst / src)))`` in float64, clamped.
* ``resize_f32``: ``cv2.resize`` with ``INTER_LINEAR`` of a float32 map
  (Mask R-CNN's mask paste), its taps and edges as cv2's, the blend in
  float64: within 2e-7 of cv2 5.0's IPP path, not bit for bit.
* ``fill_convex_poly``: ``cv2.fillConvexPoly`` of integer corners (shift
  0, ``LINE_8``): the polygon's edges drawn by cv2's 8-connected line
  iterator (left to right, ``clipLine`` where an end lies outside), then
  cv2's scanline fill in 16-bit fixed point, its edge slopes divided with
  C's truncation and each span rounded half up at both ends.

The text detector's host side (``models/textdet/postprocess.py``,
``models/textdet/targets.py``, the hmean-ic13 raster) calls these:

* ``find_contours`` (``RETR_LIST``, ``RETR_EXTERNAL`` or ``RETR_TREE``,
  ``CHAIN_APPROX_SIMPLE`` or ``CHAIN_APPROX_NONE``), and
  ``draw_contour_lines`` (thickness 1): Suzuki-Abe border following as
  cv2 does it, in
  cv2's order (the reverse of discovery). The mask is padded with zeros;
  only the pixels where a row changes between zero and non-zero can start
  a border, so the raster scan visits those (found with numpy) and the
  Python loop runs over border pixels only. A border pixel is marked
  negative where the search passed its right-hand neighbour, as cv2
  marks it; ``RETR_EXTERNAL`` skips an outer border whose last marked
  pixel on the row (cv2's ``lnbd``) is positive, and ``RETR_TREE`` takes
  each border's parent from the border that marked that pixel (Suzuki's
  rule) and walks the tree as cv2 does.
* ``contour_area`` (the shoelace sum in float64), ``arc_length`` (each
  side's length in float32, summed in float64), ``bounding_rect``.
* ``convex_hull`` (Sklansky's scan over the points sorted by x then y,
  counter-clockwise, with cv2's cyclic shift of the indices; float points
  subtract in float32) and
  ``min_area_rect``: cv2's rotating calipers over the hull in float32; the
  angle in [-90, 0) degrees, a quarter turn swapping width and height, as
  cv2 5.0 returns it. ``box_points``: ``RotatedRect::points`` in float32.
* ``fill_poly`` and ``draw_contours`` (filled, ``LINE_8``): each edge drawn
  by cv2's 8-connected line, then the even-odd scanline fill of the edges
  in 16-bit fixed point: cv2 5.0 fills the pixels from the ceiling of the
  left crossing to the floor of the right one, the crossings exact (no
  half-pixel shift, as 4.x had). An edge with an end outside the image
  takes the ends ``clipLine`` leaves (also where it misses the image):
  their x always, their y only where they differ, so an edge clipped to
  one point runs along the border column, as in cv2 5.0.
* ``get_structuring_element`` (``MORPH_ELLIPSE``, ``MORPH_CROSS``),
  ``dilate`` (pixels outside the image add nothing), ``erode`` and
  ``morphology_open`` with ``borderValue=0`` (pixels outside the image
  are 0; ``erode`` also with cv2's default border), ``flood_fill``
  (4-connected, no tolerance) and ``circle`` (filled, cv2's midpoint
  walk).
* ``polylines`` (open or closed, thickness 1, ``LINE_8``),
  ``connected_components`` (4- and 8-connectivity, cv2's label order) and
  ``distance_transform`` (``DIST_L2``, mask 3: cv2 5.0's float32 chamfer
  transform, its vector blocks of four columns included, see its
  docstring).

``tests/test_torch_augment.py`` holds each against cv2 on seeded images
(``fill_convex_poly`` and ``resize_inter_nearest``:
``tests/test_torch_seg.py``; the contour functions:
``tests/test_torch_textdet.py``; ``distance_transform``:
``tests/test_torch_det_train.py``; ``connected_components`` and the
outlines: ``tests/test_torch_panet.py``; ``RETR_TREE``, ``erode``,
``morphology_open``, ``flood_fill`` and ``circle``:
``tests/test_torch_fce_textsnake.py``; ``erode`` with cv2's default
border, ``polylines`` and 8-connected ``connected_components``:
``tests/test_torch_drrg_full.py``; ``resize_f32`` and
``resize_inter_nearest`` on float32: ``tests/test_torch_maskrcnn.py``).

The server decodes request bodies where cv2 is absent:

* ``png_decode(buf, grayscale=False)``: ``cv2.imdecode`` with
  ``IMREAD_COLOR`` (BGR, alpha dropped, grey replicated) or
  ``IMREAD_GRAYSCALE`` of an 8-bit, non-interlaced PNG of colour type 0,
  2, 3 (without ``tRNS``), 4 or 6, any of the five row filters; colour to
  grey is libpng's ``png_set_rgb_to_gray`` with OpenCV's 0.299 / 0.587,
  ``(9797 R + 19234 G + 13737 B) >> 15``. Other PNGs raise, naming cv2.
* ``png_encode(img)``: an 8-bit grey, BGR or BGRA PNG, each row filtered
  by libpng's heuristic (the filter with the least sum of absolute signed
  bytes).

``tests/test_torch_deploy.py`` holds both against cv2.
"""
from __future__ import annotations

import math
import struct
import zlib
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


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REPLICATE)``: (H, W[, C]) -> the maps' shape,
    the float32 maps' positions sampled by ``_remap_linear`` (the float
    bilinear blend of cv2 5.0's remap, bit for bit on uint8)."""
    return _remap_linear(img, np.asarray(map_x, np.float32),
                         np.asarray(map_y, np.float32))


def pil_rotate_nearest(img: np.ndarray, angle: float,
                       center: Tuple[float, float]) -> np.ndarray:
    """PIL's ``Image.fromarray(img).rotate(angle, resample=NEAREST,
    expand=False, center=center)`` of an (H, W[, C]) uint8 array, bit for
    bit: the inverse affine map PIL builds (its coefficients rounded to
    15 decimals), sampled at pixel centres in PIL's 16.16 fixed point
    (``affine_fixed`` of libImaging/Geometry.c), pixels whose source falls
    outside set to 0."""
    h, w = img.shape[:2]
    angle = angle % 360.0
    rad = -math.radians(angle)
    a = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    cx, cy = center
    a[2] = a[0] * -cx + a[1] * -cy + a[2]
    a[5] = a[3] * -cx + a[4] * -cy + a[5]
    a[2] += cx
    a[5] += cy

    def fix(v):
        return math.floor(v * 65536.0 + 0.5)

    if not (abs(w * a[0] + h * a[1] + a[2]) < 32768.0
            and abs(w * a[3] + h * a[4] + a[5]) < 32768.0):
        raise ValueError('pil_rotate_nearest: an image too large for '
                         "PIL's fixed-point path")
    a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
    a2 = fix(a[2] + a[1] * 0.5 + a[0] * 0.5)
    a5 = fix(a[5] + a[4] * 0.5 + a[3] * 0.5)
    xs = np.arange(w, dtype=np.int64)[None]
    ys = np.arange(h, dtype=np.int64)[:, None]
    xin = (a2 + a1 * ys + a0 * xs) >> 16
    yin = (a5 + a4 * ys + a3 * xs) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[inside] = img[yin[inside], xin[inside]]
    return out


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


def resize_f32(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of a float32 (H, W) map with
    ``INTER_LINEAR``: two taps an axis at the source position ``(x + 0.5)
    * src / dst - 0.5``, pinned to the edge pixel (weight 0 on the other
    tap) before the first pixel and past the last on both axes, the blend
    in float64, rounded to float32 once. A downscale by exactly 2 on both
    axes is cv2's area mean, ``((a + b) + (c + d)) * 0.25`` in float32.
    cv2 5.0 (x86, its IPP path) lands within 2e-7 of this on maps in
    [0, 1] (``tests/test_torch_maskrcnn.py``)."""
    h, w = img.shape
    img = np.asarray(img, np.float32)
    if (w, h) == (2 * width, 2 * height):     # cv2 takes the area path
        s = img
        return ((s[0::2, 0::2] + s[0::2, 1::2]) +
                (s[1::2, 0::2] + s[1::2, 1::2])) * np.float32(0.25)
    if width < 1 or height < 1:
        raise ValueError(f'cannot resize {w}x{h} to {width}x{height}')

    def taps(src, dst):
        f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        i0 = np.floor(f).astype(np.int64)
        f = f - i0
        out = (i0 < 0) | (i0 >= src - 1)
        f[out] = 0.0
        i0 = np.clip(i0, 0, src - 1)
        return i0, np.minimum(i0 + 1, src - 1), 1.0 - f, f

    x0, x1, a0, a1 = taps(w, width)
    y0, y1, b0, b1 = taps(h, height)
    src = img.astype(np.float64)
    rows = src[:, x0] * a0 + src[:, x1] * a1
    return (rows[y0] * b0[:, None] + rows[y1] * b1[:, None]).astype(
        np.float32)


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


def _clip_ends(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` to the (w, h) image: the ends as it leaves them
    (moved part of the way where the segment misses the image) and whether
    the segment meets the image."""
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
    return (x1, y1, x2, y2), (c1 | c2) == 0


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The clipped ends, or None where the segment misses the image."""
    ends, meets = _clip_ends(w, h, x1, y1, x2, y2)
    return ends if meets else None


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


# ------------------------------------------------ contours and polygons --

RETR_EXTERNAL = 0
RETR_LIST = 1
RETR_TREE = 3
CHAIN_APPROX_NONE = 1
CHAIN_APPROX_SIMPLE = 2
# cv2's chain code directions (dx, dy), y down: 0 is right, then
# counter-clockwise on the screen
_CHAIN = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
          (1, 1))


def _follow_border(img: np.ndarray, step: int, x0: int, y0: int,
                   is_hole: bool, every: bool = False, owner=None,
                   nbd: int = 0) -> list:
    """cv2's ``icvFetchContour`` on the flat padded image ``img`` (0
    background, 1 unvisited, +-2 marked) from (x0, y0); returns the turning
    points in image coordinates (``CHAIN_APPROX_SIMPLE``), or with
    ``every`` each point of the border (``CHAIN_APPROX_NONE``). With
    ``owner``, each pixel it marks records ``nbd``, as cv2's label does."""
    deltas = [dx + dy * step for dx, dy in _CHAIN] * 2
    i0 = y0 * step + x0
    s_end = s = 0 if is_hole else 4
    while True:                       # the first neighbour, clockwise
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    px, py = x0 - 1, y0 - 1
    if img[i1] == 0:                  # a single pixel
        img[i0] = -2
        if owner is not None:
            owner[i0] = nbd
        return [(px, py)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:                 # the next neighbour, counter-clockwise
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 0 < s <= s_end:            # the search passed the right neighbour
            img[i3] = -2
            if owner is not None:
                owner[i3] = nbd
        elif img[i3] == 1:
            img[i3] = 2
            if owner is not None:
                owner[i3] = nbd
        if s != prev_s or every:
            pts.append((px, py))
            prev_s = s
        px += _CHAIN[s][0]
        py += _CHAIN[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_contours(mask: np.ndarray, mode: int = RETR_LIST,
                  method: int = CHAIN_APPROX_SIMPLE) -> list:
    """``cv2.findContours(mask, mode, method)[0]`` for ``RETR_LIST`` (outer
    and hole borders), ``RETR_EXTERNAL`` or ``RETR_TREE``,
    ``CHAIN_APPROX_SIMPLE`` or ``CHAIN_APPROX_NONE``: a list of (n, 1, 2)
    int32 arrays of (x, y), in cv2's order. ``RETR_TREE`` orders the
    borders as cv2's tree walk does: depth first, each border before its
    children, the borders of one parent in the reverse of their discovery
    (cv2 puts a new border first among its parent's children)."""
    if mode not in (RETR_LIST, RETR_EXTERNAL, RETR_TREE):
        raise ValueError(f'mode {mode}: RETR_LIST, RETR_EXTERNAL or '
                         'RETR_TREE only')
    if method not in (CHAIN_APPROX_NONE, CHAIN_APPROX_SIMPLE):
        raise ValueError(f'method {method}: CHAIN_APPROX_NONE or '
                         'CHAIN_APPROX_SIMPLE only')
    every = method == CHAIN_APPROX_NONE
    nz = np.asarray(mask) != 0
    h, w = nz.shape
    pad = np.zeros((h + 2, w + 2), np.int8)
    pad[1:-1, 1:-1] = nz
    step = w + 2
    ys, xs = np.nonzero(np.diff(pad, axis=1))   # zero <-> non-zero steps
    img = pad.reshape(-1).astype(np.int32)
    external = mode == RETR_EXTERNAL
    tree = mode == RETR_TREE
    # RETR_TREE: the border that last marked each pixel, and each border's
    # parent (-1 the image's frame) and kind
    owner = np.full(img.shape, -1, np.int32) if tree else None
    parent, holes = [], []
    found = []
    row = -1
    for y, x in zip(ys.tolist(), (xs + 1).tolist()):
        i = y * step + x
        if y != row:
            row, lnbd, last = y, y * step, y * step
        if (external or tree) and i - last > 1:
            # cv2 stops wherever the row's value changes; the last stop on
            # a marked pixel is lnbd
            seg = img[last:i]
            k = np.nonzero((seg[1:] != seg[:-1]) & (seg[1:] != 0)
                           & (seg[1:] != 1))[0]
            if len(k):
                lnbd = last + 1 + int(k[-1])
        last = i
        p, prev = img[i], img[i - 1]
        if prev == 0 and p == 1:                  # an outer border
            if external and img[lnbd] > 0:
                continue
            start, is_hole = i, False
        elif p == 0 and prev >= 1:                # a hole border
            if prev != 1:
                lnbd = i - 1
            if external:
                continue
            start, is_hole = i - 1, True
        else:
            if p != 0 and p != 1:
                lnbd = i
            continue
        if tree:
            par = int(owner[lnbd]) if lnbd % step else -1
            if par >= 0 and holes[par] == is_hole:
                par = parent[par]
            parent.append(par)
            holes.append(is_hole)
        found.append(_follow_border(img, step, start % step, y, is_hole,
                                    every, owner, len(found)))
        lnbd = start
    if tree:
        children = [[] for _ in range(len(found) + 1)]
        for c in range(len(found) - 1, -1, -1):
            children[parent[c]].append(c)
        order, todo = [], children[-1][::-1]
        while todo:
            c = todo.pop()
            order.append(c)
            todo.extend(children[c][::-1])
        found = [found[c] for c in order]
    else:
        found = found[::-1]
    return [np.asarray(c, np.int32).reshape(-1, 1, 2) for c in found]


def bounding_rect(points) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect`` of integer points: (x, y, w, h)."""
    p = np.asarray(points).reshape(-1, 2)
    x0, y0 = p.min(0)
    x1, y1 = p.max(0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def contour_area(points) -> float:
    """``cv2.contourArea`` (not oriented): the shoelace sum in float64 of
    the float32 points."""
    p = np.asarray(points).reshape(-1, 2).astype(np.float32).astype(
        np.float64)
    if len(p) == 0:
        return 0.0
    prev = np.roll(p, 1, axis=0)
    return abs(float(np.sum(prev[:, 0] * p[:, 1] - prev[:, 1] * p[:, 0]))
               * 0.5)


def arc_length(points, closed: bool = True) -> float:
    """``cv2.arcLength``: each side's length in float32, summed in
    float64."""
    p = np.asarray(points).reshape(-1, 2).astype(np.float32)
    if len(p) <= 1:
        return 0.0
    prev = np.roll(p, 1, axis=0)
    if not closed:
        prev[0] = p[0]
    d = p - prev
    return float(np.sum(np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]),
                        dtype=np.float64))


def _sklansky(pts, start: int, end: int, nsign: int, sign2: int,
              sub=lambda p, q: p - q) -> list:
    """cv2's ``Sklansky_`` over the sorted points ``pts``: the indices of
    one quarter of the hull. ``sub`` is the coordinates' subtraction (in
    float32 for float points); the convexity is a double product."""
    incr = 1 if end > start else -1
    if start == end or pts[start] == pts[end]:
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury = pts[pcur][1]
        by = sub(pts[pnext][1], cury)
        if (by > 0) - (by < 0) != nsign:
            ax = sub(pts[pcur][0], pts[pprev][0])
            bx = sub(pts[pnext][0], pts[pcur][0])
            ay = sub(cury, pts[pprev][1])
            convexity = ay * bx - ax * by
            if (convexity > 0) - (convexity < 0) == sign2 and (ax or ay):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def _cyclic_shift(hull: list) -> list:
    """cv2's rotation of the hull's indices into one ascending or
    descending run, where one rotation gives that."""
    nout = len(hull)
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if not ((mmdist == 1 or mmdist == nout - 1)
            and (lt <= 1 or lt >= nout - 2)):
        return hull
    ascending = (max_idx + 1) % nout == min_idx
    j = min_idx if ascending else max_idx
    if j == 0:
        return hull
    shifted = []
    for i in range(nout):
        shifted.append(hull[j])
        nj = (j + 1) % nout
        if i < nout - 1 and ascending != (hull[j] < hull[nj]):
            return hull
        j = nj
    return shifted


def _sub_f32(p: float, q: float) -> float:
    return float(np.float32(p - q))


def convex_hull(points) -> np.ndarray:
    """``cv2.convexHull(points)`` of integer or float32 points
    (counter-clockwise on the screen, cv2's first point): (n, 2). Float
    points are cv2's ``Sklansky_<float, double>``: differences in float32,
    the convexity in double."""
    data = np.asarray(points).reshape(-1, 2)
    is_float = data.dtype.kind == 'f'
    if is_float:
        data = data.astype(np.float32)
    order = np.lexsort((data[:, 1], data[:, 0]))
    cast = float if is_float else int
    sub = _sub_f32 if is_float else (lambda p, q: p - q)
    pts = [(cast(data[k, 0]), cast(data[k, 1])) for k in order]
    total = len(pts)
    miny = maxy = 0
    for i in range(1, total):
        if pts[miny][1] > pts[i][1]:
            miny = i
        if pts[maxy][1] < pts[i][1]:
            maxy = i
    if pts[0] == pts[-1]:
        return data[order[:1]]
    tl = _sklansky(pts, total - 1, maxy, -1, -1, sub)
    tr = _sklansky(pts, 0, maxy, -1, 1, sub)
    hull = tl[:-1] + tr[:0:-1]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(pts, 0, miny, 1, -1, sub)
    br = _sklansky(pts, total - 1, miny, 1, 1, sub)
    nbl, nbr = len(bl), len(br)
    if stop >= 0:
        check = bl[1] if nbl > 2 else br[2 - nbl] if nbl + nbr > 2 else -1
        if check == stop or (check >= 0 and pts[check] == pts[stop]):
            # collinear points: the lower half mirrors the upper one
            nbl, nbr = min(nbl, 2), min(nbr, 2)
    hull += bl[:nbl - 1] + br[nbr - 1:0:-1]
    hull = [int(order[k]) for k in hull]
    if len(hull) >= 3:
        hull = _cyclic_shift(hull)
    return data[hull]


def _rotating_calipers(p: np.ndarray):
    """cv2's ``rotatingCalipers`` (``CALIPERS_MINAREARECT``) in float32
    over the hull ``p``: a corner and the two side vectors."""
    f32 = np.float32
    n = len(p)
    vect = np.empty((n, 2), f32)
    inv_len = np.empty(n, f32)
    left = bottom = right = top = 0
    left_x = right_x = p[0, 0]
    top_y = bottom_y = p[0, 1]
    for i in range(n):
        pt0, pt = p[i], p[(i + 1) % n]
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        dx, dy = float(pt[0] - pt0[0]), float(pt[1] - pt0[1])
        vect[i] = (dx, dy)
        inv_len[i] = 1.0 / math.sqrt(dx * dx + dy * dy)
    orientation = f32(0)
    ax, ay = float(vect[-1, 0]), float(vect[-1, 1])
    for i in range(n):
        bx, by = float(vect[i, 0]), float(vect[i, 1])
        if ax * by - ay * bx != 0:
            orientation = f32(1.0 if ax * by - ay * bx > 0 else -1.0)
            break
        ax, ay = bx, by
    base_a, base_b = orientation, f32(0)
    seq = [bottom, right, top, left]
    minarea, best = f32(np.finfo(np.float32).max), None
    for _ in range(n):
        v = [vect[k] for k in seq]
        dp = (base_a * v[0][0] + base_b * v[0][1],
              -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1],
              base_b * v[3][0] - base_a * v[3][1])
        main, maxcos = 0, dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            c = dp[i] * inv_len[seq[i]]
            if c > maxcos:
                main, maxcos = i, c
        k = seq[main]
        lead_x, lead_y = vect[k, 0] * inv_len[k], vect[k, 1] * inv_len[k]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        d = p[seq[1]] - p[seq[3]]
        width = d[0] * base_a + d[1] * base_b
        d = p[seq[2]] - p[seq[0]]
        height = -d[0] * base_b + d[1] * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    left, a1, width, b1, height, bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * p[left, 0] + p[left, 1] * b1
    c2 = a2 * p[bottom, 0] + p[bottom, 1] * b2
    idet = f32(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points):
    """``cv2.minAreaRect`` of integer or float32 points: ((cx, cy), (w, h),
    angle),
    the angle in [-90, 0) degrees, as cv2 5.0 gives them."""
    f32 = np.float32
    hull = convex_hull(points).astype(f32)
    n = len(hull)
    cx = cy = w = h = ang = f32(0)
    if n > 2:
        o, v1, v2 = _rotating_calipers(hull)
        cx = o[0] + (v1[0] + v2[0]) * f32(0.5)
        cy = o[1] + (v1[1] + v2[1]) * f32(0.5)
        w = f32(math.hypot(float(v1[0]), float(v1[1])))
        h = f32(math.hypot(float(v2[0]), float(v2[1])))
        ang = f32(math.atan2(float(v1[1]), float(v1[0])))
    elif n == 2:
        cx = (hull[0, 0] + hull[1, 0]) * f32(0.5)
        cy = (hull[0, 1] + hull[1, 1]) * f32(0.5)
        dx = float(hull[1, 0]) - float(hull[0, 0])
        dy = float(hull[1, 1]) - float(hull[0, 1])
        w = f32(math.sqrt(dx * dx + dy * dy))
        ang = f32(math.atan2(dy, dx))
    elif n == 1:
        cx, cy = hull[0]
    ang = f32(float(ang * f32(180)) / math.pi)
    while ang >= 0:
        ang, w, h = ang - f32(90), h, w
    while ang < -90:
        ang, w, h = ang + f32(90), h, w
    return (float(cx), float(cy)), (float(w), float(h)), float(ang)


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints(rect)``: the four corners (4, 2) in float32."""
    f32 = np.float32
    (cx, cy), (w, h), ang = rect
    cx, cy, w, h = f32(cx), f32(cy), f32(w), f32(h)
    rad = float(f32(ang)) * math.pi / 180.0
    b = f32(math.cos(rad)) * f32(0.5)
    a = f32(math.sin(rad)) * f32(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    return np.asarray([p0, p1, (f32(2) * cx - p0[0], f32(2) * cy - p0[1]),
                       (f32(2) * cx - p1[0], f32(2) * cy - p1[1])], f32)


def _poly_edges(img: np.ndarray, v: Sequence, offset, value,
                edges: list) -> None:
    """cv2's ``CollectPolyEdges`` (shift 0, ``LINE_8``): draws each edge
    and appends its [y0, y1, x, dx] in 16-bit fixed point."""
    h, w = img.shape[:2]
    ox, oy = offset
    half = _XY_ONE >> 1
    pts = [((x + ox) << _XY_SHIFT, y + oy) for x, y in v]
    pt0 = pts[-1]
    for pt1 in pts:
        t0 = ((pt0[0] + half) >> _XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + half) >> _XY_SHIFT, pt1[1])
        _draw_line(img, t0, t1, value)
        c0, c1 = pt0, pt1
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h
                and 0 <= t1[1] < h):
            # the edge takes the clipped ends' x whether or not the segment
            # meets the image, and their y only where they differ: a
            # segment clipped to one point runs along the border column
            (x0, y0, x1, y1), _ = _clip_ends(w, h, *t0, *t1)
            if y0 == y1:
                y0, y1 = pt0[1], pt1[1]
            c0, c1 = (x0 << _XY_SHIFT, y0), (x1 << _XY_SHIFT, y1)
        if pt0[1] != pt1[1]:
            dx = _div_trunc(c1[0] - c0[0], c1[1] - c0[1])
            lo, c = (pt0, c0) if pt0[1] < pt1[1] else (pt1, c1)
            edges.append([lo[1], max(pt0[1], pt1[1]),
                          c[0] + (lo[1] - c[1]) * dx, dx])
        pt0 = pt1


def _fill_edges(img: np.ndarray, edges: list, value) -> None:
    """cv2's ``FillEdgeCollection`` (``LINE_8``): the even-odd spans of the
    edges row by row, the active list kept in x order by bubble sort."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_max = max(e[1] for e in edges)
    if (y_max < 0 or min(e[0] for e in edges) >= h or max(xs) < 0
            or min(xs) >= (w << _XY_SHIFT)):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    total, i = len(edges), 0
    active = []
    for y in range(edges[0][0], min(y_max, h)):
        # drop the edges that end at y, merge in those that start there
        merged, k, draw = [], 0, False
        while True:
            while k < len(active) and active[k][1] == y:
                k += 1
            last = active[k] if k < len(active) else None
            e = edges[i] if i < total and edges[i][0] == y else None
            if last is not None and (e is None or last[2] < e[2]):
                merged.append(last)
                k += 1
            elif e is not None:
                merged.append(e)
                i += 1
            else:
                break
            if draw:
                a, b = merged[-2], merged[-1]
                if y >= 0:
                    x1, x2 = sorted((a[2], b[2]))
                    x1 = (x1 + _XY_ONE - 1) >> _XY_SHIFT
                    x2 >>= _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = value
                a[2] += a[3]
                b[2] += b[3]
            draw = not draw
        active = merged
        for end in range(len(active) - 1, 0, -1):
            swapped = False
            for j in range(end):
                if active[j][2] > active[j + 1][2]:
                    active[j], active[j + 1] = active[j + 1], active[j]
                    swapped = True
            if not swapped:
                break


def fill_poly(img: np.ndarray, polys: Sequence, value,
              offset=(0, 0)) -> np.ndarray:
    """``cv2.fillPoly(img, polys, value, LINE_8, 0, offset)`` in place for
    integer vertices; returns img."""
    edges: list = []
    for p in polys:
        v = [(int(x), int(y)) for x, y in np.asarray(p).reshape(-1, 2)]
        _poly_edges(img, v, offset, value, edges)
    _fill_edges(img, edges, value)
    return img


def draw_contours(img: np.ndarray, contour, value,
                  offset=(0, 0)) -> np.ndarray:
    """``cv2.drawContours(img, [contour], -1, value, -1, offset=offset)``
    (one contour, filled) in place; returns img."""
    return fill_poly(img, [contour], value, offset)


def draw_contour_lines(img: np.ndarray, contours: Sequence,
                       value) -> np.ndarray:
    """``cv2.drawContours(img, contours, -1, value)`` (thickness 1,
    ``LINE_8``) in place: each contour closed and its sides drawn by cv2's
    8-connected line; returns img."""
    for c in contours:
        pts = [(int(x), int(y)) for x, y in np.asarray(c).reshape(-1, 2)]
        for p0, p1 in zip(pts, pts[1:] + pts[:1]):
            _draw_line(img, p0, p1, value)
    return img


def polylines(img: np.ndarray, lines: Sequence, closed: bool = False,
              value=1, thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, lines, closed, value, thickness)`` with
    ``LINE_8`` and thickness 1, in place: each line's segments drawn in
    order by cv2's 8-connected line (a closed line's closing segment
    first, as cv2's ``PolyLine`` draws it); returns img."""
    if thickness != 1:
        raise ValueError(f'thickness {thickness}: 1 only')
    for line in lines:
        pts = [(int(x), int(y)) for x, y in np.asarray(line).reshape(-1, 2)]
        if closed and pts:
            pts = pts[-1:] + pts
        for p0, p1 in zip(pts, pts[1:]):
            _draw_line(img, p0, p1, value)
    return img


def connected_components(mask: np.ndarray, connectivity: int = 4):
    """``cv2.connectedComponents(mask, connectivity=connectivity)``:
    (the number of labels with the background's, (H, W) int32 labels).
    ``scipy.ndimage.label`` numbers the components by their first pixel in
    raster order, which is cv2's order at 4-connectivity. At 8-connectivity
    cv2 (Spaghetti) scans the image in 2 x 2 blocks; any two pixels of a
    block are 8-neighbours, so a block lies in one component, and a
    component's number is the rank of its first block in a raster scan of
    the blocks (not of its first pixel: a component starting at (row 1,
    col 0) comes before one starting at (row 0, col 3))."""
    from scipy import ndimage
    if connectivity not in (4, 8):
        raise ValueError(f'connectivity {connectivity}: 4 or 8 only')
    mask = np.asarray(mask) != 0
    if connectivity == 4:
        labels, n = ndimage.label(mask, structure=[[0, 1, 0], [1, 1, 1],
                                                   [0, 1, 0]])
        return n + 1, labels.astype(np.int32)
    lab, k = ndimage.label(mask, structure=np.ones((3, 3), bool))
    lab = lab.astype(np.int64)
    if k:
        ys, xs = np.nonzero(lab)
        blocks = (ys // 2) * ((mask.shape[1] + 1) // 2) + xs // 2
        first = np.full(k + 1, np.iinfo(np.int64).max)
        np.minimum.at(first, lab[ys, xs], blocks)
        new = np.zeros(k + 1, np.int64)
        new[1 + np.argsort(first[1:], kind='stable')] = np.arange(1, k + 1)
        lab = new[lab]
    return k + 1, lab.astype(np.int32)


MORPH_CROSS = 1
MORPH_ELLIPSE = 2


def get_structuring_element(ksize: Tuple[int, int],
                            shape: int = MORPH_ELLIPSE) -> np.ndarray:
    """``cv2.getStructuringElement(shape, ksize)``, ksize (width, height),
    the anchor at the centre: ``MORPH_ELLIPSE`` (the default) or
    ``MORPH_CROSS``."""
    w, h = ksize
    if shape not in (MORPH_CROSS, MORPH_ELLIPSE):
        raise ValueError(f'shape {shape}: MORPH_CROSS or MORPH_ELLIPSE only')
    if (w, h) == (1, 1):
        return np.ones((1, 1), np.uint8)
    if shape == MORPH_CROSS:
        elem = np.zeros((h, w), np.uint8)
        elem[h // 2, :] = 1
        elem[:, w // 2] = 1
        return elem
    r, c = h // 2, w // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    elem = np.zeros((h, w), np.uint8)
    for i in range(h):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            elem[i, max(c - dx, 0):min(c + dx + 1, w)] = 1
    return elem


def _shifted_max(a: np.ndarray, lo: int, hi: int, axis: int) -> np.ndarray:
    """``out[x] = max(a[x + lo], ..., a[x + hi])`` along ``axis``, the
    indices outside ``a`` left out."""
    n = a.shape[axis]
    out = np.zeros_like(a)
    for d in range(max(lo, 1 - n), min(hi, n - 1) + 1):
        src = [slice(None)] * a.ndim
        dst = [slice(None)] * a.ndim
        src[axis] = slice(max(d, 0), n + min(d, 0))
        dst[axis] = slice(max(-d, 0), n - max(d, 0))
        np.maximum(out[tuple(dst)], a[tuple(src)], out=out[tuple(dst)])
    return out


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, kernel)`` (anchor at the centre, one iteration):
    each row of the kernel is one run, so the maximum is taken along x
    once a run, then along y once a kernel row."""
    kh, kw = kernel.shape
    out = np.zeros_like(img)
    runs: dict = {}
    for i in range(kh):
        js = np.nonzero(kernel[i])[0]
        if len(js):
            runs.setdefault((int(js[0]), int(js[-1])), []).append(i)
    for (j0, j1), rows in runs.items():
        along_x = _shifted_max(img, j0 - kw // 2, j1 - kw // 2, 1)
        for i in rows:
            np.maximum(out, _shifted_max(along_x, i - kh // 2, i - kh // 2,
                                         0), out=out)
    return out


def erode(img: np.ndarray, kernel: np.ndarray, border=0) -> np.ndarray:
    """``cv2.erode(img, kernel, borderValue=border)`` (anchor at the
    centre, one iteration): the minimum over the kernel's taps. ``border``
    0: the pixels outside the image are 0, so that a shape touching the
    edge erodes from it too; ``None``: cv2's default border, which never
    lowers a pixel (the outside taps left out)."""
    kh, kw = kernel.shape
    h, w = img.shape
    if border is None:
        border = (np.inf if np.issubdtype(img.dtype, np.floating)
                  else np.iinfo(img.dtype).max)
    pad = np.full((h + kh - 1, w + kw - 1), border, img.dtype)
    pad[kh // 2:kh // 2 + h, kw // 2:kw // 2 + w] = img
    out = None
    for i, j in zip(*np.nonzero(kernel)):
        tap = pad[i:i + h, j:j + w]
        out = tap.copy() if out is None else np.minimum(out, tap, out=out)
    return np.zeros_like(img) if out is None else out


def morphology_open(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(img, cv2.MORPH_OPEN, kernel, borderValue=0)``:
    ``erode`` then ``dilate``, both with a border of 0."""
    return dilate(erode(img, kernel), kernel)


def flood_fill(img: np.ndarray, seed: Tuple[int, int], value) -> np.ndarray:
    """``cv2.floodFill(img, mask, seed, value)`` with no tolerance (flags
    4): the 4-connected region of the pixels equal to the seed's (x, y)
    set to ``value``, in place; returns img."""
    from scipy import ndimage
    x, y = seed
    labels, _ = ndimage.label(img == img[y, x],
                              structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    img[labels == labels[y, x]] = value
    return img


def circle(img: np.ndarray, center: Tuple[int, int], radius: int,
           value) -> np.ndarray:
    """``cv2.circle(img, center, radius, value, -1)`` (filled, ``LINE_8``,
    shift 0) in place: cv2's midpoint walk, whose each step fills the rows
    ``cy +- dy`` over ``cx +- dx`` and ``cy +- dx`` over ``cx +- dy``,
    clipped to the image; returns img."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1
    while dx >= dy:
        for yy, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                         (cy + dx, dy)):
            if 0 <= yy < h and cx - half < w and cx + half >= 0:
                img[yy, max(cx - half, 0):min(cx + half, w - 1) + 1] = value
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return img


# ------------------------------------------------- distance transform --

_DT_A = np.float32(0.955)        # cv2's DIST_L2 3x3 mask: a step across
_DT_B = np.float32(1.3693)       # ... and a step along a diagonal
_DT_LANES = 4                    # the width of cv2's vector blocks
_DT_STEPS = np.float32(np.arange(_DT_LANES + 1)) * _DT_A   # k * a
_FLT_MAX = np.float32(np.finfo(np.float32).max)


def _dt_chain(v: np.ndarray, carry) -> np.ndarray:
    """Along the last axis, ``out[j] = min(v[j], out[j - 1] + a)`` from
    ``out[-1] = carry``, one float32 addition a step, as a scalar loop
    computes it: the candidates relaxed together until nothing moves (a
    round for each addition of the longest chain that wins)."""
    out = v.copy()
    if out.shape[-1]:
        np.minimum(out[..., 0], carry + _DT_A, out=out[..., 0])
    while out.shape[-1] > 1:
        step = np.minimum(v[..., 1:], out[..., :-1] + _DT_A)
        if not (step < out[..., 1:]).any():
            break
        out[..., 1:] = step
    return out


def _dt_chain2(v: np.ndarray) -> np.ndarray:
    """Along the last axis, ``out[j] = min(v[j], out[j - 1] + a, out[j - 2]
    + 2a)``: the forward pass's last row as cv2 computes it (from 35 steps
    from a zero on, an ulp or more below ``_dt_chain``'s). Relaxed as
    ``_dt_chain`` is."""
    out = v.copy()
    while out.shape[-1] > 1:
        step = np.minimum(v[..., 1:], out[..., :-1] + _DT_A)
        step[..., 1:] = np.minimum(step[..., 1:],
                                   out[..., :-2] + _DT_STEPS[2])
        if not (step < out[..., 1:]).any():
            break
        out[..., 1:] = step
    return out


def _dt_seed_steps(inp: np.ndarray) -> np.ndarray:
    """For every column of cv2's vector blocks (from column 4), ``min(inp[m]
    + (k - m) a)`` over the block's lanes m before the column's lane k
    (``FLT_MAX`` where there is none): the in-block term of
    ``_dt_blocks``."""
    lanes = _DT_LANES
    w = inp.shape[-1]
    nb = max(0, (w - 2 * lanes - 1) // lanes + 1)     # j0 + 4 < w
    blk = inp[..., lanes:lanes + lanes * nb].reshape(*inp.shape[:-1], nb,
                                                      lanes)
    out = np.full(blk.shape, _FLT_MAX, np.float32)
    for k in range(1, lanes):
        for m in range(k):
            np.minimum(out[..., k], blk[..., m] + _DT_STEPS[k - m],
                       out=out[..., k])
    return out


def _dt_blocks(v: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """A row of cv2's forward pass after its first (the last axis): columns
    0-3 a scalar chain, then blocks of four columns from column 4 while a
    block ends before the last column, then a scalar tail. In a block,
    lane k takes ``min(v[k], carry + (k + 1) a, inp[m] + (k - m) a for m <
    k)``: ``carry`` is the block before's last lane, one addition from it,
    not k + 1, and ``inp`` the row before the pass (``seeds``, from
    ``_dt_seed_steps``)."""
    lanes = _DT_LANES
    lead = v.shape[:-1]
    nb = seeds.shape[-2]
    out = np.empty_like(v)
    out[..., :lanes] = _dt_chain(v[..., :lanes], _FLT_MAX)
    end = lanes + lanes * nb
    if nb:
        base = np.minimum(v[..., lanes:end].reshape(*lead, nb, lanes),
                          seeds)
        # each block's carry is the block before's last lane: a chain of
        # one addition of 4a a block, relaxed as _dt_chain does
        into = np.empty((*lead, nb), np.float32)
        into[..., 0] = out[..., lanes - 1]
        into[..., 1:] = base[..., :-1, -1]
        while True:
            last = np.minimum(base[..., -1], into + _DT_STEPS[lanes])
            step = last[..., :-1]
            if not (step < into[..., 1:]).any():
                break
            into[..., 1:] = step
        out[..., lanes:end] = np.minimum(
            base, into[..., None] + _DT_STEPS[1:]).reshape(*lead, -1)
    if end < v.shape[-1]:
        out[..., end:] = _dt_chain(v[..., end:], out[..., end - 1])
    return out


def distance_transform(mask: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(mask, cv2.DIST_L2, 3)`` (cv2 5.0) of an (H,
    W) mask, or of each of a stack (..., H, W): the float32 chamfer
    distance of each non-zero pixel to the nearest zero one, a step across
    0.955 and along a diagonal 1.3693, in two passes; pixels outside the
    image are never zeros, and a pixel with no zero to reach is
    ``FLT_MAX``. The forward pass (top to bottom) takes each pixel's three
    upper neighbours, then the row left to right: its first row as a scalar
    loop, the rows between in cv2's vector blocks (``_dt_blocks``), whose
    additions round differently, and its last row (of two or more) taking
    the better of one step from the pixel before and two from the pixel
    before that (``_dt_chain2``). The backward pass (bottom to top, right to
    left) is a scalar loop. This is cv2 bit for bit on every row."""
    nz = np.asarray(mask) != 0
    *lead, h, w = nz.shape
    t = np.full((*lead, h + 2, w + 2), _FLT_MAX, np.float32)
    t[..., 1:-1, 1:-1] = np.where(nz, _FLT_MAX, np.float32(0))
    a, b = _DT_A, _DT_B
    seeds = _dt_seed_steps(t[..., 1:-1, 1:-1])
    for i in range(1, h + 1):                       # forward
        up = t[..., i - 1, :]
        v = np.minimum(np.minimum(t[..., i, 1:-1], up[..., 1:-1] + a),
                       np.minimum(up[..., :-2] + b, up[..., 2:] + b))
        t[..., i, 1:-1] = (
            _dt_chain(v, _FLT_MAX) if i == 1 else _dt_chain2(v) if i == h
            else _dt_blocks(v, seeds[..., i - 1, :, :]))
    for i in range(h, 0, -1):                       # backward
        down = t[..., i + 1, :]
        v = np.minimum(np.minimum(t[..., i, 1:-1], down[..., 1:-1] + a),
                       np.minimum(down[..., :-2] + b, down[..., 2:] + b))
        t[..., i, 1:-1] = _dt_chain(v[..., ::-1], _FLT_MAX)[..., ::-1]
    return t[..., 1:-1, 1:-1]


# ---------------------------------------------------------------- PNG
PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's png_set_rgb_to_gray_fixed of OpenCV's (0.299, 0.587), in 1/32768
_GRAY_R, _GRAY_G = 9797, 19234


def _png_refuse(why: str):
    raise ValueError(f'png_decode: {why}; decode it with cv2.imdecode '
                     '(cv2 is not part of the port)')


def _png_chunks(buf: bytes):
    """The (type, data) chunks of a PNG stream, their CRCs checked."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError('png_decode: not a PNG stream')
    pos = 8
    while pos + 12 <= len(buf):
        n, kind = struct.unpack('>I4s', buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(data) != n or len(crc) != 4 or \
                zlib.crc32(kind + data) != struct.unpack('>I', crc)[0]:
            raise ValueError(f'png_decode: chunk {kind!r} is cut or its CRC '
                             'is wrong')
        yield kind, data
        if kind == b'IEND':
            return
        pos += 12 + n
    raise ValueError('png_decode: the stream ends before IEND')


def _unfilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    """The (h, w, ch) samples of the filtered rows ``raw`` (each led by its
    filter byte). Rows of None, Sub and Up alone are undone a row at a
    time; with Average or Paeth rows, whose bytes depend on the byte
    before them in the row, the image is undone an anti-diagonal at a time
    (a pixel needs its left, upper and upper-left neighbours only), on a
    sheared copy where each anti-diagonal is one column."""
    rows = raw.reshape(h, w * ch + 1)
    types, data = rows[:, 0], rows[:, 1:].reshape(h, w, ch)
    if types.max(initial=0) > 4:
        raise ValueError(f'png_decode: filter type {int(types.max())}')
    if types.max(initial=0) <= 2:
        out = np.empty((h, w, ch), np.uint8)
        prev = np.zeros((w, ch), np.uint8)
        for y in range(h):
            t = types[y]
            if t == 0:
                prev = data[y]
            elif t == 1:
                prev = (np.cumsum(data[y], axis=0, dtype=np.int64) % 256
                        ).astype(np.uint8)
            else:
                prev = data[y] + prev
            out[y] = prev
        return out
    # sheared: pixel (y, x) at S[y + 1, y + x]; row 0 is the zero row above
    # the image, and a column left of x = 0 is never written, so it reads 0
    S = np.zeros((h + 1, h + w, ch), np.int16)
    D = np.zeros((h, h + w, ch), np.int16)
    ys = np.arange(h)[:, None]
    D[ys, ys + np.arange(w)[None, :]] = data
    t = types.astype(np.int16)[:, None]
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(h - 1, k) + 1
        a = S[lo + 1:hi + 1, k - 1] if k else np.zeros((hi - lo, ch),
                                                         np.int16)
        b = S[lo:hi, k - 1] if k else a
        c = S[lo:hi, k - 2] if k > 1 else np.zeros_like(a)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        tk = t[lo:hi]
        pred = np.where(tk == 4, paeth, np.where(
            tk == 3, (a + b) >> 1, np.where(tk == 2, b, np.where(
                tk == 1, a, 0))))
        S[lo + 1:hi + 1, k] = (D[lo:hi, k] + pred) & 255
    return S[1 + ys, ys + np.arange(w)[None, :]].astype(np.uint8)


def png_decode(buf, grayscale: bool = False) -> np.ndarray:
    """``cv2.imdecode(buf, IMREAD_GRAYSCALE if grayscale else
    IMREAD_COLOR)`` of an 8-bit, non-interlaced PNG of colour type 0, 2,
    3 (no ``tRNS``), 4 or 6: (H, W, 3) BGR or (H, W) grey uint8, bit for
    bit. A PNG of another kind raises a ``ValueError`` naming cv2, and so
    does a stream that is not a whole PNG."""
    buf = bytes(buf)
    head, palette, idat = None, None, []
    for kind, data in _png_chunks(buf):
        if kind == b'IHDR':
            head = struct.unpack('>IIBBBBB', data)
        elif kind == b'PLTE':
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(data)
        elif kind == b'tRNS':
            _png_refuse('a tRNS chunk (transparency) is not decoded here')
    if head is None or not idat:
        raise ValueError('png_decode: no IHDR or no IDAT chunk')
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _PNG_CHANNELS:
        _png_refuse(f'bit depth {depth}, colour type {ctype}: only 8-bit '
                    f'colour types {sorted(_PNG_CHANNELS)} are decoded here')
    if interlace:
        _png_refuse('an interlaced PNG')
    if ctype == 3 and palette is None:
        raise ValueError('png_decode: a palette image without PLTE')
    ch = _PNG_CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f'png_decode: IDAT does not inflate: {e}') from e
    if raw.size != h * (w * ch + 1):
        raise ValueError(f'png_decode: {raw.size} bytes of image data, '
                         f'not {h * (w * ch + 1)}')
    px = _unfilter(raw, h, w, ch)
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError('png_decode: a palette index past PLTE')
        px = palette[px[..., 0]]
    elif ctype in (4, 6):
        px = px[..., :-1]                   # the alpha is stripped
    if px.shape[-1] == 1:
        return px[..., 0] if grayscale else np.repeat(px, 3, axis=-1)
    if not grayscale:
        return np.ascontiguousarray(px[..., ::-1])
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    return ((_GRAY_R * r + _GRAY_G * g + (32768 - _GRAY_R - _GRAY_G) * b)
            >> 15).astype(np.uint8)


def _png_filtered(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Each (h, stride) uint8 row filtered by the type among the five
    whose bytes, read as signed, sum to the least magnitude (the first on a
    tie): (h, stride + 1) with the type byte in front."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 255
    cost = np.where(cands > 127, 256 - cands, cands).sum(axis=2)
    best = cost.argmin(axis=0)
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = np.take_along_axis(cands, best[None, :, None], 0)[0]
    return out


def png_encode(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit PNG of ``img``: (H, W) or (H, W, 1) grey, (H, W, 3) BGR or
    (H, W, 4) BGRA uint8, as ``cv2.imencode('.png', img)`` takes them
    (written as grey, RGB or RGBA); ``level`` is zlib's."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'png_encode: uint8 images only, got {img.dtype}')
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        ctype = 2 if img.shape[-1] == 3 else 6
        px = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    else:
        raise ValueError(f'png_encode: grey, BGR or BGRA images, got shape '
                         f'{img.shape}')
    h, w, ch = px.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + kind + data +
                struct.pack('>I', zlib.crc32(kind + data)))

    rows = _png_filtered(np.ascontiguousarray(px).reshape(h, w * ch), ch)
    return (PNG_SIGNATURE +
            chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes(), level))
            + chunk(b'IEND', b''))
