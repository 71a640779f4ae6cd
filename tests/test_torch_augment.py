"""The port's training augmentations on the CPU:

* each ``cv_ops`` function against the cv2 call it copies, on seeded grey
  and BGR uint8 images of 32x128 and of odd sizes;
* each augmentation of the flagship's train pipeline against the JAX
  transform on the same per-sample keys: the JAX transform draws from the
  global ``random`` / ``np.random`` seeded with the key, the port's from
  ``seeded_rngs(key)``, so the parameters drawn are the same and only the
  pixel arithmetic may differ;
* the wrappers' draw order against JAX's.

Tolerances (uint8 grey levels): the resize, ``filter2D``, the pyramid
steps, the HSV conversions and every augmentation but the warps are
exact. The two warps are within one grey level, on at most 1e-4 of the
pixels (measured: 5 and 8 of 852,180): cv2's vector loop and its scalar
tail round the source coordinates apart, and the copy follows the vector
loop (``cv_ops`` module docstring).
"""
import random

import cv2
import numpy as np
import pytest

import tps_pp_tpu.datasets.pipelines.transforms  # noqa: F401 (registration)
from tps_pp_tpu.registry import PIPELINES as JAX_PIPELINES

from tps_pp_tpu_torch.datasets import seeded_rngs
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.registry import PIPELINES

SHAPES = [(32, 128, 3), (32, 128), (31, 77, 3), (17, 45), (32, 128, 1)]
WARP_SHARE = 1e-4


def images(n_seeds=6):
    for seed in range(n_seeds):
        g = np.random.default_rng(seed)
        for shape in SHAPES:
            yield g, g.integers(0, 256, shape, np.uint8)


def diff(got, want):
    got = np.asarray(got).reshape(np.asarray(want).shape)
    return np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64))


def test_matrices():
    m = cv_ops.get_rotation_matrix_2d((64.0, 16.0), 7.7, 1.3)
    np.testing.assert_allclose(
        m, cv2.getRotationMatrix2D((64.0, 16.0), 7.7, 1.3), rtol=0,
        atol=1e-12)
    g = np.random.default_rng(0)
    for w, h in ((128, 32), (77, 31)):
        src = np.float32([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]])
        dst = (src + g.uniform(-0.25, 0.25, (4, 2)) * [w, h]).astype(
            np.float32)
        np.testing.assert_allclose(
            cv_ops.get_perspective_transform(src, dst),
            cv2.getPerspectiveTransform(src, dst), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('kind', ['affine', 'perspective'])
def test_warps_within_one_grey_level(kind):
    worst, off, total = 0, 0, 0
    for g, img in images():
        h, w = img.shape[:2]
        if kind == 'affine':
            m = cv2.getRotationMatrix2D((w / 2, h / 2),
                                        float(g.uniform(-15, 15)),
                                        float(g.uniform(0.5, 2.0)))
            want = cv2.warpAffine(img, m, (w, h),
                                  borderMode=cv2.BORDER_REPLICATE)
            got = cv_ops.warp_affine(img, m, (w, h))
        else:
            src = np.float32([[0, 0], [w - 1, 0], [w - 1, h - 1],
                              [0, h - 1]])
            dst = (src + g.uniform(-0.25, 0.25, (4, 2)) * [w, h]).astype(
                np.float32)
            m = cv2.getPerspectiveTransform(src, dst)
            want = cv2.warpPerspective(img, m, (w, h),
                                       borderMode=cv2.BORDER_REPLICATE)
            got = cv_ops.warp_perspective(img, m, (w, h))
        assert got.shape == img.shape and got.dtype == np.uint8
        d = diff(got, want)
        worst, off, total = max(worst, d.max()), off + (d > 0).sum(), \
            total + d.size
    assert worst <= 1 and off <= WARP_SHARE * total, (worst, off, total)


@pytest.mark.parametrize('k', [3, 5])
@pytest.mark.parametrize('axis', [0, 1])
def test_filter2d_exact(k, axis):
    kernel = np.zeros((k, k), np.float32)
    kernel[(k // 2, slice(None)) if axis else (slice(None), k // 2)] = 1.0
    kernel /= kernel.sum()
    for _, img in images(3):
        assert diff(cv_ops.filter2d(img, kernel),
                    cv2.filter2D(img, -1, kernel)).max() == 0


def test_pyramid_exact():
    for _, img in images(3):
        assert diff(cv_ops.pyr_down(img), cv2.pyrDown(img)).max() == 0
        assert diff(cv_ops.pyr_up(img), cv2.pyrUp(img)).max() == 0


@pytest.mark.parametrize('shape,size', [
    ((32, 128, 3), (512, 128)), ((128, 512, 3), (128, 32)),
    ((64, 256, 3), (128, 32)), ((45, 200, 3), (128, 32)),
    ((17, 30), (128, 32)), ((8, 32, 3), (128, 32)), ((5, 7), (13, 3))])
def test_resize_exact(shape, size):
    for seed in range(3):
        img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
        assert diff(cv_ops.resize_u8(img, *size),
                    cv2.resize(img, size)).max() == 0


def test_hsv_exact():
    # every (H, S, V), in rows of 256 pixels (the vector blocks and no
    # tail) and of 1 (the scalar code alone)
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256),
                               np.arange(256), indexing='ij'),
                   -1).astype(np.uint8)
    for rows in (hsv.reshape(-1, 256, 3), hsv.reshape(-1, 1, 3)[::7]):
        assert diff(cv_ops.hsv_to_bgr(rows),
                    cv2.cvtColor(rows, cv2.COLOR_HSV2BGR)).max() == 0
    for _, img in images(3):
        if img.ndim == 3 and img.shape[2] == 3:
            assert diff(cv_ops.bgr_to_hsv(img),
                        cv2.cvtColor(img, cv2.COLOR_BGR2HSV)).max() == 0
            h = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)   # rows with a tail
            assert diff(cv_ops.hsv_to_bgr(h),
                        cv2.cvtColor(h, cv2.COLOR_HSV2BGR)).max() == 0


# the augmentations of configs/_base_/recog_pipelines/crnn_pp_pipeline.py,
# with the grey levels each may differ by
AUGMENTATIONS = [
    (dict(type='RandomRotateTextDet', max_angle=15), 1),
    (dict(type='RandomAffine', degrees=15, translate=(0.3, 0.3),
          scale=(0.5, 2.0), shear=(-45, 45)), 1),
    (dict(type='RandomPerspective', distortion_scale=0.5), 1),
    (dict(type='PyramidRescale'), 0),
    (dict(type='GaussNoise', var_limit=(20, 20), p=0.5), 0),
    (dict(type='MotionBlur', blur_limit=6, p=0.5), 0),
    (dict(type='ColorJitter', brightness=0.5, saturation=0.5, contrast=0.5,
          hue=0.1), 0),
    (dict(type='TorchVisionWrapper', op='RandomAffine', degrees=10), 1),
]


def run_both(cfg, img, key):
    """(JAX output, port output) of the transform ``cfg`` on ``img`` with
    the sample's key."""
    random.seed(key)
    np.random.seed(key % 2 ** 32)
    want = JAX_PIPELINES.build(dict(cfg))(dict(img=img.copy()))['img']
    got = PIPELINES.build(dict(cfg))(dict(img=img.copy(),
                                          **seeded_rngs(key)))['img']
    return got, want


@pytest.mark.parametrize('cfg,grey', AUGMENTATIONS,
                         ids=[c['type'] for c, _ in AUGMENTATIONS])
def test_augmentation_matches_jax(cfg, grey):
    off, total = 0, 0
    for key in range(60):
        g = np.random.default_rng(key)
        img = g.integers(0, 256, [(32, 128, 3), (32, 128, 1),
                                  (31, 77, 3)][key % 3], np.uint8)
        got, want = run_both(cfg, img, key * 1000003 + 7)
        assert got.shape == want.shape and got.dtype == want.dtype
        d = diff(got, want)
        assert d.max() <= grey, (key, d.max())
        off, total = off + (d > 0).sum(), total + d.size
    assert off <= WARP_SHARE * total


def test_wrappers_draw_in_jax_order():
    """OneOf / Random wrappers around the other transforms, twice in a
    row: the port's generator must stand where JAX's does after each, so
    the second wrapper's choices and parameters are JAX's too."""
    cfg = dict(type='RandomWrapper', p=0.7, transforms=[
        dict(type='OneOfWrapper', transforms=[
            dict(type='GaussNoise', var_limit=(20, 20), p=0.5),
            dict(type='MotionBlur', blur_limit=6, p=0.5),
            dict(type='PyramidRescale')]),
        dict(type='RandomWrapper', p=0.5, transforms=[
            dict(type='ColorJitter')])])
    jax_t, port_t = JAX_PIPELINES.build(cfg), PIPELINES.build(cfg)
    for key in range(40):
        img = np.random.default_rng(key).integers(0, 256, (32, 128, 3),
                                                  np.uint8)
        random.seed(key)
        np.random.seed(key)
        want = jax_t(jax_t(dict(img=img.copy())))['img']
        want_state = (random.random(), np.random.random_sample())
        rngs = seeded_rngs(key)
        got = port_t(port_t(dict(img=img.copy(), **rngs)))['img']
        assert diff(got, want).max() == 0, key
        assert (rngs['rng'].random(),
                rngs['np_rng'].random_sample()) == want_state
