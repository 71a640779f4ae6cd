"""The port's test pipeline (``tps_pp_tpu_torch/datasets/pipelines``)
against the JAX package's, transform by transform, on the same inputs:

* ``ResizeOCR``, both branches, with and without ``min_width`` /
  ``max_width``, on seed-made images of assorted sizes: uint8 within one
  grey level of cv2's fixed-point rounding, float32 within 1e-4; the
  metadata (``valid_ratio``, ``resize_shape``, ``pad_shape``,
  ``pre_resize_shape``, ``img_shape``) exactly.
* ``LoadImageFromNdarray`` grey <-> BGR within one grey level;
  ``LoadImageFromFile`` on the toy dataset identical (both decode with
  cv2), and without cv2 an ``ImportError``.
* ``ToTensorOCR``, ``NormalizeOCR`` (with 0-255 stats too), ``Collect``,
  ``Compose``, ``MultiRotateAugOCR`` and ``merge_aug_results``: exact on
  the same input.
"""
import os
import sys

import cv2
import numpy as np
import pytest

from tps_pp_tpu.datasets.pipelines import test_time_aug as jtta
from tps_pp_tpu.datasets.pipelines import transforms as jt

from tps_pp_tpu_torch.datasets.pipelines import test_time_aug as ttta
from tps_pp_tpu_torch.datasets.pipelines import transforms as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, 'tests/data/ocr_toy_dataset')
NORM = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
# one grey level after NormalizeOCR, with float32 rounding
GREY = 1.0 / 255.0 / min(NORM['std']) + 1e-6
META = ('valid_ratio', 'resize_shape', 'pad_shape', 'pre_resize_shape',
        'img_shape')
RESIZES = {
    'fixed_128': dict(height=32, min_width=128, max_width=128,
                      keep_aspect_ratio=False),
    'fixed_64': dict(height=32, max_width=64, keep_aspect_ratio=False),
    'ratio_pad_160': dict(height=32, max_width=160),
    'ratio_min_max': dict(height=32, min_width=32, max_width=100),
    'ratio_free': dict(height=48),
    'ratio_min_only': dict(height=32, min_width=64),
    'ratio_div4_pad': dict(height=32, max_width=128, img_pad_value=7,
                           width_downsample_ratio=0.25),
}


def images(seed, dtype, channels):
    """Seed-made crops, heights 8-80 and widths 8-400, of one kind; each
    wide enough for its resized width to round to at least 16."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(12):
        h = int(g.integers(8, 80))
        w = int(g.integers(max(8, h // 2), 400))
        shape = (h, w) if channels is None else (h, w, channels)
        img = g.integers(0, 256, shape, dtype=np.uint8)
        out.append(img if dtype == 'uint8'
                   else img.astype(np.float32) / 255.0)
    return out


@pytest.mark.parametrize('channels', [3, 1, None])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
@pytest.mark.parametrize('name', sorted(RESIZES))
def test_resize_ocr_matches_jax(name, dtype, channels):
    kw = RESIZES[name]
    atol = 1 if dtype == 'uint8' else 1e-4
    for img in images(len(name), dtype, channels):
        want = jt.ResizeOCR(**kw)(dict(img=img.copy()))
        got = tt.ResizeOCR(**kw)(dict(img=img.copy()))
        assert got['img'].dtype == want['img'].dtype
        assert got['img'].shape == want['img'].shape
        for k in META:
            assert got[k] == want[k], k
        diff = np.abs(got['img'].astype(np.float64) -
                      want['img'].astype(np.float64))
        assert diff.max() <= atol, (img.shape, diff.max())


def test_resize_to_zero_width_raises_in_both():
    img = np.zeros((56, 9, 3), np.uint8)    # 32 / 56 * 9 rounds to width 0
    with pytest.raises(cv2.error):
        jt.ResizeOCR(height=32)(dict(img=img))
    with pytest.raises(ValueError):
        tt.ResizeOCR(height=32)(dict(img=img))


def test_resize_identity_and_exact_halving_are_exact():
    g = np.random.default_rng(3)
    img = g.integers(0, 256, (32, 128, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tt.resize_bilinear(img, 128, 32), img)
    big = np.repeat(np.repeat(img, 2, 0), 2, 1)
    np.testing.assert_array_equal(tt.resize_bilinear(big, 128, 32), img)


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
@pytest.mark.parametrize('shape,color_type', [
    ((20, 50, 3), 'grayscale'), ((20, 50, 1), 'color'), ((20, 50), 'color'),
    ((20, 50), 'grayscale'), ((20, 50, 3), 'color')])
def test_load_image_from_ndarray_matches_jax(shape, color_type, dtype):
    g = np.random.default_rng(4)
    img = g.integers(0, 256, shape, dtype=np.uint8)
    if dtype == 'float32':
        img = img.astype(np.float32)
    want = jt.LoadImageFromNdarray(color_type)(dict(img=img.copy()))
    got = tt.LoadImageFromNdarray(color_type)(dict(img=img.copy()))
    assert got['img'].dtype == want['img'].dtype
    for k in ('img_shape', 'ori_shape', 'filename'):
        assert got[k] == want[k]
    diff = np.abs(got['img'].astype(np.float64) - want['img'])
    assert diff.max() <= (1 if dtype == 'uint8' else 1e-3)


@pytest.mark.parametrize('color_type', ['color', 'grayscale'])
def test_load_image_from_file_is_cv2_imread(color_type):
    for i in range(10):
        info = dict(filename=f'img_{i}.jpg')
        want = jt.LoadImageFromFile(color_type)(
            dict(img_info=dict(info), img_prefix=TOY))
        got = tt.LoadImageFromFile(color_type)(
            dict(img_info=dict(info), img_prefix=TOY))
        np.testing.assert_array_equal(got['img'], want['img'])
        assert got['filename'] == want['filename']
        assert got['img_shape'] == want['img_shape']
    path = os.path.join(TOY, 'img_0.jpg')
    got = tt.LoadImageFromFile(color_type)(dict(img_path=path))
    assert got['filename'] == path
    with pytest.raises(FileNotFoundError):
        tt.LoadImageFromFile()(dict(img_path=path + '.missing'))


def test_load_image_from_file_without_cv2_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='LoadImageFromNdarray'):
        tt.LoadImageFromFile()(dict(img_path=os.path.join(TOY, 'img_0.jpg')))
    # ndarray input needs no cv2
    out = tt.LoadImageFromNdarray()(dict(img=np.zeros((4, 5), np.uint8)))
    assert out['img'].shape == (4, 5, 3)


def tail_steps(mean, std, keys=('img',), meta_keys=None):
    collect = dict(type='Collect', keys=list(keys))
    if meta_keys is not None:
        collect['meta_keys'] = list(meta_keys)
    return [dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=mean, std=std), collect]


@pytest.mark.parametrize('stats', [
    NORM, dict(mean=[127.5] * 3, std=[127.5] * 3), dict(mean=[0.5], std=[2.0])])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_to_tensor_normalize_collect_compose_exact(stats, dtype):
    """The same resized image through both tails: exactly equal."""
    g = np.random.default_rng(5)
    img = g.integers(0, 256, (32, 64, 3), dtype=np.uint8)
    if dtype == 'float32':
        img = img.astype(np.float32)
    steps = tail_steps(stats['mean'], stats['std'], keys=('img',),
                       meta_keys=('filename', 'valid_ratio', 'img_norm_cfg'))
    res = dict(img=img, filename='x', valid_ratio=0.5, text='ab')
    want = jt.Compose(steps)(dict(res))
    got = tt.Compose(steps)(dict(res))
    assert got.keys() == want.keys()
    assert got['img'].dtype == np.float32
    np.testing.assert_array_equal(got['img'], want['img'])
    assert got['img_metas'] == want['img_metas']
    assert got['text'] == want['text'] == 'ab'


def test_compose_drops_a_filtered_sample():
    steps = [lambda r: None, dict(type='ToTensorOCR')]
    assert tt.Compose(steps)(dict(img=np.zeros((2, 2, 3), np.uint8))) is None


def flagship_test_pipeline(width=128):
    return [dict(type='ResizeOCR', height=32, min_width=width,
                 max_width=width, keep_aspect_ratio=False),
            *tail_steps(NORM['mean'], NORM['std'],
                        meta_keys=('filename', 'ori_shape', 'resize_shape',
                                   'valid_ratio'))]


def test_flagship_test_pipeline_on_the_toy_files():
    """File -> the flagship's test pipeline: images within one grey level
    after normalisation (1/255/std), metas equal."""
    steps = [dict(type='LoadImageFromFile')] + flagship_test_pipeline()
    for i in range(10):
        res = dict(img_info=dict(filename=f'img_{i}.jpg'), img_prefix=TOY)
        want = jt.Compose(steps)(dict(res))
        got = tt.Compose(steps)(dict(res))
        assert got['img_metas'] == want['img_metas']
        np.testing.assert_allclose(got['img'], want['img'], rtol=0,
                                   atol=GREY)


@pytest.mark.parametrize('degrees,force,shape', [
    ((0, 90, 270), False, (64, 16, 3)),      # tall: rotated
    ((0, 90, 270), False, (16, 64, 3)),      # wide: as it is
    ((0, 90, 180, 270), True, (16, 64, 3)),  # forced
    ((0, 45), True, (24, 40, 3)),            # any other angle is cv2's
])
@pytest.mark.parametrize('with_transforms', [False, True])
def test_multi_rotate_aug_matches_jax(degrees, force, shape,
                                      with_transforms):
    img = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    transforms = flagship_test_pipeline(64) if with_transforms else ()
    kw = dict(rotate_degrees=degrees, force_rotate=force,
              transforms=transforms)
    want = jtta.MultiRotateAugOCR(**kw)(dict(img=img.copy()))
    got = ttta.MultiRotateAugOCR(**kw)(dict(img=img.copy()))
    assert got.keys() == want.keys()
    for k in ('aug_n', 'aug_total'):
        assert got[k] == want[k]
    assert len(got['aug_imgs']) == len(want['aug_imgs'])
    for a, b in zip(got['aug_imgs'], want['aug_imgs']):
        assert a.shape == b.shape
        if with_transforms:     # through the resize: one grey level
            np.testing.assert_allclose(a, b, rtol=0, atol=GREY)
        else:
            np.testing.assert_array_equal(a, b)
    if with_transforms:
        assert got['aug_metas'] == want['aug_metas']


def test_merge_aug_results_matches_jax():
    g = np.random.default_rng(7)
    for _ in range(20):
        n = int(g.integers(1, 4))
        results = [dict(text='ab'[:int(g.integers(0, 3))],
                        score=g.uniform(0, 1, int(g.integers(0, 4))).tolist())
                   for _ in range(n)]
        assert ttta.merge_aug_results(results) == \
            jtta.merge_aug_results(results)
