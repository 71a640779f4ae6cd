"""DBNet in the port against the JAX package on the CPU: ``deform_conv2d``
(stride 1 and 2, offsets that leave the image), ``ResNetDet``,
``ResNetDet50`` with DCNv2 stages, ``FPNC``, the head's up branch,
``DBHead`` and ``DBNetModule`` at narrow widths (64 x 64, and 72 x 100,
where FPNC's nearest resizes have no integer ratio; the shipped configs
at full width are ``test_torch_textdet_full.py``), each ``cv_ops``
contour copy against cv2 5.0,
``DBPostprocessor`` (quad and poly) against JAX's on the same probability
maps, and the hmean metrics and polygon functions against JAX's. Inputs
and weights are made from seeds with numpy; weights go across through
``state_dict_from_jax``."""
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import load_sub, perturb_batch_stats

from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.evaluation import hmean_ic13 as j_ic13
from tps_pp_tpu.evaluation import polygon as j_polygon
from tps_pp_tpu.models.textdet import dbnet as jdb
from tps_pp_tpu.models.textdet.postprocess import \
    DBPostprocessor as JaxPostprocessor
from tps_pp_tpu.models.textdet.postprocess import \
    eval_hmean_iou as jax_hmean_iou
from tps_pp_tpu.ops import deform_conv as jdc

from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.evaluation import eval_hmean_iou, hmean_ic13, polygon
from tps_pp_tpu_torch.models.textdet import (DBHead, DBPostprocessor, FPNC,
                                             ResNetDet, ResNetDet50)
from tps_pp_tpu_torch.models.textdet.dbnet import _up_branch
from tps_pp_tpu_torch.ops.deform_conv import deform_conv2d
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

SIZES = [(64, 64), (72, 100)]
NARROW_R18 = dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                  base_channels=8)
NARROW_R50 = dict(type='ResNetDet50', stage_blocks=[1, 2, 1, 1],
                  base_channels=8, dcn=dict(type='DCNv2'),
                  stage_with_dcn=(False, True, True, True))
NARROW = {'r18': NARROW_R18, 'r50_dcn': NARROW_R50}


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run (ROADMAP queue 3:
    torch's oneDNN corrupts the heap at 3 or more in a channels-last
    conv)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def narrow_cfg(backbone):
    ins = [8, 16, 32, 64] if backbone['type'] == 'ResNetDet' else \
        [32, 64, 128, 256]
    return dict(type='DBNet', backbone=backbone,
                neck=dict(type='FPNC', in_channels=ins, lateral_channels=16,
                          out_channels=4),
                head=dict(type='DBHead', in_channels=16, k=50),
                postprocessor=dict(type='DBPostprocessor',
                                   text_repr_type='quad'))


def offsets_moved(variables, seed=1, scale=0.3):
    """Random DCNv2 offset predictors (JAX initialises them to zero), so
    that the deformable sampling is exercised."""
    g = np.random.default_rng(seed)

    def walk(t, path):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], path + (k,))
            elif 'conv_offset' in path:
                t[k] = g.normal(0, scale, t[k].shape).astype(np.float32)
    walk(variables['params'], ())
    return variables


def jax_variables(module, *inputs, seed=0):
    v = module.init(jax.random.PRNGKey(seed),
                    *[jnp.asarray(x) for x in inputs])
    return offsets_moved(perturb_batch_stats(v, seed))


def images(hw, batch=2):
    return np.random.default_rng(7).random((batch, *hw, 3)).astype(
        np.float32)


def random_variables(module, *inputs, seed=0):
    """Variables in the shapes of ``module.init``'s without running it (one
    compile fewer): kernels N(0, 1 / fan-in), biases N(0, 0.1), then
    BatchNorm and the DCNv2 offsets as ``jax_variables`` sets them."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs]))
    g = np.random.default_rng(seed)

    def leaf(s):
        std = (1 / np.prod(s.shape[:-1])) ** 0.5 if len(s.shape) > 1 else 0.1
        return (g.standard_normal(s.shape) * std).astype(s.dtype)
    v = jax.tree.map(leaf, shapes)
    return offsets_moved(perturb_batch_stats(v, seed))


@functools.lru_cache(maxsize=None)
def narrow_dbnet(name, hw):
    """(config, variables, the maps, the trunk's C2-C5) of the narrow
    DBNet on ``name``'s trunk from one jitted apply, for the trunk's and
    the model's tests."""
    cfg = narrow_cfg(NARROW[name])
    jm = jax_build(cfg)
    x = images(hw)
    v = random_variables(jm, x[:1])
    out, state = jax.jit(lambda v, x: jm.apply(
        v, x, train=False, capture_intermediates=True))(v, jnp.asarray(x))
    feats = state['intermediates']['backbone']['__call__'][0]
    return cfg, v, np.asarray(out), [np.asarray(f) for f in feats]


def sub_state(variables, rules, prefix):
    """The torch tensors of the rules under ``prefix`` (a flax path and a
    torch name), the prefix taken off the names."""
    sd = convert.convert_rules(
        variables, [r for r in rules if r[1].startswith(prefix + '/')])
    return {k[len(prefix) + 1:]: t for k, t in sd.items()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# ------------------------------------------------------------- DCNv2 --

@pytest.mark.parametrize('stride', [1, 2])
def test_deform_conv2d_matches_jax(stride):
    g = np.random.default_rng(stride)
    n, h, w, cin, cout = 2, 11, 13, 5, 7
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = g.standard_normal((n, h, w, cin)).astype(np.float32)
    # offsets of up to 8 pixels: many taps land outside the image
    off = g.uniform(-8, 8, (n, ho, wo, 18)).astype(np.float32)
    mask = g.random((n, ho, wo, 9)).astype(np.float32)
    weight = g.standard_normal((3, 3, cin, cout)).astype(np.float32)
    bias = g.standard_normal(cout).astype(np.float32)
    want = jdc.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                             jnp.asarray(mask), jnp.asarray(weight),
                             jnp.asarray(bias), stride=stride)
    got = deform_conv2d(nchw(x), nchw(off), nchw(mask),
                        torch.from_numpy(weight).permute(3, 2, 0, 1),
                        torch.from_numpy(bias), stride=stride)
    assert got.shape == (n, cout, ho, wo)
    close(got.permute(0, 2, 3, 1), want, 1e-5)


# ---------------------------------------------------- modules, narrow --

@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('name', ['r18', 'r50_dcn'])
def test_resnet_det_trunks_match_jax(name, hw):
    """ResNetDet, and ResNetDet50 with DCNv2 stages: C2-C5."""
    cfg, v, _, want = narrow_dbnet(name, hw)
    kw = {k: val for k, val in cfg['backbone'].items() if k != 'type'}
    tm = (ResNetDet if name == 'r18' else ResNetDet50)(**kw)
    tm.load_state_dict(sub_state(v, convert.rules_for_config(cfg),
                                 'backbone'), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images(hw)))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        close(a.permute(0, 2, 3, 1), b, 1e-4)


@pytest.mark.parametrize('hw', SIZES)
def test_fpnc_matches_jax(hw):
    g = np.random.default_rng(4)
    h, w = hw[0] // 4, hw[1] // 4
    chans = (8, 16, 32, 64)
    feats = []
    for i, c in enumerate(chans):    # the trunk's sizes: ceil halvings
        feats.append(g.standard_normal((2, h, w, c)).astype(np.float32))
        h, w = (h + 1) // 2, (w + 1) // 2
    jm = jdb.FPNC(in_channels=chans, lateral_channels=16, out_channels=4)
    v = jm.init(jax.random.PRNGKey(0), tuple(jnp.asarray(f) for f in feats))
    want = jm.apply(v, tuple(jnp.asarray(f) for f in feats))
    tm = load_sub(FPNC(chans, 16, 4), v, convert.fpnc_rules(), 'neck',
                  'neck')
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    close(got.permute(0, 2, 3, 1), want, 1e-4)


@pytest.mark.parametrize('hw', SIZES)
def test_up_branch_matches_jax(hw):
    """The transposed convolutions: flax correlates with its kernel, torch
    scatters, so the converter flips it."""
    x = np.random.default_rng(5).standard_normal(
        (2, hw[0] // 4, hw[1] // 4, 16)).astype(np.float32)
    jm = jdb._UpBranch(4)
    v = jax_variables(jm, x)
    want = jm.apply(v, jnp.asarray(x), train=False)
    rules = [r for r in convert.db_head_rules()
             if r[0].startswith('head.binarize')]
    tm = load_sub(_up_branch(16, 4), v, rules, 'head/binarize',
                  'head.binarize').eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 1, hw[0], hw[1])
    close(got.permute(0, 2, 3, 1), want, 1e-4)


@pytest.mark.parametrize('hw', SIZES)
def test_db_head_matches_jax(hw):
    x = np.random.default_rng(6).standard_normal(
        (2, hw[0] // 4, hw[1] // 4, 16)).astype(np.float32)
    jm = jdb.DBHead(in_channels=16, k=50)
    v = jax_variables(jm, x)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = load_sub(DBHead(16, 50), v, convert.db_head_rules(), 'head',
                  'head').eval()
    with torch.no_grad():
        got = tm(nchw(x))
    close(got.permute(0, 2, 3, 1), want, 1e-4)


@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('name', ['r18', 'r50_dcn'])
def test_dbnet_module_matches_jax(name, hw):
    cfg, v, want, _ = narrow_dbnet(name, hw)
    x = images(hw)
    tm = build_detector_module(cfg)
    tm.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (2, *hw, 3)
    close(got, want, 1e-4)


# ------------------------------------------------- cv_ops against cv2 --

def masks(seed):
    """Seeded binary masks: noise, blurred blobs, rectangles with holes,
    one-pixel lines and single pixels, many touching the border."""
    g = np.random.default_rng(seed)
    h, w = (int(v) for v in g.integers(1, 40, 2))
    kind = seed % 4
    if kind == 0:
        return (g.random((h, w)) < g.uniform(0.2, 0.8)).astype(np.uint8)
    if kind == 1:
        blur = cv2.blur(g.random((h, w)).astype(np.float32), (3, 3))
        return (blur > 0.5).astype(np.uint8)
    m = np.zeros((h, w), np.uint8)
    for _ in range(int(g.integers(1, 6))):
        y0, x0 = int(g.integers(0, h)), int(g.integers(0, w))
        if kind == 2:
            m[y0:y0 + int(g.integers(1, 12)),
              x0:x0 + int(g.integers(1, 12))] = 1
            if g.random() < 0.5:
                m[y0 + 1:y0 + 3, x0 + 1:x0 + 3] = 0
        elif g.random() < 0.5:
            m[y0, x0:x0 + int(g.integers(1, 15))] = 1
        else:
            m[y0:y0 + int(g.integers(1, 15)), x0] = 1
    return m


SEED_BLOCKS = [range(i * 150, (i + 1) * 150) for i in range(6)]


def contours_of(seeds):
    for s in seeds:
        m = masks(s)
        yield m, cv2.findContours(m, cv2.RETR_LIST,
                                  cv2.CHAIN_APPROX_SIMPLE)[0]


@pytest.mark.parametrize('mode', ['list', 'external'])
@pytest.mark.parametrize('block', range(6))
def test_find_contours_matches_cv2(block, mode):
    """Every contour, point for point, in cv2's order (holes included in
    RETR_LIST)."""
    cv_mode = cv2.RETR_LIST if mode == 'list' else cv2.RETR_EXTERNAL
    port_mode = cv_ops.RETR_LIST if mode == 'list' else cv_ops.RETR_EXTERNAL
    for s in SEED_BLOCKS[block]:
        m = masks(s)
        want = cv2.findContours(m, cv_mode, cv2.CHAIN_APPROX_SIMPLE)[0]
        got = cv_ops.find_contours(m, port_mode)
        assert len(got) == len(want), s
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and a.shape == b.shape, s
            np.testing.assert_array_equal(a, b, err_msg=str(s))


def test_find_contours_on_a_large_blurred_map():
    g = np.random.default_rng(0)
    m = (cv2.blur(g.random((320, 320)).astype(np.float32), (9, 9))
         > 0.55).astype(np.uint8)
    want = cv2.findContours(m, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)[0]
    got = cv_ops.find_contours(m)
    assert len(got) == len(want) > 100
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize('block', range(3))
def test_contour_measures_match_cv2(block):
    """bounding_rect, contour_area, arc_length (closed and open) and
    convex_hull exactly; min_area_rect within 1e-4; box_points within
    1e-3 px."""
    for _, cs in contours_of(SEED_BLOCKS[block]):
        for c in cs[:6]:
            assert cv_ops.bounding_rect(c) == cv2.boundingRect(c)
            assert cv_ops.contour_area(c) == cv2.contourArea(c)
            assert cv_ops.arc_length(c, True) == cv2.arcLength(c, True)
            assert cv_ops.arc_length(c, False) == cv2.arcLength(c, False)
            np.testing.assert_array_equal(cv_ops.convex_hull(c),
                                          cv2.convexHull(c).reshape(-1, 2))
            want = cv2.minAreaRect(c)
            got = cv_ops.min_area_rect(c)
            close([*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]],
                  1e-4)
            close(cv_ops.box_points(want), cv2.boxPoints(want), 1e-3)


def test_min_area_rect_and_hull_of_point_clouds_match_cv2():
    """Random integer clouds with repeated and collinear points."""
    g = np.random.default_rng(1)
    for _ in range(1500):
        pts = g.integers(0, int(g.integers(2, 30)),
                         (int(g.integers(1, 60)), 2)).astype(np.int32)
        np.testing.assert_array_equal(cv_ops.convex_hull(pts),
                                      cv2.convexHull(pts).reshape(-1, 2))
        want, got = cv2.minAreaRect(pts), cv_ops.min_area_rect(pts)
        close([*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]],
              1e-4)
        rect = ((g.uniform(-50, 700), g.uniform(-50, 700)),
                (g.uniform(0, 300), g.uniform(0, 300)), g.uniform(-180, 180))
        close(cv_ops.box_points(rect), cv2.boxPoints(rect), 1e-3)


@pytest.mark.parametrize('block', range(3))
def test_draw_contours_filled_matches_cv2(block):
    for m, cs in contours_of(SEED_BLOCKS[block]):
        for c in cs[:6]:
            x, y, w, h = cv2.boundingRect(c)
            want = np.zeros((h, w), np.uint8)
            cv2.drawContours(want, [c - [x, y]], -1, 1, -1)
            got = cv_ops.draw_contours(np.zeros((h, w), np.uint8),
                                       c - [x, y], 1)
            np.testing.assert_array_equal(got, want)
            # an offset that keeps the contour inside a larger canvas
            want = np.zeros((m.shape[0] + 4, m.shape[1] + 6), np.uint8)
            cv2.drawContours(want, [c], -1, 7, -1, offset=(3, 2))
            got = cv_ops.draw_contours(np.zeros_like(want), c, 7, (3, 2))
            np.testing.assert_array_equal(got, want)


def test_fill_poly_matches_cv2():
    """Polygons with their vertices inside the image: convex, concave and
    self-intersecting, one or two at once (cv_ops' docstring states the
    case of vertices outside the image is the next test)."""
    g = np.random.default_rng(2)
    for _ in range(1500):
        h, w = (int(v) for v in g.integers(3, 40, 2))
        polys = [np.stack([g.integers(0, w, k), g.integers(0, h, k)], 1)
                 .astype(np.int32)
                 for k in g.integers(1, 9, int(g.integers(1, 3)))]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        got = cv_ops.fill_poly(np.zeros((h, w), np.uint8), polys, 1)
        np.testing.assert_array_equal(got, want)


def test_fill_poly_outside_the_image_matches_cv2():
    """Vertices outside the image, one or two polygons, with an offset:
    cv2 5.0 fills the border column where a clipped edge collapses to one
    point, and the copy does as well."""
    g = np.random.default_rng(7)
    for _ in range(1500):
        h, w = (int(v) for v in g.integers(1, 30, 2))
        polys = [g.integers(-30, 60, (k, 2)).astype(np.int32)
                 for k in g.integers(1, 8, int(g.integers(1, 3)))]
        off = tuple(int(v) for v in g.integers(-5, 6, 2))
        want = cv2.fillPoly(np.zeros((h, w), np.uint8), polys, 1,
                            offset=off)
        got = cv_ops.fill_poly(np.zeros((h, w), np.uint8), polys, 1, off)
        np.testing.assert_array_equal(got, want)
    # a segment clipped to one point: the border column from its start
    p = np.array([[-1, 0], [0, 3]], np.int32)
    want = cv2.fillPoly(np.zeros((10, 10), np.uint8), [p], 1)
    assert want[:4, 0].tolist() == [1, 1, 1, 1]
    np.testing.assert_array_equal(
        cv_ops.fill_poly(np.zeros((10, 10), np.uint8), [p], 1), want)


def test_structuring_element_and_dilate_match_cv2():
    for s in range(1, 40):
        for k in ((s, s), (2 * s + 1, 2 * s + 1), (s, s + 3)):
            np.testing.assert_array_equal(
                cv_ops.get_structuring_element(k),
                cv2.getStructuringElement(cv2.MORPH_ELLIPSE, k))
    g = np.random.default_rng(3)
    for _ in range(200):
        h, w = (int(v) for v in g.integers(1, 40, 2))
        img = ((g.random((h, w)) < g.uniform(0.01, 0.3))
               * g.integers(1, 256)).astype(np.uint8)
        kernel = cv_ops.get_structuring_element(
            (2 * int(g.integers(0, 8)) + 1,) * 2)
        np.testing.assert_array_equal(cv_ops.dilate(img, kernel),
                                      cv2.dilate(img, kernel))


# ------------------------------------------------------ postprocessor --

def prob_maps(n=16, seed=0):
    g = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in g.integers(20, 160, 2))
        k = 2 * int(g.integers(1, 6)) + 1
        p = cv2.GaussianBlur(g.random((h, w)).astype(np.float32), (k, k), 0)
        yield i, (p - p.min()) / (p.max() - p.min() + 1e-6)


@pytest.mark.parametrize('mode', ['quad', 'poly'])
def test_db_postprocessor_matches_jax(mode):
    total = 0
    for i, prob in prob_maps():
        kw = dict(text_repr_type=mode, min_text_width=1 + 4 * (i % 2),
                  unclip_ratio=1.5 + i % 3)
        want = JaxPostprocessor(**kw)(prob)
        got = DBPostprocessor(**kw)(prob)
        assert len(got) == len(want), i
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == b.shape, i
            close(a[:-1], b[:-1], 1e-3)
            close(a[-1:], b[-1:], 1e-6)
        total += len(got)
    assert total > 200


def test_db_postprocessor_cuts_at_max_candidates_as_jax():
    _, prob = next(prob_maps(1, seed=9))
    for cap in (1, 5, 40):
        want = JaxPostprocessor(max_candidates=cap, min_text_width=1)(prob)
        got = DBPostprocessor(max_candidates=cap, min_text_width=1)(prob)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            close(a, b, 1e-3)


# ------------------------------------------------------------ metrics --

def boxes(g, n, jitter, lo=0):
    out = []
    for _ in range(n):
        x, y = g.uniform(lo, 200, 2)
        w, h = g.uniform(8, 60, 2)
        q = np.array([x, y, x + w, y, x + w, y + h, x, y + h], np.float32)
        out.append(q + g.uniform(-jitter, jitter, 8).astype(np.float32))
    return out


def detection_sets(seed, lo=0):
    """(predictions with scores, gts, don't-cares) of a few images: the
    gts jittered into predictions, some dropped, some added; the boxes'
    corners from ``lo`` on."""
    g = np.random.default_rng(seed)
    preds, gts, ignores = [], [], []
    for _ in range(4):
        gt = boxes(g, int(g.integers(0, 6)), 2, lo)
        ig = boxes(g, int(g.integers(0, 2)), 2, lo)
        pr = [b + g.uniform(-6, 6, 8).astype(np.float32)
              for b in gt + ig if g.random() < 0.8]
        pr += boxes(g, int(g.integers(0, 3)), 2, lo)
        preds.append([np.append(p, g.random()).astype(np.float32)
                      for p in pr])
        gts.append([b.reshape(-1, 2) for b in gt])
        ignores.append([b.reshape(-1, 2) for b in ig])
    return preds, gts, ignores


@pytest.mark.parametrize('seed', range(4))
def test_hmean_iou_matches_jax(seed):
    preds, gts, ignores = detection_sets(seed)
    for thr in (0.3, 0.5):
        assert eval_hmean_iou(preds, gts, iou_thr=thr, gt_ignore=ignores) \
            == jax_hmean_iou(preds, gts, iou_thr=thr, gt_ignore=ignores)
    assert eval_hmean_iou(preds, gts) == jax_hmean_iou(preds, gts)


@pytest.mark.parametrize('seed', range(4))
def test_hmean_ic13_matches_jax(seed):
    preds, gts, ignores = detection_sets(seed)
    assert hmean_ic13.eval_hmean_ic13(preds, gts, gt_ignore=ignores) == \
        j_ic13.eval_hmean_ic13(preds, gts, gt_ignore=ignores)
    assert hmean_ic13.eval_hmean_ic13(preds, gts) == \
        j_ic13.eval_hmean_ic13(preds, gts)


@pytest.mark.parametrize('seed', (0, 1, 20, 84))
def test_hmean_ic13_matches_jax_across_the_top_left_edges(seed):
    """Boxes whose corners start anywhere in [-60, 200): some 40% cross
    x = 0 or y = 0 and fall partly off the raster's canvas. On seeds 20
    and 84 a fill without cv2's border column (an edge clipped to one
    point) gives another hmean."""
    preds, gts, ignores = detection_sets(seed, lo=-60)
    assert any((b[:-1] < 0).any() for page in preds for b in page)
    assert hmean_ic13.eval_hmean_ic13(preds, gts, gt_ignore=ignores) == \
        j_ic13.eval_hmean_ic13(preds, gts, gt_ignore=ignores)
    assert hmean_ic13.eval_hmean_ic13(preds, gts) == \
        j_ic13.eval_hmean_ic13(preds, gts)


def test_polygon_functions_match_jax():
    g = np.random.default_rng(5)
    for _ in range(300):
        a = g.uniform(0, 50, (int(g.integers(3, 8)), 2))
        b = g.uniform(0, 50, (int(g.integers(3, 8)), 2))
        for f in ('polygon_area', 'is_convex'):
            assert getattr(polygon, f)(a) == getattr(j_polygon, f)(a)
        for f in ('poly_intersection_area', 'poly_iou'):
            assert getattr(polygon, f)(a, b) == getattr(j_polygon, f)(a, b)
        np.testing.assert_array_equal(polygon.clip_convex(a, b),
                                      j_polygon.clip_convex(a, b))
        got, want = polygon.triangulate(a), j_polygon.triangulate(a)
        assert len(got) == len(want)
        for t, u in zip(got, want):
            np.testing.assert_array_equal(t, u)
