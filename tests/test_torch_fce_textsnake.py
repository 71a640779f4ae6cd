"""FCENet and TextSnake in the port against the JAX package on the CPU: the
``cv_ops`` copies they add against cv2 5.0 (``find_contours`` with
``RETR_TREE``, in cv2's order; the cross structuring element, ``erode``
and ``morphology_open`` with a border of 0; ``flood_fill``; the filled
``circle``), the sideline geometry of ``sidelines.py``,
``TextSnakeTargets`` and ``FCENetTargets`` exact, ``FPNDet`` /
``FCEHead`` and ``FPN_UNet`` / ``TextSnakeHead`` and the narrow modules
against flax, ``FCELoss`` and ``TextSnakeLoss`` with their gradients
against ``jax.value_and_grad``, ``fourier2poly``, ``poly_nms`` and both
postprocessors exact on trained-like maps (each config's own targets of
word polygons, as logits), and the entry points on narrow configs:
``init_detector`` from a ``.pth``, ``detect_batch``, ``train_detector``
with its ``.pth`` resume, ``tools/test.py`` (hmean-iou), ``tools/train.py``
and ``MMOCR.readtext`` with a config path. Inputs and weights are made from
seeds with numpy; the shipped configs at full width are
``test_torch_fce_textsnake_full.py``."""
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import fce_like, textsnake_like
from hypothesis import given, settings, strategies as st
from test_torch_det_train import SCHEDULE, Pages, word_polygons
from test_torch_panet import flax_variables, nchw, pyramid, same_boundaries
from test_torch_textdet import close, random_variables

from tps_pp_tpu.apis.detector import TextDetector as JaxDetector
from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.apis.train_det import train_detector as jax_train
from tps_pp_tpu.datasets.textdet_dataset import TextDetDataset as JaxDataset
from tps_pp_tpu.models.textdet import fce_textsnake as jfce
from tps_pp_tpu.models.textdet import postprocess as jpp
from tps_pp_tpu.models.textdet import sidelines as jsl
from tps_pp_tpu.models.textdet import targets as jt

from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.models.textdet import (FCEHead, FCELoss, FPNDet,
                                             FPN_UNet, TextSnakeHead,
                                             TextSnakeLoss, postprocess,
                                             sidelines, targets)
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

R50 = dict(type='ResNetDet50', stage_blocks=[1, 1, 1, 1], base_channels=8)
R50_DCN = dict(R50, dcn=dict(type='DCNv2'),
               stage_with_dcn=(False, True, True, True))
CFGS = {
    'fce': dict(type='FCENet', backbone=R50,
                neck=dict(type='FPNDet', in_channels=[64, 128, 256],
                          out_channels=8),
                head=dict(type='FCEHead', in_channels=8, fourier_degree=5),
                loss=dict(type='FCELoss', fourier_degree=5, num_sample=50,
                          ohem_ratio=3),
                # 0.36: a boundary or so from the random weights (at the
                # shipped 0.3 their pages give ~7 each and poly_nms takes
                # seconds a page)
                postprocessor=dict(type='FCEPostprocessor', alpha=1.2,
                                   beta=1.0, score_thr=0.36, nms_thr=0.1),
                targets=dict(type='FCENetTargets', fourier_degree=5)),
    'fce_dcn': dict(type='FCENet', backbone=R50_DCN,
                    neck=dict(type='FPNDet', in_channels=[64, 128, 256],
                              out_channels=8),
                    head=dict(type='FCEHead', in_channels=8),
                    loss=dict(type='FCELoss'),
                    postprocessor=dict(type='FCEPostprocessor',
                                       text_repr_type='quad')),
    'textsnake': dict(type='TextSnake', backbone=R50,
                      neck=dict(type='FPN_UNet',
                                in_channels=[32, 64, 128, 256],
                                out_channels=4),
                      head=dict(type='TextSnakeHead', out_channels=5),
                      loss=dict(type='TextSnakeLoss'),
                      postprocessor=dict(type='TextSnakePostprocessor',
                                         text_repr_type='poly'),
                      targets=dict(type='TextSnakeTargets')),
}


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run (ROADMAP queue 3:
    torch's oneDNN corrupts the heap at 3 or more in a channels-last
    conv)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------- cv_ops --

def nested_masks(g, n):
    """Masks with holes, nested components and rings: noise, bands of a
    blurred field, concentric rings and XORed rectangles, of 1 x 1 up to
    70 x 70, as 0/1 or 0/255."""
    out = []
    for t in range(n):
        hw = tuple(int(v) for v in g.integers(1, 70, 2))
        kind = t % 4
        if kind == 0:
            m = g.random(hw) < g.uniform(0.2, 0.8)
        elif kind == 1:
            base = cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0),
                                    float(g.uniform(0.7, 3)))
            q = np.quantile(base, np.sort(g.uniform(0, 1, 4)))
            m = ((base > q[0]) & (base < q[1])) | ((base > q[2])
                                                   & (base < q[3]))
        elif kind == 2:
            yy, xx = np.mgrid[:hw[0], :hw[1]]
            r = np.hypot(yy - g.uniform(0, hw[0]), xx - g.uniform(0, hw[1]))
            m = (r // g.uniform(1.5, 5)).astype(int) % 2 == 1
        else:
            m = np.zeros(hw, bool)
            for _ in range(6):
                y0, x0 = g.integers(0, hw[0]), g.integers(0, hw[1])
                m[y0:y0 + g.integers(1, 30), x0:x0 + g.integers(1, 30)] ^= True
        out.append(m.astype(np.uint8) * np.uint8(g.choice([1, 255])))
    return out


@pytest.mark.parametrize('seed', range(4))
def test_find_contours_tree_matches_cv2(seed):
    """``RETR_TREE``: cv2's contours in cv2's order, with both chain
    methods, on masks with holes and nested components (the other modes
    on the same masks too)."""
    for m in nested_masks(np.random.default_rng(seed), 60):
        for mode in (cv_ops.RETR_TREE, cv_ops.RETR_LIST,
                     cv_ops.RETR_EXTERNAL):
            for method in (cv_ops.CHAIN_APPROX_SIMPLE,
                           cv_ops.CHAIN_APPROX_NONE):
                want = cv2.findContours(m, mode, method)[0]
                got = cv_ops.find_contours(m, mode, method)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)


def test_find_contours_tree_orders_nested_borders_as_cv2():
    """Two top-level squares, one holding a hole with two blobs, one of
    them holed: depth first, the borders of one parent latest first."""
    m = np.zeros((40, 50), np.uint8)
    m[2:30, 2:30] = 1
    m[5:27, 5:27] = 0
    m[7:14, 7:14] = 1
    m[9:12, 9:12] = 0
    m[16:24, 16:24] = 1
    m[2:10, 35:45] = 1
    want = cv2.findContours(m, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)[0]
    got = cv_ops.find_contours(m, cv_ops.RETR_TREE)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', range(3))
def test_morphology_matches_cv2(seed):
    """The structuring elements, ``erode`` and ``morphology_open`` with
    ``borderValue=0`` (shapes touching the edges), and ``dilate``."""
    g = np.random.default_rng(seed)
    for ks in [(3, 3), (5, 3), (1, 1), (4, 4), (2, 5)]:
        for shape in (cv_ops.MORPH_CROSS, cv_ops.MORPH_ELLIPSE):
            np.testing.assert_array_equal(
                cv_ops.get_structuring_element(ks, shape),
                cv2.getStructuringElement(shape, ks))
    for _ in range(60):
        hw = tuple(int(v) for v in g.integers(1, 50, 2))
        m = (cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0), 1.5)
             > 0.5).astype(np.uint8)
        k = cv2.getStructuringElement(int(g.integers(0, 3)),
                                      (int(g.integers(1, 6)),
                                       int(g.integers(1, 6))))
        # a rectangle, cross or ellipse: erode takes any kernel
        np.testing.assert_array_equal(cv_ops.erode(m, k),
                                      cv2.erode(m, k, borderValue=0))
        np.testing.assert_array_equal(
            cv_ops.morphology_open(m, k),
            cv2.morphologyEx(m, cv2.MORPH_OPEN, k, borderValue=0))
        np.testing.assert_array_equal(cv_ops.dilate(m, k), cv2.dilate(m, k))


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(0, 2 ** 31 - 1))
def test_flood_fill_and_circle_match_cv2(h, w, seed):
    """``flood_fill`` from any seed of a 0/1 mask; filled circles of any
    radius, centred inside or outside the image."""
    g = np.random.default_rng(seed)
    m = (g.random((h, w)) < g.uniform(0.2, 0.8)).astype(np.uint8)
    sx, sy = int(g.integers(0, w)), int(g.integers(0, h))
    want = m.copy()
    cv2.floodFill(want, np.zeros((h + 2, w + 2), np.uint8), (sx, sy), 7)
    np.testing.assert_array_equal(cv_ops.flood_fill(m.copy(), (sx, sy), 7),
                                  want)
    want = np.zeros((h, w), np.uint8)
    got = want.copy()
    for _ in range(4):
        c = (int(g.integers(-10, w + 10)), int(g.integers(-10, h + 10)))
        r = int(g.integers(0, 30))
        cv2.circle(want, c, r, 1, -1)
        cv_ops.circle(got, c, r, 1)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- sidelines --

def curved_polygons(g, n, h, w):
    """``word_polygons`` with half of them curved (8 points)."""
    return word_polygons(g, n, h, w, curved=0.5)


@pytest.mark.parametrize('seed', range(3))
def test_sideline_geometry_matches_jax(seed):
    """Head / tail, the sidelines and their resampling, the centre line,
    the centre region and attribute maps, the text and effective masks."""
    g = np.random.default_rng(seed)
    h, w = 96, 128
    polys = curved_polygons(g, 8, h, w)
    for p in polys:
        for a, b in zip(sidelines.sideline_center(p), jsl.sideline_center(p)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sidelines.reorder_poly_edge(p),
                        jsl.reorder_poly_edge(p)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(sidelines.generate_center_mask_attrib_maps((h, w), polys),
                    jsl.generate_center_mask_attrib_maps((h, w), polys)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        sidelines.generate_center_region_mask((h, w), polys),
        jsl.generate_center_region_mask((h, w), polys))
    np.testing.assert_array_equal(
        sidelines.generate_text_region_mask((h, w), polys),
        jsl.generate_text_region_mask((h, w), polys))
    np.testing.assert_array_equal(
        sidelines.generate_effective_mask((h, w), polys[:2]),
        jsl.generate_effective_mask((h, w), polys[:2]))


@pytest.mark.parametrize('seed', range(2))
def test_postprocess_geometry_matches_jax(seed):
    """``fill_hole``, ``skeletonize`` (edges touched), ``centralize`` and
    ``merge_disks`` on masks with holes and random normals and radii."""
    g = np.random.default_rng(seed)
    for m in nested_masks(g, 8):
        m = (m > 0).astype(np.uint8)
        np.testing.assert_array_equal(sidelines.fill_hole(m),
                                      jsl.fill_hole(m))
        np.testing.assert_array_equal(sidelines.skeletonize(m),
                                      jsl.skeletonize(m))
        yx = np.argwhere(m)
        if not len(yx):
            continue
        n = len(yx)
        sin = g.normal(size=(n, 1)).astype(np.float32)
        cos = g.normal(size=(n, 1)).astype(np.float32)
        rad = np.abs(g.normal(3, 2, (n, 1))).astype(np.float32)
        rad[::7] = 0                        # frozen points
        np.testing.assert_array_equal(
            sidelines.centralize(yx, cos, -sin, rad, m),
            jsl.centralize(yx, cos, -sin, rad, m))
        disks = np.hstack([yx[:, ::-1], rad, g.random((n, 1))])
        np.testing.assert_array_equal(sidelines.merge_disks(disks, 0.03),
                                      jsl.merge_disks(disks, 0.03))


# ------------------------------------------------------------ targets --

@pytest.mark.parametrize('hw', [(64, 64), (96, 128), (160, 200)])
@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('kind', ['TextSnakeTargets', 'FCENetTargets'])
def test_fce_textsnake_targets_match_jax(kind, seed, hw):
    """Quads and curved polygons (some past the edges) and don't-care
    ones: every map bit for bit, in JAX's dtype."""
    g = np.random.default_rng(seed * 13 + hw[0])
    item = dict(img=np.zeros((*hw, 3)),
                gt_polygons=curved_polygons(g, int(g.integers(1, 9)), *hw),
                gt_polygons_ignore=word_polygons(g, 1, *hw))
    want = getattr(jt, kind)()(dict(item))
    got = getattr(targets, kind)()(dict(item))
    keys = [k for k in want if k.startswith(('gt_', 'p'))
            and k not in ('gt_polygons', 'gt_polygons_ignore')]
    assert len(keys) == (6 if kind == 'TextSnakeTargets' else 3)
    for k in keys:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fourier_signature_matches_jax():
    """The Fourier signature of quads and curved polygons, and its
    orientation (``clockwise``) on both directions of travel."""
    g = np.random.default_rng(5)
    mine, theirs = targets.FCENetTargets(), jt.FCENetTargets()
    for p in curved_polygons(g, 12, 200, 300):
        for q in (p, p[::-1]):
            np.testing.assert_array_equal(mine.cal_fourier_signature(q, 5),
                                          theirs.cal_fourier_signature(q, 5))


# ------------------------------------------------------------ modules --

def fce_pyramid(g, hw, chans, batch=2):
    """C3-C5 at the trunk's sizes."""
    return pyramid(g, hw, (1,) + tuple(chans), batch)[1:]


@pytest.mark.parametrize('hw', [(64, 64), (72, 100)])
def test_fpn_det_and_fce_head_match_flax(hw):
    feats = fce_pyramid(np.random.default_rng(1), hw, (16, 32, 64))
    jn = jfce.FPNDet(in_channels=(16, 32, 64), out_channels=8)
    vn = flax_variables(jn, feats)
    levels = jn.apply(vn, tuple(jnp.asarray(f) for f in feats))
    jh = jfce.FCEHead(in_channels=8)
    vh = jh.init(jax.random.PRNGKey(1), levels)
    want = jh.apply(vh, levels)
    tn = FPNDet((16, 32, 64), 8)
    sd = convert.convert_rules({k: {'neck': t} for k, t in vn.items()},
                               convert.fpn_det_rules(3))
    tn.load_state_dict({k[5:]: t for k, t in sd.items()}, strict=True)
    th = FCEHead(8)
    sd = convert.convert_rules({'params': {'head': vh['params']}},
                               convert.fcenet_rules(dict(
                                   backbone=R50, neck={}))[-2:])
    th.load_state_dict({k[5:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        lv = tn([nchw(f) for f in feats])
        got = th(lv)
    for a, b in zip(lv, levels):
        close(a.permute(0, 2, 3, 1), b, 1e-5)
    assert len(got) == 3
    for (c, r), (wc, wr) in zip(got, want):
        assert c.shape[1] == 4 and r.shape[1] == 22
        close(c.permute(0, 2, 3, 1), wc, 1e-5)
        close(r.permute(0, 2, 3, 1), wr, 1e-5)


def test_fpn_unet_and_textsnake_head_match_flax():
    feats = pyramid(np.random.default_rng(2), (64, 96), (16, 32, 64, 128))
    jn = jfce.FPN_UNet(in_channels=(16, 32, 64, 128), out_channels=4)
    vn = flax_variables(jn, feats)
    x = jn.apply(vn, tuple(jnp.asarray(f) for f in feats))
    jh = jfce.TextSnakeHead()
    vh = jh.init(jax.random.PRNGKey(1), x)
    want = jh.apply(vh, x)
    tn = FPN_UNet((16, 32, 64, 128), 4)
    sd = convert.convert_rules({k: {'neck': t} for k, t in vn.items()},
                               convert.fpn_unet_rules())
    tn.load_state_dict({k[5:]: t for k, t in sd.items()}, strict=True)
    th = TextSnakeHead(in_channels=4)
    sd = convert.convert_rules({'params': {'head': vh['params']}},
                               [('head.out_conv', 'head/out_conv', 'conv')])
    th.load_state_dict({k[5:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        y = tn([nchw(f) for f in feats])
        got = th(y)
    assert y.shape == (2, 4, 64, 96)
    close(y.permute(0, 2, 3, 1), x, 1e-5)
    close(got.permute(0, 2, 3, 1), want, 1e-5)


def images(hw, batch=2, seed=7):
    return np.random.default_rng(seed).random((batch, *hw, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def narrow(name, hw):
    """(config, variables, the outputs) of a narrow config on 2 images."""
    cfg = CFGS[name]
    jm = jax_build(cfg)
    x = images(hw)
    v = random_variables(jm, x[:1])
    out = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    return cfg, v, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize('name,hw', [('fce', (64, 64)), ('fce', (72, 100)),
                                     ('fce_dcn', (64, 64)),
                                     ('textsnake', (64, 96))])
def test_fce_textsnake_modules_match_flax(name, hw):
    cfg, v, want = narrow(name, hw)
    tm = build_detector_module(cfg)
    tm.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images(hw)))
    if name == 'textsnake':
        assert got.shape == want.shape == (2, *hw, 5)
        close(got, want, 1e-4)
        return
    assert len(got) == len(want) == 3
    for (c, r), (wc, wr) in zip(got, want):
        assert c.shape == wc.shape and r.shape == wr.shape
        close(c, wc, 1e-4)
        close(r, wr, 1e-4)


# -------------------------------------------------------------- losses --

def check_loss(jloss, tloss, preds, tgt, rtol=1e-5):
    """Each named loss within ``rtol`` and the gradient of their sum within
    1e-5 of its largest entry."""
    def total(p):
        out = jloss(p, {k: jnp.asarray(v) for k, v in tgt.items()})
        return sum(out.values()), out
    jp = jax.tree.map(jnp.asarray, preds)
    (_, j_out), j_grad = jax.value_and_grad(total, has_aux=True)(jp)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), preds)
    out = tloss(tp, {k: torch.from_numpy(v) for k, v in tgt.items()})
    sum(out.values()).backward()
    assert set(out) == set(j_out)
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(j_out[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    for t, g in zip(jax.tree.leaves(tp), jax.tree.leaves(j_grad)):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize('seed', range(3))
def test_fce_loss_and_gradients_match_jax(seed):
    """Three levels of a 128 x 160 page; seed 0 leaves the coarse levels
    without positives (the OHEM fallback of 100 negatives)."""
    g = np.random.default_rng(seed)
    hw = (128, 160)
    tg = [jt.FCENetTargets()(dict(
        img=np.zeros((*hw, 3)),
        gt_polygons=curved_polygons(g, 4, *hw) if seed else
        word_polygons(g, 3, 40, 40),
        gt_polygons_ignore=word_polygons(g, 1, *hw))) for _ in range(2)]
    tgt = {k: np.stack([t[k] for t in tg])
           for k in ('p3_maps', 'p4_maps', 'p5_maps')}
    preds = tuple((g.normal(0, 2, (2, h, w, 4)).astype(np.float32),
                   g.normal(0, 3, (2, h, w, 22)).astype(np.float32))
                  for h, w in ((16, 20), (8, 10), (4, 5)))
    if seed == 0:
        assert not tgt['p5_maps'][..., 0].any()
    check_loss(jfce.FCELoss(), FCELoss(), preds, tgt)


@pytest.mark.parametrize('seed', range(2))
def test_textsnake_loss_and_gradients_match_jax(seed):
    g = np.random.default_rng(seed)
    hw = (64, 80)
    tg = [jt.TextSnakeTargets()(dict(
        img=np.zeros((*hw, 3)), gt_polygons=curved_polygons(g, 4, *hw),
        gt_polygons_ignore=word_polygons(g, 1, *hw))) for _ in range(2)]
    keys = ('gt_text_mask', 'gt_center_region_mask', 'gt_mask',
            'gt_radius_map', 'gt_sin_map', 'gt_cos_map')
    tgt = {k: np.stack([t[k] for t in tg]) for k in keys}
    preds = g.normal(0, 2, (2, *hw, 5)).astype(np.float32)
    check_loss(jfce.TextSnakeLoss(), TextSnakeLoss(), preds, tgt)


# ------------------------------------------------------- postprocessing --

def test_fourier2poly_and_poly_nms_match_jax():
    g = np.random.default_rng(3)
    c = g.normal(0, 8, (20, 11)) + 1j * g.normal(0, 8, (20, 11))
    c[:, 5] += g.uniform(20, 80, 20) + 1j * g.uniform(20, 80, 20)
    want = jpp.fourier2poly(c, 50)
    got = postprocess.fourier2poly(c, 50)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # convex polygons keep poly_iou on its fast path
    boxes = [[x, y, x + w, y, x + w, y + h, x, y + h, s] for x, y, w, h, s in
             zip(*g.uniform(0, 40, (2, 30)), *g.uniform(5, 20, (2, 30)),
                 g.random(30))]
    assert postprocess.poly_nms(boxes, 0.1) == jpp.poly_nms(boxes, 0.1)


@pytest.mark.parametrize('seed,mode', [(0, 'poly'), (1, 'quad')])
def test_fce_postprocessor_matches_jax(seed, mode):
    """Trained-like maps of a page with two short words: the same
    boundaries ('poly' exactly, 'quad' within 1e-3 px)."""
    g = np.random.default_rng(seed + 30)
    maps = fce_like(g, (128, 160), curved_polygons(g, 2, 40, 56))
    kw = dict(text_repr_type=mode, alpha=1.2, beta=1.0)
    want = jpp.FCEPostprocessor(**kw)(maps)
    got = postprocess.FCEPostprocessor(**kw)(maps)
    if mode == 'poly':
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    else:
        same_boundaries(got, want)
    assert len(want) >= 1


@pytest.mark.parametrize('seed', range(3))
def test_textsnake_postprocessor_matches_jax(seed):
    g = np.random.default_rng(seed + 40)
    n = 0
    for hw in ((96, 128), (128, 96)):
        x = textsnake_like(g, hw, curved_polygons(g, 4, *hw))
        want = jpp.TextSnakePostprocessor()(x)
        got = postprocess.TextSnakePostprocessor()(x)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        n += len(want)
    assert n >= 4


# ------------------------------------------------------- entry points --

SIZE = (96, 128)


@pytest.fixture(scope='module')
def dets(tmp_path_factory):
    """For each narrow config: (config, JAX detector, the port's from a
    .pth of the same random weights (seed 3), the .pth)."""
    out = {}
    for name in ('fce', 'textsnake'):
        cfg = CFGS[name]
        jdet = JaxDetector(cfg, img_size=SIZE)
        v = random_variables(jdet.module,
                             np.zeros((1, *SIZE, 3), np.float32), seed=3)
        jdet.variables = v
        pth = str(tmp_path_factory.mktemp(name) / 'det.pth')
        torch.save({'meta': {}, 'state_dict': state_dict_from_jax(v, cfg)},
                   pth)
        det = init_detector(dict(model=cfg), pth, img_size=SIZE,
                            device='cpu')
        out[name] = (cfg, jdet, det, pth)
    return out


def pages(n, seed=0, size=SIZE):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (*size, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize('name', ['fce', 'textsnake'])
def test_detect_batch_and_init_detector_match_jax(dets, name):
    """``init_detector`` from a ``.pth``: the maps of three pages within
    1e-4 of JAX's, the boundaries of ``detect_batch`` JAX's, and the
    postprocessing of trained-like maps through ``TextDetector`` JAX's
    ``_post_single``, scaled back to a larger page."""
    cfg, jdet, det, pth = dets[name]
    assert det.downsample == 1.0 and not det.model.training
    imgs = pages(3, seed=5)
    x = np.stack([det.prep(i)[0] for i in imgs])
    want = jax.tree.map(np.asarray, jdet._jitted(jdet.variables,
                                                 jnp.asarray(x)))
    got = det.forward(x)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        close(a, b, 1e-4)
    same_boundaries(sum(det.detect_batch(imgs), []),
                    sum(jdet.detect_batch(imgs), []))
    g = np.random.default_rng(6)
    if name == 'fce':
        maps = [fce_like(g, SIZE, curved_polygons(g, 1, 32, 48))]
    else:
        maps = [textsnake_like(g, SIZE, curved_polygons(g, 3, *SIZE))]
    bounds = det.postprocess(maps, [(2.0, 1.5)])
    assert sum(len(b) for b in bounds) >= 1
    for b, m in zip(bounds, maps):
        want = jdet._post_single(m)
        for w in want:
            w[:-1:2] *= 2.0
            w[1:-1:2] *= 1.5
        same_boundaries(b, want, atol=0)


def test_build_detector_module_families():
    """Each family's module and its head's inputs: FCENet's neck on the
    last three levels, TextSnake's head on the neck's channels."""
    fce = build_detector_module(CFGS['fce'])
    assert fce.neck.in_channels == (64, 128, 256)
    ts = build_detector_module(CFGS['textsnake'])
    assert ts.head.out_conv.in_channels == 4
    # Mask R-CNN (which raised before its port) on the same FPNDet: its
    # RPN and RoI heads on the neck's channels, a fifth level from P5
    mask = build_detector_module(dict(
        type='OCRMaskRCNN', backbone=CFGS['fce']['backbone'],
        neck=dict(type='FPNDet', in_channels=[32, 64, 128, 256],
                  out_channels=8),
        rpn_head=dict(type='RPNHead', feat_channels=8)))
    assert mask.rpn_head.rpn_conv.in_channels == 8
    assert mask.roi_head.bbox_head.shared_fcs[0].in_features == 8 * 49
    assert mask.roi_head.mask_head.convs[0].conv.in_channels == 8
    with torch.no_grad():
        levels, rpn = mask(torch.zeros((1, 64, 64, 3)))
    assert [t.shape[-1] for t in levels] == [16, 8, 4, 2, 1]
    assert [r.shape[-1] for _, r in rpn] == [20] * 5


def ts_pages(n, seed):
    """``Pages`` at 64 x 96, TextSnake's sizes being multiples of 32."""
    return Pages(n, seed=seed, hw=(64, 96), words=(2, 5))


@pytest.mark.parametrize('name', ['fce', 'textsnake'])
def test_train_detector_matches_the_jax_loop(name):
    """Two epochs of four pages in batches of 2, Adam 1e-3 (JAX's default
    where a config names no optimizer): each epoch's last loss within 1e-4
    of JAX's loop on the same initial weights. Five pages are held in
    float64 (``test_torch_fce_textsnake_float64.py``): on one
    of their batches JAX's float32 gradients of the narrow FCENet are
    4.4% off the float64 ones on a parameter (the port's 1e-5), and its
    float32 loop parts from both by 1% within three steps."""
    cfg = dict(model=CFGS[name], total_epochs=2)
    ds = ts_pages(4, 2)
    _, want = jax_train(cfg, ds, batch_size=2, seed=1)
    model = jax_initial(name)[1]
    _, opt, hist = train_detector(cfg, ds, batch_size=2, seed=1,
                                  device='cpu', model=model)
    np.testing.assert_allclose([h['loss'] for h in hist], want, rtol=1e-4)
    assert opt.count == 4
    keys = ({'loss_text', 'loss_center', 'loss_reg_x', 'loss_reg_y'}
            if name == 'fce' else
            {'loss_text', 'loss_center', 'loss_radius', 'loss_sin',
             'loss_cos'})
    assert set(hist[0]) >= keys


def jax_initial(name):
    """(the variables JAX's ``train_detector`` starts from on seed 1, the
    port's model on them)."""
    v = jax.tree.map(np.asarray, jax_build(CFGS[name]).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    model = build_detector_module(CFGS[name])
    model.load_state_dict(state_dict_from_jax(v, CFGS[name]), strict=True)
    return v, model


@pytest.mark.parametrize('name', ['fce', 'textsnake'])
def test_train_detector_resume_repeats_the_run(name, tmp_path):
    """A run resumed from its epoch-1 ``.pth`` takes the uninterrupted
    run's batches and lrs (the shipped SGD schedule) and reaches its
    loss."""
    cfg = dict(model=CFGS[name], total_epochs=2, **SCHEDULE)
    ds = ts_pages(4, 3)
    _, opt, hist = train_detector(cfg, ds, work_dir=str(tmp_path),
                                  batch_size=2, seed=2, device='cpu')
    assert os.path.exists(tmp_path / 'epoch_1.pth')
    _, opt2, again = train_detector(
        cfg, ds, batch_size=2, seed=2, device='cpu',
        resume_from=str(tmp_path / 'epoch_1.pth'))
    assert [h['epoch'] for h in again] == [1]
    assert opt2.count == opt.count == 4
    assert again[-1]['lr'] == hist[-1]['lr']
    np.testing.assert_allclose(again[-1]['loss'], hist[-1]['loss'],
                               rtol=1e-6)


def write_config(tmp_path, cfg, ann, prefix, extra=''):
    path = str(tmp_path / 'toy.py')
    with open(path, 'w') as f:
        f.write(f'''model = {cfg!r}
det_img_size = {SIZE!r}
ds = dict(type='IcdarDataset', ann_file={ann!r}, img_prefix={prefix!r},
          img_size={SIZE!r})
data = dict(samples_per_gpu=2,
            train=dict(type='UniformConcatDataset', datasets=[ds]),
            test=dict(type='UniformConcatDataset', datasets=[ds]))
{extra}''')
    return path


def test_tools_test_and_train_on_an_fcenet_config(dets, tmp_path):
    """tools/test.py: the hmean-iou of the JAX detector's boundaries on
    the same weights; tools/train.py: an epoch, a checkpoint, finite
    losses."""
    from test_torch_detector import write_dataset
    cfg, jdet, _, pth = dets['fce']
    ann = write_dataset(str(tmp_path), [SIZE] * 3, seed=4)
    prefix = str(tmp_path / 'imgs')
    path = write_config(tmp_path, cfg, ann, prefix, 'total_epochs = 1\n')
    metrics = test_tool.main([path, pth, '--eval', 'hmean-iou'],
                             device='cpu')
    jds = JaxDataset(ann, img_prefix=prefix, img_size=SIZE, test_mode=True)
    preds = jdet.detect_batch([(jds[i]['img'] * 255).astype(np.uint8)
                               for i in range(3)])
    for k, v in jds.evaluate(preds, metric='hmean-iou').items():
        assert metrics[f'mean_{k}'] == v
    wd = str(tmp_path / 'wd')
    _, opt, hist = train_tool.main([path, '--work-dir', wd, '--load-from',
                                    pth], device='cpu')
    assert opt.count == 2 and np.isfinite(hist[-1]['loss'])
    assert os.path.exists(os.path.join(wd, 'epoch_1.pth'))


def test_readtext_with_an_fcenet_config_path(dets, tmp_path):
    """MMOCR with an FCENet config file and its ``.pth`` (no recognizer):
    each page's boundaries as ``TextDetector.detect`` gives them."""
    cfg, _, det, pth = dets['fce']
    path = str(tmp_path / 'fcenet_toy.py')
    with open(path, 'w') as f:
        f.write(f'model = {cfg!r}\n')
    ocr = MMOCR(det=path, det_ckpt=pth, recog=None, det_img_size=SIZE,
                device='cpu')
    imgs = pages(2, seed=8)
    res = ocr.readtext(imgs)
    assert len(res) == 2
    for img, r in zip(imgs, res):
        assert [b['box'] for b in r['result']] == [
            ocr._to_quad(b[:-1]) for b in det.detect(img)]
