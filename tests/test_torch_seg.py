"""The segmentation recognizer in the port against the JAX package on the
CPU: ``SegConvertor`` (the connected-component decode, against JAX's cv2
labelling, numbering included), ``cv_ops.fill_convex_poly`` and
``resize_inter_nearest`` against cv2, ``OCRSegTargets`` and ``OCRSegDataset``
items, ``Normalize`` and the seg test pipeline, ``FPNOCR`` / ``SegHead`` /
``SegLoss`` (eval and train mode, the running statistics), the full-width
``seg_r31_1by16_fpnocr_academic.py`` (logits, texts, loss, gradients), the
weight round trip, a training step and ``init_recognizer`` /
``model_inference``. Inputs are made from seeds with numpy."""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch_port_util import load_sub, perturb_batch_stats

import tps_pp_tpu.apis.seg as jax_seg_api
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.config import load_config as jax_load_config
from tps_pp_tpu.convertors.seg import SegConvertor as JaxSegConvertor
from tps_pp_tpu.datasets.ocr_seg_dataset import OCRSegDataset as JaxDataset
from tps_pp_tpu.datasets.pipelines.ocr_seg_targets import \
    OCRSegTargets as JaxTargets
from tps_pp_tpu.datasets.pipelines.transforms import Compose as JaxCompose
from tps_pp_tpu.models.recognizers import seg as jseg
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import (SegRecognizer, build_recognizer,
                                   init_recognizer, model_inference)
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.convertors import SegConvertor
from tps_pp_tpu_torch.convertors.seg import label_components
from tps_pp_tpu_torch.datasets import OCRSegDataset
from tps_pp_tpu_torch.datasets.pipelines import OCRSegTargets
from tps_pp_tpu_torch.datasets.pipelines.cv_ops import (fill_convex_poly,
                                                        resize_inter_nearest)
from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
from tps_pp_tpu_torch.models.recognizers.seg import FPNOCR, SegHead, SegLoss
from tps_pp_tpu_torch.parallel import build_optimizer, make_train_step
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_CFG = 'configs/textrecog/seg/seg_r31_1by16_fpnocr_academic.py'
# the same model (the base model config's stage4_pool_cfg) with the seg
# pipelines
SEG_TOY_CFG = 'configs/textrecog/seg/seg_r31_1by16_fpnocr_toy_dataset.py'
LC = dict(dict_type='DICT36', with_unknown=True, lower=True)


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run, as every test
    module has them, set here and not at import (ROADMAP queue 3: torch's
    oneDNN corrupts the heap at 3 or more in a channels-last conv
    backward), and the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ convertor --

def _block_map(seed, n=2, h=24, w=64, c=38, p_bg=0.55):
    """Seeded (n, h, w, c) logits whose argmax is a blocky class map:
    classes drawn on a grid of 2-6 px cells, background where a cell draws
    it, `<UKN>` among the classes; components of 1 to a few hundred px."""
    g = np.random.default_rng(seed)
    out = g.normal(0, 0.1, (n, h, w, c)).astype(np.float32)
    for b in range(n):
        ch, cw = int(g.integers(2, 7)), int(g.integers(2, 7))
        cells = g.integers(1, c, (h // ch + 1, w // cw + 1))
        cells[g.random(cells.shape) < p_bg] = 0
        cls = np.kron(cells, np.ones((ch, cw), np.int64))[:h, :w]
        np.put_along_axis(out[b], cls[..., None], 5.0, axis=-1)
    return out


@pytest.mark.parametrize('seed', range(6))
def test_seg_convertor_matches_jax(seed):
    """Texts and scores equal to JAX's cv2 decode, with valid ratios
    cutting the columns, `<UKN>` components, components under 20 px."""
    logits = _block_map(seed, p_bg=(0.3, 0.55, 0.8)[seed % 3])
    metas = [{'valid_ratio': r} for r in (1.0, 0.37 + 0.1 * seed)]
    kw = LC if seed % 2 else dict(LC, with_unknown=False)
    jc, pc = JaxSegConvertor(**kw), SegConvertor(**kw)
    assert pc.idx2char == jc.idx2char and pc.unknown_idx == jc.unknown_idx
    want = jc.tensor2str(logits[..., :len(jc.idx2char)], metas)
    got = pc.tensor2str(torch.from_numpy(logits[..., :len(pc.idx2char)]),
                        metas)
    assert got == want
    if seed % 3 != 2:       # sparse maps: isolated cells under 20 px
        assert any(want[0])


def test_seg_convertor_numbers_components_as_cv2():
    """Two components whose centroids tie in x (28.5): B's first pixel
    comes first in a raster scan ((4, 32) against A's (5, 28)), A's first
    2 x 2 block first in cv2's block scan (block column 14 against 16), so
    cv2 numbers A first and the stable sort keeps A before B. The port
    gives JAX's text."""
    h, w, c = 48, 64, 38
    cls = np.zeros((h, w), np.int64)
    cls[5:31, 28:30] = 11                 # A: 'a', 52 px
    cls[4:46, 32:34] = 12                 # B: 'b', a bar and a foot
    cls[46:48, 10:34] = 12                # reaching left, 132 px
    assert np.nonzero(cls == 11)[1].mean() == \
        np.nonzero(cls == 12)[1].mean() == 28.5
    logits = np.zeros((1, h, w, c), np.float32)
    np.put_along_axis(logits[0], cls[..., None], 1.0, axis=-1)
    want = JaxSegConvertor(**LC).tensor2str(logits)
    got = SegConvertor(**LC).tensor2str(logits)
    assert got == want and want[0] == ['ab']
    n, lab, _, _ = label_components(cls != 0)
    assert n == 3 and lab[5, 28] == 1 and lab[4, 32] == 2


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 40), st.integers(1, 90), st.floats(0.05, 0.7),
       st.integers(0, 2 ** 31 - 1))
def test_label_components_match_cv2(h, w, p, seed):
    """Labels, areas and centroid x of every component (the background's
    too, where it has a pixel) equal to ``cv2.connectedComponentsWithStats``
    (8-connectivity), numbering included."""
    mask = np.random.default_rng(seed).random((h, w)) < p
    n, lab, areas, cx = label_components(mask)
    wn, wlab, stats, cents = cv2.connectedComponentsWithStats(
        mask.astype(np.uint8) * 255)
    assert n == wn
    np.testing.assert_array_equal(lab, wlab)
    np.testing.assert_array_equal(areas, stats[:, cv2.CC_STAT_AREA])
    some = areas > 0          # cv2's centroid of no pixel is NaN
    np.testing.assert_allclose(cx[some], cents[some, 0], rtol=0, atol=1e-12)


# -------------------------------------------------- cv2-free image ops --

def _poly(draw, w, h):
    kind = draw(st.sampled_from(['rect', 'quad', 'convex', 'collinear']))
    coord = st.integers(-8, max(w, h) + 8)
    if kind == 'rect':
        x0, x1 = sorted([draw(coord), draw(coord)])
        y0, y1 = sorted([draw(coord), draw(coord)])
        return [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]
    if kind == 'quad':
        return [[draw(coord), draw(coord)] for _ in range(4)]
    if kind == 'convex':
        cx, cy = draw(st.integers(0, w)), draw(st.integers(0, h))
        ang = sorted(draw(st.floats(0, 6.28)) for _ in range(4))
        r = [draw(st.floats(0, 20)) for _ in range(4)]
        return [[round(cx + ri * np.cos(a)), round(cy + ri * np.sin(a))]
                for a, ri in zip(ang, r)]
    x, y = draw(coord), draw(coord)            # three collinear corners
    dx, dy = draw(st.integers(-6, 6)), draw(st.integers(-6, 6))
    return [[x, y], [x + dx, y + dy], [x + 2 * dx, y + 2 * dy],
            [draw(coord), draw(coord)]]


@st.composite
def _poly_case(draw):
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 80))
    return h, w, _poly(draw, w, h)


@settings(max_examples=400, deadline=None)
@given(_poly_case(), st.integers(1, 254))
def test_fill_convex_poly_matches_cv2(case, value):
    """The pixels of ``cv2.fillConvexPoly`` on an int32 map (integer
    corners, shift 0, LINE_8), exactly: rects, any quads, convex quads,
    zero widths and three collinear corners, ends outside the map."""
    h, w, pts = case
    pts = np.asarray(pts, np.int32)
    want = np.full((h, w), 255, np.int32)
    want[:, : w // 2] = 0
    got = want.copy()
    cv2.fillConvexPoly(want, pts, value)
    assert fill_convex_poly(got, pts, value) is got
    np.testing.assert_array_equal(got, want)


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 70), st.integers(1, 300), st.integers(1, 70),
       st.integers(1, 300))
def test_resize_inter_nearest_matches_cv2(h, w, oh, ow):
    a = np.arange(h * w, dtype=np.int32).reshape(h, w)
    np.testing.assert_array_equal(
        resize_inter_nearest(a, ow, oh),
        cv2.resize(a, (ow, oh), interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------- targets, dataset --

def _ann(seed, n_chars, box_type, H0, W0):
    g = np.random.default_rng(seed)
    chars = list(g.choice(list('abcdefghij0123456789XY#'), n_chars))
    rects, quads = [], []
    for i in range(n_chars):
        x0 = float(g.uniform(-2, W0 - 4))
        y0 = float(g.uniform(-2, H0 / 2))
        x1, y1 = x0 + float(g.uniform(0, 30)), y0 + float(g.uniform(0, H0))
        rects.append([x0, y0, x1, y1])
        j = g.uniform(-4, 4, 8)
        quads.append([x0 + j[0], y0 + j[1], x1 + j[2], y0 + j[3],
                      x1 + j[4], y1 + j[5], x0 + j[6], y1 + j[7]])
    return dict(chars=chars, char_rects=rects, char_quads=quads)


@pytest.mark.parametrize('box_type', ['char_rects', 'char_quads'])
@pytest.mark.parametrize('seed', range(3))
def test_ocr_seg_targets_match_jax(box_type, seed):
    H0, W0 = 40 + 7 * seed, 150 + 31 * seed
    results = dict(pre_resize_shape=(H0, W0), resize_shape=(64, 200 + seed),
                   pad_shape=(64, 256), img_shape=(64, 256),
                   ann_info=_ann(seed, 6 + seed, box_type, H0, W0))
    kw = dict(label_convertor=dict(type='SegConvertor', **LC),
              box_type=box_type)
    want = JaxTargets(**kw)(dict(results))
    got = OCRSegTargets(**kw)(dict(results))
    for k in ('gt_attn', 'gt_seg', 'gt_mask'):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(np.unique(got['gt_seg'])) > 3
    for a, b in zip(got['gt_kernels'], want['gt_kernels']):
        np.testing.assert_array_equal(a, b)


def _write_seg_set(tmp_path, n=4):
    """Seeded BGR crops written as PNG and a JSON-lines annotation file
    (rects, xywh rects, quads; one line without annotations), as
    ``tests/test_textdet.py`` writes its seg set."""
    g = np.random.default_rng(3)
    lines = []
    for i in range(n):
        h, w = int(g.integers(20, 90)), int(g.integers(30, 400))
        img = g.integers(0, 256, (h, w, 3), np.uint8)
        cv2.putText(img, 'ab', (2, h - 4), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 1)
        cv2.imwrite(str(tmp_path / f'{i}.png'), img)
        anns = []
        for k in range(int(g.integers(2, 6))):
            x0, y0 = float(g.uniform(0, w - 10)), float(g.uniform(0, h / 2))
            bw, bh = float(g.uniform(2, 20)), float(g.uniform(4, h / 2))
            box = ([x0, y0, x0 + bw, y0 + bh] if k % 3 == 0 else
                   [x0, y0, bw, bh] if k % 3 == 1 else
                   [x0, y0, x0 + bw, y0 + 1, x0 + bw + 2, y0 + bh,
                    x0 - 1, y0 + bh - 1])
            ann = dict(char_box=box, char_text='abc7'[k % 4])
            if k % 3 == 1:
                ann['char_box_type'] = 'xywh'
            anns.append(ann)
        line = dict(file_name=f'{i}.png', annotations=anns)
        if i == n - 1:
            line = dict(file_name=f'{i}.png', text='Zq')
        lines.append(json.dumps(line))
    ann_file = tmp_path / 'seg.jsonl'
    ann_file.write_text('\n'.join(lines) + '\n')
    return str(ann_file)


@pytest.mark.parametrize('ratio,box_type', [(0.5, 'char_rects'),
                                            (1.0, 'char_quads')])
def test_ocr_seg_dataset_items_match_jax(tmp_path, ratio, box_type):
    """Each item against JAX's: the image within one grey level (the
    port's resize is ``cv_ops.resize_u8``), the int32 kernels, metas and
    text equal; ``evaluate`` equal."""
    ann = _write_seg_set(tmp_path)
    kw = dict(img_prefix=str(tmp_path), img_size=(64, 256),
              label_convertor=dict(type='SegConvertor', **LC),
              seg_downsample_ratio=ratio, box_type=box_type)
    jds, pds = JaxDataset(ann, **kw), OCRSegDataset(ann, **kw)
    assert len(jds) == len(pds) == 4
    for i in range(len(pds)):
        want, got = jds[i], pds[i]
        assert sorted(got) == sorted(want)
        assert got['text'] == want['text'] and \
            got['img_metas'] == want['img_metas']
        assert got['img'].dtype == np.float32
        np.testing.assert_allclose(got['img'], want['img'], rtol=0,
                                   atol=1.0 / 255 + 1e-7)
        for k in ('gt_seg', 'gt_attn', 'gt_mask'):
            if k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 'gt_seg' in pds[0] and 'gt_seg' not in pds[3]
    results = [{'text': t} for t in ('ab', 'bc', 'x', 'zq')]
    assert pds.evaluate(results) == jds.evaluate(results)
    test_ds = OCRSegDataset(ann, test_mode=True, **kw)
    assert 'gt_seg' not in test_ds[0]


def test_seg_test_pipeline_matches_jax():
    """The seg config's test pipeline (``Normalize`` with 0-255 stats and
    the BGR -> RGB flip, ``DefaultFormatBundle``) on decoded crops."""
    steps = [dict(t) for t in load_config(SEG_TOY_CFG)['test_pipeline']]
    steps[0] = dict(type='LoadImageFromNdarray')
    g = np.random.default_rng(0)
    for _ in range(3):
        crop = g.integers(0, 256, (int(g.integers(16, 80)),
                                   int(g.integers(20, 300)), 3), np.uint8)
        res = dict(img=crop, img_info=dict(filename=None))
        want = JaxCompose([dict(s) for s in steps])(dict(res))
        got = Compose([dict(s) for s in steps])(dict(res))
        assert got['img_metas'] == want['img_metas']
        assert got['img'].shape[0] == 64
        np.testing.assert_allclose(got['img'], want['img'], rtol=0,
                                   atol=2e-2 + 1e-6)


# --------------------------------------------- neck, head, loss modules --

def _feats(n=2, widths=(8, 16, 32, 32), seed=0):
    return [randn(n, 16 // 2 ** i, 32 // 2 ** i, c, seed=seed + i)
            for i, c in enumerate(widths)]


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('last_stage_only', [True, False])
def test_fpnocr_matches_jax(train, last_stage_only):
    """Outputs within 1e-5 of their magnitude; in train mode also the
    running statistics. The top-down 2x upsample is torch's
    ``align_corners=False`` bilinear against ``jax.image.resize``: their
    edge rows agree (JAX renormalises the taps, torch clamps the index)."""
    feats = _feats()
    jm = jseg.FPNOCR(in_channels=(8, 16, 32, 32), out_channels=16,
                     last_stage_only=last_stage_only)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(0),
                                    [jnp.asarray(f) for f in feats]), 1)
    want, state = jm.apply(jax.tree.map(jnp.asarray, v),
                           [jnp.asarray(f) for f in feats], train=train,
                           mutable=['batch_stats'])
    m = FPNOCR((8, 16, 32, 32), 16, last_stage_only)
    load_sub(m, v, convert.seg_rules(), 'neck', 'neck').train(train)
    got = m([torch.from_numpy(f) for f in feats])
    assert len(got) == len(want) == (1 if last_stage_only else 3)
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert tuple(g_.shape) == w_.shape
        np.testing.assert_allclose(g_.detach().numpy(), w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())
    if train:
        sd = state_dict_from_jax_sub(state, 'neck')
        for k, t in m.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(t.numpy(), sd[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def state_dict_from_jax_sub(state, prefix):
    """The running statistics of a JAX state subtree as port names."""
    flat = {}
    rules = [r for r in convert.seg_rules() if r[1].startswith(prefix)]
    for tp, fp, kind in rules:
        if kind != 'bn':
            continue
        node = state['batch_stats']
        for part in fp.split('/')[1:]:
            node = node[part]
        t = tp[len(prefix) + 1:]
        flat[f'{t}.running_mean'] = np.asarray(node['mean'])
        flat[f'{t}.running_var'] = np.asarray(node['var'])
    return flat


def test_fpnocr_upsample_edges_match_jax_resize():
    """The 2x bilinear upsample alone: torch's edge rows and columns are
    JAX's, all within 1e-6."""
    x = randn(2, 3, 5, 4, seed=3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 6, 10, 4),
                                       'bilinear'))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode='bilinear', align_corners=False).permute(0, 2, 3, 1).numpy()
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[sl], want[sl], atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize('up', [dict(upsample=2.0),
                                dict(upsample_param=dict(scale_factor=2.0,
                                                         mode='nearest')),
                                dict(upsample_param=dict(scale_factor=1.5,
                                                         mode='nearest')),
                                dict(upsample_param=dict(scale_factor=2.0,
                                                         mode='bilinear')),
                                dict(upsample=None)])
@pytest.mark.parametrize('train', [False, True])
def test_seg_head_matches_jax(up, train):
    x = randn(2, 6, 10, 16, seed=5)
    jm = jseg.SegHead(in_channels=16, num_classes=9, **up)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(1),
                                    [jnp.asarray(x)]), 2)
    want, _ = jm.apply(jax.tree.map(jnp.asarray, v), [jnp.asarray(x)],
                       train=train, mutable=['batch_stats'])
    want = np.asarray(want)
    m = load_sub(SegHead(16, 9, **up), v, convert.seg_rules(), 'head',
                 'head').train(train)
    got = m([torch.from_numpy(x)]).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('n_ignore', [0, 40, 10 ** 6])
def test_seg_loss_matches_jax(weighted, n_ignore):
    """Ignored pixels (255) out, targets past the classes clipped, the
    positive weight; an all-ignored map gives 0 in both."""
    g = np.random.default_rng(n_ignore)
    logits = randn(2, 8, 12, 7, seed=1) * 3
    gt = g.integers(0, 7, (2, 8, 12)).astype(np.int32)
    gt[g.random(gt.shape) < 0.4] = 0
    flat = gt.reshape(-1)
    flat[g.permutation(flat.size)[:min(n_ignore, flat.size)]] = 255
    flat[3] = 9 if n_ignore < 10 ** 6 else 255         # clipped to 6
    kw = dict(seg_with_loss_weight=weighted)
    want = jseg.SegLoss(**kw)(jnp.asarray(logits), jnp.asarray(gt))
    got = SegLoss(**kw)(torch.from_numpy(logits), torch.from_numpy(gt))
    np.testing.assert_allclose(float(got['loss_seg']),
                               float(want['loss_seg']), rtol=1e-6,
                               atol=1e-7)


# ----------------------------------------------- the full-width config --

@pytest.fixture(scope='module')
def full():
    """The config at full width in both packages (the JAX variables with
    perturbed BatchNorm statistics carried into the port), B=2 64 x 256
    crops, a target map, and JAX's logits, texts, loss and gradients."""
    cfg = dict(load_config(SEG_CFG)['model'])
    assert cfg == dict(jax_load_config(SEG_CFG)['model'])
    jrec = build_jax(cfg)
    v = jax.jit(lambda k: jrec.init_variables(k, (1, 64, 256, 3)))(
        jax.random.PRNGKey(7))
    v = perturb_batch_stats(v, 7)
    jv = jax.tree.map(jnp.asarray, v)
    img = randn(2, 64, 256, 3, seed=8)
    vr = np.array([1.0, 0.6], np.float32)
    logits = np.asarray(jrec.predict(jv, jnp.asarray(img)))
    texts = jrec.simple_test(jv, jnp.asarray(img), vr)
    cls = np.kron(np.random.default_rng(9).integers(0, 38, (2, 8, 32)),
                  np.ones((1, 8, 8), np.int64))
    cls[:, :, 100:] = 0
    cls[1, :, 200:] = 255
    batch = dict(img=img, gt_seg=cls.astype(np.int32))

    def loss_fn(params):
        total, (_, state) = jrec.compute_loss(dict(jv, params=params),
                                              jax.tree.map(jnp.asarray,
                                                           batch))
        return total, state
    (loss, state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jv['params'])
    gsd = state_dict_from_jax(jax.tree.map(np.asarray, dict(
        params=grads, batch_stats=state['batch_stats'])), cfg)
    return dict(cfg=cfg, v=v, img=img, vr=vr, logits=logits, texts=texts,
                batch=batch, loss=float(loss), grads=gsd)


def _port(full, **over):
    rec = build_recognizer(dict(full['cfg'], **over), device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(full['v'], full['cfg']),
                              strict=True)
    return rec


def test_full_width_seg_logits_and_texts_match_jax(full):
    rec = _port(full)
    assert isinstance(rec, SegRecognizer)
    assert rec.resolved_decode_mode() == 'single_pass'
    assert sum(p.numel() for p in rec.model.parameters()) == 47_655_462
    got = rec.predict(full['img'])
    want = full['logits']
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (2, 64, 256, 38)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    res = rec.simple_test(full['img'], full['vr'])
    assert [r['text'] for r in res] == [r['text'] for r in full['texts']]
    for g_, w_ in zip(res, full['texts']):
        np.testing.assert_allclose(g_['score'], w_['score'], rtol=0,
                                   atol=1e-6)
    assert not rec.model.training


def test_full_width_seg_loss_and_gradients_match_jax(full):
    """``compute_loss`` in train mode: the loss within 1e-5 (relative) of
    JAX's and the running statistics within 1e-5. Gradients: every
    parameter's cosine against JAX's at least 0.9995, and against the
    port's float64 gradients at least 0.9999 or as close as JAX's float32
    ones are (1 - cos at most 3x theirs). Not 0.9999 against JAX: through
    28 train-mode BatchNorms at B=2 both float32 frameworks part from the
    float64 gradients by 1 - cos of 1e-4 to 3e-4 (measured: JAX
    0.99972-0.99999, the port 0.99980-0.99999), each in its own sums;
    ``test_small_seg_float64_gradients_match_jax`` holds the arithmetic
    to JAX's in float64. The conv biases before a train-mode BatchNorm
    have no gradient (1e-16 in float64, rounding in float32)."""
    r64 = _port(full, dtype='float64')
    t64, _ = r64.compute_loss(full['batch'])
    t64.backward()
    ref = {n: p.grad.flatten() for n, p in r64.model.named_parameters()}
    top = max(float(g.norm()) for g in ref.values())
    rec = _port(full)
    total, losses = rec.compute_loss(full['batch'])
    assert set(losses) == {'loss_seg'}
    assert abs(float(total.detach()) - full['loss']) <= \
        1e-5 * abs(full['loss'])
    total.backward()

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))
    n_held = 0
    for n, p in rec.model.named_parameters():
        a, b = p.grad.double().flatten(), full['grads'][n].double().flatten()
        if float(ref[n].norm()) <= 1e-9 * top:
            assert float(a.norm()) <= 1e-5 * top, n
            continue
        assert cos(a, b) >= 0.9995, (n, cos(a, b))
        mine, theirs = 1 - cos(a, ref[n]), 1 - cos(b, ref[n])
        assert mine <= max(1e-4, 3 * theirs), (n, mine, theirs)
        n_held += 1
    assert n_held > 100
    for n, t in rec.model.state_dict().items():
        if n.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(t.numpy(), full['grads'][n].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)


def test_seg_loss_resizes_the_target_to_the_head(full):
    """A target at half the head's size is resized by the nearest rule of
    ``jax.image.resize`` (as JAX's ``compute_loss``): the loss equals the
    loss of the target upsampled by hand."""
    rec = _port(full)
    small = full['batch']['gt_seg'][:, ::2, ::2]
    a, _ = rec.compute_loss(dict(full['batch'], gt_seg=small), train=False)
    up = np.repeat(np.repeat(small, 2, axis=1), 2, axis=2)
    b, _ = rec.compute_loss(dict(full['batch'], gt_seg=up), train=False)
    assert float(a.detach()) == float(b.detach())


def test_seg_weights_round_trip_bit_for_bit():
    """``state_dict_from_jax`` of random variables loads strictly, and the
    JAX converter, given the port's rules (JAX has no seg table), gives
    the variables back bit for bit."""
    cfg = dict(load_config(SEG_CFG)['model'])
    jrec = build_jax(cfg)
    shapes = jax.eval_shape(lambda: jrec.init_variables(
        jax.random.PRNGKey(0), (1, 64, 256, 3)))
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                     shapes)
    sd = state_dict_from_jax(v, cfg)
    build_recognizer(cfg, device='cpu').model.load_state_dict(sd,
                                                              strict=True)
    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = jtc.filter_rules_to_state(convert.rules_for_config(cfg), sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


# ------------------------------------------- training and inference API --

SMALL = dict(
    type='SegRecognizer',
    backbone=dict(type='ResNet31OCR', layers=[1, 1, 1, 1],
                  channels=[8, 8, 8, 16, 16, 16], out_indices=[0, 1, 2, 3],
                  stage4_pool=(2, 2), last_stage_pool=True),
    neck=dict(type='FPNOCR', in_channels=[8, 16, 16, 16], out_channels=8),
    head=dict(type='SegHead', in_channels=8, upsample=2.0),
    loss=dict(type='SegLoss', seg_downsample_ratio=1.0),
    label_convertor=dict(type='SegConvertor', **LC))


def test_small_seg_float64_gradients_match_jax():
    """A small seg model in float64 on both sides (JAX under
    ``jax.enable_x64``, its recognizer given a 'float64' dtype for the
    call), train mode, B=2 32 x 64: the loss within 1e-12 and every
    gradient and running statistic within 1e-9 of the largest."""
    cfg = dict(SMALL, dtype='float64')
    img = randn(2, 32, 64, 3, seed=11).astype(np.float64)
    gt = np.kron(np.random.default_rng(12).integers(0, 38, (2, 4, 8)),
                 np.ones((1, 8, 8), np.int64)).astype(np.int32)
    gt[0, :, 40:] = 255
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setitem(jax_seg_api._DTYPES, 'float64', jnp.float64)
        jrec = build_jax(cfg)
        v = perturb_batch_stats(jax.jit(lambda k: jrec.init_variables(
            k, (1, 32, 64, 3)))(jax.random.PRNGKey(0)), 0)
        v = jax.tree.map(lambda a: a.astype(np.float64), v)
        jv = jax.tree.map(jnp.asarray, v)

        def loss_fn(params):
            total, (_, state) = jrec.compute_loss(
                dict(jv, params=params),
                dict(img=jnp.asarray(img), gt_seg=jnp.asarray(gt)))
            return total, state
        (loss, state), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jv['params'])
        want = state_dict_from_jax(jax.tree.map(np.asarray, dict(
            params=grads, batch_stats=state['batch_stats'])), cfg)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    total, _ = rec.compute_loss(dict(img=img, gt_seg=gt))
    assert abs(float(total.detach()) - float(loss)) <= 1e-12
    total.backward()
    top = max(float(t.abs().max()) for t in want.values())
    for n, p in rec.model.named_parameters():
        assert p.grad.dtype == torch.float64
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-9 * top, err_msg=n)
    for n, t in rec.model.state_dict().items():
        if n.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(t.numpy(), want[n].numpy(),
                                       rtol=1e-12, atol=1e-12, err_msg=n)


def test_small_seg_trains_on_the_dataset(tmp_path):
    """``OCRSegDataset`` items through ``make_train_step`` (Adam): losses
    finite and falling over a few steps on one batch, the BatchNorm
    statistics updated; bf16 compute with float32 parameters runs."""
    ann = _write_seg_set(tmp_path)
    ds = OCRSegDataset(ann, img_prefix=str(tmp_path), img_size=(32, 64),
                       seg_downsample_ratio=1.0)
    items = [ds[i] for i in range(3)]
    batch = dict(img=np.stack([it['img'] for it in items]),
                 gt_seg=np.stack([it['gt_seg'] for it in items]))
    for dtype in ('float32', 'bfloat16'):
        rec = build_recognizer(dict(SMALL, dtype=dtype), device='cpu',
                               param_dtype='float32').init_weights(0)
        opt, _ = build_optimizer(dict(type='Adam', lr=1e-2),
                                 rec.model.named_parameters())
        step = make_train_step(rec, opt)
        losses = [float(step(batch)['loss']) for _ in range(4)]
        assert all(np.isfinite(losses))
        if dtype == 'float32':
            assert losses[-1] < losses[0]
    bn = rec.model.neck.lateral_convs[0].bn
    assert int(bn.num_batches_tracked) == 4
    assert tuple(rec.predict(batch['img']).shape) == (3, 32, 64, 38)


def test_init_recognizer_and_model_inference_on_the_seg_config(tmp_path,
                                                                full):
    """A ``.pth`` of the full config's JAX weights (mmcv's wrapper,
    ``module.`` prefixes) into ``init_recognizer`` with the toy config's
    file (the same model, and the seg test pipeline),
    then ``model_inference`` on uint8 crops through the config's test
    pipeline (one crop a batch: the widths differ): each text is JAX's
    ``simple_test`` on JAX's pipeline output, whose logits the port's
    ``predict`` matches within 1e-5 of their magnitude."""
    cfg, v = full['cfg'], full['v']
    jrec, jv = build_jax(cfg), jax.tree.map(jnp.asarray, v)
    pth = tmp_path / 'seg.pth'
    torch.save({'meta': {}, 'state_dict': {
        f'module.{k}': t for k, t in state_dict_from_jax(v, cfg).items()}},
        pth)
    rec = init_recognizer(os.path.join(REPO, SEG_TOY_CFG), str(pth),
                          device='cpu')
    g = np.random.default_rng(4)
    crops = [g.integers(0, 256, (int(g.integers(20, 60)),
                                 int(g.integers(30, 150)), 3), np.uint8)
             for _ in range(2)]
    got = model_inference(rec, crops)
    steps = [dict(t) for t in rec.test_pipeline_cfg]
    steps[0] = dict(type='LoadImageFromNdarray')
    pipe = JaxCompose(steps)
    for crop, res in zip(crops, got):
        d = pipe(dict(img=crop, img_info=dict(filename=None)))
        x = d['img'][None].astype(np.float32)
        want = jrec.simple_test(jv, jnp.asarray(x),
                                img_metas=[d['img_metas']])
        assert res['text'] == want[0]['text']
        lj = np.asarray(jrec.predict(jv, jnp.asarray(x)))
        np.testing.assert_allclose(rec.predict(x).numpy(), lj, rtol=0,
                                   atol=1e-5 * np.abs(lj).max())
