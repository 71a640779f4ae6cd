"""PANet and PSENet in the port against the JAX package on the CPU: the
necks (``FPEM_FFM``, ``FPNF``), the head and the whole module at narrow
widths (64 x 64, and 72 x 100, where the resizes have no integer ratio),
``PANetTargets`` / ``PSENetTargets`` exact, ``PANLoss`` (under and over
its 24 instances) and ``PSELoss`` (``'adaptive'`` and ``'hard'``) with
their gradients against ``jax.value_and_grad``, ``contour_expand`` and
``pixel_group`` against the JAX package's native C++ library,
``connected_components`` and the kernel outlines against cv2, the
postprocessors' boundaries against JAX's, ``init_detector`` from a
``.pth``, ``detect_batch``, ``MMOCR.readtext`` and ``tools/test.py`` on
small PAN / PSE configs, and PANet's ``train_detector`` against JAX's
loop. Inputs and weights are made from seeds with numpy; the shipped
configs at full width are ``test_torch_panet_full.py``."""
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_det_train import Pages, word_polygons
from test_torch_textdet import close, random_variables
from torch_port_util import perturb_batch_stats

from tps_pp_tpu import native
from tps_pp_tpu.apis.detector import TextDetector as JaxDetector
from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.apis.train_det import train_detector as jax_train
from tps_pp_tpu.datasets.textdet_dataset import TextDetDataset as JaxDataset
from tps_pp_tpu.models.textdet import pan as jpan
from tps_pp_tpu.models.textdet import postprocess as jpp
from tps_pp_tpu.models.textdet import targets as jt

from tps_pp_tpu_torch.apis import MMOCR, TextDetector, init_detector
from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.models.textdet import (FPEM_FFM, FPNF, PANHead,
                                             PANLoss, PSELoss, pixel_ops,
                                             postprocess, targets)
from tps_pp_tpu_torch.models.textdet.pan import _ohem_mask
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

SIZES = [(64, 64), (72, 100)]
R18 = dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1], base_channels=8)
R50 = dict(type='ResNetDet50', stage_blocks=[1, 1, 1, 1], base_channels=8)
CFGS = {
    'pan': dict(type='PANet', backbone=R18,
                neck=dict(type='FPEM_FFM', in_channels=[8, 16, 32, 64],
                          conv_out=8),
                head=dict(type='PANHead', out_channels=6),
                loss=dict(type='PANLoss'),
                postprocessor=dict(type='PANPostprocessor',
                                   text_repr_type='quad'),
                targets=dict(type='PANetTargets', shrink_ratio=(1.0, 0.5))),
    'pse': dict(type='PSENet', backbone=R50,
                neck=dict(type='FPNF', in_channels=[32, 64, 128, 256],
                          out_channels=8),
                head=dict(type='PSEHead', out_channels=7),
                loss=dict(type='PSELoss'),
                postprocessor=dict(type='PSEPostprocessor',
                                   text_repr_type='poly'),
                targets=dict(type='PSENetTargets')),
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


def images(hw, batch=2, seed=7):
    return np.random.default_rng(seed).random((batch, *hw, 3)).astype(
        np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def pyramid(g, hw, chans, batch=2):
    """C2-C5 at the trunk's sizes (ceil halvings of H / 4, W / 4)."""
    h, w = -(-hw[0] // 4), -(-hw[1] // 4)
    out = []
    for c in chans:
        out.append(g.standard_normal((batch, h, w, c)).astype(np.float32))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def flax_variables(neck, feats):
    """A neck's init on the tuple of levels, its BatchNorm moved off its
    init."""
    v = neck.init(jax.random.PRNGKey(0), tuple(jnp.asarray(f)
                                               for f in feats))
    return perturb_batch_stats(v, 1)


def load_neck(module, variables, rules):
    sd = convert.convert_rules({k: {'neck': t} for k, t in
                                variables.items()}, rules)
    module.load_state_dict({k[len('neck.'):]: t for k, t in sd.items()},
                           strict=True)
    return module.eval()


# ------------------------------------------------------------ modules --

@pytest.mark.parametrize('hw', SIZES)
def test_fpem_ffm_matches_flax(hw):
    feats = pyramid(np.random.default_rng(1), hw, (8, 16, 32, 64))
    jm = jpan.FPEM_FFM(in_channels=(8, 16, 32, 64), conv_out=8)
    v = flax_variables(jm, feats)
    want = jm.apply(v, tuple(jnp.asarray(f) for f in feats))
    tm = load_neck(FPEM_FFM((8, 16, 32, 64), 8), v,
                   convert.fpem_ffm_rules())
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert len(got) == 4 and tm.out_channels == 32
    for a, b in zip(got, want):
        close(a.permute(0, 2, 3, 1), b, 1e-5)


@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('fusion', ['concat', 'add'])
def test_fpnf_matches_flax(hw, fusion):
    feats = pyramid(np.random.default_rng(2), hw, (32, 64, 128, 256))
    jm = jpan.FPNF(in_channels=(32, 64, 128, 256), out_channels=8,
                   fusion_type=fusion)
    v = flax_variables(jm, feats)
    want = jm.apply(v, tuple(jnp.asarray(f) for f in feats))
    tm = load_neck(FPNF((32, 64, 128, 256), 8, fusion), v,
                   convert.fpnf_rules())
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    close(got.permute(0, 2, 3, 1), want, 1e-5)


def test_pan_head_matches_flax():
    g = np.random.default_rng(3)
    feats = [g.standard_normal((2, 16, 16, 8)).astype(np.float32)
             for _ in range(4)]
    jm = jpan.PANHead(out_channels=6)
    v = jm.init(jax.random.PRNGKey(0), tuple(jnp.asarray(f) for f in feats))
    want = jm.apply(v, tuple(jnp.asarray(f) for f in feats))
    tm = PANHead(in_channels=[8] * 4, out_channels=6)
    sd = convert.convert_rules({'params': {'head': v['params']}},
                               [('head.out_conv', 'head/out_conv', 'conv')])
    tm.load_state_dict({k[5:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(tuple(nchw(f) for f in feats))
    close(got.permute(0, 2, 3, 1), want, 1e-5)


@functools.lru_cache(maxsize=None)
def narrow(name, hw):
    """(config, variables, the logits) of the narrow PANet / PSENet."""
    cfg = CFGS[name]
    jm = jax_build(cfg)
    x = images(hw)
    v = random_variables(jm, x[:1])
    out = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    return cfg, v, np.asarray(out)


@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('name', list(CFGS))
def test_panet_modules_match_flax(name, hw):
    cfg, v, want = narrow(name, hw)
    tm = build_detector_module(cfg)
    tm.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images(hw)))
    assert got.shape == want.shape == (2, -(-hw[0] // 4), -(-hw[1] // 4),
                                       6 if name == 'pan' else 7)
    close(got, want, 1e-5)


# ------------------------------------------------------------ targets --

@pytest.mark.parametrize('hw', [(64, 64), (96, 96)])
@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('kind', ['PANetTargets', 'PSENetTargets'])
def test_pan_pse_targets_match_jax(kind, seed, hw):
    g = np.random.default_rng(seed * 7 + hw[0])
    item = dict(img=np.zeros((*hw, 3)),
                gt_polygons=word_polygons(g, int(g.integers(1, 9)), *hw),
                gt_polygons_ignore=word_polygons(g, 1, *hw))
    kw = dict(max_shrink=int(g.choice([5, 20])))
    want = getattr(jt, kind)(**kw)(dict(item))
    got = getattr(targets, kind)(**kw)(dict(item))
    keys = ('gt_texts', 'gt_kernels', 'gt_mask') if kind == 'PANetTargets' \
        else ('gt_kernels', 'gt_mask')
    for k in keys:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------- losses --

def pan_batch(seed, n_inst, hw=(32, 40)):
    """Logits and PANetTargets at the logits' size with ``n_inst`` small
    instances an image."""
    g = np.random.default_rng(seed)
    preds = g.normal(0, 1.5, (2, *hw, 6)).astype(np.float32)
    tg = []
    for _ in range(2):
        polys = [np.array([[x, y], [x + 4, y], [x + 4, y + 3], [x, y + 3]],
                          np.float32)
                 for x, y in zip(g.integers(0, hw[1] - 5, n_inst),
                                 g.integers(0, hw[0] - 4, n_inst))]
        tg.append(jt.PANetTargets(shrink_ratio=(1.0, 0.5), max_shrink=1)(
            dict(img=np.zeros((*hw, 3)), gt_polygons=polys,
                 gt_polygons_ignore=word_polygons(g, 1, *hw))))
    return preds, {k: np.stack([t[k] for t in tg])
                   for k in ('gt_texts', 'gt_kernels', 'gt_mask')}


def pse_batch(seed, hw=(32, 40)):
    g = np.random.default_rng(seed)
    preds = g.normal(0, 1.5, (2, *hw, 7)).astype(np.float32)
    tg = [jt.PSENetTargets(max_shrink=3)(dict(
        img=np.zeros((*hw, 3)), gt_polygons=word_polygons(g, 4, *hw),
        gt_polygons_ignore=[])) for _ in range(2)]
    return preds, {k: np.stack([t[k] for t in tg])
                   for k in ('gt_kernels', 'gt_mask')}


def check_loss(jloss, tloss, preds, tgt):
    """Each named loss and the gradient of their sum within 1e-5."""
    def total(p):
        out = jloss(p, {k: jnp.asarray(v) for k, v in tgt.items()})
        return sum(out.values()), out
    (_, j_out), j_grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    out = tloss(p, {k: torch.from_numpy(v) for k, v in tgt.items()})
    sum(out.values()).backward()
    assert set(out) == set(j_out)
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(j_out[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    g = np.asarray(j_grad)
    np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                               atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize('n_inst', [5, 30])
def test_pan_loss_and_gradients_match_jax(n_inst):
    """Under and over max_instances (24): the instances past the cap get
    no embedding loss in either."""
    preds, tgt = pan_batch(n_inst, n_inst)
    assert tgt['gt_texts'].max() > (24 if n_inst > 24 else 0)
    check_loss(jpan.PANLoss(), PANLoss(), preds, tgt)


@pytest.mark.parametrize('kind', ['adaptive', 'hard'])
def test_pse_loss_and_gradients_match_jax(kind):
    preds, tgt = pse_batch(0)
    check_loss(jpan.PSELoss(kernel_sample_type=kind),
               PSELoss(kernel_sample_type=kind), preds, tgt)


def test_ohem_degenerate_mask_matches_jax():
    """No positive in one image, no negative in the other: the whole
    effective mask, as in JAX."""
    g = np.random.default_rng(4)
    score = g.normal(size=(2, 8, 9)).astype(np.float32)
    text = np.zeros((2, 8, 9), np.float32)
    text[1] = 1
    mask = (g.random((2, 8, 9)) > 0.2).astype(np.float32)
    want = jpan._ohem_mask(jnp.asarray(score), jnp.asarray(text),
                           jnp.asarray(mask), 3)
    got = _ohem_mask(torch.from_numpy(score), torch.from_numpy(text),
                     torch.from_numpy(mask), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ host ops --

def nested_kernels(g, hw, k):
    """``k`` nested masks (index 0 the largest) from a blurred field."""
    base = cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0), 2)
    return np.stack([base > t for t in np.quantile(
        base, np.linspace(0.3, 0.9, k))]).astype(np.uint8)


@pytest.mark.parametrize('seed', range(4))
def test_contour_expand_matches_native(seed):
    assert native.get_lib() is not None      # the C++ path, not numpy's
    g = np.random.default_rng(seed)
    for _ in range(25):
        hw = tuple(int(v) for v in g.integers(5, 60, 2))
        km = nested_kernels(g, hw, int(g.integers(2, 8)))
        n, lab = cv2.connectedComponents(km[-1], connectivity=4)
        area = int(g.integers(0, 4))
        np.testing.assert_array_equal(
            pixel_ops.contour_expand(km, lab, area, n - 1),
            native.contour_expand(km, lab, area, n - 1))


@pytest.mark.parametrize('seed', range(4))
def test_pixel_group_matches_native(seed):
    assert native.get_lib() is not None
    g = np.random.default_rng(seed)
    for _ in range(25):
        hw = tuple(int(v) for v in g.integers(5, 60, 2))
        base = cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0), 2)
        text = base > np.quantile(base, 0.4)
        kernel = (base > np.quantile(base, 0.8)) & text
        emb = g.normal(0, 0.5, (*hw, 4)).astype(np.float32)
        score = g.random(hw).astype(np.float32)
        n, lab = cv2.connectedComponents(kernel.astype(np.uint8),
                                         connectivity=4)
        thr = float(g.uniform(0.3, 1.5))
        outline = np.zeros(hw, np.uint8)
        assert pixel_ops.pixel_group(score, text, emb, lab, outline, n - 1,
                                     thr) == native.pixel_group(
            score, text, emb, lab, outline, n - 1, thr)


@pytest.mark.parametrize('seed', range(3))
def test_components_and_kernel_outlines_match_cv2(seed):
    g = np.random.default_rng(seed)
    for _ in range(40):
        hw = tuple(int(v) for v in g.integers(1, 50, 2))
        m = (cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0),
                              float(g.uniform(0.5, 2))) > 0.5)
        m = m.astype(np.uint8) * 255
        n, lab = cv2.connectedComponents(m, connectivity=4)
        got_n, got = cv_ops.connected_components(m)
        assert got_n == n and got.dtype == np.int32
        np.testing.assert_array_equal(got, lab)
        cs, _ = cv2.findContours(m, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
        mine = cv_ops.find_contours(m, cv_ops.RETR_LIST,
                                    cv_ops.CHAIN_APPROX_NONE)
        assert len(mine) == len(cs)
        for a, b in zip(mine, cs):
            np.testing.assert_array_equal(a, b)
        want = cv2.drawContours(np.zeros_like(m), cs, -1, 255)
        np.testing.assert_array_equal(
            cv_ops.draw_contour_lines(np.zeros_like(m), mine, 255), want)


# ------------------------------------------------------- postprocessing --

def same_boundaries(got, want, atol=1e-3):
    """The same boundaries: points within ``atol`` px (quads: the min-area
    rectangle's angle comes out of cv2 an ulp or so apart), scores equal."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a[:-1], b[:-1], atol=atol, rtol=0)
        np.testing.assert_allclose(a[-1], b[-1], atol=1e-6, rtol=0)


def logit_maps(g, hw, c):
    maps = cv2.GaussianBlur(g.standard_normal((*hw, c)).astype(np.float32),
                            (0, 0), 3) * 12
    return maps


@pytest.mark.parametrize('mode', ['quad', 'poly'])
@pytest.mark.parametrize('seed', range(3))
def test_pse_postprocessor_matches_jax(seed, mode):
    g = np.random.default_rng(seed)
    n = 0
    for hw in ((40, 48), (64, 80), (90, 70)):
        # text and six kernels, each nested in the one before, from one
        # field plus a little noise
        x = logit_maps(g, hw, 1).reshape(*hw, 1) + np.linspace(0, -2, 7) + \
            g.normal(0, 0.3, (*hw, 7)).astype(np.float32)
        kw = dict(text_repr_type=mode, min_text_avg_confidence=0.6)
        want = jpp.PSEPostprocessor(**kw)(x)
        same_boundaries(postprocess.PSEPostprocessor(**kw)(x), want)
        n += len(want)
    assert n >= 10


@pytest.mark.parametrize('mode', ['quad', 'poly'])
@pytest.mark.parametrize('seed', range(3))
def test_pan_postprocessor_matches_jax(seed, mode):
    g = np.random.default_rng(seed + 10)
    n = 0
    for hw in ((40, 48), (64, 80), (90, 70)):
        x = logit_maps(g, hw, 6)
        x[..., 2:] /= 10
        kw = dict(text_repr_type=mode, min_text_avg_confidence=0.6)
        want = jpp.PANPostprocessor(**kw)(x)
        same_boundaries(postprocess.PANPostprocessor(**kw)(x), want)
        n += len(want)
    assert n >= 10


# ------------------------------------------------------- entry points --

SIZE = (96, 128)


@pytest.fixture(scope='module')
def dets(tmp_path_factory):
    """For each small config: (config, JAX detector, the port's, a .pth of
    the port's weights), on random weights (seed 3)."""
    out = {}
    for name, cfg in CFGS.items():
        cfg = dict(cfg, postprocessor=dict(cfg['postprocessor'],
                                           min_text_avg_confidence=0.5))
        jdet = JaxDetector(cfg, img_size=SIZE)
        v = random_variables(jdet.module,
                             np.zeros((1, *SIZE, 3), np.float32), seed=3)
        jdet.variables = v
        sd = state_dict_from_jax(v, cfg)
        det = TextDetector(cfg, img_size=SIZE, device='cpu')
        det.model.load_state_dict(sd, strict=True)
        pth = str(tmp_path_factory.mktemp(name) / 'det.pth')
        torch.save({'meta': {}, 'state_dict': sd}, pth)
        out[name] = (cfg, jdet, det, pth)
    return out


def pages(n, seed=0, size=SIZE):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (*size, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize('name', list(CFGS))
def test_detect_batch_and_init_detector_match_jax(dets, name):
    cfg, jdet, det, pth = dets[name]
    imgs = pages(3, seed=5)
    want = jdet.detect_batch(imgs)
    assert sum(len(b) for b in want) >= 3
    same_boundaries(sum(det.detect_batch(imgs), []), sum(want, []))
    loaded = init_detector(dict(model=cfg), pth, img_size=SIZE, device='cpu')
    assert loaded.downsample == 0.25 and not loaded.model.training
    same_boundaries(sum(loaded.detect_batch(imgs), []), sum(want, []))
    big = pages(1, seed=6, size=(150, 230))[0]
    inner, sx, sy = det.prep(big)
    assert (sx, sy) == (230 / SIZE[1] / 0.25, 150 / SIZE[0] / 0.25)
    want = jdet.detect((inner * 255).round().astype(np.uint8))
    for b in want:
        b[:-1:2] *= 230 / SIZE[1]
        b[1:-1:2] *= 150 / SIZE[0]
    same_boundaries(det.detect(big), want)


def test_readtext_detects_with_panet(dets, tmp_path):
    """MMOCR with a PANet det config (no recognizer): each page's
    boundaries as axis-aligned boxes, those of ``TextDetector.detect``."""
    cfg, _, det, pth = dets['pan']
    path = str(tmp_path / 'panet_toy.py')
    with open(path, 'w') as f:
        f.write(f'model = {cfg!r}\n')
    ocr = MMOCR(det=path, det_ckpt=pth, recog=None, det_img_size=SIZE,
                device='cpu')
    imgs = pages(2, seed=8)
    res = ocr.readtext(imgs)
    for img, r in zip(imgs, res):
        bounds = det.detect(img)
        assert [b['box'] for b in r['result']] == [
            ocr._to_quad(b[:-1]) for b in bounds]


@pytest.mark.parametrize('name', list(CFGS))
def test_tools_test_evaluates_a_pan_pse_config(dets, name, tmp_path):
    """tools/test.py on a UniformConcatDataset config: the hmean of the
    JAX detector's boundaries under the JAX metric."""
    cfg, jdet, _, pth = dets[name]
    from test_torch_detector import write_dataset
    ann = write_dataset(str(tmp_path), [SIZE] * 4, seed=3)
    for i, img in enumerate(pages(4, seed=21)):
        cv2.imwrite(str(tmp_path / 'imgs' / f'img_{i}.png'), img)
    path = str(tmp_path / 'toy.py')
    with open(path, 'w') as f:
        f.write(f'''model = {cfg!r}
det_img_size = {SIZE!r}
test = dict(type='IcdarDataset', ann_file={ann!r},
            img_prefix={str(tmp_path / 'imgs')!r}, img_size={SIZE!r})
data = dict(samples_per_gpu=2,
            test=dict(type='UniformConcatDataset', datasets=[test]))
''')
    metrics = test_tool.main([path, pth, '--eval', 'hmean-iou'],
                             device='cpu')
    jds = JaxDataset(ann, img_prefix=str(tmp_path / 'imgs'), img_size=SIZE,
                     test_mode=True)
    preds = jdet.detect_batch([(jds[i]['img'] * 255).astype(np.uint8)
                               for i in range(4)])
    for k, v in jds.evaluate(preds, metric='hmean-iou').items():
        assert metrics[f'mean_{k}'] == v


def test_panet_train_detector_matches_the_jax_loop():
    """Two epochs of five 64 x 64 pages in batches of 2, Adam 1e-3 (JAX's
    default where a config names no optimizer): each epoch's last loss
    within 1e-4 of JAX's, the targets rescaled to the head's 1/4."""
    cfg = dict(model=CFGS['pan'], total_epochs=2)
    ds = Pages(5, seed=2, words=(3, 9))
    _, want = jax_train(cfg, ds, batch_size=2, seed=1)
    jm = jax_build(CFGS['pan'])
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    model = build_detector_module(CFGS['pan'])
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, v), CFGS['pan']), strict=True)
    _, opt, hist = train_detector(cfg, ds, batch_size=2, seed=1,
                                  device='cpu', model=model)
    np.testing.assert_allclose([h['loss'] for h in hist], want, rtol=1e-4)
    assert opt.count == 6
    assert set(hist[0]) >= {'loss_text', 'loss_kernel', 'loss_aggregation',
                            'loss_discrimination'}


def test_max_instances_cap_warns(caplog):
    cfg = dict(model=dict(CFGS['pan'], loss=dict(type='PANLoss',
                                                 max_instances=2)),
               total_epochs=1)
    with caplog.at_level('WARNING', logger='tps_pp_tpu_torch'):
        train_detector(cfg, Pages(1, words=(4, 5)), batch_size=1,
                       device='cpu')
    assert 'max_instances=2' in caplog.text


def test_jax_numpy_fallbacks_part_from_the_native_library():
    """The JAX package's numpy fallbacks of ``contour_expand`` and
    ``pixel_group`` (run only without its C++ library) grow labels a step
    at a time in a fixed direction order; on these seeded maps they part
    from the C++, which the port copies (ROADMAP queue 3)."""
    lib = native.get_lib
    assert lib() is not None
    g = np.random.default_rng(0)
    parted = [0, 0]
    for _ in range(40):
        hw = tuple(int(v) for v in g.integers(5, 60, 2))
        km = nested_kernels(g, hw, 5)
        n, lab = cv2.connectedComponents(km[-1], connectivity=4)
        base = cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0), 2)
        text = base > np.quantile(base, 0.4)
        kernel = (base > np.quantile(base, 0.8)) & text
        emb = g.normal(0, 0.5, (*hw, 4)).astype(np.float32)
        score = g.random(hw).astype(np.float32)
        m, klab = cv2.connectedComponents(kernel.astype(np.uint8),
                                          connectivity=4)
        args = (score, text, emb, klab, np.zeros(hw, np.uint8), m - 1, 0.8)
        want = (pixel_ops.contour_expand(km, lab, 0, n - 1),
                pixel_ops.pixel_group(*args))
        try:
            native.get_lib = lambda: None
            fallback = (native.contour_expand(km, lab, 0, n - 1),
                        native.pixel_group(*args))
        finally:
            native.get_lib = lib
        parted[0] += not np.array_equal(fallback[0], want[0])
        parted[1] += fallback[1] != want[1]
    assert parted[0] > 0 and parted[1] > 0, parted
