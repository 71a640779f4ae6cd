"""DRRG in the port against the JAX package on the CPU: the host utilities
and the rotated RoI pooling bit for bit, ``GraphConv`` / ``GCN`` /
``DRRGHead`` against flax on converted weights, ``LocalGraphs.build`` /
``pack`` and ``ProposalLocalGraphs.build_test`` equal (components on a
grid, so that distances tie), each ``DRRGLoss`` term and its gradients
with respect to the maps and the GCN's logits (with and without padded
graphs), ``DRRGTargets`` bit for bit over seeded pages, the
postprocessor and the detection of trained-like maps with the GCN's link
bias raised, and the entry points on the narrow config of
``tests/test_detector_api.py``: ``init_detector`` from a ``.pth`` of the
JAX detector's variables, ``detect_batch``, ``train_detector`` against
JAX's ``_train_drrg`` and its resume, ``tools/test.py`` (hmean-iou),
``tools/train.py`` and ``MMOCR.readtext`` with a config path. Inputs are
made from seeds with numpy; the shipped config at full width and the
``cv_ops`` copies DRRG adds are ``test_torch_drrg_full.py``."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import drrg_like
from test_torch_det_train import SCHEDULE, Pages, word_polygons
from test_torch_panet import same_boundaries
from test_torch_textdet import close

from tps_pp_tpu.apis.detector import TextDetector as JaxDetector
from tps_pp_tpu.apis.train_det import train_detector as jax_train
from tps_pp_tpu.datasets.textdet_dataset import TextDetDataset as JaxDataset
from tps_pp_tpu.models.textdet import drrg as jdrrg
from tps_pp_tpu.models.textdet import targets as jt

from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.models.textdet import drrg, targets
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

BB = dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1], base_channels=8)
CFG = dict(type='DRRG', backbone=BB,
           neck=dict(type='FPN_UNet', in_channels=[8, 16, 32, 64],
                     out_channels=8),
           targets=dict(type='DRRGTargets'))
C = 8                               # the neck's channels
NFL = 12 * (C + 6) + 120            # the node features' length
SIZE = (64, 64)
LINK_BIAS = 8.0     # added to the GCN's class-1 bias: random weights
                    # rarely reach link_thr (0.8); exp stays finite


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run (ROADMAP queue 3:
    torch's oneDNN corrupts the heap at 3 or more in a channels-last
    conv)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def straight_words(g, n, h, w):
    """``n`` axis-aligned word quads at integer corners, one in the middle
    of each band of ``h / n`` rows: components of straight words fall on
    whole pixels, so that their distances tie, and words whose centre
    lines lie more than ``edge_len_thr`` (50) px apart are clusters of
    their own."""
    out = []
    for i in range(n):
        bw, bh = int(g.integers(w // 3, w * 2 // 3)), int(g.integers(12, 18))
        x = int(g.integers(2, w - bw - 2))
        y = i * h // n + (h // n - bh) // 2
        out.append(np.array([[x, y], [x + bw, y], [x + bw, y + bh],
                             [x, y + bh]], np.float32))
    return out


# ------------------------------------------------------- host utilities --

@pytest.mark.parametrize('seed', range(3))
def test_host_utilities_match_jax(seed):
    """The distance matrix, the normalised adjacency (an isolated node
    included), the geometry embedding with and without its residue
    branch, and the rotated RoI pooling (RoIs past the edges), bit for
    bit."""
    g = np.random.default_rng(seed)
    a = g.uniform(0, 60, (15, 2)).astype(np.float32)
    b = g.uniform(0, 60, (9, 2)).astype(np.float32)
    np.testing.assert_array_equal(drrg.euclidean_distance_matrix(a, b),
                                  jdrrg.euclidean_distance_matrix(a, b))
    adj = (g.random((12, 12)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    adj[3] = adj[:, 3] = 0
    np.testing.assert_array_equal(drrg.normalize_adjacent_matrix(adj),
                                  jdrrg.normalize_adjacent_matrix(adj))
    geo = np.hstack([g.uniform(0, 60, (10, 4)),
                     g.uniform(-1, 1, (10, 2))]).astype(np.float32)
    for length in (120, 124, 7):
        got = drrg.feature_embedding(geo, length)
        assert got.shape == (10, length) and got.dtype == np.float32
        np.testing.assert_array_equal(got,
                                      jdrrg.feature_embedding(geo, length))
    feat = g.standard_normal((40, 50, 5)).astype(np.float32)
    rois = np.hstack([g.uniform(-10, 60, (20, 2)), g.uniform(1, 30, (20, 2)),
                      g.uniform(-np.pi, np.pi, (20, 1))])
    for size, scale in (((4, 3), 1.0), ((2, 5), 0.5)):
        np.testing.assert_array_equal(
            drrg.roi_align_rotated_np(feat, rois, size, scale),
            jdrrg.roi_align_rotated_np(feat, rois, size, scale))
    assert drrg.roi_align_rotated_np(feat, rois[:0], (4, 3)).shape == \
        (0, 3, 4, 5)


# ------------------------------------------------------------ modules --

def jax_gcn(seed=0, bias=0.0):
    """The JAX GCN on ``NFL`` features and its parameters (the class-1
    bias raised by ``bias``) as numpy."""
    gcn = jdrrg.GCN()
    v = gcn.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, NFL)),
                 jnp.zeros((1, 4, 4)), jnp.zeros((1, 2), jnp.int32))
    v = jax.tree.map(np.array, v)
    v['params']['cls_fc2']['bias'][1] += bias
    return gcn, v


def gcn_state(params):
    """The port's GCN ``state_dict`` of JAX GCN parameters, through
    ``drrg_rules``."""
    rules = [r for r in convert.drrg_rules(CFG)
             if r[0].startswith('head.gcn.')]
    sd = convert.convert_rules({'params': {'gcn': params}}, rules)
    return {k[len('head.gcn.'):]: t for k, t in sd.items()}


def port_gcn(v):
    gcn = drrg.GCN(NFL)
    gcn.load_state_dict(gcn_state(v['params']), strict=True)
    return gcn.eval()


def graph_inputs(g, G=6, N=11, K=4):
    x = g.standard_normal((G, N, NFL)).astype(np.float32) * 3 + 1
    adj = g.random((G, N, N)).astype(np.float32)
    knn = g.integers(0, N, (G, K)).astype(np.int32)
    return x, adj, knn


def test_graph_conv_gcn_and_head_match_flax():
    """A ``GraphConv`` alone, the ``GCN``'s link logits (both within 1e-5
    of their largest magnitude) and ``DRRGHead``'s maps, on converted
    weights; the parameter names are MMOCR 0.4.0's."""
    g = np.random.default_rng(0)
    x, adj, knn = graph_inputs(g)
    jconv = jdrrg.GraphConv(16)
    vc = jconv.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(adj))
    want = np.asarray(jconv.apply(vc, jnp.asarray(x), jnp.asarray(adj)))
    conv = drrg.GraphConv(NFL, 16)
    conv.load_state_dict({k: torch.from_numpy(np.array(t)) for k, t in
                          vc['params'].items()}, strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x), torch.from_numpy(adj))
    close(got, want, 1e-5 * np.abs(want).max())
    gcn, v = jax_gcn(1)
    want = np.asarray(gcn.apply(v, *map(jnp.asarray, (x, adj, knn))))
    tg = port_gcn(v)
    assert set(dict(tg.named_parameters())) == {
        *(f'conv{i}.{n}' for i in range(1, 5) for n in ('weight', 'bias')),
        'classifier.0.weight', 'classifier.0.bias', 'classifier.1.weight',
        'classifier.2.weight', 'classifier.2.bias'}
    with torch.no_grad():
        got = tg(*map(torch.from_numpy, (x, adj, knn)))
    assert got.shape == (6 * 4, 2)
    close(got, want, 1e-5 * np.abs(want).max())
    f = g.standard_normal((2, 16, 20, C)).astype(np.float32)
    jh = jdrrg.DRRGHead(in_channels=C)
    vh = jh.init(jax.random.PRNGKey(3), jnp.asarray(f))
    want = np.asarray(jh.apply(vh, jnp.asarray(f)))
    th = drrg.DRRGHead(in_channels=C)
    assert th.node_feat_len == NFL
    sd = convert.convert_rules({'params': {'head': vh['params']}},
                               [r for r in convert.drrg_rules(CFG)
                                if r[0] == 'head.out_conv'])
    th.out_conv.load_state_dict({k[len('head.out_conv.'):]: t
                                 for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = th(torch.from_numpy(np.ascontiguousarray(
            f.transpose(0, 3, 1, 2)))).permute(0, 2, 3, 1)
    close(got, want, 1e-5 * np.abs(want).max())


# ------------------------------------------------------------- graphs --

def grid_attribs(g, n_side=5, step=6.0):
    """Components on a square grid (distances tie everywhere), random
    sizes, angles and labels 0-2."""
    ys, xs = np.mgrid[:n_side, :n_side] * step + 8
    n = n_side * n_side
    ang = g.uniform(-1, 1, n)
    return np.stack([xs.ravel(), ys.ravel(), g.uniform(4, 12, n),
                     g.uniform(8, 12, n), np.cos(ang), np.sin(ang),
                     g.integers(0, 3, n)], 1).astype(np.float32)


def same_graphs(got, want):
    for a, b in zip(got[:4], want[:4]):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [list(map(int, x)) for x in got[4]] == \
        [list(map(int, x)) for x in want[4]]
    assert [list(map(int, x)) for x in got[5]] == \
        [list(map(int, x)) for x in want[5]]


@pytest.mark.parametrize('seed', range(3))
def test_local_graphs_match_jax(seed):
    """``build`` on grid components (tied distances) and on a page's
    ``DRRGTargets`` components, unpadded and padded as the training loop
    pads (nodes to 41, graphs to a power of two, links -1): graphs, knns,
    features, adjacency, ``knn_inds`` and links equal."""
    g = np.random.default_rng(seed)
    feat = g.standard_normal((64, 64, C + 6)).astype(np.float32)
    np.random.seed(seed)
    page = jt.DRRGTargets().generate(
        word_polygons(g, 3, *SIZE), [], *SIZE)['gt_comp_attribs']
    for attribs in (grid_attribs(g), page):
        for pad in ({}, dict(pad_nodes=41, pad_graphs=max(8, 1 << (
                len(attribs) - 1).bit_length()))):
            want = jdrrg.LocalGraphs().build(feat, attribs, **pad)
            got = drrg.LocalGraphs().build(feat, attribs, **pad)
            same_graphs(got, want)
            if pad:
                assert (got[3] == -1).any() or len(got[4]) == len(got[0])
    assert drrg.LocalGraphs().pad_nodes == 41


@pytest.mark.parametrize('seed', range(2))
def test_build_test_matches_jax(seed):
    """``ProposalLocalGraphs.build_test`` on trained-like maps of straight
    words (components on whole pixels, ties in their distances): the
    proposed components and every output equal; None on maps that
    propose nothing."""
    g = np.random.default_rng(seed + 10)
    hw = (96, 128)
    maps = drrg_like(g, hw, straight_words(g, 3, *hw), seed=seed)
    feat = np.concatenate([g.standard_normal((*hw, C)).astype(np.float32),
                           maps], -1)
    want = jdrrg.ProposalLocalGraphs().build_test(maps, feat)
    got = drrg.ProposalLocalGraphs().build_test(maps, feat)
    assert len(want[5]) >= 10
    np.testing.assert_array_equal(got[5], want[5])
    same_graphs(got[:3] + (None,) + got[3:5], want[:3] + (None,) + want[3:5])
    quiet = maps.copy()
    quiet[..., 0] = -8
    assert drrg.ProposalLocalGraphs().build_test(quiet, feat) is None
    assert jdrrg.ProposalLocalGraphs().build_test(quiet, feat) is None


# -------------------------------------------------------------- losses --

def drrg_targets(g, n, hw):
    keys = ('gt_text_mask', 'gt_center_region_mask', 'gt_mask',
            'gt_top_height_map', 'gt_bot_height_map', 'gt_sin_map',
            'gt_cos_map')
    tg = [targets.DRRGTargets(seed=i).generate(
        word_polygons(g, 3, *hw, curved=0.5), word_polygons(g, 1, *hw), *hw)
        for i in range(n)]
    return {k: np.stack([t[k] for t in tg]) for k in keys}


@pytest.mark.parametrize('padded', [False, True])
def test_drrg_loss_and_gradients_match_jax(padded):
    """Each term within 1e-5 (relative) and the gradients of their sum
    with respect to the maps and to the GCN's logits within 1e-5 of their
    largest entry; ``padded``: a quarter of the links are -1 (padded
    graphs), which ``loss_gcn`` leaves out."""
    g = np.random.default_rng(int(padded))
    hw = (64, 80)
    tgt = drrg_targets(g, 2, hw)
    preds = g.normal(0, 2, (2, *hw, 6)).astype(np.float32)
    preds[..., 4:] += 6
    logits = g.normal(0, 2, (96, 2)).astype(np.float32)
    links = g.integers(0, 2, 96).astype(np.int32)
    if padded:
        links[72:] = -1

    def total(p, lg):
        out = jdrrg.DRRGLoss()(p, {k: jnp.asarray(v) for k, v in tgt.items()},
                               lg, jnp.asarray(links))
        return sum(out.values()), out
    (_, want), (gp, gl) = jax.value_and_grad(total, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(preds), jnp.asarray(logits))
    tp = torch.tensor(preds, requires_grad=True)
    tl = torch.tensor(logits, requires_grad=True)
    got = drrg.DRRGLoss()(tp, {k: torch.from_numpy(v) for k, v in
                                tgt.items()}, tl, torch.from_numpy(links))
    sum(got.values()).backward()
    assert list(got) == ['loss_text', 'loss_center', 'loss_height',
                         'loss_sin', 'loss_cos', 'loss_gcn']
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for t, w in ((tp, gp), (tl, gl)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    if padded:
        assert not tl.grad[72:].any()
    no_gcn = drrg.DRRGLoss()(tp.detach(), {k: torch.from_numpy(v) for k, v
                                           in tgt.items()})
    assert 'loss_gcn' not in no_gcn


# ------------------------------------------------------------ targets --

def target_pages():
    """24 (polygons, ignored polygons, size, jitter) cases: curved and
    straight words, words past the page's edge, small pages whose few
    components take the random top-up, and empty pages."""
    g = np.random.default_rng(11)
    out = []
    for i in range(24):
        hw = [(64, 64), (96, 128), (64, 96), (48, 160)][i % 4]
        n = 0 if i in (0, 5, 10, 15) else [1, 2, 3, 4, 2][i % 5]
        polys = word_polygons(g, n, *hw, curved=0.5)
        if i % 5 == 2:      # a word across the right edge
            polys.append(np.array([[hw[1] - 20, 10], [hw[1] + 15, 12],
                                   [hw[1] + 14, 26], [hw[1] - 21, 24]],
                                  np.float32))
        out.append((polys, word_polygons(g, i % 2, *hw), hw,
                    0.0 if i % 3 == 1 else 0.2))
    return out


@pytest.mark.parametrize('chunk', range(4))
def test_drrg_targets_match_jax(chunk):
    """Every key bit for bit, in JAX's dtype, on a quarter of the 24 pages
    each (an empty page in each; jitter off and on; JAX seeded through
    ``np.random.seed``, the port through its ``RandomState``)."""
    topped = empty = 0
    for i, (polys, ign, hw, jitter) in enumerate(target_pages()):
        if i % 4 != chunk:
            continue
        np.random.seed(i)
        want = jt.DRRGTargets(jitter_level=jitter).generate(polys, ign, *hw)
        got = targets.DRRGTargets(jitter_level=jitter, seed=i).generate(
            polys, ign, *hw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        topped += bool((want['gt_comp_attribs'][:, 6] == 0).any())
        empty += not polys
    assert topped >= 1 and empty == 1


def test_drrg_targets_call_and_rng():
    """``__call__`` reads the image's size; one ``RandomState`` carries on
    from page to page as numpy's global generator does in JAX."""
    g = np.random.default_rng(3)
    items = [dict(img=np.zeros((64, 64, 3)),
                  gt_polygons=word_polygons(g, 1, 64, 64)) for _ in range(3)]
    np.random.seed(5)
    jtg, tg = jt.DRRGTargets(), targets.DRRGTargets(seed=5)
    for item in items:
        want, got = jtg(dict(item)), tg(dict(item))
        np.testing.assert_array_equal(got['gt_comp_attribs'],
                                      want['gt_comp_attribs'])


# ------------------------------------------------------ postprocessing --

@pytest.mark.parametrize('seed', range(3))
def test_postprocessor_matches_jax(seed):
    """Random edges and scores (some above ``link_thr``, some long) over
    random quads: the same boundaries; nothing from no edges."""
    g = np.random.default_rng(seed)
    n = 30
    ctr = g.uniform(10, 100, (n, 2))
    quads = ctr[:, None] + g.uniform(-8, 8, (n, 4, 2))
    comps = np.hstack([quads.reshape(n, 8), g.random((n, 1))]).astype(
        np.float32)
    edges = g.integers(0, n, (80, 2))
    scores = g.uniform(0.5, 1.0, 80).astype(np.float32)
    want = jdrrg.DRRGPostprocessor()(edges, scores, comps)
    got = drrg.DRRGPostprocessor()(edges, scores, comps)
    assert len(want) >= 1
    same_boundaries(got, want, atol=0)
    assert drrg.DRRGPostprocessor()(np.zeros((0, 2)), [], comps) == []


@pytest.mark.parametrize('seed', range(2))
def test_detection_on_trained_like_maps_matches_jax(seed):
    """``DRRGDetector`` on a page's features and trained-like maps, the
    GCN's link bias raised by ``LINK_BIAS`` in both: at least 2
    boundaries, JAX's ``DRRGDetector.detect``'s."""
    g = np.random.default_rng(seed + 20)
    hw = (192, 160)
    maps = drrg_like(g, hw, straight_words(g, 3, *hw), seed=seed)
    feats = g.standard_normal((*hw, C)).astype(np.float32)
    gcn, v = jax_gcn(seed, LINK_BIAS)
    jdet = jdrrg.DRRGDetector(jdrrg.DRRGHead(in_channels=C))
    jdet.gcn = gcn
    want = jdet.detect({'head': None, 'gcn': v}, feats[None],
                       pred_maps=maps[None])
    got = drrg.DRRGDetector(port_gcn(v))(np.concatenate([feats, maps], -1))
    assert len(want) >= 2
    same_boundaries(got, want, atol=0)


# ------------------------------------------------------- entry points --

@functools.lru_cache(maxsize=None)
def jax_detector(seed=3):
    """The JAX ``TextDetector`` of the narrow config at ``SIZE`` on seed
    ``seed``, its variables as numpy."""
    jdet = JaxDetector(CFG, img_size=SIZE, rng_seed=seed)
    return jdet, jax.tree.map(np.asarray, {'net': jdet.variables['net'],
                                           'gcn': jdet.variables['gcn']})


@pytest.fixture(scope='module')
def dets(tmp_path_factory):
    """(JAX detector, the port's from a .pth of its variables, the
    .pth)."""
    jdet, v = jax_detector()
    pth = str(tmp_path_factory.mktemp('drrg') / 'det.pth')
    torch.save({'meta': {}, 'state_dict': state_dict_from_jax(v, CFG)}, pth)
    det = init_detector(dict(model=CFG), pth, img_size=SIZE, device='cpu')
    return jdet, det, pth


def pages(n, seed=0, size=SIZE):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (*size, 3), np.uint8) for _ in range(n)]


def test_detect_batch_and_init_detector_match_jax(dets):
    """``init_detector`` from a ``.pth``: the features and maps of three
    pages within 1e-4 of JAX's, ``detect_batch``'s boundaries JAX's; then
    trained-like maps with the link bias raised through
    ``TextDetector.postprocess``, scaled back to a larger page, JAX's
    ``DRRGDetector``'s."""
    jdet, det, _ = dets
    assert det.downsample == 1.0 and not det.model.training
    assert isinstance(det.postprocessor, drrg.DRRGDetector)
    imgs = pages(3, seed=5)
    x = np.stack([det.prep(i)[0] for i in imgs])
    want = [np.asarray(t)[:3] for t in jdet._jitted(jdet.variables['net'],
                                                    jnp.asarray(x))]
    got = det.forward(x)
    assert got[0].shape == (3, *SIZE, C) and got[1].shape == (3, *SIZE, 6)
    for a, b in zip(got, want):
        close(a, b, 1e-4)
    same_boundaries(sum(det.detect_batch(imgs), []),
                    sum(jdet.detect_batch(imgs), []))
    g = np.random.default_rng(6)
    maps = drrg_like(g, SIZE, straight_words(g, 2, *SIZE))
    feat = np.concatenate([g.standard_normal((*SIZE, C)).astype(np.float32),
                           maps], -1)
    with torch.no_grad():
        det.model.head.gcn.classifier[2].bias[1] += LINK_BIAS
    try:
        got = det.postprocess([feat], [(2.0, 1.5)])[0]
    finally:
        with torch.no_grad():
            det.model.head.gcn.classifier[2].bias[1] -= LINK_BIAS
    v = jax_detector()[1]['gcn']
    v = jax.tree.map(np.array, v)
    v['params']['cls_fc2']['bias'][1] += LINK_BIAS
    jd = jdrrg.DRRGDetector(jdrrg.DRRGHead(in_channels=C))
    want = jd.detect({'head': None, 'gcn': v}, feat[None, ..., :C],
                     pred_maps=maps[None])
    for w in want:
        w[:-1:2] *= 2.0
        w[1:-1:2] *= 1.5
    assert len(want) >= 1
    same_boundaries(got, want, atol=0)


def test_drrg_builds_without_a_head_config():
    """The shipped config names no head: ``DRRGHead`` on the neck's
    channels, its GCN on their node features."""
    m = build_detector_module(CFG)
    assert isinstance(m, drrg.DRRGModule)
    assert m.head.out_conv.in_channels == C
    assert m.head.gcn.conv1.weight.shape == (2 * NFL, 512)


def test_drrg_entry_points_without_a_card_raise(monkeypatch):
    """``init_detector`` and ``train_detector`` run DRRG on the card
    unless the CPU is asked for: with no card they raise."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_detector(dict(model=CFG), img_size=SIZE)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_detector(dict(model=CFG), Pages(1, hw=SIZE))


def jax_initial(seed):
    """The port's model on the variables JAX's ``_train_drrg`` starts
    from on ``seed`` (its net on ``PRNGKey(seed)``, its GCN on
    ``PRNGKey(seed + 1)``, as the JAX ``TextDetector`` makes them)."""
    model = build_detector_module(CFG)
    model.load_state_dict(state_dict_from_jax(jax_detector(seed)[1], CFG),
                          strict=True)
    return model


def test_train_detector_matches_the_jax_loop():
    """Two epochs of four pages, one a step, Adam 1e-3 (JAX's default):
    each epoch's last loss within 1e-4 of JAX's ``_train_drrg`` on the same
    initial weights and target draws (JAX's numpy global generator seeded
    with the port's ``RandomState`` seed)."""
    cfg = dict(model=CFG, total_epochs=2)
    ds = Pages(4, seed=2, hw=SIZE, words=(1, 4))
    np.random.seed(1)
    _, want = jax_train(cfg, ds, seed=1)
    _, opt, hist = train_detector(cfg, ds, batch_size=4, seed=1,
                                  device='cpu', model=jax_initial(1))
    np.testing.assert_allclose([h['loss'] for h in hist], want, rtol=1e-4)
    assert opt.count == 8
    assert set(hist[0]) >= {'loss_text', 'loss_center', 'loss_height',
                            'loss_sin', 'loss_cos', 'loss_gcn'}


def test_train_detector_resume_repeats_the_run(tmp_path):
    """A run resumed from its epoch-1 ``.pth`` takes the uninterrupted
    run's pages, target draws and lrs (the shipped SGD schedule) and
    reaches its loss exactly."""
    cfg = dict(model=CFG, total_epochs=2, **SCHEDULE)
    ds = Pages(3, seed=3, hw=SIZE, words=(1, 4))
    _, opt, hist = train_detector(cfg, ds, work_dir=str(tmp_path), seed=2,
                                  device='cpu')
    assert os.path.exists(tmp_path / 'epoch_1.pth')
    _, opt2, again = train_detector(
        cfg, ds, seed=2, device='cpu',
        resume_from=str(tmp_path / 'epoch_1.pth'))
    assert [h['epoch'] for h in again] == [1]
    assert opt2.count == opt.count == 6
    assert again[-1]['lr'] == hist[-1]['lr']
    for k in ('loss', 'loss_gcn', 'grad_norm'):
        assert again[-1][k] == hist[-1][k], k


def write_config(tmp_path, ann, prefix, extra=''):
    path = str(tmp_path / 'drrg_toy.py')
    with open(path, 'w') as f:
        f.write(f'''model = {CFG!r}
det_img_size = {SIZE!r}
ds = dict(type='IcdarDataset', ann_file={ann!r}, img_prefix={prefix!r},
          img_size={SIZE!r})
data = dict(samples_per_gpu=2,
            train=dict(type='UniformConcatDataset', datasets=[ds]),
            test=dict(type='UniformConcatDataset', datasets=[ds]))
{extra}''')
    return path


def test_tools_test_and_train_on_a_drrg_config(dets, tmp_path):
    """tools/test.py: the hmean-iou of the JAX detector's boundaries on
    the same weights; tools/train.py: an epoch of one page a step (its
    ``samples_per_gpu`` of 2 not read), a checkpoint, finite losses."""
    from test_torch_detector import write_dataset
    jdet, _, pth = dets
    ann = write_dataset(str(tmp_path), [SIZE] * 3, seed=4)
    prefix = str(tmp_path / 'imgs')
    path = write_config(tmp_path, ann, prefix, 'total_epochs = 1\n')
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
    assert opt.count == 3 and np.isfinite(hist[-1]['loss'])
    assert os.path.exists(os.path.join(wd, 'epoch_1.pth'))


def test_readtext_with_a_drrg_config_path(dets, tmp_path):
    """MMOCR with a DRRG config file and its ``.pth`` (no recognizer):
    each page's boundaries as ``TextDetector.detect`` gives them."""
    _, det, pth = dets
    path = str(tmp_path / 'drrg_toy.py')
    with open(path, 'w') as f:
        f.write(f'model = {CFG!r}\n')
    ocr = MMOCR(det=path, det_ckpt=pth, recog=None, det_img_size=SIZE,
                device='cpu')
    imgs = pages(2, seed=8)
    res = ocr.readtext(imgs)
    assert len(res) == 2
    for img, r in zip(imgs, res):
        assert [b['box'] for b in r['result']] == [
            ocr._to_quad(b[:-1]) for b in det.detect(img)]
