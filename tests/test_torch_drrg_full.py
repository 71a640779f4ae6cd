"""The shipped DRRG config at full width in the port against the JAX
package on the CPU (``configs/textdet/drrg/drrg_r50_fpn_unet_1200e_
ctw1500.py``: ResNetDet50 [3, 4, 6, 3], FPN_UNet to 32 channels,
DRRGHead and its GCN on 576 node features): it parses as JAX's loader
parses it and builds, its ``state_dict`` takes the JAX detector's
``{'net', 'gcn'}`` variables strictly (as many weights), the features, maps
and link logits of one 64 x 64 image on random JAX variables agree within
1e-4, and ``state_dict_from_jax`` goes back through the JAX converter
(given the port's rules; the transposed convolutions, graph convolutions
and PReLU slope, kinds the JAX converter lacks, turned back by hand) bit
for bit. Also the ``cv_ops`` copies DRRG adds, each exact against cv2
5.0: ``erode`` with cv2's default border, ``polylines`` (lines that leave
the image included) and 8-connected ``connected_components`` in cv2's
numbering. The narrow modules are ``test_torch_drrg.py``."""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_textdet import close, random_variables

from tps_pp_tpu.apis.detector import _build as jax_build
from tps_pp_tpu.config import load_config as jax_load_config
from tps_pp_tpu.models.textdet import drrg as jdrrg
from tps_pp_tpu.registry import BACKBONES, NECKS
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = 'configs/textdet/drrg/drrg_r50_fpn_unet_1200e_ctw1500.py'
NFL = 12 * (32 + 6) + 120


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class JaxNet(nn.Module):
    """The JAX ``TextDetector``'s DRRG network: backbone -> neck ->
    (features, DRRGHead's maps)."""
    backbone: object
    neck: object
    head: object

    @nn.compact
    def __call__(self, img, train=False):
        f = self.neck(self.backbone(img, train=train), train=train)
        return f, self.head(f, train=train)


def model_cfg():
    path = os.path.join(REPO, CONFIG)
    cfg = dict(load_config(path)['model'])
    assert cfg == dict(jax_load_config(path)['model'])
    return cfg


def jax_net(cfg):
    return JaxNet(backbone=jax_build(BACKBONES, cfg['backbone']),
                  neck=jax_build(NECKS, cfg['neck']),
                  head=jdrrg.DRRGHead(in_channels=32))


def gcn_inputs(g, G=3, N=41, K=8):
    return (g.standard_normal((G, N, NFL)).astype(np.float32),
            g.random((G, N, N)).astype(np.float32),
            g.integers(0, N, (G, K)).astype(np.int32))


def random_gcn(g):
    shapes = jax.eval_shape(lambda: jdrrg.GCN().init(
        jax.random.PRNGKey(0), *map(jnp.asarray, gcn_inputs(g, 1, 4, 2))))
    return jax.tree.map(
        lambda s: (g.standard_normal(s.shape) * 0.05).astype(s.dtype), shapes)


def test_shipped_drrg_config_builds_at_full_width():
    cfg = model_cfg()
    assert cfg['type'] == 'DRRG'
    g = np.random.default_rng(0)
    x = np.zeros((1, 64, 64, 3), np.float32)
    net = jax.eval_shape(lambda: jax_net(cfg).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    v = {'net': jax.tree.map(
        lambda s: g.standard_normal(s.shape).astype(s.dtype), net),
        'gcn': random_gcn(g)}
    tm = build_detector_module(cfg)
    tm.load_state_dict(convert.state_dict_from_jax(v, cfg), strict=True)
    n_jax = sum(np.prod(s.shape) for s in jax.tree.leaves(
        [v['net']['params'], v['gcn']['params']]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert tm.head.gcn.conv1.weight.shape == (2 * NFL, 512)


def test_shipped_drrg_config_matches_jax():
    """The features, the six maps (within 1e-4) and the GCN's link logits
    on node features of that scale (within 1e-4 of their largest)."""
    cfg = model_cfg()
    g = np.random.default_rng(7)
    x = g.random((1, 64, 64, 3)).astype(np.float32)
    jm = jax_net(cfg)
    v = {'net': random_variables(jm, x), 'gcn': random_gcn(g)}
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v['net'], jnp.asarray(x))
    tm = build_detector_module(cfg)
    tm.load_state_dict(convert.state_dict_from_jax(v, cfg), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got[0].shape == (1, 64, 64, 32) and got[1].shape == (1, 64, 64, 6)
    for a, b in zip(got, want):
        close(a, b, 1e-4)
    inputs = gcn_inputs(g)
    want = np.asarray(jdrrg.GCN().apply(v['gcn'],
                                        *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = tm.head.gcn(*map(torch.from_numpy, inputs))
    close(got, want, 1e-4 * np.abs(want).max())


def test_shipped_drrg_round_trip_through_jax_converter():
    cfg = model_cfg()
    g = np.random.default_rng(1)
    net = jax.eval_shape(lambda: jax_net(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    v = {'net': jax.tree.map(
        lambda s: g.standard_normal(s.shape).astype(s.dtype), net),
        'gcn': random_gcn(g)}
    sd = {k: t.numpy() for k, t in
          convert.state_dict_from_jax(v, cfg).items()}
    rules = convert.rules_for_config(cfg)
    by_hand = ('conv_transpose', 'graph_conv', 'prelu')
    flat = jtc.convert_state_dict(sd, jtc.filter_rules_to_state(
        [r for r in rules if r[2] not in by_hand], sd))
    for tp, fp, kind in rules:
        if kind == 'conv_transpose':
            flat['params'][f'{fp}/kernel'] = np.transpose(
                sd[f'{tp}.weight'], (2, 3, 0, 1))[::-1, ::-1]
            flat['params'][f'{fp}/bias'] = sd[f'{tp}.bias']
        elif kind == 'graph_conv':
            flat['params'][f'{fp}/weight'] = sd[f'{tp}.weight']
            flat['params'][f'{fp}/bias'] = sd[f'{tp}.bias']
        elif kind == 'prelu':
            flat['params'][f'{fp}/prelu_alpha'] = sd[f'{tp}.weight']
    assert {r[2] for r in rules} >= set(by_hand)
    merged_v = dict(v['net'], params=dict(v['net']['params'],
                                          gcn=v['gcn']['params']))
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, merged_v), flat)
    want = jax.tree_util.tree_flatten_with_path(merged_v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- cv_ops --

def blob_masks(g, n):
    """Blurred-noise masks of 1 x 1 up to 70 x 70 (blobs touching the
    edges, nested, diagonal contacts), as 0/1 or 0/255."""
    out = []
    for _ in range(n):
        hw = tuple(int(v) for v in g.integers(1, 70, 2))
        m = cv2.GaussianBlur(g.random(hw).astype(np.float32), (0, 0),
                             float(g.uniform(0.4, 2.5)))
        m = m > np.quantile(m, g.uniform(0.2, 0.8))
        out.append(m.astype(np.uint8) * np.uint8(g.choice([1, 255])))
    return out


@pytest.mark.parametrize('seed', range(2))
def test_connected_components_8_match_cv2(seed):
    """cv2's labels at 8-connectivity (its block-scan numbering) on 120
    masks a seed; ``label_components`` shares them."""
    from tps_pp_tpu_torch.convertors.seg import label_components
    for m in blob_masks(np.random.default_rng(seed), 120):
        n, want = cv2.connectedComponents(m, connectivity=8)
        got_n, got = cv_ops.connected_components(m, connectivity=8)
        assert got_n == n and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(label_components(m > 0)[1], want)
    with pytest.raises(ValueError):
        cv_ops.connected_components(m, connectivity=6)


@pytest.mark.parametrize('seed', range(2))
def test_erode_with_the_default_border_matches_cv2(seed):
    """``erode(..., border=None)``: cv2's default border, which never
    lowers a pixel, with rectangles, crosses and ellipses, on uint8 and
    float32 masks touching the edges; 120 masks a seed."""
    g = np.random.default_rng(seed + 5)
    for m in blob_masks(g, 120):
        k = cv2.getStructuringElement(int(g.integers(0, 3)),
                                      (int(g.integers(1, 22)),
                                       int(g.integers(1, 22))))
        np.testing.assert_array_equal(cv_ops.erode(m, k, border=None),
                                      cv2.erode(m, k))
        f = m.astype(np.float32) * 0.5
        np.testing.assert_array_equal(cv_ops.erode(f, k, border=None),
                                      cv2.erode(f, k))


@pytest.mark.parametrize('seed', range(2))
def test_polylines_match_cv2(seed):
    """Open and closed lines of 1 to 7 points, many leaving the image or
    missing it, drawn over one another; 120 images a seed."""
    g = np.random.default_rng(seed + 9)
    for t in range(120):
        h, w = (int(v) for v in g.integers(1, 70, 2))
        lines = [g.integers(-40, 110, (int(g.integers(1, 8)), 2)).astype(
            np.int32) for _ in range(int(g.integers(1, 4)))]
        closed = bool(t % 2)
        value = int(g.integers(1, 256))
        want = np.zeros((h, w), np.uint8)
        cv2.polylines(want, lines, closed, value, 1)
        got = cv_ops.polylines(np.zeros((h, w), np.uint8), lines, closed,
                               value)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        cv_ops.polylines(got, lines, thickness=2)
