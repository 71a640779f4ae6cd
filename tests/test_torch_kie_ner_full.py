"""KIE and NER at full width against the JAX package on the CPU: the
shipped configs parse as JAX parses them; SDMGR at the wildreceipt widths
(92 characters, 64 nodes of 32 characters, node and edge embeddings 256,
fusion 1024, 2 GNN layers, 26 classes; the openset head's 4) with and
without the UNet16 at 512 x 512, its map and pooled features too; BERT-base
(12 layers, hidden 768, 12 heads, FFN 3072, vocabulary 21128, 512
positions) at B=1, T=128 with 21 labels. Random weights in the variables'
shapes, carried by ``state_dict_from_jax``.

Tolerances: SDMGR's outputs within 1e-5 of their largest magnitude (at
least 1; the pooled visual features, values of the UNet's map, of the
map's), BERT-base's logits within 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kie_ner import close, graphs, t

from tps_pp_tpu.apis.train_kie import roi_visual_pool as jax_pool
from tps_pp_tpu.config import load_config as jax_load_config
from tps_pp_tpu.models import common as jcommon
from tps_pp_tpu.models.kie import sdmgr as jsdmgr
from tps_pp_tpu.models.ner import bert as jbert

from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.models.kie import build_sdmgr
from tps_pp_tpu_torch.models.ner import NerClassifier
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'unet16': 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py',
    'novisual': 'configs/kie/sdmgr/sdmgr_novisual_60e_wildreceipt.py',
    'openset': 'configs/kie/sdmgr/sdmgr_novisual_60e_wildreceipt_openset.py',
    'bert': 'configs/ner/bert_softmax/bert_softmax_cluener_18e.py',
}
N_NODES, N_CHARS, IMG = 64, 32, 512
BERT_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def random_variables(shapes, seed=0):
    """Leaves in the variables' shapes: kernels at variance 1/fan_in,
    embeddings at 1/width, the LSTM uniform in +-1/sqrt(H), BatchNorm and
    LayerNorm affines and statistics away from their init."""
    g = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if 'weight_' in name or 'bias_' in name:          # the LSTM
            b = 1.0 / np.sqrt(shape[-1] if 'weight_hh' in name
                              else shape[0] // 4)
            x = g.uniform(-b, b, shape)
        elif name.endswith("['scale']") or name.endswith("['var']"):
            x = g.uniform(0.5, 1.5, shape)
        elif name.endswith("['bias']") or name.endswith("['mean']"):
            x = g.normal(0, 0.1, shape)
        elif name.endswith("['embedding']"):
            x = g.normal(0, 1.0 / np.sqrt(shape[-1]), shape)
        else:
            x = g.normal(0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        return x.astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_shipped_configs_parse_as_jax(name):
    path = os.path.join(REPO, CONFIGS[name])
    assert load_config(path) == jax_load_config(path)


def head_of(cfg):
    c = dict(cfg['model']['head'])
    c.pop('type')
    return jsdmgr.SDMGRHead(**c)


@pytest.mark.parametrize('name', ['novisual', 'openset'])
def test_sdmgr_full_width_matches_jax(name):
    """B=2 receipts of 64 nodes (the second with 20 valid)."""
    cfg = load_config(os.path.join(REPO, CONFIGS[name]))
    g = np.random.default_rng(0)
    rel, texts = graphs(g, N=N_NODES, L=N_CHARS, n_valid=(64, 20))
    head = head_of(cfg)
    shapes = jax.eval_shape(lambda: head.init(
        jax.random.PRNGKey(0), jnp.asarray(rel[0]), jnp.asarray(texts[0])))
    v = random_variables(shapes)
    model = build_sdmgr(cfg['model'])
    model.load_state_dict(state_dict_from_jax(
        {'params': {'head': v['params']}}, cfg['model']), strict=True)
    with torch.no_grad():
        node, edge = model(t(rel), t(texts))
    wn, we = jax.jit(jax.vmap(lambda r, x: head.apply(v, r, x)))(rel, texts)
    assert node.shape == (2, N_NODES, head.num_classes)
    close(node, wn)
    close(edge, we)


def test_sdmgr_unet16_full_width_matches_jax():
    """The UNet16 at 512 x 512 (eval mode), the 7x7 RoI max pool of 64
    boxes, the visual head: map, pooled features and logits."""
    cfg = load_config(os.path.join(REPO, CONFIGS['unet16']))
    g = np.random.default_rng(1)
    rel, texts = graphs(g, B=1, N=N_NODES, L=N_CHARS, n_valid=(40,))
    img = g.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    xy = g.uniform(0, 480, (N_NODES, 2))
    boxes = np.concatenate([xy, xy + g.uniform(2, 60, (N_NODES, 2))],
                           1).astype(np.float32)[None]
    boxes[0, 40:] = 0
    unet = jcommon.UNet(base_channels=16)
    head = head_of(cfg)
    ushapes = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), img))
    hshapes = jax.eval_shape(lambda: head.init(
        jax.random.PRNGKey(0), rel[0], texts[0],
        jnp.zeros((N_NODES, 16), jnp.float32)))
    uv, hv = random_variables(ushapes, 1), random_variables(hshapes, 2)

    @jax.jit
    def jax_forward(img, boxes, rel, texts):
        fm = unet.apply(uv, img)
        vis = jax_pool(fm[0], boxes[0])
        return fm, vis, head.apply(hv, rel[0], texts[0], vis)
    fm, vis, (wn, we) = jax_forward(img, boxes, rel, texts)
    model = build_sdmgr(cfg['model'], visual=True)
    model.load_state_dict(state_dict_from_jax(
        {'params': {'head': hv['params'], 'unet': uv['params']},
         'batch_stats': uv['batch_stats']}, cfg['model']), strict=True)
    model.eval()
    with torch.no_grad():
        got_fm = model.backbone(t(img))
        got_vis = model.visual_features(t(img), t(boxes))
        node, edge = model.head(t(rel), t(texts), got_vis)
    close(got_fm, fm)
    # the pooled features are values of the map: held to the map's scale
    close(got_vis[0], vis, scale=float(np.abs(fm).max()))
    close(node[0], wn)
    close(edge[0], we)


def test_bert_base_full_width_matches_jax():
    """BERT-base at B=1, T=128, the last 30 positions padding."""
    cfg = load_config(os.path.join(REPO, CONFIGS['bert']))['model']
    enc, dec = dict(cfg['encoder']), dict(cfg['decoder'])
    enc.pop('type')
    dec.pop('type')
    module = jbert.NerClassifierModule(encoder=jbert.BertEncoder(**enc),
                                       decoder=jbert.FCDecoder(**dec))
    T = 128
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32)))
    v = random_variables(shapes, 3)
    g = np.random.default_rng(3)
    ids = g.integers(0, 21128, (1, T)).astype(np.int32)
    mask = np.ones((1, T), np.int32)
    mask[0, 98:] = 0
    want = jax.jit(lambda i, m: module.apply(v, i, m))(ids, mask)
    model = NerClassifier(cfg)
    model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(t(ids), t(mask))
    assert got.shape == (1, T, 21)
    close(got, want, BERT_TOL)
