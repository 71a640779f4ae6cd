"""The three shipped FCENet and TextSnake configs at full width in the port
against the JAX package on the CPU (``configs/textdet/fcenet/*.py``,
``configs/textdet/textsnake/*.py``): each parses as JAX's loader parses
it and builds, its ``state_dict`` takes the JAX variables strictly (as
many weights as the flax module), the outputs of one 64 x 64 image on
random JAX variables agree within 1e-4 (FCENet's (cls, reg) pair of each
level, TextSnake's five maps), and ``state_dict_from_jax`` goes back
through the JAX converter (given the port's rules: JAX's
``torch_convert.py`` has no detection table) bit for bit. The narrow
modules are ``test_torch_fce_textsnake.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_textdet import close, random_variables

from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.config import load_config as jax_load_config
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'fcenet_r50_icdar2015': 'configs/textdet/fcenet/'
                            'fcenet_r50_fpn_1500e_icdar2015.py',
    'fcenet_r50dcnv2_ctw1500': 'configs/textdet/fcenet/'
                               'fcenet_r50dcnv2_fpn_1500e_ctw1500.py',
    'textsnake_r50_ctw1500': 'configs/textdet/textsnake/'
                             'textsnake_r50_fpn_unet_1200e_ctw1500.py',
}


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def model_cfg(name):
    path = os.path.join(REPO, CONFIGS[name])
    cfg = dict(load_config(path)['model'])
    assert cfg == dict(jax_load_config(path)['model'])
    return cfg


def shapes(cfg):
    return jax.eval_shape(lambda: jax_build(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


@pytest.mark.parametrize('name', list(CONFIGS))
def test_shipped_fce_textsnake_configs_build_at_full_width(name):
    cfg = model_cfg(name)
    assert cfg['type'] in ('FCENet', 'TextSnake')
    g = np.random.default_rng(0)
    v = jax.tree.map(lambda s: g.standard_normal(s.shape).astype(s.dtype),
                     shapes(cfg))
    tm = build_detector_module(cfg)
    tm.load_state_dict(convert.state_dict_from_jax(v, cfg), strict=True)
    n_jax = sum(np.prod(s.shape) for s in jax.tree.leaves(v['params']))
    assert sum(p.numel() for p in tm.parameters()) == n_jax


@pytest.mark.parametrize('name', list(CONFIGS))
def test_shipped_fce_textsnake_configs_match_jax(name):
    cfg = model_cfg(name)
    x = np.random.default_rng(7).random((1, 64, 64, 3)).astype(np.float32)
    jm = jax_build(cfg)
    v = random_variables(jm, x)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    tm = build_detector_module(cfg)
    tm.load_state_dict(convert.state_dict_from_jax(v, cfg), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    if cfg['type'] == 'TextSnake':
        assert got.shape == (1, 64, 64, 5)
    else:
        assert [tuple(c.shape) for c, _ in got] == [(1, 8, 8, 4),
                                                    (1, 4, 4, 4),
                                                    (1, 2, 2, 4)]
        assert all(r.shape[-1] == 22 for _, r in got)
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        close(a, b, 1e-4)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_shipped_fce_textsnake_round_trip_through_jax_converter(name):
    """``state_dict_from_jax`` of random variables through the JAX
    converter with the port's rules gives the variables back bit for bit
    (FPN_UNet's transposed convolutions, a kind the JAX converter lacks,
    turned back by hand: the kernel transposed to (kh, kw, in, out) and
    flipped)."""
    cfg = model_cfg(name)
    g = np.random.default_rng(1)
    v = jax.tree.map(lambda s: g.standard_normal(s.shape).astype(s.dtype),
                     shapes(cfg))
    sd = {k: t.numpy() for k, t in
          convert.state_dict_from_jax(v, cfg).items()}
    rules = convert.rules_for_config(cfg)
    flat = jtc.convert_state_dict(sd, jtc.filter_rules_to_state(
        [r for r in rules if r[2] != 'conv_transpose'], sd))
    for tp, fp, kind in rules:
        if kind == 'conv_transpose':
            flat['params'][f'{fp}/kernel'] = np.transpose(
                sd[f'{tp}.weight'], (2, 3, 0, 1))[::-1, ::-1]
            flat['params'][f'{fp}/bias'] = sd[f'{tp}.bias']
    assert any(r[2] == 'conv_transpose' for r in rules) == (
        cfg['type'] == 'TextSnake')
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v), flat)
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
