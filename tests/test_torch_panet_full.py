"""The six shipped PANet and PSENet configs at full width in the port
against the JAX package on the CPU (``configs/textdet/panet/*.py``,
``configs/textdet/psenet/*.py``): each parses alike and builds, its
``state_dict`` takes the JAX variables strictly, and on the three
architectures among them (PANet-R18 and PANet-R50 on FPEM_FFM, PSENet-R50
on FPNF) the logits of one 64 x 64 image on random JAX variables agree
within 1e-4 and ``state_dict_from_jax`` goes back through the JAX
converter (given the port's rules: JAX's ``torch_convert.py`` has no
detection table) bit for bit. The narrow modules are
``test_torch_panet.py``."""
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
    'panet_r18_ctw1500': 'configs/textdet/panet/'
                         'panet_r18_fpem_ffm_600e_ctw1500.py',
    'panet_r18_icdar2015': 'configs/textdet/panet/'
                           'panet_r18_fpem_ffm_600e_icdar2015.py',
    'panet_r50_icdar2017': 'configs/textdet/panet/'
                           'panet_r50_fpem_ffm_600e_icdar2017.py',
    'psenet_r50_ctw1500': 'configs/textdet/psenet/'
                          'psenet_r50_fpnf_600e_ctw1500.py',
    'psenet_r50_icdar2015': 'configs/textdet/psenet/'
                            'psenet_r50_fpnf_600e_icdar2015.py',
    'psenet_r50_icdar2017': 'configs/textdet/psenet/'
                            'psenet_r50_fpnf_600e_icdar2017.py',
}
# one config of each architecture: the forward and the round trip
ARCHS = ['panet_r18_icdar2015', 'panet_r50_icdar2017',
         'psenet_r50_icdar2015']


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
def test_shipped_pan_pse_configs_build_at_full_width(name):
    """The port's module of every config takes the JAX variables
    strictly, with as many weights as the flax module."""
    cfg = model_cfg(name)
    assert cfg['type'] in ('PANet', 'PSENet')
    g = np.random.default_rng(0)
    v = jax.tree.map(lambda s: g.standard_normal(s.shape).astype(s.dtype),
                     shapes(cfg))
    tm = build_detector_module(cfg)
    tm.load_state_dict(convert.state_dict_from_jax(v, cfg), strict=True)
    n_jax = sum(np.prod(s.shape) for s in jax.tree.leaves(v['params']))
    assert sum(p.numel() for p in tm.parameters()) == n_jax


@pytest.mark.parametrize('name', ARCHS)
def test_shipped_pan_pse_architectures_match_jax(name):
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
    assert got.shape == (1, 16, 16, 6 if cfg['type'] == 'PANet' else 7)
    close(got, want, 1e-4)


@pytest.mark.parametrize('name', ARCHS)
def test_shipped_pan_pse_round_trip_through_jax_converter(name):
    """``state_dict_from_jax`` of random variables through the JAX
    converter with the port's rules gives the variables back bit for
    bit."""
    cfg = model_cfg(name)
    g = np.random.default_rng(1)
    v = jax.tree.map(lambda s: g.standard_normal(s.shape).astype(s.dtype),
                     shapes(cfg))
    sd = {k: t.numpy() for k, t in
          convert.state_dict_from_jax(v, cfg).items()}
    rules = jtc.filter_rules_to_state(convert.rules_for_config(cfg), sd)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
