"""Both shipped DBNet configs at full width in the port against the JAX
package on the CPU (``dbnet_r18_fpnc_1200e_icdar2015.py``,
``dbnet_r50dcnv2_fpnc_1200e_icdar2015.py``): the configs parse alike,
and the maps of one 64 x 64 image on random JAX variables (fan-in
scaled, BatchNorm and DCNv2 offsets moved off their init) carried across
by ``state_dict_from_jax`` agree within 1e-4 (the narrow modules are
``test_torch_textdet.py``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_textdet import close, random_variables

from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.config import load_config as jax_load_config

from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'r18': 'configs/textdet/dbnet/dbnet_r18_fpnc_1200e_icdar2015.py',
    'r50_dcn': 'configs/textdet/dbnet/dbnet_r50dcnv2_fpnc_1200e_icdar2015.py',
}


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_shipped_dbnet_configs_at_full_width_match_jax(name):
    path = os.path.join(REPO, CONFIGS[name])
    cfg = dict(load_config(path)['model'])
    assert cfg == dict(jax_load_config(path)['model'])
    x = np.random.default_rng(7).random((1, 64, 64, 3)).astype(np.float32)
    jm = jax_build(cfg)
    v = random_variables(jm, x)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    tm = build_detector_module(cfg)
    tm.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (1, 64, 64, 3)
    close(got, want, 1e-4)
