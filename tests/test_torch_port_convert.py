"""Weights carried from the JAX package into the PyTorch port: the port's
``state_dict_from_jax`` fed back through the JAX package's own
``convert_state_dict`` + ``merge_flat`` must give the original variables bit
for bit. That also proves the port's keys are the reference's torch names.
"""
import jax
import numpy as np
import pytest
import torch

from tps_pp_tpu.apis.flagship import nrtr_tps_pp_cfg
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.utils import convert

torch.set_num_threads(2)


def _random_variables(cfg, tiny, seed=0):
    """Random float32 leaves in the shapes of the JAX recognizer's
    variables (no JAX init needed for a bit-exact round trip)."""
    rec = build_jax(cfg)
    shape = (1, 32, 64, 3) if tiny else (1, 32, 128, 3)
    shapes = jax.eval_shape(
        lambda: rec.init_variables(jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize('tiny', [True, False])
def test_state_dict_round_trips_through_jax_converter(tiny):
    cfg = nrtr_tps_pp_cfg(tiny=tiny)
    v = _random_variables(cfg, tiny)
    sd = convert.state_dict_from_jax(v, cfg)
    # the keys are exactly the port model's
    model = build_recognizer(cfg, device='cpu').model
    model.load_state_dict(sd, strict=True)

    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = jtc.filter_rules_to_state(jtc.rules_for_config(cfg), sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('tiny', [True, False])
def test_rule_tables_match_the_jax_package(tiny):
    cfg = nrtr_tps_pp_cfg(tiny=tiny)
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))
