"""The shipped ResNet31 attention configs at full width against the JAX
package, on the CPU in float32:
``configs/textrecog/sar/sar_r31_parallel_decoder_academic.py``,
``sar_r31_sequential_decoder_academic.py`` and
``configs/textrecog/robust_scanner/robustscanner_r31_academic.py`` (the
46.0 M-parameter ResNet31 trunk, DICT90, 30 steps), on 48 x 160 crops with
mixed valid ratios. The weights are the port's seed-0 init with perturbed
BatchNorm statistics, carried into the JAX package by its own converter
(no JAX init at this width). The greedy argmax equal to JAX's at every
step, the probabilities within 1e-5; the teacher-forced logits of two
labels within 1e-5 of their largest magnitude. The small-size tests are in
``tests/test_torch_sar.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.config import load_config

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ['configs/textrecog/sar/sar_r31_parallel_decoder_academic.py',
           'configs/textrecog/sar/sar_r31_sequential_decoder_academic.py',
           'configs/textrecog/robust_scanner/robustscanner_r31_academic.py']


def port_weights_into_jax(rec, jrec, shape):
    """The port's weights as the JAX recognizer's variables, through the
    JAX package's converter."""
    sd = {k: t.numpy() for k, t in rec.model.state_dict().items()}
    shapes = jax.eval_shape(
        lambda: jrec.init_variables(jax.random.PRNGKey(0), shape))
    rules = jtc.filter_rules_to_state(jtc.rules_for_config(jrec.cfg), sd)
    v = jtc.merge_flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes), jtc.convert_state_dict(sd, rules))
    return jax.tree.map(jnp.asarray, v)


@pytest.mark.parametrize('path', CONFIGS,
                         ids=['sar_parallel', 'sar_sequential',
                              'robust_scanner'])
def test_full_width_greedy_matches_jax(path):
    cfg = dict(load_config(os.path.join(REPO, path))['model'])
    rec = build_recognizer(cfg, device='cpu').init_weights(0)
    g = np.random.default_rng(1)
    with torch.no_grad():
        for name, b in rec.model.named_buffers():
            if name.endswith('running_mean'):
                b.copy_(torch.from_numpy(g.normal(0, 0.2, b.shape)))
            elif name.endswith('running_var'):
                b.copy_(torch.from_numpy(g.uniform(0.5, 1.5, b.shape)))
    jrec = build_jax(cfg)
    v = port_weights_into_jax(rec, jrec, (1, 48, 160, 3))
    img = g.standard_normal((2, 48, 160, 3)).astype(np.float32)
    vr = np.array([1.0, 0.65], np.float32)
    want = np.asarray(jrec.predict(v, jnp.asarray(img), jnp.asarray(vr)))
    got = rec.predict(img, vr).numpy()
    assert got.shape == want.shape == (2, 30, 92)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # seed-0 weights decode one token at every step; the teacher-forced
    # pass over varied labels holds the recurrences and the attention on
    # other inputs (logits within 1e-5 of their largest magnitude)
    td = rec.label_convertor.str2tensor(['Hello', 'w0rld!'])
    want = np.asarray(jrec.module.apply(
        v, jnp.asarray(img), targets=jnp.asarray(td['padded_targets']),
        valid_ratio=jnp.asarray(vr), train=False))
    with torch.no_grad():
        got = rec.model(torch.from_numpy(img),
                        torch.from_numpy(td['padded_targets']),
                        torch.from_numpy(vr)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
