"""The shipped transformer configs on the port's other trunks at full width
against the JAX package, on the CPU in float32:
``configs/textrecog/satrn/satrn_academic.py`` and ``satrn_small.py``
(ShallowCNN, the 12- and 6-layer SATRN encoders, d_k 64 and 32),
``configs/textrecog/nrtr/nrtr_modality_transform_academic.py`` (the
modality transform, a 12-layer NRTR encoder, DICT36) and
``nrtr_r31_1by16_1by8_academic.py`` / ``nrtr_r31_1by8_1by4_academic.py``
(ResNet31, 40 and 320 encoder tokens at 32 x 160). The weights are the
port's seed-0 init with perturbed BatchNorm statistics, carried into the
JAX package by its own converter (no JAX init at this width). Two crops
with valid ratios 1 and 0.65: the ``steps`` greedy argmax equal to JAX's
at every step, the probabilities within 1e-5; the whole decode's plain
version (``fused40_bf16`` in float32, the path the kernels take on the
card) likewise; the teacher-forced logits of two labels within 1e-5 of
their largest magnitude. The small-size tests are in
``tests/test_torch_satrn.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sar_full import port_weights_into_jax

from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.config import load_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# config, crop width, encoder tokens an image
CONFIGS = {
    'satrn_academic': ('configs/textrecog/satrn/satrn_academic.py', 100, 200),
    'satrn_small': ('configs/textrecog/satrn/satrn_small.py', 100, 200),
    'nrtr_modality': (
        'configs/textrecog/nrtr/nrtr_modality_transform_academic.py', 160,
        40),
    'nrtr_r31_1by16': (
        'configs/textrecog/nrtr/nrtr_r31_1by16_1by8_academic.py', 160, 40),
    'nrtr_r31_1by8': (
        'configs/textrecog/nrtr/nrtr_r31_1by8_1by4_academic.py', 160, 320),
}


@pytest.mark.parametrize('name', list(CONFIGS))
def test_full_width_greedy_matches_jax(name):
    path, width, tokens = CONFIGS[name]
    cfg = dict(load_config(os.path.join(REPO, path))['model'])
    rec = build_recognizer(cfg, device='cpu').init_weights(0)
    g = np.random.default_rng(1)
    with torch.no_grad():
        for n, b in rec.model.named_buffers():
            if n.endswith('running_mean'):
                b.copy_(torch.from_numpy(g.normal(0, 0.2, b.shape)))
            elif n.endswith('running_var'):
                b.copy_(torch.from_numpy(g.uniform(0.5, 1.5, b.shape)))
    jrec = build_jax(cfg)
    v = port_weights_into_jax(rec, jrec, (1, 32, width, 3))
    img = g.standard_normal((2, 32, width, 3)).astype(np.float32)
    vr = np.array([1.0, 0.65], np.float32)
    with torch.no_grad():
        feat = rec.model.extract_feat(torch.from_numpy(img))
    assert feat.shape[1] * feat.shape[2] == tokens
    want = np.asarray(jrec.predict(v, jnp.asarray(img), jnp.asarray(vr)))
    S, C = rec.max_seq_len, rec.label_convertor.num_classes() - 1
    for mode in ('steps', 'fused40_bf16'):
        rec.decode_mode = mode
        got = rec.predict(img, vr).numpy()
        assert got.shape == want.shape == (2, S, C)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    td = rec.label_convertor.str2tensor(['Hello', 'w0rld!'])
    want = np.asarray(jax.jit(lambda v, x, t, r: jrec.module.apply(
        v, x, targets=t, valid_ratio=r, train=False))(
        v, jnp.asarray(img), jnp.asarray(td['padded_targets']),
        jnp.asarray(vr)))
    with torch.no_grad():
        got = rec.model(torch.from_numpy(img),
                        torch.from_numpy(td['padded_targets']),
                        torch.from_numpy(vr)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
