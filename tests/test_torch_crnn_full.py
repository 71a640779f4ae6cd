"""The CTC family at full width on the CPU: the models of
``configs/textrecog/crnn/crnn_academic_dataset.py`` and
``configs/textrecog/tps/crnn_tps_academic_dataset.py`` (VGG, two BiLSTMs,
for CRNN-TPS the TPS-STN with 20 fiducials; ~1.8 GFLOP a 32 x 100 crop,
8.3 M and 10.0 M parameters), and of ``crnn_toy_dataset.py`` (CRNN with
``<UKN>``: 38 classes), built by both packages from the config files,
the JAX variables (BatchNorm statistics perturbed; for CRNN-TPS fc2 drawn
at random, so that the warp samples between pixels and past the border)
carried into the port, and B=3 crops with mixed valid ratios through
``predict`` (``single_pass``): logits (N, 26, 37) within 1e-4, their
argmax equal, and ``simple_test``'s texts equal (the CTC decode clipped to
``ceil(26 * valid_ratio)`` frames) with scores within 1e-4.

JAX's CRNN-TPS computes its TPS grid in float32, ~2e-5 off the float64
grid the port rounds once (``tests/test_torch_crnn.py``
``test_tps_preprocessor_matches_jax``); through the VGG and the BiLSTMs
that moves these logits by ~1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import perturb_batch_stats

from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.config import load_config as jax_load_config

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'crnn': 'configs/textrecog/crnn/crnn_academic_dataset.py',
    'crnn_tps': 'configs/textrecog/tps/crnn_tps_academic_dataset.py',
    'crnn_toy': 'configs/textrecog/crnn/crnn_toy_dataset.py'}
# parameters of each model; the toy config's convertor has <UKN>, so its
# classifier has one class more (38)
N_PARAMS = {'crnn': 8_331_301, 'crnn_tps': 10_023_693, 'crnn_toy': 8_331_814}
VR = np.array([1.0, 0.5, 0.77], np.float32)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_full_width_predict_and_simple_test_match_jax(name):
    path = os.path.join(REPO, CONFIGS[name])
    cfg = dict(load_config(path)['model'])
    assert cfg == dict(jax_load_config(path)['model'])
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(lambda k: jrec.init_variables(
        k, (1, 32, 100, 1)))(jax.random.PRNGKey(4)), 4)
    if name == 'crnn_tps':
        fc2 = v['params']['preprocessor']['localization']['fc2']
        fc2['kernel'] = (0.05 * np.random.default_rng(4).standard_normal(
            fc2['kernel'].shape)).astype(np.float32)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    n_params = sum(p.numel() for p in rec.model.parameters())
    assert n_params == N_PARAMS[name]
    assert rec.resolved_decode_mode() == jrec.resolved_decode_mode() \
        == 'single_pass'
    img = np.random.default_rng(5).standard_normal((3, 32, 100, 1)).astype(
        np.float32)
    jv = jax.tree.map(jnp.asarray, v)
    want = np.asarray(jrec.predict(jv, jnp.asarray(img), jnp.asarray(VR)))
    got = rec.predict(img, VR)
    C = rec.label_convertor.num_classes()
    assert C == (38 if name == 'crnn_toy' else 37)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (3, 26, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if name == 'crnn_toy':        # no warp: within 1e-5 of the magnitude
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    want = jrec.simple_test(jv, jnp.asarray(img), jnp.asarray(VR))
    got = rec.simple_test(img, VR)
    assert [r['text'] for r in got] == [r['text'] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g['score'], w['score'], atol=1e-4)
    # the half-width row decodes at most ceil(26 * 0.5) = 13 frames
    full = rec.label_convertor.tensor2idx(rec.predict(img[1:2]).numpy())[0]
    assert len(got[1]['text']) <= len(rec.label_convertor.idx2str(full)[0])
