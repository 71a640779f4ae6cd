"""The port's NRTR encoder against the JAX package, float32 on the CPU.

* The fused path (``ops.encoder``, here its plain version) against the
  whole-encoder Pallas kernel in interpret mode, at atol 2e-5 / rtol 1e-4,
  the JAX kernel's own contract (tests/test_pallas_encoder.py).
* The module path against the XLA ``NRTREncoder``, same tolerance.

valid_ratio < 1 makes the flattened-token ceil mask matter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jnp_tree, to_numpy

from tps_pp_tpu.models.encoders.nrtr import NRTREncoder as JaxEncoder
from tps_pp_tpu.models.encoders.nrtr import sequence_mask as jax_mask

from tps_pp_tpu_torch.models.encoders.nrtr import NRTREncoder, sequence_mask
from tps_pp_tpu_torch.ops.encoder import encoder_forward, encoder_forward_plain
from tps_pp_tpu_torch.utils.convert import convert_rules, nrtr_encoder_rules

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-4)
DIMS = dict(n_layers=2, n_head=4, d_k=16, d_v=16, d_model=64, d_inner=128)


@pytest.fixture(scope='module')
def models():
    rng = np.random.default_rng(0)
    jenc = JaxEncoder(**DIMS, dtype=jnp.float32)
    feat = rng.standard_normal((6, 4, 8, 64)).astype(np.float32)
    vr = np.array([0.4, 1.0, 0.7, 1.0, 0.55, 0.9], np.float32)
    v = to_numpy(jenc.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                           valid_ratio=jnp.asarray(vr)))
    # non-trivial LayerNorm affines, so that folding them matters
    for p in v['params'].values():
        for ln in ('norm1', 'norm2') if 'norm1' in p else ():
            p[ln]['scale'] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
            p[ln]['bias'] = rng.normal(0, 0.2, 64).astype(np.float32)
    sd = convert_rules({'params': {'encoder': v['params']}},
                       nrtr_encoder_rules(DIMS['n_layers']))
    enc = NRTREncoder(**DIMS).eval()
    enc.load_state_dict({k[len('encoder.'):]: t for k, t in sd.items()},
                        strict=True)
    return jenc, jnp_tree(v), enc, feat, vr


def test_sequence_mask_ceil_over_flattened_tokens():
    vr = np.array([0.01, 0.4, 0.55, 1.0, 0.999], np.float32)
    want = np.asarray(jax_mask(jnp.asarray(vr), 32))
    np.testing.assert_array_equal(
        sequence_mask(torch.from_numpy(vr), 32).numpy(), want)
    assert sequence_mask(None, 32) is None


@pytest.mark.parametrize('n,masked', [(6, True), (3, True), (1, True),
                                      (5, False)])
def test_fused_path_matches_pallas_kernel(models, monkeypatch, n, masked):
    import tps_pp_tpu.ops.pallas_encoder as pe
    orig = pe.fused_encoder_forward
    monkeypatch.setattr(pe, 'fused_encoder_forward',
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    jenc, v, enc, feat, vr = models
    feat, vr = feat[:n], (vr[:n] if masked else None)
    want = np.asarray(jenc.apply(
        v, jnp.asarray(feat), fused=True,
        valid_ratio=None if vr is None else jnp.asarray(vr)))
    tvr = None if vr is None else torch.from_numpy(vr)
    with torch.no_grad():
        got = enc(torch.from_numpy(feat), tvr, fused=True)
    assert got.shape == (n, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the ops wrapper on CPU tensors is its plain version
    w = enc.folded_weights(torch.float32)
    x = torch.from_numpy(feat).reshape(n, 32, 64)
    mask = sequence_mask(tvr, 32)
    np.testing.assert_array_equal(encoder_forward(x, mask, w, 4).numpy(),
                                  encoder_forward_plain(x, mask, w,
                                                        4).numpy())


@pytest.mark.parametrize('masked', [True, False])
def test_module_path_matches_xla_encoder(models, masked):
    jenc, v, enc, feat, vr = models
    vr = vr if masked else None
    want = np.asarray(jenc.apply(
        v, jnp.asarray(feat),
        valid_ratio=None if vr is None else jnp.asarray(vr)))
    with torch.no_grad():
        got = enc(torch.from_numpy(feat),
                  None if vr is None else torch.from_numpy(vr))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_folded_weights_cached_until_reload(models):
    _, _, enc, _, _ = models
    w = enc.folded_weights(torch.float32)
    assert enc.folded_weights(torch.float32) is w
    enc.load_state_dict(enc.state_dict())
    assert enc.folded_weights(torch.float32) is not w
