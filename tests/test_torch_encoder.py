"""The port's NRTR encoder against the JAX package, float32 on the CPU.

* The fused path (``ops.encoder``, here its plain version) against the
  whole-encoder Pallas kernel in interpret mode, at atol 2e-5 / rtol 1e-4,
  the JAX kernel's own contract (tests/test_pallas_encoder.py).
  Also at 8, 40 and 100 tokens an image, which kernel 3 now takes.
* The module path against the XLA ``NRTREncoder``, same tolerance.
* The fused path on a batch with an image whose keys are all masked
  (valid ratio 0) against the XLA encoder, which attends within each
  image. Not against the Pallas kernel: its block-diagonal mask sets every
  score of such an image to -1e9, so the image's softmax spreads over the
  other images of its block (a fault of the JAX package, ROADMAP.md
  queue 3).
* ``chip_smoke.py``'s library yardstick for kernel 3, an
  ``nn.TransformerEncoder`` loaded with the module's weights, against the
  fused path's plain version.

valid_ratio < 1 makes the flattened-token ceil mask matter.
"""
import chip_smoke
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


@pytest.mark.parametrize('T', [8, 40, 100])
def test_fused_path_matches_pallas_kernel_at_other_token_counts(
        models, monkeypatch, T):
    """Kernel 3 takes any token count up to 512 (the NRTR configs give
    8-40 and 64-320): its plain version against the Pallas kernel in
    interpret mode at T = 8, 40 and 100 tokens an image (a row of T
    cells), with masks, at the tolerance above."""
    import tps_pp_tpu.ops.pallas_encoder as pe
    orig = pe.fused_encoder_forward
    monkeypatch.setattr(pe, 'fused_encoder_forward',
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    jenc, v, enc, _, vr = models
    feat = np.random.default_rng(T).standard_normal(
        (4, 1, T, 64)).astype(np.float32)
    vr = vr[:4]
    want = np.asarray(jenc.apply(v, jnp.asarray(feat), fused=True,
                                 valid_ratio=jnp.asarray(vr)))
    with torch.no_grad():
        got = enc(torch.from_numpy(feat), torch.from_numpy(vr), fused=True)
    assert got.shape == (4, T, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


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


@pytest.mark.parametrize('n', [6, 3])
def test_fused_path_attends_within_each_image(models, n):
    """Image 1 has valid ratio 0: every key masked, so its softmax is
    uniform over its own 64 keys, as in the XLA encoder."""
    jenc, v, enc, feat, vr = models
    feat, vr = feat[:n], vr[:n].copy()
    vr[1] = 0.0
    want = np.asarray(jenc.apply(v, jnp.asarray(feat),
                                 valid_ratio=jnp.asarray(vr)))
    with torch.no_grad():
        got = enc(torch.from_numpy(feat), torch.from_numpy(vr), fused=True)
    assert not bool(sequence_mask(torch.from_numpy(vr), 32)[1].any())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('masked', [True, False])
def test_transformer_encoder_yardstick_computes_the_same(models, masked):
    """The yardstick that chip_smoke.py times beside kernel 3 computes the
    fused path's function: float32, tiny width, valid ratios > 0 (its
    softmax of a fully masked row is NaN)."""
    _, _, enc, feat, vr = models
    n = feat.shape[0]
    x = torch.from_numpy(feat).reshape(n, 32, 64)
    mask = sequence_mask(torch.from_numpy(vr) if masked else None, 32)
    te = chip_smoke.transformer_encoder_yardstick(enc, torch.float32)
    with torch.no_grad():
        got = te(x, src_key_padding_mask=None if mask is None
                 else mask <= 0)
    want = encoder_forward_plain(x, mask, enc.folded_weights(torch.float32),
                                 DIMS['n_head'])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_folded_weights_cached_until_reload(models):
    _, _, enc, _, _ = models
    w = enc.folded_weights(torch.float32)
    assert enc.folded_weights(torch.float32) is w
    enc.load_state_dict(enc.state_dict())
    assert enc.folded_weights(torch.float32) is not w
