"""The port's NRTR + TPS++ flagship end to end against the JAX package's
``TextRecognizer`` (``steps`` decode, gather sampler), on the CPU in
float32, with the JAX weights carried across.

* Tiny flagship, batch 5 (pow2 bucketing runs), mixed valid ratios:
  ``simple_test`` strings equal, per-character scores within 1e-6, on the
  port's ``steps`` and ``fused40_bf16`` paths (the latter through the
  kernels' plain versions here).
* The same batch through the JAX package's other serving decodes, with
  their Pallas kernels in interpret mode: ``fused40`` (int8 encoder K/V)
  argmax equal and probabilities within atol 2e-2 / rtol 5e-2, the JAX
  kernel's own contract (tests/test_pallas_full_decode.py:45); ``steps``
  with ``use_fused_step=True`` argmax equal and within 1e-5 (both sides
  round the same operands to bf16 at the same points).
* Full-width flagship (heavy), batch 2: argmax equal, probabilities within
  atol 1e-3, which allows for float32 sums taken in another order over the
  trunk and 12 transformer layers.
* The copies the port carries (config, convertors, batching) against their
  originals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (jax_flagship, jax_recognizer, jnp_tree,
                             port_from_jax)

from tps_pp_tpu.apis import flagship as jflag
from tps_pp_tpu.convertors.attn import AttnConvertor as JaxAttnConvertor
from tps_pp_tpu.utils import batching as jbatching

from tps_pp_tpu_torch.apis import flagship as tflag
from tps_pp_tpu_torch.convertors import AttnConvertor
from tps_pp_tpu_torch.utils import batching as tbatching

torch.set_num_threads(2)
VR5 = np.array([1.0, 0.6, 0.85, 0.35, 1.0], np.float32)


@pytest.fixture(scope='module')
def tiny():
    jrec, v, cfg = jax_flagship(tiny=True, seed=2)
    img = np.random.default_rng(2).standard_normal((5, 32, 64, 3)).astype(
        np.float32)
    want = jrec.simple_test(jnp_tree(v), jnp.asarray(img), jnp.asarray(VR5))
    probs = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                    jnp.asarray(VR5)))
    return v, cfg, img, want, probs


@pytest.mark.parametrize('mode', ['auto', 'steps', 'fused40_bf16'])
def test_tiny_simple_test_matches_jax(tiny, mode):
    v, cfg, img, want, probs = tiny
    rec = port_from_jax(cfg, v, decode_mode=mode)
    assert rec.resolved_decode_mode() == ('steps' if mode == 'auto'
                                          else mode)
    got = rec.simple_test(img, VR5)
    assert [r['text'] for r in got] == [r['text'] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g['score'], w['score'], atol=1e-6,
                                   rtol=0)
    out = rec.predict(torch.from_numpy(img), torch.from_numpy(VR5))
    assert out.shape == probs.shape
    np.testing.assert_allclose(out.numpy(), probs, atol=1e-6, rtol=0)


def _interpret_kernels(monkeypatch):
    """The JAX package's Pallas kernels of the serving decodes, in
    interpret mode."""
    import tps_pp_tpu.ops.pallas_decode as pd
    import tps_pp_tpu.ops.pallas_encoder as pe
    import tps_pp_tpu.ops.pallas_full_decode as pfd
    for mod, name in ((pe, 'fused_encoder_forward'),
                      (pfd, 'full_greedy_decode'), (pd, 'self_attn_step'),
                      (pd, 'cross_ffn_step')):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **k: _f(
            *a, **dict(k, interpret=True)))


@pytest.mark.parametrize('mode', ['fused40', 'fused_step'])
def test_tiny_other_decodes_match_jax(tiny, monkeypatch, mode):
    _interpret_kernels(monkeypatch)
    v, cfg, img, _, _ = tiny
    if mode == 'fused40':
        jrec = jax_recognizer(cfg, 'fused40')
        rec = port_from_jax(cfg, v, decode_mode='fused40')
        atol, rtol = 2e-2, 5e-2
    else:
        jrec = jax_recognizer(cfg, use_fused_step=True)
        rec = port_from_jax(
            dict(cfg, decoder=dict(cfg['decoder'], use_fused_step=True)), v,
            decode_mode='steps')
        atol, rtol = 1e-5, 0
    assert jrec.resolved_decode_mode() == rec.resolved_decode_mode()
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(VR5)))
    got = rec.predict(img, VR5).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_bucketing_pads_and_slices(tiny):
    v, cfg, img, _, probs = tiny
    rec = port_from_jax(cfg, v)
    np.testing.assert_allclose(
        rec.predict(img, VR5, bucket_batch=False).numpy(), probs,
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(rec.predict(img[:3], VR5[:3]).numpy(),
                               probs[:3], atol=1e-6, rtol=0)


@pytest.mark.heavy
def test_full_width_flagship_argmax_matches_jax():
    jrec, v, cfg = jax_flagship(tiny=False, seed=3)
    img = np.random.default_rng(3).standard_normal((2, 32, 128, 3)).astype(
        np.float32)
    vr = np.array([1.0, 0.7], np.float32)
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(vr)))
    rec = port_from_jax(cfg, v)
    for mode in ('steps', 'fused40_bf16'):
        rec.decode_mode = mode
        got = rec.predict(img, vr).numpy()
        assert got.shape == want.shape == (2, 40, 92)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize('tiny_cfg', [True, False])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_flagship_config_copy(tiny_cfg, dtype):
    for mode in ('steps', 'auto'):
        assert tflag.nrtr_tps_pp_cfg(dtype, tiny_cfg, decode_mode=mode) == \
            jflag.nrtr_tps_pp_cfg(dtype, tiny_cfg, decode_mode=mode)
    assert tflag.FLAGSHIP_INPUT == jflag.FLAGSHIP_INPUT
    assert tflag.TINY_INPUT == jflag.TINY_INPUT


@pytest.mark.parametrize('dict_type', ['DICT90', 'DICT36'])
def test_attn_convertor_copy(dict_type):
    t, j = AttnConvertor(dict_type), JaxAttnConvertor(dict_type)
    assert t.idx2char == j.idx2char
    assert (t.start_idx, t.end_idx, t.padding_idx, t.unknown_idx) == \
        (j.start_idx, j.end_idx, j.padding_idx, j.unknown_idx)
    if dict_type == 'DICT90':
        assert (t.num_classes(), t.start_idx, t.padding_idx) == (93, 91, 92)
    strings = ['hello', 'A1!', '', 'x' * 50]
    np.testing.assert_array_equal(t.str2tensor(strings)['padded_targets'],
                                  j.str2tensor(strings)['padded_targets'])
    out = np.random.default_rng(0).random((4, 12, t.num_classes() - 1))
    out[1, 3, t.end_idx] = 5.0
    assert t.tensor2idx(out) == j.tensor2idx(out)
    assert t.idx2str(t.tensor2idx(out)[0]) == j.idx2str(j.tensor2idx(out)[0])


@pytest.mark.parametrize('n', [1, 3, 5, 8, 9])
def test_batching_copy(n):
    assert tbatching.next_pow2(n) == jbatching.next_pow2(n)
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    m = tbatching.next_pow2(n)
    got, = tbatching.pad_rows((torch.from_numpy(x),), n, m)
    want, = jbatching.pad_rows((jnp.asarray(x),), n, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
