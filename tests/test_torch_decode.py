"""The port's NRTR greedy decode against the JAX package, on the CPU.

* The fused path (``ops.full_decode``, here its plain version) and the
  module path (``greedy_decode``) against the JAX ``steps`` loop
  (decode_init / decode_step): argmax identical, probabilities within atol
  1e-5. Both sides in float32.
* The fused path against the whole-decode Pallas kernel with bf16 encoder
  K/V in interpret mode: argmax identical, atol 2e-2 / rtol 5e-2, the JAX
  kernel's own contract (tests/test_pallas_full_decode.py).
* The fused path with int8 encoder K/V (``enc_dtype='int8'``, the JAX
  package's ``fused40``) against the same Pallas kernel's int8 branch in
  interpret mode: argmax identical, atol 2e-2 / rtol 5e-2
  (tests/test_pallas_full_decode.py:45); its per-(layer, head) scales and
  int8 values against the JAX formula (pallas_full_decode.py:302-311) on
  the same K/V: scales to 1e-6 relative, values equal.
* The all-rows-EOS early exit, forced by classifier-bias surgery.
* The same against JAX's steps and the Pallas kernel (both K/V types) at
  d_k 32 (SATRN-small's heads) and at 300 source tokens, which kernels 4-5
  take since they were widened.
* ``chip_smoke.bf16_ulp_step``, the one-ulp perturbation behind the
  near-tie width of kernel 4 on the card.
"""
import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jnp_tree, to_numpy

from tps_pp_tpu.models.decoders.nrtr import NRTRDecoder as JaxDecoder

from tps_pp_tpu_torch.models.decoders import NRTRDecoder, greedy_decode
from tps_pp_tpu_torch.models.encoders.nrtr import sequence_mask
from tps_pp_tpu_torch.models.transformer import sinusoid_position_table
from tps_pp_tpu_torch.ops.full_decode import (full_decode, full_decode_plain,
                                              quantize_enc_kv)
from tps_pp_tpu_torch.utils.convert import convert_rules, nrtr_decoder_rules

torch.set_num_threads(2)
S, C, END = 10, 39, 37
DIMS = dict(n_layers=2, num_classes=C, max_seq_len=S, start_idx=1,
            padding_idx=38)


def _port(v):
    sd = convert_rules({'params': {'decoder': v['params']}},
                       nrtr_decoder_rules(DIMS['n_layers']))
    sd = {k[len('decoder.'):]: t for k, t in sd.items()}
    sd['position_enc.position_table'] = torch.from_numpy(
        sinusoid_position_table(200, 512))
    dec = NRTRDecoder(**DIMS).eval()
    dec.load_state_dict(sd, strict=True)
    return dec


@pytest.fixture(scope='module')
def setup():
    rng = np.random.default_rng(0)
    jdec = JaxDecoder(**DIMS, dtype=jnp.float32)
    out_enc = rng.standard_normal((4, 16, 512)).astype(np.float32)
    vr = np.array([0.6, 1.0, 0.8, 1.0], np.float32)
    v = to_numpy(jdec.init(jax.random.PRNGKey(0), None, jnp.asarray(out_enc),
                           targets=jnp.full((4, S), 38, jnp.int32),
                           valid_ratio=jnp.asarray(vr)))
    # non-trivial LayerNorm affines, so that folding them matters
    lns = [v['params']['layer_norm']] + [
        p[n] for k, p in v['params'].items() if k.startswith('layer_stack')
        for n in ('norm1', 'norm2', 'norm3')]
    for ln in lns:
        ln['scale'] = rng.uniform(0.5, 1.5, 512).astype(np.float32)
        ln['bias'] = rng.normal(0, 0.2, 512).astype(np.float32)
    jv = jnp_tree(v)
    carry, static = jdec.apply(jv, None, jnp.asarray(out_enc),
                               jnp.asarray(vr), method='decode_init')
    tok, ref = jnp.full((4,), 1, jnp.int32), []
    for t in range(S):
        p, carry = jdec.apply(jv, tok, t, carry, static,
                              method='decode_step')
        ref.append(np.asarray(p))
        tok = jnp.argmax(p, -1).astype(jnp.int32)
    return jdec, v, _port(v), out_enc, vr, np.stack(ref, axis=1)


def _fused(dec, out_enc, vr, end_idx=None, enc_dtype='bfloat16'):
    with torch.no_grad():
        return dec.fused_full_decode(torch.from_numpy(out_enc),
                                     torch.from_numpy(vr), end_idx=end_idx,
                                     enc_dtype=enc_dtype).numpy()


def _interpret(monkeypatch):
    import tps_pp_tpu.ops.pallas_full_decode as pfd
    orig = pfd.full_greedy_decode
    monkeypatch.setattr(pfd, 'full_greedy_decode',
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))


@pytest.mark.parametrize('n', [4, 3, 1])
def test_fused_path_matches_jax_steps(setup, n):
    _, _, dec, out_enc, vr, ref = setup
    got = _fused(dec, out_enc[:n], vr[:n])
    assert got.shape == (n, S, C - 1)
    np.testing.assert_array_equal(got.argmax(-1), ref[:n].argmax(-1))
    np.testing.assert_allclose(got, ref[:n], atol=1e-5, rtol=0)


@pytest.mark.parametrize('n', [4, 3, 1])
def test_module_path_matches_jax_steps(setup, n):
    _, _, dec, out_enc, vr, ref = setup
    with torch.no_grad():
        got = greedy_decode(dec, torch.from_numpy(out_enc[:n]),
                            torch.from_numpy(vr[:n]), max_seq_len=S,
                            start_idx=1).numpy()
    np.testing.assert_array_equal(got.argmax(-1), ref[:n].argmax(-1))
    np.testing.assert_allclose(got, ref[:n], atol=1e-5, rtol=0)


@pytest.mark.parametrize('n', [4, 3, 1])
def test_fused_path_matches_pallas_kernel_bf16(setup, monkeypatch, n):
    import tps_pp_tpu.ops.pallas_full_decode as pfd
    orig = pfd.full_greedy_decode
    monkeypatch.setattr(pfd, 'full_greedy_decode',
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    jdec, v, dec, out_enc, vr, _ = setup
    want = np.asarray(jdec.apply(jnp_tree(v), None, jnp.asarray(out_enc[:n]),
                                 jnp.asarray(vr[:n]),
                                 method='fused_full_decode',
                                 enc_dtype='bfloat16'))
    got = _fused(dec, out_enc[:n], vr[:n])
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=5e-2)


@pytest.mark.parametrize('n', [4, 3, 1])
def test_fused_path_matches_pallas_kernel_int8(setup, monkeypatch, n):
    _interpret(monkeypatch)
    jdec, v, dec, out_enc, vr, _ = setup
    want = np.asarray(jdec.apply(jnp_tree(v), None, jnp.asarray(out_enc[:n]),
                                 jnp.asarray(vr[:n]),
                                 method='fused_full_decode',
                                 enc_dtype='int8'))
    got = _fused(dec, out_enc[:n], vr[:n], enc_dtype='int8')
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=5e-2)
    # the quantization is seen: the bf16 branch gives other probabilities
    assert np.abs(got - _fused(dec, out_enc[:n], vr[:n])).max() > 1e-5


def test_int8_scales_match_jax(setup):
    """``quantize_enc_kv`` on JAX's own encoder K/V (``project_enc_kv``)
    against the formula of ``_full_greedy_decode_impl`` (per (layer, head)
    over the whole batch; round half to even): scales to 1e-6 relative,
    int8 values equal. The port's projection gives scales within 1e-5
    (f32 sums of 512 terms in another order)."""
    jdec, v, dec, out_enc, _, _ = setup
    L, H, DK = DIMS['n_layers'], 8, 64
    kv = jdec.apply(jnp_tree(v), jnp.asarray(out_enc), method=lambda m, o: [
        m.layer_stack[l].project_enc_kv(o) for l in range(L)])
    kv = np.stack([np.stack([np.asarray(k), np.asarray(u)]) for k, u in kv])
    want = np.max(np.abs(kv), axis=(2, 4, 5)) / np.float32(127.0) + \
        np.float32(1e-8)                                  # (L, 2, H)
    # the port's layout: rows (N, TE), columns (L, K|V, H, DK)
    ekv = torch.from_numpy(kv.transpose(2, 4, 0, 1, 3, 5).reshape(
        out_enc.shape[0] * out_enc.shape[1], L * 2 * H * DK))
    q, scales = quantize_enc_kv(ekv, DK)
    assert q.dtype == torch.int8 and scales.shape == (L * 2 * H,)
    np.testing.assert_allclose(scales.numpy().reshape(L, 2, H), want,
                               rtol=1e-6, atol=0)
    x = ekv.numpy().reshape(ekv.shape[0], L * 2 * H, DK)
    want_q = np.asarray(jnp.clip(jnp.round(
        jnp.asarray(x) / want.reshape(-1)[:, None]), -127, 127).astype(
        jnp.int8))
    np.testing.assert_array_equal(q.numpy().reshape(x.shape), want_q)
    # the port's own projection
    w = dec.packed_weights(torch.float32)
    _, scales = quantize_enc_kv(
        torch.from_numpy(out_enc).reshape(-1, 512) @ w['wkv_enc'], DK)
    np.testing.assert_allclose(scales.numpy().reshape(L, 2, H), want,
                               rtol=1e-5, atol=0)
    # exact halves round to even
    half = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 0.0, 3.5]])
    q, s = quantize_enc_kv(half, 8)
    np.testing.assert_array_equal(
        q.numpy(), np.clip(np.round(half.numpy() / s.numpy()), -127, 127))


def test_int8_early_exit(setup, monkeypatch):
    """EOS at step 0 everywhere: one step runs, the rest read back as
    zeros, as the int8 Pallas kernel's while loop does."""
    _interpret(monkeypatch)
    jdec, v, _, out_enc, vr, _ = setup
    b = v['params']['classifier']['bias'].copy()
    b[END] += 100.0
    v_eos = jax.tree.map(lambda x: x, v)
    v_eos['params']['classifier'] = dict(v['params']['classifier'], bias=b)
    got = _fused(_port(v_eos), out_enc, vr, END, enc_dtype='int8')
    want = np.asarray(jdec.apply(jnp_tree(v_eos), None, jnp.asarray(out_enc),
                                 jnp.asarray(vr), method='fused_full_decode',
                                 enc_dtype='int8', end_idx=END))
    assert (got.argmax(-1)[:, 0] == END).all()
    assert np.all(got[:, 1:] == 0.0) and np.all(want[:, 1:] == 0.0)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=5e-2)


def test_early_exit_forced_by_classifier_bias(setup, monkeypatch):
    import tps_pp_tpu.ops.pallas_full_decode as pfd
    orig = pfd.full_greedy_decode
    monkeypatch.setattr(pfd, 'full_greedy_decode',
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    jdec, v, _, out_enc, vr, ref = setup
    # random weights rarely emit END: with the exit on, nothing changes
    assert not (ref.argmax(-1) == END).any(axis=1).all()
    dec = _port(v)
    np.testing.assert_array_equal(_fused(dec, out_enc, vr, END),
                                  _fused(dec, out_enc, vr))
    # EOS everywhere at step 0: one step runs, the rest read back as zeros
    b = v['params']['classifier']['bias'].copy()
    b[END] += 100.0
    v_eos = jax.tree.map(lambda x: x, v)
    v_eos['params']['classifier'] = dict(v['params']['classifier'], bias=b)
    dec = _port(v_eos)
    got = _fused(dec, out_enc, vr, END)
    full = _fused(dec, out_enc, vr)
    assert (got.argmax(-1)[:, 0] == END).all()
    np.testing.assert_allclose(got[:, 0], full[:, 0], atol=1e-6, rtol=1e-6)
    assert np.all(got[:, 1:] == 0.0)
    want = np.asarray(jdec.apply(jnp_tree(v_eos), None, jnp.asarray(out_enc),
                                 jnp.asarray(vr), method='fused_full_decode',
                                 enc_dtype='bfloat16', end_idx=END))
    assert np.all(want[:, 1:] == 0.0)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=5e-2)
    # the module path stops the same way
    with torch.no_grad():
        steps = greedy_decode(dec, torch.from_numpy(out_enc),
                              torch.from_numpy(vr), max_seq_len=S,
                              start_idx=1, end_idx=END).numpy()
    np.testing.assert_allclose(steps, got, atol=1e-5, rtol=0)


# the whole decode at SATRN-small's head width (d_model 256, 8 heads of 32)
# and over more than 256 source tokens (NRTR on ResNet31 1by8: 320)
WIDER = {'dk32': (dict(d_embedding=256, d_model=256, n_head=8, d_k=32,
                       d_v=32, d_inner=512), 16),
         'te300': ({}, 300)}


@pytest.fixture(scope='module', params=list(WIDER))
def wider(request):
    """(JAX decoder, its variables, the port's decoder, encoder output,
    valid ratios, JAX steps probabilities) at one of the ``WIDER`` shapes:
    two layers, S steps, three rows."""
    dims, TE = WIDER[request.param]
    dims = dict(DIMS, **dims)
    D = dims.get('d_model', 512)
    rng = np.random.default_rng(1)
    jdec = JaxDecoder(**dims, dtype=jnp.float32)
    out_enc = rng.standard_normal((3, TE, D)).astype(np.float32)
    vr = np.array([0.7, 1.0, 0.45], np.float32)
    v = to_numpy(jdec.init(jax.random.PRNGKey(1), None, jnp.asarray(out_enc),
                           targets=jnp.full((3, S), 38, jnp.int32),
                           valid_ratio=jnp.asarray(vr)))
    sd = convert_rules({'params': {'decoder': v['params']}},
                       nrtr_decoder_rules(DIMS['n_layers']))
    sd = {k[len('decoder.'):]: t for k, t in sd.items()}
    sd['position_enc.position_table'] = torch.from_numpy(
        sinusoid_position_table(200, D))
    dec = NRTRDecoder(**dims).eval()
    dec.load_state_dict(sd, strict=True)
    jv = jnp_tree(v)
    carry, static = jdec.apply(jv, None, jnp.asarray(out_enc),
                               jnp.asarray(vr), method='decode_init')
    tok, ref = jnp.full((3,), 1, jnp.int32), []
    for t in range(S):
        p, carry = jdec.apply(jv, tok, t, carry, static,
                              method='decode_step')
        ref.append(np.asarray(p))
        tok = jnp.argmax(p, -1).astype(jnp.int32)
    return jdec, v, dec, out_enc, vr, np.stack(ref, axis=1)


def test_fused_path_matches_jax_steps_wider(wider):
    """d_k 32 and 300 source tokens, which kernels 4-5 now take: as
    ``test_fused_path_matches_jax_steps``."""
    _, _, dec, out_enc, vr, ref = wider
    got = _fused(dec, out_enc, vr)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('enc_dtype', ['bfloat16', 'int8'])
def test_fused_path_matches_pallas_kernel_wider(wider, monkeypatch,
                                                enc_dtype):
    """The plain version against the Pallas decode in interpret mode at d_k
    32 and at 300 source tokens, both K/V types, at the JAX kernel's
    contract (argmax equal, atol 2e-2 / rtol 5e-2); int8 with one scale per
    (layer, K or V, head), groups of d_k columns."""
    _interpret(monkeypatch)
    jdec, v, dec, out_enc, vr, _ = wider
    want = np.asarray(jdec.apply(jnp_tree(v), None, jnp.asarray(out_enc),
                                 jnp.asarray(vr), method='fused_full_decode',
                                 enc_dtype=enc_dtype))
    got = _fused(dec, out_enc, vr, enc_dtype=enc_dtype)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=5e-2)


def test_rows_without_valid_tokens_start_finished():
    """A row whose source mask is all invalid counts as finished from the
    start: with no valid row at all, the exit fires before step 0."""
    dec = NRTRDecoder(**DIMS).eval()
    out_enc = torch.randn(3, 16, 512, generator=torch.Generator()
                          .manual_seed(1))
    mask = torch.zeros((3, 16))
    w = dec.packed_weights(torch.float32)
    with torch.no_grad():
        got = full_decode(out_enc, mask, w, 8, 1, END)
        ran = full_decode(out_enc, mask, w, 8, 1, None)
    assert bool((got == 0).all())
    assert bool((ran.sum(-1) > 0.99).all())


def test_bf16_ulp_step_moves_every_value_by_one_ulp():
    """The encoding that sets kernel 4's near-tie width on the card: every
    bf16 value one ulp up or down (its bits one apart), zeros off 0, none
    to inf or NaN, both ways taken, and the same steps from the same
    seed."""
    t = torch.randn(4, 40, 512, generator=torch.Generator().manual_seed(2))
    t = t.to(torch.bfloat16)
    t[0, 0, :3] = torch.tensor([0.0, -0.0, -1.0])
    got = chip_smoke.bf16_ulp_step(t, 0)
    bits = (got.view(torch.int16).int() - t.view(torch.int16).int()).abs()
    assert bool((bits == 1).all())
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got.float() != 0).all())
    up = got.float().abs() > t.float().abs()
    assert 0.4 < float(up.float().mean()) < 0.6
    assert torch.equal(chip_smoke.bf16_ulp_step(t, 0).view(torch.int16),
                       got.view(torch.int16))
