"""The port's beam search and the recognizer keys that steer its decodes,
against the JAX package on the CPU, in float32.

* ``beam_decode`` against the JAX ``beam_decode`` on a tiny NRTR decoder
  (2 layers, d_model 64) with the JAX weights carried across: over batch
  sizes, beam widths and ``length_norm``, the best beam's tokens (the
  argmax of the output) equal and the output within 1e-5; the same with
  int8 caches (``kv_dtype='int8'``, 4-tuple carries) and with
  ``use_fused_step`` (the JAX step kernels in interpret mode, the port's
  plain versions on the CPU).
* ``TextRecognizer`` with ``beam_width=3`` on the tiny flagship against the
  JAX recognizer on the same weights, and its decode mode: ``'steps'``
  whatever the fused mode asked for.
* ``fused_early_exit=False`` with EOS forced through the classifier bias:
  the whole decodes keep every step (equal to ``early_exit=False``), the
  default zeroes the steps after the stop, and ``steps`` still exits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (jax_flagship, jax_recognizer, jnp_tree,
                             port_from_jax, to_numpy)

import tps_pp_tpu.ops.pallas_decode as pd
from tps_pp_tpu.models.decoders.base import beam_decode as jax_beam
from tps_pp_tpu.models.decoders.nrtr import NRTRDecoder as JaxDecoder

from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.models.decoders import NRTRDecoder, beam_decode
from tps_pp_tpu_torch.models.transformer import sinusoid_position_table
from tps_pp_tpu_torch.utils.convert import convert_rules, nrtr_decoder_rules

torch.set_num_threads(2)
S, C = 8, 39
DIMS = dict(n_layers=2, d_embedding=64, n_head=2, d_model=64, d_inner=64,
            d_k=8, d_v=8, num_classes=C, max_seq_len=S, start_idx=1,
            padding_idx=38, dropout=0.0)
TE = 16
VR = np.array([0.6, 1.0, 0.8], np.float32)


def _port(v, **kw):
    sd = convert_rules({'params': {'decoder': v['params']}},
                       nrtr_decoder_rules(DIMS['n_layers']))
    sd = {k[len('decoder.'):]: t for k, t in sd.items()}
    sd['position_enc.position_table'] = torch.from_numpy(
        sinusoid_position_table(200, DIMS['d_embedding']))
    dec = NRTRDecoder(**DIMS, **kw).eval()
    dec.load_state_dict(sd, strict=True)
    return dec


@pytest.fixture(scope='module')
def setup():
    """JAX decoder weights (numpy) with non-trivial LayerNorm affines, and
    an encoder output of 3 rows."""
    rng = np.random.default_rng(0)
    out_enc = rng.standard_normal((3, TE, 64)).astype(np.float32)
    jdec = JaxDecoder(**DIMS, dtype=jnp.float32)
    v = to_numpy(jdec.init(jax.random.PRNGKey(0), None, jnp.asarray(out_enc),
                           targets=jnp.full((3, S), 38, jnp.int32),
                           valid_ratio=jnp.asarray(VR)))
    lns = [v['params']['layer_norm']] + [
        p[n] for k, p in v['params'].items() if k.startswith('layer_stack')
        for n in ('norm1', 'norm2', 'norm3')]
    for ln in lns:
        ln['scale'] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        ln['bias'] = rng.normal(0, 0.2, 64).astype(np.float32)
    return v, out_enc


def _jax_beam(v, out_enc, vr, W, length_norm, **kw):
    jdec = JaxDecoder(**DIMS, dtype=jnp.float32, **kw)
    jv = jnp_tree(v)

    def apply(name, *a):
        return jdec.apply(jv, *a, method=name)
    return np.asarray(jax_beam(apply, None, jnp.asarray(out_enc),
                               jnp.asarray(vr), max_seq_len=S, start_idx=1,
                               beam_width=W, length_norm=length_norm))


def _port_beam(dec, out_enc, vr, W, length_norm, return_ranking=False):
    with torch.no_grad():
        got = beam_decode(dec, torch.from_numpy(out_enc),
                          torch.from_numpy(vr), max_seq_len=S, start_idx=1,
                          beam_width=W, length_norm=length_norm,
                          return_ranking=return_ranking)
    if return_ranking:
        return tuple(x.numpy() for x in got)
    return got.numpy()


def _assert_same_beam(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('length_norm', [False, True])
@pytest.mark.parametrize('W', [3, 5])
@pytest.mark.parametrize('n', [1, 3])
def test_beam_decode_matches_jax(setup, n, W, length_norm):
    v, out_enc = setup
    want = _jax_beam(v, out_enc[:n], VR[:n], W, length_norm)
    got, totals, cut = _port_beam(_port(v), out_enc[:n], VR[:n], W,
                                  length_norm, return_ranking=True)
    _assert_same_beam(got, want)
    # one score a step, at the best beam's token; the best beam's total is
    # the sum of its step scores; the cut's margins are the ranking's gaps
    assert ((got > 0).sum(-1) == 1).all()
    assert totals.shape == (n, W) and cut.shape == (n, S)
    np.testing.assert_allclose(totals[:, 0], got.sum((1, 2)), rtol=1e-5)
    assert (cut >= 0).all() and (cut[:, 1:] > 0).any()
    if not length_norm:
        assert (np.diff(totals, axis=1) <= 0).all()


@pytest.mark.parametrize('path', ['int8', 'fused_step'])
def test_beam_decode_other_steps_match_jax(setup, monkeypatch, path):
    """The 4-tuple int8 caches and the fused step's caches are reindexed by
    parent beam as the 2-tuple ones are."""
    for name in ('self_attn_step', 'cross_ffn_step'):
        monkeypatch.setattr(pd, name, functools.partial(getattr(pd, name),
                                                        interpret=True))
    v, out_enc = setup
    kw = (dict(kv_dtype='int8') if path == 'int8'
          else dict(use_fused_step=True))
    want = _jax_beam(v, out_enc, VR, 3, False, **kw)
    got = _port_beam(_port(v, **kw), out_enc, VR, 3, False)
    _assert_same_beam(got, want)


def test_beam_reindex_copies_the_caches(setup):
    """A cache of the carry after the reindex is a new tensor: a step that
    writes slot t in place never reaches the parent's cache."""
    v, out_enc = setup
    dec = _port(v)
    seen = []

    class Spy:
        def decode_init(self, *a):
            return dec.decode_init(*a)

        def decode_step(self, token, t, carry, static, plain=False):
            seen.append([c.data_ptr() for pair in carry for c in pair])
            return dec.decode_step(token, t, carry, static, plain=plain)
    with torch.no_grad():
        beam_decode(Spy(), torch.from_numpy(out_enc), torch.from_numpy(VR),
                    max_seq_len=3, start_idx=1, beam_width=3)
    for before, after in zip(seen, seen[1:]):
        assert not set(before) & set(after)


@pytest.fixture(scope='module')
def tiny():
    jrec, v, cfg = jax_flagship(tiny=True, seed=2)
    img = np.random.default_rng(2).standard_normal((3, 32, 64, 3)).astype(
        np.float32)
    return jrec, v, cfg, img


def test_recognizer_beam_width_matches_jax(tiny):
    _, v, cfg, img = tiny
    vr = VR
    jrec = jax_recognizer(dict(cfg, beam_width=3))
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(vr)))
    rec = port_from_jax(cfg, v, beam_width=3, decode_mode='fused40_bf16')
    assert rec.beam_width == 3 and rec.resolved_decode_mode() == 'steps'
    got = rec.predict(img, vr).numpy()
    _assert_same_beam(got, want)
    # the greedy decode reads other tokens on some row
    greedy = port_from_jax(cfg, v).predict(img, vr).numpy()
    assert not np.array_equal(got, greedy)


@pytest.mark.parametrize('mode', ['fused40_bf16', 'fused40', 'auto'])
def test_beam_width_resolves_to_steps(mode):
    """As JAX (:150-165): a beam search runs the steps loop whatever the
    mode; ``beam_length_norm`` is read with it."""
    cfg = nrtr_tps_pp_cfg(tiny=True)
    rec = build_recognizer(dict(cfg, decode_mode=mode, beam_width=3,
                                beam_length_norm=True), device='cpu')
    assert rec.resolved_decode_mode() == 'steps' and rec.beam_length_norm
    assert build_recognizer(dict(cfg, decode_mode=mode), device='cpu') \
        .beam_width == 1


@pytest.fixture(scope='module')
def eos_rec():
    """The tiny flagship on the CPU whose classifier bias makes EOS win at
    step 0 on every row."""
    rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True), device='cpu')
    rec.init_weights(0)
    with torch.no_grad():
        rec.model.decoder.classifier.bias[rec.label_convertor.end_idx] += \
            100.0
    img = np.random.default_rng(3).standard_normal((4, 32, 64, 3)).astype(
        np.float32)
    return rec, img


@pytest.mark.parametrize('mode', ['fused40_bf16', 'fused40'])
def test_fused_early_exit_off_keeps_every_step(eos_rec, mode):
    rec, img = eos_rec
    rec.decode_mode = mode
    try:
        rec.early_exit, rec.fused_early_exit = True, True
        stopped = rec.predict(img).numpy()
        rec.fused_early_exit = False
        kept = rec.predict(img).numpy()
        rec.early_exit, rec.fused_early_exit = False, True
        no_exit = rec.predict(img).numpy()
    finally:
        rec.decode_mode, rec.early_exit, rec.fused_early_exit = (
            'auto', True, True)
    end = rec.label_convertor.end_idx
    assert (stopped.argmax(-1)[:, 0] == end).all()
    assert np.all(stopped[:, 1:] == 0.0)
    np.testing.assert_array_equal(kept, no_exit)
    assert (np.abs(kept[:, 1:]).sum(-1) > 0.99).all()
    np.testing.assert_array_equal(kept[:, 0], stopped[:, 0])


def test_fused_early_exit_off_leaves_steps_exit(eos_rec):
    rec, img = eos_rec
    rec.decode_mode = 'steps'
    try:
        exits = rec.predict(img).numpy()
        rec.fused_early_exit = False
        still = rec.predict(img).numpy()
    finally:
        rec.decode_mode, rec.fused_early_exit = 'auto', True
    np.testing.assert_array_equal(still, exits)
    assert np.all(still[:, 1:] == 0.0)
    assert build_recognizer(dict(nrtr_tps_pp_cfg(tiny=True),
                                 fused_early_exit=False),
                            device='cpu').fused_early_exit is False
