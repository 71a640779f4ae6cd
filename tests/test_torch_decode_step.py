"""The port's per-step decode paths against the JAX package, on the CPU, at
the widths of ``tests/test_pallas_decode.py`` (2 layers, d_model 64, 2
heads of 8).

* ``ops.decode_step``'s plain versions against the Pallas kernels
  ``self_attn_step`` / ``cross_ffn_step`` in interpret mode, caches
  included, at several steps: in float32 within 2e-6 absolute (the same
  bf16 operands on both sides; only f32 sums are taken in another order),
  in bf16 within one bf16 ulp of the output (2^-7 relative bounds it).
* The ``steps`` decode with ``use_fused_step=True`` against the JAX one
  (kernels in interpret mode): argmax equal, probabilities within 1e-6.
  Both sides round the same operands to bf16 at the same points, so they
  part only where an f32 sum taken in another order moves a bf16 rounding;
  the JAX package's own fused-vs-unfused bound (atol 2e-3, rtol 5e-2,
  ``tests/test_pallas_decode.py:63``) is for a comparison across those
  roundings.
* The ``steps`` decode with ``kv_dtype='int8'`` against the JAX one, both
  in float32: argmax equal, probabilities within 1e-6 (the same
  quantization on both sides; int8 values part only where f32 noise moves
  x / scale across a rounding boundary).
* ``greedy_decode``'s exit, which reads the all-done flag a few steps
  behind the step it issues, on the fused-step, module and int8 step
  paths, with rows forced to emit EOS at chosen steps: bit-equal to a loop
  that reads the flag after every step (the zeros after the exit step
  included), and to the JAX ``greedy_decode`` (``lax.while_loop``) with
  the same forcing: argmax equal, the same zeros, probabilities within
  1e-5 (int8: 1e-4, an int8 value may sit one step away where f32 noise
  moves x / scale across a rounding boundary, and over 12 steps that
  reaches ~2e-5).
* ``greedy_decode``'s device exit (``device_exit=True``: every step, each
  zeroed on the device where every row ended before it, the flag handed to
  the fused step as ``skip``) on the same paths and schedules: bit-equal to
  the host exit on every row, and to the JAX loop within the tolerances
  above.
* The skipped step of the plain step functions: with ``skip`` set, x_out
  is x and the caches are untouched, bit for bit; with it unset, the step
  is the one without the flag, bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jnp_tree, to_numpy

import tps_pp_tpu.ops.pallas_decode as pd
from tps_pp_tpu.models.decoders.base import greedy_decode as jax_greedy
from tps_pp_tpu.models.decoders.nrtr import NRTRDecoder as JaxDecoder

from tps_pp_tpu_torch.models.decoders import NRTRDecoder, greedy_decode
from tps_pp_tpu_torch.models.transformer import sinusoid_position_table
from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step_plain,
                                              self_attn_step_plain)
from tps_pp_tpu_torch.utils.convert import convert_rules, nrtr_decoder_rules

torch.set_num_threads(2)
S, C = 8, 39
DIMS = dict(n_layers=2, d_embedding=64, n_head=2, d_model=64, d_inner=64,
            d_k=8, d_v=8, num_classes=C, max_seq_len=S, start_idx=1,
            padding_idx=38, dropout=0.0)
N, TE = 4, 16
VR = np.array([0.6, 1.0, 0.8, 1.0], np.float32)


def _interpret(monkeypatch):
    for name in ('self_attn_step', 'cross_ffn_step'):
        monkeypatch.setattr(pd, name, functools.partial(getattr(pd, name),
                                                        interpret=True))


# ------------------------------------------------------------ the kernels

def _step_inputs(dtype, seed=0):
    """numpy inputs of both kernels at the tiny widths; the caches hold
    random values in every slot, so that slots > t must be masked."""
    rng = np.random.default_rng(seed)
    D, H, DK, DI, T = 64, 2, 8, 64, S + 1

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    a = dict(x=r(N, D), ck=r(N, H, T, DK), cv=r(N, H, T, DK),
             wqkv=r(D, 3 * H * DK, scale=D ** -0.5),
             wfc=r(H * DK, D, scale=D ** -0.5), ln_s=1 + r(D, scale=0.2),
             ln_b=r(D, scale=0.2), enc_k=r(N, H, TE, DK),
             enc_v=r(N, H, TE, DK),
             src_mask=(np.arange(TE)[None] < np.ceil(TE * VR)[:, None])
             .astype(np.float32),
             wq=r(D, H * DK, scale=D ** -0.5),
             wfc2=r(H * DK, D, scale=D ** -0.5), ln2_s=1 + r(D, scale=0.2),
             ln2_b=r(D, scale=0.2), w1=r(D, DI, scale=D ** -0.5),
             b1=r(DI, scale=0.1), w2=r(DI, D, scale=DI ** -0.5),
             b2=r(D, scale=0.1), ln3_s=1 + r(D, scale=0.2),
             ln3_b=r(D, scale=0.2))
    a['src_mask'][2] = 0.0          # a row with no valid key: uniform softmax
    act = ('x', 'ck', 'cv', 'enc_k', 'enc_v')
    jx = {k: jnp.asarray(v, jnp.dtype(dtype) if k in act else jnp.float32)
          for k, v in a.items()}
    tt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype) if k in act else torch.float32)
        for k, v in jx.items()}
    return jx, tt


# (atol, rtol) of the kernel checks: float32, and one bf16 ulp in bf16
STEP_TOL = {'float32': (2e-6, 0.0), 'bfloat16': (1e-2, 2 ** -7)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t', [0, 1, S - 1])
def test_self_attn_step_matches_pallas(dtype, t):
    jx, tt = _step_inputs(dtype)
    want_x, want_k, want_v = pd.self_attn_step(
        jx['x'], jx['ck'], jx['cv'], t, jx['wqkv'], jx['wfc'], jx['ln_s'],
        jx['ln_b'], interpret=True)
    ck0 = tt['ck'].clone()
    got_x, got_k, got_v = self_attn_step_plain(
        tt['x'], tt['ck'], tt['cv'], t, tt['wqkv'], tt['wfc'], tt['ln_s'],
        tt['ln_b'])
    assert got_k is tt['ck'] and got_x.dtype == tt['x'].dtype
    atol, rtol = STEP_TOL[dtype]
    np.testing.assert_allclose(got_x.float().numpy(),
                               np.asarray(want_x.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
    for got, want in ((got_k, want_k), (got_v, want_v)):
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        # only slot t is written
        np.testing.assert_array_equal(np.delete(got, t, axis=2),
                                      np.delete(want, t, axis=2))
        np.testing.assert_allclose(got[:, :, t], want[:, :, t], atol=atol,
                                   rtol=rtol)
    assert not torch.equal(ck0[:, :, t], got_k[:, :, t])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('masked', [True, False])
def test_cross_ffn_step_matches_pallas(dtype, masked):
    jx, tt = _step_inputs(dtype, seed=1)
    names = ('wq', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1', 'w2', 'b2', 'ln3_s',
             'ln3_b')
    want = pd.cross_ffn_step(
        jx['x'], jx['enc_k'], jx['enc_v'], jx['src_mask'] if masked else None,
        *(jx[k] for k in names), interpret=True)
    got = cross_ffn_step_plain(
        tt['x'], tt['enc_k'], tt['enc_v'], tt['src_mask'] if masked else None,
        *(tt[k] for k in names))
    assert got.dtype == tt['x'].dtype
    atol, rtol = STEP_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------- the steps decode

def _port(v, max_seq_len=S, **kw):
    sd = convert_rules({'params': {'decoder': v['params']}},
                       nrtr_decoder_rules(DIMS['n_layers']))
    sd = {k[len('decoder.'):]: t for k, t in sd.items()}
    sd['position_enc.position_table'] = torch.from_numpy(
        sinusoid_position_table(200, DIMS['d_embedding']))
    dec = NRTRDecoder(**dict(DIMS, max_seq_len=max_seq_len), **kw).eval()
    dec.load_state_dict(sd, strict=True)
    return dec


@pytest.fixture(scope='module')
def setup():
    rng = np.random.default_rng(0)
    out_enc = rng.standard_normal((N, TE, 64)).astype(np.float32)
    jdec = JaxDecoder(**DIMS, dtype=jnp.float32)
    v = to_numpy(jdec.init(jax.random.PRNGKey(0), None, jnp.asarray(out_enc),
                           targets=jnp.full((N, S), 38, jnp.int32),
                           valid_ratio=jnp.asarray(VR)))
    lns = [v['params']['layer_norm']] + [
        p[n] for k, p in v['params'].items() if k.startswith('layer_stack')
        for n in ('norm1', 'norm2', 'norm3')]
    for ln in lns:
        ln['scale'] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        ln['bias'] = rng.normal(0, 0.2, 64).astype(np.float32)
    return v, out_enc


def _jax_steps(v, out_enc, **kw):
    """The JAX greedy ``steps`` loop (decode_init / decode_step)."""
    jdec = JaxDecoder(**DIMS, dtype=jnp.float32, **kw)
    jv = jnp_tree(v)
    carry, static = jdec.apply(jv, None, jnp.asarray(out_enc),
                               jnp.asarray(VR), method='decode_init')
    tok, ref = jnp.full((N,), 1, jnp.int32), []
    for t in range(S):
        p, carry = jdec.apply(jv, tok, t, carry, static,
                              method='decode_step')
        ref.append(np.asarray(p))
        tok = jnp.argmax(p, -1).astype(jnp.int32)
    return np.stack(ref, axis=1)


def _port_steps(dec, out_enc, plain=False):
    with torch.no_grad():
        return greedy_decode(dec, torch.from_numpy(out_enc),
                             torch.from_numpy(VR), max_seq_len=S,
                             start_idx=1, plain=plain).numpy()


@pytest.mark.parametrize('plain', [False, True])
def test_fused_step_decode_matches_jax(setup, monkeypatch, plain):
    """``plain`` picks the plain versions explicitly; on CPU tensors the
    wrappers take them anyway, so both must agree with JAX."""
    _interpret(monkeypatch)
    v, out_enc = setup
    want = _jax_steps(v, out_enc, use_fused_step=True)
    got = _port_steps(_port(v, use_fused_step=True), out_enc, plain)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and the fused step is the unfused step's function
    np.testing.assert_allclose(got, _port_steps(_port(v), out_enc),
                               atol=2e-3, rtol=5e-2)


def test_int8_kv_decode_matches_jax(setup):
    v, out_enc = setup
    want = _jax_steps(v, out_enc, kv_dtype='int8')
    got = _port_steps(_port(v, kv_dtype='int8'), out_enc)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # int8 moves the probabilities away from the unquantized decode's
    assert np.abs(got - _port_steps(_port(v), out_enc)).max() > 1e-4


def test_int8_caches_and_scales(setup):
    """decode_init's int8 layout: per-(row, head) encoder scales, per-slot
    cache scales, equal to JAX's after a step (scales to 1e-6 relative;
    an int8 value may sit one step away where f32 noise moves x / scale
    across a rounding boundary)."""
    v, out_enc = setup
    dec = _port(v, kv_dtype='int8')
    jdec = JaxDecoder(**DIMS, dtype=jnp.float32, kv_dtype='int8')
    jv = jnp_tree(v)
    with torch.no_grad():
        carry, (enc, _) = dec.decode_init(torch.from_numpy(out_enc),
                                          torch.from_numpy(VR))
        dec.decode_step(torch.full((N,), 1), 0, carry, (enc, _))
    jcarry, (jenc, _) = jdec.apply(jv, None, jnp.asarray(out_enc),
                                   jnp.asarray(VR), method='decode_init')
    _, jcarry = jdec.apply(jv, jnp.full((N,), 1, jnp.int32), 0, jcarry,
                           (jenc, _), method='decode_step')
    for got, want in zip(enc[0] + carry[1], jenc[0] + jcarry[1]):
        want = np.asarray(want)
        assert got.dtype == {np.int8: torch.int8,
                             np.float32: torch.float32}[want.dtype.type]
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                   atol=0 if want.dtype == np.float32 else 1)


def test_fused_step_refuses_int8(setup):
    """As JAX (nrtr.py:171-172): the fused step takes bf16 caches only."""
    v, out_enc = setup
    dec = _port(v, use_fused_step=True, kv_dtype='int8')
    with pytest.raises(ValueError, match='int8'):
        _port_steps(dec, out_enc)
    with pytest.raises(AssertionError, match='int8'):
        _jax_steps(v, out_enc, use_fused_step=True, kv_dtype='int8')


# ---------------------------------------------------------- the loop's exit
EXIT_S, END = 12, 37     # steps (7 and the last differ), the EOS class
# step at which each row is forced to emit EOS (-1: never)
EXIT_SCHEDULES = {'all_at_0': [0, 0, 0, 0], 'last_at_7': [2, 7, 0, 5],
                  'last_at_end': [3, EXIT_S - 1, 6, 1],
                  'never': [2, -1, 4, 0]}
EXIT_PATHS = {'fused_step': dict(use_fused_step=True), 'module': {},
              'int8': dict(kv_dtype='int8')}
EXIT_ATOL = {'fused_step': 1e-5, 'module': 1e-5, 'int8': 1e-4}


class _Forced:
    """The decoder's steps, with row n's probabilities replaced by a
    one-hot EOS at step finish[n]."""

    def __init__(self, dec, finish):
        self.dec, self.finish = dec, torch.tensor(finish)

    def decode_init(self, *a):
        return self.dec.decode_init(*a)

    def decode_step(self, token, t, carry, static, plain=False):
        probs, carry = self.dec.decode_step(token, t, carry, static,
                                            plain=plain)
        eos = torch.nn.functional.one_hot(torch.tensor(END), C - 1).float()
        return torch.where((self.finish == t)[:, None], eos, probs), carry


def _every_step_loop(decoder, out_enc, vr, end_idx):
    """The greedy loop that reads the all-done flag after every step."""
    N = out_enc.shape[0]
    carry, static = decoder.decode_init(out_enc, vr)
    token = torch.full((N,), 1, dtype=torch.long)
    done = torch.zeros((N,), dtype=torch.bool)
    out = None
    for t in range(EXIT_S):
        probs, carry = decoder.decode_step(token, t, carry, static)
        if out is None:
            out = probs.new_zeros((N, EXIT_S, probs.shape[-1]))
        out[:, t] = probs
        token = probs.argmax(dim=-1)
        done |= token == end_idx
        if bool(done.all()):
            break
    return out


@pytest.fixture(scope='module')
def jax_exit(setup):
    """{path: jitted (finish (N,) int32) -> the JAX greedy decode with
    end_idx and that forcing}, the Pallas step kernels in interpret mode."""
    v, out_enc = setup
    fns = {}
    for path, kw in EXIT_PATHS.items():
        jdec = JaxDecoder(**dict(DIMS, max_seq_len=EXIT_S),
                          dtype=jnp.float32, **kw)
        jv = jnp_tree(v)

        def run(finish, jdec=jdec, jv=jv):
            def apply(name, *a):
                out = jdec.apply(jv, *a, method=name)
                if name != 'decode_step':
                    return out
                probs, carry = out
                eos = jax.nn.one_hot(END, C - 1, dtype=probs.dtype)
                return jnp.where((finish == a[1])[:, None], eos, probs), carry
            return jax_greedy(apply, None, jnp.asarray(out_enc),
                              jnp.asarray(VR), max_seq_len=EXIT_S,
                              start_idx=1, end_idx=END)
        fns[path] = jax.jit(run)
    return fns


@pytest.mark.parametrize('schedule', list(EXIT_SCHEDULES))
@pytest.mark.parametrize('path', list(EXIT_PATHS))
def test_greedy_decode_exit(setup, jax_exit, path, schedule):
    v, out_enc = setup
    finish = EXIT_SCHEDULES[schedule]
    dec = _Forced(_port(v, max_seq_len=EXIT_S, **EXIT_PATHS[path]), finish)
    with torch.no_grad():
        got = greedy_decode(dec, torch.from_numpy(out_enc),
                            torch.from_numpy(VR), max_seq_len=EXIT_S,
                            start_idx=1, end_idx=END)
        want = _every_step_loop(dec, torch.from_numpy(out_enc),
                                torch.from_numpy(VR), END)
    assert torch.equal(got, want)
    got = got.numpy()
    if max(finish) >= 0 and min(finish) >= 0:
        stop = max(finish)
        assert (got[:, stop + 1:] == 0).all() and (got[:, stop].sum(-1) > 0.99
                                                   ).all()
    with pytest.MonkeyPatch.context() as mp:
        for name in ('self_attn_step', 'cross_ffn_step'):
            mp.setattr(pd, name, functools.partial(getattr(pd, name),
                                                   interpret=True))
        ref = np.asarray(jax_exit[path](jnp.asarray(finish, jnp.int32)))
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(got, ref, atol=EXIT_ATOL[path], rtol=0)


class _ForcedSkip(_Forced):
    """``_Forced`` that takes the device exit's ``skip`` flag and hands it
    to the decoder's step."""
    TAKES_SKIP = True

    def decode_step(self, token, t, carry, static, plain=False, skip=None):
        probs, carry = self.dec.decode_step(token, t, carry, static,
                                            plain=plain, skip=skip)
        eos = torch.nn.functional.one_hot(torch.tensor(END), C - 1).float()
        return torch.where((self.finish == t)[:, None], eos, probs), carry


@pytest.mark.parametrize('schedule', list(EXIT_SCHEDULES))
@pytest.mark.parametrize('path', list(EXIT_PATHS))
def test_greedy_device_exit(setup, jax_exit, path, schedule):
    v, out_enc = setup
    finish = EXIT_SCHEDULES[schedule]
    dec = _port(v, max_seq_len=EXIT_S, **EXIT_PATHS[path])
    kw = dict(max_seq_len=EXIT_S, start_idx=1, end_idx=END)
    enc, vr = torch.from_numpy(out_enc), torch.from_numpy(VR)
    with torch.no_grad():
        host = greedy_decode(_Forced(dec, finish), enc, vr, **kw)
        got = greedy_decode(_ForcedSkip(dec, finish), enc, vr,
                            device_exit=True, **kw)
    assert torch.equal(got, host)
    got = got.numpy()
    with pytest.MonkeyPatch.context() as mp:
        for name in ('self_attn_step', 'cross_ffn_step'):
            mp.setattr(pd, name, functools.partial(getattr(pd, name),
                                                   interpret=True))
        ref = np.asarray(jax_exit[path](jnp.asarray(finish, jnp.int32)))
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(got, ref, atol=EXIT_ATOL[path], rtol=0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_skipped_step_plain(setup, dtype):
    """The plain step functions under ``skip``: set, x passes through and
    the caches keep every slot; unset, the step without the flag."""
    v, out_enc = setup
    dt = getattr(torch, dtype)
    dec = _port(v, use_fused_step=True)
    (sa_w, cf_w), = dec._step_layer_args()[:1]
    g = torch.Generator().manual_seed(3)
    x = torch.randn((N, 64), generator=g).to(dt)
    ck, cv = (torch.randn((N, 2, S + 1, 8), generator=g).to(dt)
              for _ in range(2))
    ek, ev = (torch.randn((N, 2, TE, 8), generator=g).to(dt)
              for _ in range(2))
    mask = torch.from_numpy((np.arange(TE)[None] < VR[:, None] * TE
                             ).astype(np.float32))
    t = 3
    for skip in (True, False):
        flag = torch.tensor(skip)
        a = [c.clone() for c in (ck, cv)]
        b = [c.clone() for c in (ck, cv)]
        got, _, _ = self_attn_step_plain(x, *a, t, *sa_w, flag)
        want, _, _ = self_attn_step_plain(x, *b, t, *sa_w)
        got2 = cross_ffn_step_plain(x, ek, ev, mask, *cf_w, flag)
        want2 = cross_ffn_step_plain(x, ek, ev, mask, *cf_w)
        if skip:
            assert torch.equal(got, x) and torch.equal(got2, x)
            assert torch.equal(a[0], ck) and torch.equal(a[1], cv)
            assert not torch.equal(want, x)
        else:
            assert torch.equal(got, want) and torch.equal(got2, want2)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
