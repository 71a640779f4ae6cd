"""The image-space preprocessors MORAN and SPIN in the port against the JAX
package on the CPU, alone and in front of a recognizer: MORAN (``enhance``
0 and 2) and SPIN (offsets on and off), outputs and the input gradient
through the plain grid-sample VJP; CRNN + MORAN
(``crnn_academic_dataset.py`` with the preprocessor) at full width and a
small ABINet + SPIN through ``predict`` / ``simple_test`` /
``compute_loss``; the weight rules and their round trip; the repairs
(``rules_for_config`` dispatching on the preprocessor's type, ABINet's
preprocessor slot). Inputs are made from seeds with numpy.

MORAN's warp multiplies a y-coordinate error by (H - 1) / 2 times the
crop's row difference (~100 on a random crop): float32 offsets that part
by one rounding (its conv sums in another order) move the output by
~5e-4 at a few pixels, JAX's as much as the port's. So each preprocessor
is held in float64 (JAX under ``jax.enable_x64``), where the port takes
JAX's sampler convention (float32 coordinates, the gather + lerp of
``ops.grid_sample._gather_lerp``, which the plain VJP differentiates) in
place of ATen's forward: outputs and input gradients within 1e-10; and in
float32 as shipped against those float64 values, as close as JAX's
float32 values are (``check_preprocessor``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import load_sub, perturb_batch_stats

import tps_pp_tpu.models.decoders.abi as jabi_dec
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.config import load_config as jax_load_config
from tps_pp_tpu.models.rectifiers.moran import MORAN as JaxMORAN
from tps_pp_tpu.models.rectifiers.spin import SPIN as JaxSPIN
from tps_pp_tpu.models.rectifiers.spin import generate_beta as jax_beta
from tps_pp_tpu.models.transformer import PositionalEncoding as JaxPE
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import ABINetRecognizer, build_recognizer
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.models.rectifiers import MORAN, SPIN, generate_beta
from tps_pp_tpu_torch.ops import grid_sample as gs
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import rules_for_config, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN_CFG = 'configs/textrecog/crnn/crnn_academic_dataset.py'
MORAN_CFG = dict(type='MORAN', num_img_channel=1, img_size=(32, 100))


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run, as every test
    module has them, set here and not at import (ROADMAP queue 3: torch's
    oneDNN corrupts the heap at 3 or more in a channels-last conv
    backward), and the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def load_pre(module, variables, rules):
    """The JAX preprocessor's own variables into the port's ``module``."""
    return load_sub(module, variables, rules, 'preprocessor', 'preprocessor')


def jax_out_and_grad(jm, v, x, cot, train=False):
    """JAX's output, d(sum(out * cot)) / dx and the batch statistics."""
    jv = jax.tree.map(jnp.asarray, v)

    @jax.jit
    def run(xx, cc):
        def f(x_):
            out, state = jm.apply(jv, x_, train=train,
                                  mutable=['batch_stats'])
            return jnp.sum(out * cc), (out, state)
        return jax.value_and_grad(f, has_aux=True)(xx)
    (_, (out, state)), dx = run(jnp.asarray(x), jnp.asarray(cot))
    return np.asarray(out), np.asarray(dx), jax.tree.map(np.asarray, state)


def port_out_and_grad(m, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def running_stats(state, rules):
    """The running statistics of a JAX preprocessor's batch statistics as
    the port's names (without the ``preprocessor.`` prefix)."""
    out = {}
    for tp, fp, kind in rules:
        if kind == 'bn':
            node = state['batch_stats'][fp.split('/')[1]]
            t = tp[len('preprocessor.'):]
            out[f'{t}.running_mean'] = np.asarray(node['mean'])
            out[f'{t}.running_var'] = np.asarray(node['var'])
    return out


def check_preprocessor(make_jax, make_port, rules, v, x, cot, monkeypatch):
    """Eval and train mode. Float64 on both sides (JAX under x64, the
    port's plain sampler on JAX's convention): the output and the input
    gradient within 1e-10 (of the gradient's largest), the running
    statistics within 1e-10. Float32 as shipped: each of the three no
    farther from the float64 values than 3x JAX's float32 ones are, or
    within 1e-5 (of the gradient's largest)."""
    v64 = jax.tree.map(lambda a: a.astype(np.float64), v)
    x64, cot64 = x.astype(np.float64), cot.astype(np.float64)
    for train in (False, True):
        with jax.enable_x64(True):
            ref, ref_dx, ref_state = jax_out_and_grad(
                make_jax(jnp.float64), v64, x64, cot64, train)
        j32, j32_dx, j32_state = jax_out_and_grad(make_jax(jnp.float32), v,
                                                  x, cot, train)
        with monkeypatch.context() as mp:
            mp.setattr(gs, 'grid_sample_plain',
                       lambda img, grid: gs._gather_lerp(img, grid))
            m64 = load_pre(make_port(), v, rules).double().train(train)
            got, dx = port_out_and_grad(m64, x64, cot64)
        scale = np.abs(ref_dx).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
        np.testing.assert_allclose(dx, ref_dx, rtol=0, atol=1e-10 * scale)
        m32 = load_pre(make_port(), v, rules).train(train)
        got, dx = port_out_and_grad(m32, x, cot)
        assert got.dtype == np.float32 and got.shape == ref.shape
        for mine, theirs, want, floor in ((got, j32, ref, 1e-5),
                                          (dx, j32_dx, ref_dx,
                                           1e-5 * scale)):
            err = np.abs(mine - want).max()
            jerr = np.abs(theirs - want).max()
            assert err <= max(3 * jerr, floor), (train, err, jerr)
        if train:
            want = running_stats(ref_state, rules)
            j32_stats = running_stats(j32_state, rules)
            for k, t in m64.state_dict().items():
                if k.endswith(('running_mean', 'running_var')):
                    np.testing.assert_allclose(t.numpy(), want[k], rtol=0,
                                               atol=1e-10, err_msg=k)
                    err = np.abs(m32.state_dict()[k].numpy() - want[k]).max()
                    jerr = np.abs(j32_stats[k] - want[k]).max()
                    assert err <= max(3 * jerr, 1e-5), (k, err, jerr)


# ------------------------------------------------------------------ MORAN --

@pytest.mark.parametrize('enhance,channels', [(0, 1), (2, 3)])
def test_moran_matches_jax(enhance, channels, monkeypatch):
    """Perturbed BatchNorm statistics; a 40 x 90 crop resized to
    32 x 100 by the identity grid (the offsets reach past the border):
    ``check_preprocessor``."""
    x = randn(2, 40, 90, channels, seed=1 + enhance)
    cot = randn(2, 32, 100, channels, seed=2)

    def make_jax(dt):
        return JaxMORAN(num_img_channel=channels, img_size=(32, 100),
                        enhance=enhance, dtype=dt)
    v = perturb_batch_stats(jax.jit(lambda k: make_jax(jnp.float32).init(
        k, jnp.asarray(x)))(jax.random.PRNGKey(enhance)), 3)
    check_preprocessor(make_jax, lambda: MORAN(channels, (32, 100), enhance),
                       convert.moran_rules(), v, x, cot, monkeypatch)


def test_moran_offset_map_is_pooled_valid():
    """The offset net's map at 32 x 100: 4 x 12, pooled (2, stride 1,
    no padding) to 3 x 11, which kernel 8 samples up to 32 x 100."""
    m = MORAN(1, (32, 100)).eval()
    with torch.no_grad():
        assert tuple(m.offset_net(torch.zeros(2, 32, 100, 1)).shape) == \
            (2, 3, 11, 1)


# ------------------------------------------------------------------- SPIN --

@pytest.mark.parametrize('offsets', [True, False])
def test_spin_matches_jax(offsets, monkeypatch):
    """Perturbed BatchNorm statistics, fc2 drawn at random (at its
    reference init the transform is near the identity), 32 x 128 RGB
    crops: ``check_preprocessor`` (``fc1_bn1d``'s statistics too)."""
    assert generate_beta(6) == jax_beta(6) and len(generate_beta(6)) == 13
    x = randn(3, 32, 128, 3, seed=6)
    cot = randn(3, 32, 128, 3, seed=7)

    def make_jax(dt):
        return JaxSPIN(offsets=offsets, dtype=dt)
    v = perturb_batch_stats(jax.jit(lambda k: make_jax(jnp.float32).init(
        k, jnp.asarray(x)))(jax.random.PRNGKey(2)), 5)
    fc2 = v['params']['fc2']
    fc2['kernel'] = np.random.default_rng(8).normal(
        0, 0.3, fc2['kernel'].shape).astype(np.float32)
    check_preprocessor(make_jax, lambda: SPIN(offsets=offsets),
                       convert.spin_rules(offsets), v, x, cot, monkeypatch)


def test_spin_keeps_the_channel_broadcast_and_the_reference_init():
    """A one-channel crop comes out with three channels, as in JAX (the
    three-value mean and std broadcast over the last axis); fc2 starts at
    zero weights and the bias [0] * 12 + [5, -5], as JAX's init."""
    x = randn(2, 32, 64, 1, seed=9)
    jm = JaxSPIN(input_channel=1)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = load_pre(SPIN(input_channel=1), v, convert.spin_rules()).eval()
    got = m(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 32, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    bias = SPIN().fc2.bias.detach().numpy()
    np.testing.assert_array_equal(bias, [0] * 12 + [5, -5])
    np.testing.assert_array_equal(v['params']['fc2']['bias'], bias)
    assert not v['params']['fc2']['kernel'].any()


# ------------------------------------------------------- in a recognizer --

def crnn_moran_cfg():
    cfg = dict(load_config(os.path.join(REPO, CRNN_CFG))['model'])
    assert cfg == dict(jax_load_config(os.path.join(REPO, CRNN_CFG))['model'])
    return dict(cfg, preprocessor=dict(MORAN_CFG))


def small_abinet_spin_cfg():
    """A small ABINet (ResNetABI of width 4, one encoder layer, one
    language layer, two rounds, d_model 64) behind SPIN."""
    return dict(
        type='ABINet',
        label_convertor=dict(type='ABIConvertor', dict_type='DICT36',
                             with_unknown=False, with_padding=False,
                             lower=True),
        preprocessor=dict(type='SPIN'),
        backbone=dict(type='ResNetABI', stem_channels=4, base_channels=4,
                      arch_settings=[1, 1, 1, 1, 1],
                      strides=[2, 1, 2, 1, 1]),
        encoder=dict(
            type='ABIVisionModel',
            encoder=dict(type='TransformerEncoder', n_layers=1, n_head=2,
                         d_model=64, d_inner=64, dropout=0.0,
                         max_len=8 * 16),
            decoder=dict(type='ABIVisionDecoder', in_channels=64,
                         num_channels=16, attn_height=8, attn_width=16)),
        decoder=dict(type='ABILanguageDecoder', d_model=64, n_head=2,
                     d_inner=64, n_layers=1, dropout=0.0,
                     detach_tokens=True, use_self_attn=False),
        fuser=dict(type='ABIFuser', d_model=64),
        loss=dict(type='ABILoss'), max_seq_len=8, iter_size=2)


def _jax_and_port(cfg, shape, seed, perturb_fc2=False):
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(lambda k: jrec.init_variables(
        k, shape))(jax.random.PRNGKey(seed)), seed)
    if perturb_fc2:
        fc2 = v['params']['preprocessor']['fc2']
        fc2['kernel'] = np.random.default_rng(seed).normal(
            0, 0.3, fc2['kernel'].shape).astype(np.float32)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    return jrec, v, rec


def test_crnn_moran_matches_jax_end_to_end():
    """``crnn_academic_dataset.py`` with MORAN at full width: logits
    (N, 26, 37) within 1e-3 (MORAN's amplified float32 rounding through
    the VGG and two BiLSTMs; their argmax equal) and ``simple_test``'s
    texts equal; ``compute_loss`` in train mode within 1e-4 relative."""
    cfg = crnn_moran_cfg()
    jrec, v, rec = _jax_and_port(cfg, (1, 32, 100, 1), 6)
    assert isinstance(rec.model.preprocessor, MORAN)
    img = randn(3, 32, 100, 1, seed=10)
    vr = np.array([1.0, 0.5, 0.8], np.float32)
    jv = jax.tree.map(jnp.asarray, v)
    want = np.asarray(jrec.predict(jv, jnp.asarray(img), jnp.asarray(vr)))
    got = rec.predict(img, vr).numpy()
    assert got.shape == want.shape == (3, 26, 37)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert [r['text'] for r in rec.simple_test(img, vr)] == \
        [r['text'] for r in jrec.simple_test(jv, jnp.asarray(img),
                                             jnp.asarray(vr))]
    td = rec.label_convertor.str2tensor(['ab', 'hello', 'x7'])
    batch = dict(img=img, valid_ratio=vr,
                 padded_targets=td['padded_targets'],
                 target_lengths=td['target_lengths'])
    wl = float(jrec.compute_loss(jv, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))[0])
    gl, _ = rec.compute_loss(batch)
    assert abs(float(gl.detach()) - wl) <= 1e-4 * abs(wl)
    gl.backward()
    assert float(rec.model.preprocessor.conv4.weight.grad.abs().max()) > 0


def test_abinet_spin_matches_jax_end_to_end(monkeypatch):
    """The small ABINet behind SPIN (fc2 random): ``predict``'s logits
    within 1e-4 and argmax equal, ``simple_test``'s texts equal;
    ``compute_loss`` in train mode (every dropout 0, the language
    decoder's token dropout too, as ``tests/test_torch_abinet.py`` sets
    it) within 1e-5 relative, SPIN's gradients reached."""
    monkeypatch.setattr(jabi_dec, 'PositionalEncoding',
                        lambda *a, dropout=0.0, **k: JaxPE(*a, **k))
    cfg = small_abinet_spin_cfg()
    jrec, v, rec = _jax_and_port(cfg, (1, 32, 64, 3), 7, perturb_fc2=True)
    rec.model.decoder.token_encoder.dropout = 0.0
    assert isinstance(rec, ABINetRecognizer)
    assert isinstance(rec.model.preprocessor, SPIN)
    img = randn(2, 32, 64, 3, seed=11)
    vr = np.array([1.0, 0.7], np.float32)
    jv = jax.tree.map(jnp.asarray, v)
    want = np.asarray(jrec.predict(jv, jnp.asarray(img), jnp.asarray(vr)))
    got = rec.predict(img, vr).numpy()
    assert got.shape == want.shape and got.shape[:2] == (2, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert [r['text'] for r in rec.simple_test(img, vr)] == \
        [r['text'] for r in jrec.simple_test(jv, jnp.asarray(img),
                                             jnp.asarray(vr))]
    td = rec.label_convertor.str2tensor(['ab', 'hello'])
    batch = dict(img=img, valid_ratio=vr,
                 padded_targets=td['padded_targets'],
                 target_lengths=td['target_lengths'])
    wl = float(jrec.compute_loss(jv, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))[0])
    gl, _ = rec.compute_loss(batch)
    assert abs(float(gl.detach()) - wl) <= 1e-5 * abs(wl)
    gl.backward()
    assert float(rec.model.preprocessor.fc2.weight.grad.abs().max()) > 0


# -------------------------------------------------------------- weights --

@pytest.mark.parametrize('which', ['crnn_moran', 'abinet_spin',
                                   'abinet_spin_no_offsets'])
def test_preprocessor_weights_round_trip_bit_for_bit(which):
    """``state_dict_from_jax`` of random variables loads strictly, and the
    JAX converter, given the port's rules (JAX has none for MORAN or
    SPIN), gives them back bit for bit."""
    if which == 'crnn_moran':
        cfg, shape = crnn_moran_cfg(), (1, 32, 100, 1)
    else:
        cfg, shape = small_abinet_spin_cfg(), (1, 32, 64, 3)
        if which.endswith('no_offsets'):
            cfg['preprocessor'] = dict(type='SPIN', offsets=False)
    jrec = build_jax(cfg)
    shapes = jax.eval_shape(lambda: jrec.init_variables(
        jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(1)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                     shapes)
    sd = state_dict_from_jax(v, cfg)
    build_recognizer(cfg, device='cpu').model.load_state_dict(sd,
                                                              strict=True)
    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = jtc.filter_rules_to_state(rules_for_config(cfg), sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


# -------------------------------------------------------------- repairs --

def test_rules_for_config_dispatches_on_the_preprocessor_type():
    """Repair: any preprocessor other than the TPS-STN used to get no
    rules and no error. MORAN and SPIN get theirs, the identity none, and
    a type without rules raises a ``ValueError``."""
    cfg = crnn_moran_cfg()
    names = {r[0] for r in rules_for_config(cfg)}
    assert {f'preprocessor.conv{i}' for i in range(5)} <= names
    spin = dict(cfg, preprocessor=dict(type='SPIN', offsets=False))
    names = {r[0] for r in rules_for_config(spin)}
    assert 'preprocessor.fc2' in names and \
        'preprocessor.offset_conv1' not in names
    base = dict(cfg, preprocessor=dict(type='BasePreprocessor'))
    assert not any(r[0].startswith('preprocessor')
                   for r in rules_for_config(base))
    with pytest.raises(ValueError, match="preprocessor type 'Unknown'"):
        rules_for_config(dict(cfg, preprocessor=dict(type='Unknown')))


def test_abinet_builds_and_runs_its_preprocessor():
    """Repair: ``ABINetRecognizer`` raised ``NotImplementedError`` for any
    preprocessor; JAX builds it and runs it before the backbone. MORAN
    and SPIN now build in it, run first (``plain`` reaching them), and
    ``init_weights`` resets SPIN's fc2 to its reference init."""
    cfg = small_abinet_spin_cfg()
    rec = build_recognizer(cfg, device='cpu').init_weights(3)
    pre = rec.model.preprocessor
    assert isinstance(pre, SPIN) and not pre.fc2.weight.any()
    np.testing.assert_array_equal(pre.fc2.bias.detach().numpy(),
                                  [0] * 12 + [5, -5])
    seen = []
    pre.register_forward_hook(lambda m, a, o: seen.append(tuple(o.shape)))
    rec.plain = True
    assert tuple(rec.predict(randn(2, 32, 64, 3)).shape)[:2] == (2, 8)
    assert seen == [(2, 32, 64, 3)]
    moran = build_recognizer(dict(cfg, preprocessor=dict(
        type='MORAN', img_size=(32, 64))), device='cpu').init_weights(0)
    assert isinstance(moran.model.preprocessor, MORAN)
    assert tuple(moran.predict(randn(2, 32, 64, 3)).shape)[:2] == (2, 8)
