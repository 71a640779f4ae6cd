"""The port's CTC family (CRNN, CRNN + TPS-STN) against the JAX package's, on
the CPU in float32, with the JAX weights carried across by
``state_dict_from_jax``.

* ``CTCConvertor``: ``str2tensor`` (round trips, ``lower``, empty strings,
  lengths clamped to ``max_seq_len``) equal to JAX's; ``tensor2idx`` equal,
  with ``valid_ratio`` < 1 and top-k;
* ``CTCLoss``: the loss within 1e-6 relative and its gradient w.r.t. the
  logits within 1e-5 absolute and 2e-5 relative of ``jax.grad`` of JAX's
  (both run float32 recursions over the frames, in other orders), for
  each reduction,
  ``flatten=False``, an empty target, a label longer than T and
  ``zero_infinity`` on an alignment that cannot be made; without
  ``zero_infinity`` such an alignment is ``inf`` here and ~1e5 in JAX (the
  difference the port keeps);
* modules, eval mode unless said, within 1e-5: ``max_pool`` with padding,
  ``BidirectionalLSTM``, ``CRNNDecoder`` (both flags),
  ``LocalizationNetwork``, and ``TPSPreprocessor`` with fc2 perturbed
  (against JAX's warp of the float64 grid; against JAX's own module
  within the bound its float32 grid's rounding gives, see the test);
  ``VeryDeepVgg`` (ReLU and LeakyReLU, and in train mode with its
  BatchNorm statistics) within 1e-5 of its outputs' largest magnitude
  (``close_scaled``: seven convs of up to 4,608-term float32 sums);
* the warp at C = 1 and C = 3: the plain versions against the Pallas
  kernels in interpret mode, exact pixel centres and border ties in
  (``tests/test_torch_grid_sample.py``'s tolerances);
* a small CRNN-TPS (``num_fiducial=6``, 32 x 64 crops): ``compute_loss``
  and its gradients in train mode (in float32 and in float64), and one
  Adadelta step (float64), against JAX;
* weights: the round trip through the JAX package's converter and the
  rule tables, for both configs;
* entry points: ``init_recognizer`` / ``model_inference`` on grayscale
  crops of mixed widths, ``train_recognizer`` with the convertor's
  lengths, the train-then-test CLIs on ``crnn_tps_academic_dataset.py``
  over the toy dataset, and ``build_recognizer`` needing the card unless
  given ``device='cpu'``.

The full-width configs are in ``tests/test_torch_crnn_full.py``.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import perturb_batch_stats

import tps_pp_tpu.apis.recognizer as jax_recognizer
from tps_pp_tpu.apis.inference import init_recognizer as jax_init
from tps_pp_tpu.apis.inference import model_inference as jax_infer
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.convertors.ctc import CTCConvertor as JaxCTCConvertor
from tps_pp_tpu.losses.ctc import CTCLoss as JaxCTCLoss
from tps_pp_tpu.models import layers as jlayers
from tps_pp_tpu.models.backbones.vgg import VeryDeepVgg as JaxVgg
from tps_pp_tpu.models.decoders.crnn import CRNNDecoder as JaxCRNNDecoder
from tps_pp_tpu.models.rectifiers import tps_stn as jstn
from tps_pp_tpu.ops import tps as jtps
from tps_pp_tpu.ops.grid_sample import grid_sample as jgrid_sample
from tps_pp_tpu.ops.pallas_grid_sample import (grid_sample_grad,
                                               grid_sample_grad_img,
                                               grid_sample_pallas)
from tps_pp_tpu.parallel import TrainState
from tps_pp_tpu.parallel import build_optimizer as jbuild_optimizer
from tps_pp_tpu.parallel import make_train_step as jmake_train_step
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import (TextRecognizer, build_recognizer,
                                   init_recognizer, model_inference,
                                   train_recognizer)
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.convertors import CTCConvertor
from tps_pp_tpu_torch.datasets import seeded_rngs
from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
from tps_pp_tpu_torch.losses import CTCLoss
from tps_pp_tpu_torch.models.backbones import VeryDeepVgg
from tps_pp_tpu_torch.models.decoders import CRNNDecoder
from tps_pp_tpu_torch.models.layers import BidirectionalLSTM, max_pool
from tps_pp_tpu_torch.models.rectifiers import TPSPreprocessor
from tps_pp_tpu_torch.ops import grid_sample as tgs
from tps_pp_tpu_torch.ops import tps as ttps
from tps_pp_tpu_torch.parallel import build_optimizer, make_train_step
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import convert_rules, state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN_TPS_CFG = os.path.join(
    REPO, 'configs/textrecog/tps/crnn_tps_academic_dataset.py')
CRNN_CFG = os.path.join(REPO,
                        'configs/textrecog/crnn/crnn_academic_dataset.py')
TOY = os.path.join(REPO, 'tests/data/ocr_toy_dataset')
ATOL = 1e-5


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def close_scaled(got, want, atol=ATOL):
    """Within ``atol`` times the largest magnitude of ``want`` (at least
    1): deep float32 convolutions sum up to 4,608 terms, and two
    implementations' orders part by a few ulps of the activations'
    scale."""
    close(got, want, atol * max(1.0, float(np.abs(np.asarray(want)).max())))


def load_sub(module, variables, rules, fp, tp=''):
    """Load the JAX variables of one module (``{'params', 'batch_stats'}``
    of its subtree) into the port's ``module`` through ``rules``, whose
    flax paths start with ``fp`` and torch names with ``tp``."""
    wrapped = {k: {fp: t} for k, t in variables.items()}
    sd = convert_rules(wrapped, [r for r in rules
                                 if r[1].startswith(fp + '/')])
    cut = len(tp) + 1 if tp else 0
    module.load_state_dict({k[cut:]: t for k, t in sd.items()}, strict=True)
    return module


def jax_init_vars(module, *args, seed=0):
    return perturb_batch_stats(jax.jit(module.init)(
        jax.random.PRNGKey(seed), *args), seed)


def small_cfg():
    """A small CRNN-TPS: ``num_fiducial=6`` over 32 x 64 crops
    (``tests/test_model_families.py:120``'s), the VGG at its only width."""
    return dict(
        type='CRNNNet',
        label_convertor=dict(type='CTCConvertor', dict_type='DICT36',
                             with_unknown=False, lower=True),
        preprocessor=dict(type='TPSPreprocessor', num_fiducial=6,
                          img_size=(32, 64), rectified_img_size=(32, 64),
                          num_img_channel=1),
        backbone=dict(type='VeryDeepVgg', leaky_relu=False,
                      input_channels=1),
        decoder=dict(type='CRNNDecoder', in_channels=512, rnn_flag=True),
        loss=dict(type='CTCLoss'),
        max_seq_len=6)


def perturb_fc2(loc_params, seed=0, scale=0.02):
    """fc2 of the localization network (its params subtree, numpy, changed
    in place) drawn at random, so that the fiducials, and the warp's
    samples, move with the crop."""
    rng = np.random.default_rng(seed)
    fc2 = loc_params['fc2']
    fc2['kernel'] = (scale * rng.standard_normal(fc2['kernel'].shape)
                     ).astype(np.float32)


# ----------------------------------------------------------- convertor --

CONV_KW = dict(dict_type='DICT36', with_unknown=False, lower=True,
               max_seq_len=6)


@pytest.mark.parametrize('kw,strings', [
    (CONV_KW, ['hello', 'a', 'ABC12']),              # lower-cased
    (CONV_KW, ['', 'abcdefghij', '']),               # empty; clamped at 6
    (dict(CONV_KW, with_unknown=True, lower=False), ['aZ!b', 'x']),
    (dict(CONV_KW, dict_type='DICT90', lower=False), ['A-b', '']),
])
def test_ctc_convertor_str2tensor_matches_jax(kw, strings):
    lc, jlc = CTCConvertor(**kw), JaxCTCConvertor(**kw)
    assert lc.idx2char == jlc.idx2char and lc.blank_idx == 0
    assert (lc.num_classes(), lc.unknown_idx) == (jlc.num_classes(),
                                                  jlc.unknown_idx)
    got, want = lc.str2tensor(strings), jlc.str2tensor(strings)
    assert got.keys() == want.keys()
    for k in ('flatten_targets', 'target_lengths', 'padded_targets'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(got['targets'], want['targets']):
        np.testing.assert_array_equal(a, b)
    assert max(got['target_lengths']) <= 6
    # the padded targets as one-hot logits with a blank between frames
    # decode back to the strings (cut at 6)
    n, L = got['padded_targets'].shape
    frames = np.zeros((n, 2 * L), np.int64)
    frames[:, ::2] = got['padded_targets']
    logits = 9.0 * np.eye(lc.num_classes(), dtype=np.float32)[frames]
    idx, _ = lc.tensor2idx(logits)
    expect = [''.join([c if c in lc.char2idx else '<UKN>'
                       for c in (s.lower() if lc.lower else s)][:6])
              for s in strings]
    assert lc.idx2str(idx) == expect


@pytest.mark.parametrize('topk', [1, 3])
def test_ctc_convertor_tensor2idx_matches_jax(topk):
    """Repeats and blanks collapse; ``valid_ratio`` < 1 clips the decode
    to ceil(T * ratio) frames; top-k lists with ``return_topk``."""
    lc, jlc = CTCConvertor(**CONV_KW), JaxCTCConvertor(**CONV_KW)
    logits = randn(4, 26, 37, seed=1, scale=3.0)
    logits[:, ::3, 0] += 6.0                     # blanks between runs
    metas = [{'valid_ratio': r} for r in (1.0, 0.5, 0.33, 0.04)]
    for m in (None, metas):
        for rt in (False, True):
            got = lc.tensor2idx(logits, m, topk=topk, return_topk=rt)
            want = jlc.tensor2idx(logits, m, topk=topk, return_topk=rt)
            assert got == want
    idx, _ = lc.tensor2idx(logits, metas)
    full, _ = lc.tensor2idx(logits)
    assert len(idx[3]) <= 1 and len(idx[1]) < len(full[1])


# ---------------------------------------------------------------- loss --

def _loss_case(texts, T, seed):
    lc = CTCConvertor(**dict(CONV_KW, max_seq_len=8))
    td = lc.str2tensor(texts)
    logits = randn(len(texts), T, 37, seed=seed, scale=2.0)
    return td, logits


def _jax_loss(kw, td, logits, vr):
    loss = JaxCTCLoss(**kw)

    def f(x):
        out = loss(x, {'padded_targets': jnp.asarray(td['padded_targets']),
                       'target_lengths': jnp.asarray(td['target_lengths'])},
                   valid_ratio=None if vr is None else jnp.asarray(vr))
        return out['loss_ctc']
    value = np.asarray(f(jnp.asarray(logits)))
    grad = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(logits)))
    return value, grad


def _port_loss(kw, td, logits, vr):
    x = torch.tensor(logits, requires_grad=True)
    out = CTCLoss(**kw)(x, {
        'padded_targets': torch.from_numpy(td['padded_targets']),
        'target_lengths': torch.from_numpy(td['target_lengths'])},
        valid_ratio=None if vr is None else torch.from_numpy(vr))['loss_ctc']
    out.sum().backward()
    return out.detach().numpy(), x.grad.numpy()


VR5 = np.array([1.0, 0.5, 0.8, 1.0, 0.6], np.float32)
# ceil(12 * ratio) = 12, 5, 10, 6, 3 frames: too few for 'hello' (6 with
# the blank between its l's), for row 3's 8 labels and for 'aab' (4)
VR_SHORT = np.array([1.0, 0.4, 0.8, 0.5, 0.2], np.float32)
TEXTS5 = ['ab', 'hello', '', 'abcdefghijklmnop', 'aab']


@pytest.mark.parametrize('kw,T,vr', [
    (dict(), 12, None),
    (dict(reduction='sum'), 12, None),
    (dict(reduction='none'), 12, None),
    (dict(reduction='none'), 6, None),
    (dict(flatten=False), 26, VR5),
    (dict(flatten=False, reduction='none'), 26, VR5),
    (dict(zero_infinity=True), 12, None),
    (dict(flatten=False, zero_infinity=True, reduction='none'), 12,
     VR_SHORT),
    (dict(flatten=False, zero_infinity=True), 12, VR_SHORT),
])
def test_ctc_loss_and_gradient_match_jax(kw, T, vr):
    """Row 2 is empty (the all-blank alignment); row 3's label is cut to
    the convertor's 8 and, at T=6, clamped to min(L, T) = 6 (a label
    longer than T); row 4 needs a blank between its repeats. With
    ``VR_SHORT`` three rows cannot be aligned in their frames, and
    ``zero_infinity`` zeroes them with their gradients."""
    td, logits = _loss_case(TEXTS5, T, seed=T)
    want, want_g = _jax_loss(kw, td, logits, vr)
    got, got_g = _port_loss(kw, td, logits, vr)
    assert np.isfinite(got).all()
    if vr is VR_SHORT and kw.get('reduction') == 'none':
        assert (got == 0).tolist() == [False, True, False, True, True]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_g, want_g, rtol=2e-5, atol=1e-5)


def test_ctc_loss_unalignable_is_inf_where_jax_saturates():
    """Without ``zero_infinity``, 'aab' in 3 frames cannot be aligned:
    torch (and the reference) give inf, optax ~1e5; the other rows
    agree."""
    td, logits = _loss_case(['ab', 'aab'], 3, seed=3)
    kw = dict(reduction='none')
    want, _ = _jax_loss(kw, td, logits, None)
    got, _ = _port_loss(kw, td, logits, None)
    assert np.isinf(got[1]) and 5e4 <= want[1] < np.inf
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    got_z, got_zg = _port_loss(dict(kw, zero_infinity=True), td, logits,
                               None)
    want_z, want_zg = _jax_loss(dict(kw, zero_infinity=True), td, logits,
                                None)
    assert got_z[1] == want_z[1] == 0.0
    assert not got_zg[1].any() and not want_zg[1].any()
    np.testing.assert_allclose(got_zg, want_zg, rtol=2e-5, atol=1e-5)


# ------------------------------------------------------------- modules --

@pytest.mark.parametrize('window,stride,padding', [
    (2, 2, 0), ((2, 2), (2, 1), (0, 1)), (3, 2, 1)])
def test_max_pool_matches_jax(window, stride, padding):
    x = randn(2, 7, 11, 3, seed=2)
    want = jlayers.max_pool(jnp.asarray(x), window, stride, padding)
    got = max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride,
                   padding).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bidirectional_lstm_matches_jax():
    x = randn(3, 9, 12, seed=3)
    jm = jlayers.BidirectionalLSTM(8, 5)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    rules = [('m.rnn', 'm/fwd', 'lstm'), ('m.rnn', 'm/bwd', 'lstm_reverse'),
             ('m.embedding', 'm/embedding', 'linear')]
    m = load_sub(BidirectionalLSTM(12, 8, 5), v, rules, 'm', 'm')
    assert m.rnn.weight_ih_l0.shape == (32, 12)
    close(m(torch.from_numpy(x)), want)


@pytest.mark.parametrize('leaky', [False, True])
def test_very_deep_vgg_matches_jax(leaky):
    """Eval mode, then train mode: the batch's BatchNorm statistics, the
    output and the running statistics it leaves."""
    x = randn(2, 32, 100, 1, seed=4)
    jm = JaxVgg(leaky_relu=leaky, input_channels=1)
    v = jax_init_vars(jm, jnp.asarray(x), seed=4)
    m = load_sub(VeryDeepVgg(leaky, 1).eval(), v,
                 convert.crnn_rules(), 'backbone', 'backbone')
    want = jm.apply(v, jnp.asarray(x))
    got = m(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 1, 26, 512)
    close_scaled(got, want)
    want, state = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
    m.train()
    close_scaled(m(torch.from_numpy(x)), want)
    stats = convert_rules({'params': {'backbone': v['params']},
                           'batch_stats': {'backbone': jax.tree.map(
                               np.asarray, state['batch_stats'])}},
                          convert.crnn_rules()[:10])
    for k, t in m.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            close_scaled(t, stats[f'backbone.{k}'].numpy())


@pytest.mark.parametrize('rnn_flag', [True, False])
def test_crnn_decoder_matches_jax(rnn_flag):
    feat = randn(3, 1, 26, 64, seed=5)
    jm = JaxCRNNDecoder(in_channels=64, num_classes=37, rnn_flag=rnn_flag)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(feat))
    want = jm.apply(v, jnp.asarray(feat))
    # (the BiLSTMs at the decoder's fixed 256 widths, over 64 channels)
    m = load_sub(CRNNDecoder(64, 37, rnn_flag), v,
                 convert.crnn_rules(rnn_flag), 'decoder', 'decoder')
    if not rnn_flag:
        assert m.decoder.weight.shape == (37, 64, 1, 1)
    assert CRNNDecoder.IS_AUTOREGRESSIVE is False
    got = m(torch.from_numpy(feat))
    assert tuple(got.shape) == want.shape == (3, 26, 37)
    close(got, want)


def _preprocessor(num_fiducial=20, seed=6):
    """(JAX TPSPreprocessor, its variables with fc2 perturbed and
    BatchNorm statistics perturbed, the port's with them, a crop batch)."""
    img = randn(3, 32, 100, 1, seed=seed)
    jm = jstn.TPSPreprocessor(num_fiducial=num_fiducial)
    v = jax_init_vars(jm, jnp.asarray(img), seed=seed)
    perturb_fc2(v['params']['localization'], seed)
    m = load_sub(TPSPreprocessor(num_fiducial).eval(), v,
                 convert.tps_preprocessor_rules(), 'preprocessor',
                 'preprocessor')
    return jm, v, m, img


def test_localization_network_matches_jax():
    jm, v, m, img = _preprocessor()
    sub = {k: t['localization'] for k, t in v.items()}
    want = jstn.LocalizationNetwork(20).apply(sub, jnp.asarray(img))
    got = m.LocalizationNetwork(torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (3, 20, 2)
    close(got, want)
    # the perturbed fc2 moves the fiducials off the reference bias
    bias = m.LocalizationNetwork.localization_fc2.bias.detach()
    assert float((got.detach() - bias.reshape(20, 2)).abs().max()) > 1e-2


def _tps_stn_mats(F, H, W):
    """The float64 (inv_delta_C, [1 | P | P_hat]) of the JAX package's
    builders for F fiducials over an H x W grid."""
    C = jtps.build_C_border(F)
    P = jtps.build_P_minus1_1(W, H)
    return jtps.build_inv_delta_C(C), np.concatenate(
        [np.ones((P.shape[0], 1)), P, jtps.build_P_hat(C, P)], 1)


def _grid64(cp, inv, full, xp=np):
    """The TPS-STN grid ``full @ (inv @ [C'; 0])`` in float64 (numpy, or
    ``jnp`` under ``jax.enable_x64``, where it is differentiable):
    ``build_P_prime_plain``'s function without its float32
    accumulation."""
    Cp = xp.concatenate([cp, xp.zeros((cp.shape[0], 3, 2))], axis=1)
    return xp.einsum('ij,njk->nik', full, xp.einsum('ij,njk->nik', inv, Cp))


def test_tps_preprocessor_matches_jax():
    """The grid: the port's against the float64 grid of JAX's fiducials
    within 1e-6, and the warp of that grid by JAX's ``grid_sample`` within
    1e-5 plus two float32 ulps of 99 (the unnormalized coordinate, which
    ATen rounds in another order than JAX) times the crop's largest step
    between neighbours. The JAX module itself rounds the static matrices
    to float32 and accumulates in float32, and the 23-term sums cancel
    (the entries of ``inv_delta_C`` reach ~90 for a grid in [-1, 1]): its
    grid is off the float64 one by ``gerr`` (~2e-5 here), which moves a
    sample by ``gerr * (size - 1) / 2`` pixels; the outputs then agree
    within that many pixels times the crop's largest step between
    neighbours."""
    jm, v, m, img = _preprocessor()
    sub = {k: t['localization'] for k, t in v.items()}
    cp = np.asarray(jstn.LocalizationNetwork(20).apply(sub,
                                                       jnp.asarray(img)))
    inv, full = _tps_stn_mats(20, 32, 100)
    g64 = _grid64(cp.astype(np.float64), inv, full)
    got_grid = m.grid(torch.from_numpy(img))
    close(got_grid.reshape(3, -1, 2), g64, atol=1e-6)
    want = jgrid_sample(jnp.asarray(img),
                        jnp.asarray(g64.reshape(3, 32, 100, 2), jnp.float32))
    got = m(torch.from_numpy(img))
    assert tuple(got.shape) == (3, 32, 100, 1)
    step = max(float(np.abs(np.diff(img, axis=a)).max()) for a in (1, 2))
    close(got, want, atol=ATOL + 2 * float(np.spacing(np.float32(99))) * step)
    # JAX's module: its float32 grid
    g32 = np.asarray(jtps.build_P_prime_plain(
        jnp.asarray(cp), jnp.asarray(inv, jnp.float32),
        jnp.asarray(full, jnp.float32)))
    gerr = float(np.abs(g32 - g64).max())
    bound = gerr * 99 / 2 * step * 1.01 + ATOL
    close(got, jm.apply(v, jnp.asarray(img)), atol=bound)
    assert bound < 1e-2


def test_tps_math_copies_match_jax():
    """The static builders bit for bit; ``build_P_prime_plain`` in float64
    against the float64 grid within 1e-12, and against the JAX function
    (which accumulates in float32 whatever its inputs) within 1e-6."""
    for f in (20, 6):
        np.testing.assert_array_equal(ttps.build_C_border(f),
                                      jtps.build_C_border(f))
    np.testing.assert_array_equal(ttps.build_P_minus1_1(100, 32),
                                  jtps.build_P_minus1_1(100, 32))
    cp = np.random.default_rng(7).uniform(-1, 1, (2, 6, 2))
    inv, full = _tps_stn_mats(6, 4, 8)
    got = ttps.build_P_prime_plain(*(torch.from_numpy(a)
                                     for a in (cp, inv, full)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _grid64(cp, inv, full),
                               rtol=0, atol=1e-12)
    with jax.enable_x64(True):
        want = np.asarray(jtps.build_P_prime_plain(
            jnp.asarray(cp), jnp.asarray(inv), jnp.asarray(full)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ----------------------------------------------------- the warp, odd C --

def _odd_case(seed, C, N=2, H=9, W=17, Ho=5, Wo=6):
    """img, grid, cot as float32 numpy at C channels: the grid spans
    [-1.3, 1.3], its first row holds interior pixel centres (exact: size
    - 1 is a power of two), its second and third rows border ties."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((N, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (N, Ho, Wo, 2)).astype(np.float32)
    grid[:, 0, :, 0] = 2 * rng.integers(1, W - 1, (N, Wo)) / (W - 1) - 1
    grid[:, 0, :, 1] = 2 * rng.integers(1, H - 1, (N, Wo)) / (H - 1) - 1
    grid[:, 1, :, 0] = rng.choice([-1.0, 1.0], (N, Wo))
    grid[:, 2, :, 1] = rng.choice([-1.0, 1.0], (N, Wo))
    cot = rng.standard_normal((N, Ho, Wo, C)).astype(np.float32)
    return img, grid, cot


@pytest.mark.parametrize('C', [1, 3])
def test_warp_at_odd_channel_counts_matches_pallas(C):
    """Kernels 8, 9 and 10 of the JAX package in interpret mode (blocks
    (1, H*W, C) at any C) against the port's plain versions and wrappers
    on CPU tensors: values 1e-5 / 1e-6, d_img 1e-5, d_grid rtol 1e-4 /
    atol 1e-5."""
    img, grid, cot = _odd_case(8 + C, C)
    H, W = img.shape[1:3]
    ji, jg, jc = (jnp.asarray(a) for a in (img, grid, cot))
    want = np.asarray(grid_sample_pallas(ji, jg, interpret=True))
    want_img, want_grid = (np.asarray(a) for a in grid_sample_grad(
        jg, jc, ji, tile=8, interpret=True))
    want_img10 = np.asarray(grid_sample_grad_img(jg, jc, H, W, tile=8,
                                                 interpret=True))
    ti, tg, tc = (torch.from_numpy(a) for a in (img, grid, cot))
    for got in (tgs.grid_sample_plain(ti, tg), tgs.grid_sample_forward(ti,
                                                                       tg)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for d_img, d_grid in (tgs.grid_sample_grad_plain(tg, tc, ti),
                          tgs.grid_sample_grad(tg, tc, ti)):
        np.testing.assert_allclose(d_img.numpy(), want_img, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(d_grid.numpy(), want_grid, rtol=1e-4,
                                   atol=1e-5)
    for d_img in (tgs.grid_sample_grad_img_plain(tg, tc, H, W),
                  tgs.grid_sample_grad_img(tg, tc, H, W)):
        np.testing.assert_allclose(d_img.numpy(), want_img10, rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------- the small recognizer --

_SMALL_HW = (32, 64)
SMALL_OPT = dict(type='Adadelta', lr=1.0)


def _jax_grid_in_float64(cp, inv_delta_C, P_hat_full):
    """JAX's TPS-STN grid as the port computes it: in float64 from the
    float64 static matrices, rounded once to float32 (JAX's module rounds
    the matrices to float32 and sums in float32, ~1e-5 off; at a sample
    that this moves across a pixel edge the warp's d_grid jumps). For the
    small config's 32 x 64 grid; needs ``jax.enable_x64``."""
    inv, full = _tps_stn_mats(cp.shape[1], *_SMALL_HW)
    assert full.shape == P_hat_full.shape
    return _grid64(cp.astype(jnp.float64), jnp.asarray(inv),
                   jnp.asarray(full), xp=jnp).astype(jnp.float32)


def _jax_loss_grads_step(jrec, v, batch):
    """(loss, gradients and BatchNorm statistics as a port state dict,
    the metrics and the variables after one ``SMALL_OPT`` step) of JAX's
    ``compute_loss`` / ``make_train_step`` in train mode."""
    jv = jax.tree.map(jnp.asarray, v)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params):
        total, (_, state) = jrec.compute_loss(
            dict(jv, params=params), jbatch, jax.random.PRNGKey(0))
        return total, state['batch_stats']

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jv['params'])
    tx, _ = jbuild_optimizer(dict(SMALL_OPT))
    state, metrics = jmake_train_step(jrec, donate=False)(
        TrainState.create(jv, tx), jbatch, jax.random.PRNGKey(0))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    cfg = jrec.cfg
    return (float(loss), state_dict_from_jax(np_tree(dict(
        params=grads, batch_stats=stats)), cfg),
        {k: float(m) for k, m in metrics.items()},
        state_dict_from_jax(np_tree(dict(params=state.params,
                                         batch_stats=state.batch_stats)),
                            cfg))


@pytest.fixture(scope='module')
def small():
    """The small CRNN-TPS (fc2 and BatchNorm statistics perturbed), a
    batch of 4 with its labels, and JAX's loss, gradients and Adadelta
    step: in float32 as the JAX package computes them, and in float64
    (the JAX package's recognizer knows no 'float64', so it is named for
    the call; its float32 islands stay, and its TPS-STN grid is computed
    as the port's, ``_jax_grid_in_float64``)."""
    cfg = small_cfg()
    jrec = build_jax(cfg)
    v = jax.jit(lambda k: jrec.init_variables(k, (1, 32, 64, 1)))(
        jax.random.PRNGKey(2))
    v = perturb_batch_stats(v, 2)
    perturb_fc2(v['params']['preprocessor']['localization'], 2, scale=0.05)
    td = jrec.label_convertor.str2tensor(['ab', 'hello', '', 'x7q'])
    batch = dict(img=randn(4, 32, 64, 1, seed=9),
                 valid_ratio=np.array([1.0, 0.6, 0.8, 1.0], np.float32),
                 padded_targets=td['padded_targets'],
                 target_lengths=td['target_lengths'])
    f32 = _jax_loss_grads_step(jrec, v, batch)
    jdt = jax_recognizer._DTYPES
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jstn.tps_ops, 'build_P_prime_plain',
                   _jax_grid_in_float64)
        mp.setitem(jdt, 'float64', jnp.float64)
        jrec64 = build_jax(dict(cfg, dtype='float64'))
        mp.delitem(jdt, 'float64')
        v64 = jax.tree.map(lambda a: a.astype(np.float64)
                           if a.dtype == np.float32 else a, v)
        f64 = _jax_loss_grads_step(jrec64, v64, dict(
            batch, img=batch['img'].astype(np.float64)))
    return dict(cfg=cfg, v=v, batch=batch, f32=f32, f64=f64)


def _small_port(small, dtype='float32'):
    rec = build_recognizer(dict(small['cfg'], dtype=dtype), device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(small['v'], small['cfg']),
                              strict=True)
    batch = small['batch']
    if dtype == 'float64':
        batch = dict(batch, img=batch['img'].astype(np.float64))
    return rec, batch


def _grad_scale(want, model):
    return max(float(want[n].abs().max()) for n, _ in model.named_parameters())


def test_small_compute_loss_and_gradients_match_jax(small):
    """Train mode (batch BatchNorm statistics in the localization network
    and the VGG, the training warp's d_grid into fc2). float32: the loss
    within 1e-6 relative of JAX's and the BatchNorm statistics within
    1e-5. Gradients, in float64 on both sides: every parameter's within
    rtol 1e-4 and atol 1e-4 x the largest gradient (G). Not tighter: JAX's
    float64 model still rounds the fiducials to float32 and unnormalizes
    the grid in float32, and where that moves a sample across a pixel
    edge the warp's d_grid jumps (measured: 3.9e-5 G at fc2, 1e-7 G or
    less in the VGG and the decoder). In float32 the train-mode VGG alone
    parts from its float64 gradients by up to ~3e-2 of a layer's largest
    gradient in either framework (max pools after train-mode BatchNorm
    over 4 x 1 x 17 values route by float32 near-ties), as
    ``tests/test_torch_train.py`` found for the flagship; so in float32
    each of the port's gradients must be within 3x JAX's float32 distance
    from the float64 ones, or within 1e-2 G (measured: the port 5.3e-3 G
    at fc2, JAX 1.1e-3 G there)."""
    loss32, grads32, _, _ = small['f32']
    _, grads64, _, _ = small['f64']
    rec, batch = _small_port(small)
    total, losses = rec.compute_loss(batch)
    assert set(losses) == {'loss_ctc'}
    assert abs(float(total.detach()) - loss32) <= 1e-6 * abs(loss32)
    total.backward()
    scale = _grad_scale(grads64, rec.model)
    for n, p in rec.model.named_parameters():
        err = float((p.grad.double() - grads64[n]).abs().max())
        jax_err = float((grads32[n].double() - grads64[n]).abs().max())
        assert err <= max(3 * jax_err, 1e-2 * scale), (n, err, jax_err)
    fc2 = rec.model.preprocessor.LocalizationNetwork.localization_fc2
    assert float(fc2.weight.grad.abs().max()) > 1e-3 * scale
    for n, b in rec.model.state_dict().items():
        if n.endswith(('running_mean', 'running_var')):
            close(b, grads32[n].numpy())
    assert not rec.model.training

    rec64, batch64 = _small_port(small, 'float64')
    total64, _ = rec64.compute_loss(batch64)
    total64.backward()
    for n, p in rec64.model.named_parameters():
        assert p.grad.dtype == torch.float64
        np.testing.assert_allclose(p.grad.numpy(), grads64[n].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=n)


def test_small_adadelta_step_matches_jax(small):
    """One step of the configs' ``Adadelta`` at lr 1.0 in float64 (the
    float32 gradients part as the test above says, and Adadelta's first
    step, ~sqrt(eps) / sqrt(0.1 g^2 + eps) g, turns a gradient's rounding
    near 0 into a step's): the metrics within 1e-4 relative (the gradient
    norm parts by 2e-5, as the test above says) and every parameter after
    it within 1e-5 G: near g = 0 the step, sqrt(eps) g / sqrt(0.1 g^2 +
    eps), moves one for one with the gradient, so the steps part as the
    gradients do (measured 4.6e-5 = 7.6e-6 G)."""
    _, _, metrics64, step64 = small['f64']
    rec, batch = _small_port(small, 'float64')
    optimizer, _ = build_optimizer(dict(SMALL_OPT),
                                   rec.model.named_parameters())
    metrics = make_train_step(rec, optimizer)(batch)
    scale = _grad_scale(small['f64'][1], rec.model)
    assert set(metrics) == set(metrics64) == {'loss', 'loss_ctc',
                                              'grad_norm'}
    for k in metrics64:
        assert float(metrics[k]) == pytest.approx(metrics64[k], rel=1e-4), k
    for n, t in rec.model.state_dict().items():
        if n in step64 and not n.endswith('num_batches_tracked'):
            close(t, step64[n].numpy(), atol=1e-5 * scale)


# -------------------------------------------------------------- weights --

def _random_variables(cfg, shape, seed=0):
    rec = build_jax(cfg)
    shapes = jax.eval_shape(
        lambda: rec.init_variables(jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize('path', [CRNN_TPS_CFG, CRNN_CFG],
                         ids=['crnn_tps', 'crnn'])
def test_state_dict_round_trips_through_jax_converter(path):
    cfg = dict(load_config(path)['model'])
    v = _random_variables(cfg, (1, 32, 100, 1))
    sd = convert.state_dict_from_jax(v, cfg)
    build_recognizer(cfg, device='cpu').model.load_state_dict(sd,
                                                              strict=True)
    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = jtc.filter_rules_to_state(jtc.rules_for_config(cfg), sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for p, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize('path', [CRNN_TPS_CFG, CRNN_CFG],
                         ids=['crnn_tps', 'crnn'])
def test_rule_tables_match_the_jax_package(path):
    cfg = dict(load_config(path)['model'])
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))
    names = {r[0] for r in convert.rules_for_config(cfg)}
    assert 'decoder.decoder.1.rnn' in names
    assert ('preprocessor.LocalizationNetwork.conv.12' in names) == (
        path == CRNN_TPS_CFG)


def test_init_weights_draws_the_lstm_and_resets_the_heads():
    """Two builds with one seed are equal; the LSTM weights lie in
    U(-1/sqrt(H), 1/sqrt(H)) and are not torch's defaults; fc2 is at the
    reference init (zero weights, the reference bias)."""
    cfg = small_cfg()
    a = build_recognizer(cfg, device='cpu').init_weights(3)
    b = build_recognizer(cfg, device='cpu').init_weights(3)
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    rnn = a.model.decoder.decoder[0].rnn
    w = rnn.weight_hh_l0_reverse
    assert float(w.abs().max()) <= 1 / 16 and float(w.abs().max()) > 0.06
    assert float(rnn.bias_ih_l0.abs().max()) > 0.03
    fc2 = a.model.preprocessor.LocalizationNetwork.localization_fc2
    assert not fc2.weight.any()
    np.testing.assert_allclose(
        fc2.bias.detach().numpy().reshape(6, 2),
        [[-1, 0], [0, -0.5], [1, -1], [-1, 1], [0, 0.5], [1, 0]])


# ---------------------------------------------------------- entry points --

def test_build_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    cfg = load_config(CRNN_TPS_CFG)['model']
    with pytest.raises(RuntimeError, match='TextRecognizer: no CUDA'):
        build_recognizer(cfg)
    rec = build_recognizer(cfg, device='cpu')
    assert isinstance(rec, TextRecognizer) and rec.device.type == 'cpu'
    assert rec.resolved_decode_mode() == 'single_pass'
    assert rec.resolved_stem_mode() == 'xla'
    assert rec.model.encoder is None and not rec.autoregressive
    assert tuple(rec.predict(np.zeros((1, 32, 100, 1), np.float32)).shape) \
        == (1, 26, 37)
    with pytest.raises(NotImplementedError, match='DBNet'):
        build_recognizer(dict(cfg, type='DBNet'), device='cpu')


def _crops(n, seed=0):
    """Seeded BGR uint8 crops of heights 24-48 and widths 8-80: a
    keep-aspect-ratio resize at height 32 gives widths of 32 and up,
    padded to the pipeline's max_width."""
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (int(g.integers(24, 49)),
                                int(g.integers(8, 81)), 3), np.uint8)
            for _ in range(n)]


def test_init_recognizer_and_model_inference_match_jax(tmp_path):
    """One ``.pth`` of the small CRNN-TPS (mmcv's wrapper, ``module.``
    prefixes) into both packages' ``init_recognizer``, then
    ``model_inference`` on grayscale crops of mixed widths (the test
    pipeline of ``crnn_tps_academic_dataset.py`` at width 64) and on the
    toy images, alone and batched: the texts equal, the scores within
    1e-4. Narrow crops keep ``valid_ratio`` < 1, which clips the CTC
    decode."""
    cfg = small_cfg()
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(
        lambda k: jrec.init_variables(k, (1, 32, 64, 1)))(
        jax.random.PRNGKey(3)), 3)
    perturb_fc2(v['params']['preprocessor']['localization'], 3, scale=0.05)
    pth = str(tmp_path / 'crnn_tps.pth')
    torch.save({'meta': {}, 'state_dict': {
        f'module.{k}': t for k, t in state_dict_from_jax(v, cfg).items()}},
        pth)
    pipeline = [dict(t) for t in load_config(CRNN_TPS_CFG)['test_pipeline']]
    pipeline[1].update(max_width=64)
    config = dict(model=cfg, test_pipeline=pipeline)
    jr, jv = jax_init(config, pth, input_shape=(1, 32, 64, 1))
    rec = init_recognizer(config, pth, device='cpu')
    toy = [cv2.imread(os.path.join(TOY, f'img_{i}.jpg')) for i in range(4)]
    imgs = _crops(6) + toy
    ratios = []
    for batch_mode in (False, True):
        want = jax_infer(jr, jv, imgs, batch_mode=batch_mode)
        got = model_inference(rec, imgs, batch_mode=batch_mode)
        assert [r['text'] for r in got] == [r['text'] for r in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g['score'], w['score'], atol=1e-4)
    load = Compose([dict(type='LoadImageFromNdarray',
                         color_type='grayscale')] + pipeline[1:])
    for im in imgs:
        d = load(dict(img=im, img_info=dict(filename=None)))
        assert d['img'].shape == (32, 64, 1)
        ratios.append(d['img_metas']['valid_ratio'])
    assert min(ratios) < 0.6 and max(ratios) == 1.0


def test_train_recognizer_passes_target_lengths():
    """Two steps of batch 2 of the small CRNN-TPS through the config's
    train pipeline: each step's CTC loss sees the convertor's lengths."""
    rec = build_recognizer(small_cfg(), device='cpu', param_dtype='float32')
    pipeline = [dict(t) for t in load_config(CRNN_TPS_CFG)['train_pipeline']]
    pipeline[0]['type'] = 'LoadImageFromNdarray'
    pipeline[1].update(min_width=64, max_width=64)

    class Crops:
        texts = ['ab', 'hello', '', 'x7']

        def __init__(self):
            self.imgs = _crops(4, seed=1)
            self.pipeline = Compose(pipeline)

        def __len__(self):
            return 4

        def sample(self, i, key=None):
            return self.pipeline(dict(img=self.imgs[i], text=self.texts[i],
                                      img_info=dict(filename=None),
                                      **seeded_rngs(key)))

    seen, loss = [], rec.loss_obj

    def recording(outputs, targets_dict, valid_ratio=None):
        seen.append(targets_dict['target_lengths'].tolist())
        return loss(outputs, targets_dict, valid_ratio)

    rec.loss_obj = recording
    opt, history = train_recognizer(
        rec, Crops(), dict(optimizer=dict(type='Adadelta', lr=1.0),
                           samples_per_gpu=2, total_epochs=1,
                           log_interval=1))
    assert opt.count == 2 and len(seen) == 2
    assert sorted(sum(seen, [])) == [0, 2, 2, 5]
    assert all(np.isfinite(h['loss_ctc']) for h in history[:2])


def test_train_cli_then_test_cli_take_the_crnn_tps_config(tmp_path):
    """``configs/textrecog/tps/crnn_tps_academic_dataset.py`` at its full
    width (``lr_config = dict()``: a constant rate), trained on the ten toy
    images once at batch 5 with a checkpoint and an evaluation, then
    ``tools/test.py`` on the checkpoint gives that evaluation."""
    base = load_config(CRNN_TPS_CFG)['data']
    toy = dict(base['test'])
    toy['datasets'] = [dict(toy['datasets'][0])]
    train = [dict(toy['datasets'][0], test_mode=False)]
    opts = ['total_epochs=1', 'log_config.interval=1',
            'data.samples_per_gpu=5', 'data.workers_per_gpu=0',
            f'data.val={toy!r}', f'data.train.datasets={train!r}']
    wd = str(tmp_path / 'wd')
    opt, hist = train_tool.main([CRNN_TPS_CFG, '--work-dir', wd, '--seed',
                                 '1', '--cfg-options'] + opts, device='cpu')
    assert opt.count == 2 and opt.optimizer.__class__.__name__ == 'Adadelta'
    lrs = [h['lr'] for h in hist if 'lr' in h]
    assert lrs == [1.0, 1.0]
    evals = [h['eval'] for h in hist if 'eval' in h]
    assert len(evals) == 1 and sorted(os.listdir(wd)) == ['epoch_1.pth']
    metrics = test_tool.main([CRNN_TPS_CFG, os.path.join(wd, 'epoch_1.pth'),
                              '--eval', 'acc', '--cfg-options'] + opts,
                             device='cpu')
    assert metrics == evals[0]
