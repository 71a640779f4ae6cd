"""The port's ResNet31 attention family (SAR with its parallel, sequential and
beam-search decoders; RobustScanner) against the JAX package's, on the CPU
in float32, with the JAX weights carried across by ``state_dict_from_jax``.

Tolerances (as ``tests/test_torch_crnn.py``'s): modules within 1e-5
absolute, or within 1e-5 of the largest magnitude of the output
(``close_scaled``) where float32 sums of hundreds of terms are taken in
other orders (the trunk's convolutions, the LSTMs' gates); probabilities
within 1e-5 and the greedy argmax equal; the loss within 1e-5 relative
and the gradients within 1e-4 relative and 1e-4 of the largest gradient.

* modules: ``ResNet31OCR`` (the default stage-4 pool, the reference's
  ``stage4_pool_cfg`` forms with ``last_stage_pool``, ``out_indices``; in
  eval mode and in train mode with its BatchNorm statistics),
  ``SAREncoder`` (LSTM, GRU, bidirectional, unmasked), the inter-layer
  dropout's layer-by-layer run, ``ChannelReductionEncoder``,
  ``dot_product_attention`` and the width mask, ``PositionAwareLayer``,
  ``RobustScannerFusionLayer``, ``SARLoss`` and its gradient;
* small models (ResNet31 of ``layers=[1, 1, 1, 1]``, d 16, DICT36): the
  parallel and sequential decoders (LSTM and ``dec_gru``, the sequential's
  c := h quirk) and RobustScanner, teacher-forced logits and the greedy
  ``predict``; beam search at widths 1 and 5 against JAX's
  ``beam_decode``; ``compute_loss`` and its gradients in train mode;
* the decode protocol carries ``feat`` (greedy, beam, the training pass),
  and ``'auto'`` never picks a path the kernels refuse (SAR; an NRTR on
  ResNet31 with d_k 32 or more than 512 tokens; the predicates against the
  constants of the CUDA sources);
* weights: the round trip through the JAX package's converter and the rule
  tables, for the shipped configs;
* entry points: ``init_recognizer`` / ``model_inference`` against JAX's,
  and the train-then-test CLIs on ``sar_r31_parallel_decoder_toy_dataset.py``.

The full-width configs are in ``tests/test_torch_sar_full.py``.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import load_sub, perturb_batch_stats

from tps_pp_tpu.apis.inference import init_recognizer as jax_init
from tps_pp_tpu.apis.inference import model_inference as jax_infer
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.losses.ce import SARLoss as JaxSARLoss
from tps_pp_tpu.models.backbones.resnet31 import ResNet31OCR as JaxResNet31
from tps_pp_tpu.models.decoders import robust_scanner as jrs
from tps_pp_tpu.models.decoders.base import beam_decode as jax_beam_decode
from tps_pp_tpu.models.encoders.sar import SAREncoder as JaxSAREncoder
from tps_pp_tpu.models.encoders.satrn import \
    ChannelReductionEncoder as JaxChannelReduction
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import (TextRecognizer, build_recognizer,
                                   init_recognizer, model_inference)
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.losses import SARLoss
from tps_pp_tpu_torch.models.backbones import ResNet31OCR
from tps_pp_tpu_torch.models.decoders import beam_decode, greedy_decode
from tps_pp_tpu_torch.models.decoders import robust_scanner as trs
from tps_pp_tpu_torch.models.encoders import (ChannelReductionEncoder,
                                              SAREncoder)
from tps_pp_tpu_torch.models.transformer import dropout
from tps_pp_tpu_torch.ops import encoder as tenc
from tps_pp_tpu_torch.ops import full_decode as tfd
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import convert_rules, state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAR_CFG = os.path.join(
    REPO, 'configs/textrecog/sar/sar_r31_parallel_decoder_academic.py')
SEQ_CFG = os.path.join(
    REPO, 'configs/textrecog/sar/sar_r31_sequential_decoder_academic.py')
RS_CFG = os.path.join(
    REPO, 'configs/textrecog/robust_scanner/robustscanner_r31_academic.py')
TOY_CFG = os.path.join(
    REPO, 'configs/textrecog/sar/sar_r31_parallel_decoder_toy_dataset.py')
NRTR_R31_CFG = os.path.join(
    REPO, 'configs/textrecog/nrtr/nrtr_r31_1by16_1by8_academic.py')
ATOL = 1e-5
# the small trunk of tests/test_model_families.py:36-38
TINY_R31 = dict(layers=[1, 1, 1, 1], channels=[8, 8, 8, 8, 16, 16, 16])
VR3 = np.array([1.0, 0.5, 0.8], np.float32)


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def close_scaled(got, want, atol=ATOL):
    """Within ``atol`` times the largest magnitude of ``want`` (at least
    1)."""
    close(got, want, atol * max(1.0, float(np.abs(np.asarray(want)).max())))


def jax_init_vars(module, *args, seed=0, **kw):
    return perturb_batch_stats(jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(seed)), seed)


# ------------------------------------------------------------- trunk --

@pytest.mark.parametrize('kw', [
    dict(),
    dict(stage4_pool_cfg=dict(kernel_size=(2, 1), stride=(2, 1)),
         last_stage_pool=True),
    dict(stage4_pool_cfg=None),
    dict(stage4_pool_cfg=dict(kernel_size=2, stride=2),
         out_indices=[0, 1, 2, 3]),
], ids=['default', 'nrtr_1by16', 'nrtr_1by8', 'pool2_out_indices'])
def test_resnet31_matches_jax(kw):
    """Eval mode, then train mode (the batch's BatchNorm statistics, the
    output and the running statistics it leaves). Train mode's output
    within 1e-4 of its largest magnitude: each of its eight BatchNorms
    normalizes by the batch's own statistics, down to 32 values a channel
    at the last stage of the 1by16 geometry, which magnifies the two
    packages' float32 rounding (measured 3.8e-5 at a magnitude of 1.2
    there)."""
    x = randn(2, 32, 64, 3, seed=1)
    jm = JaxResNet31(**TINY_R31, **kw)
    v = jax_init_vars(jm, jnp.asarray(x))
    m = load_sub(ResNet31OCR(**TINY_R31, **kw).eval(), v,
                 convert.resnet31_rules(TINY_R31['layers']), 'backbone',
                 'backbone')
    want = jm.apply(v, jnp.asarray(x))
    got = m(torch.from_numpy(x))
    if kw.get('out_indices'):
        assert len(got) == len(want) == 4
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close_scaled(g, w)
    want, state = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
    m.train()
    got = m(torch.from_numpy(x))
    if kw.get('out_indices'):
        got, want = got[-1], want[-1]
    close_scaled(got, want, 1e-4)
    sd = convert_rules({'params': {'backbone': v['params']}, 'batch_stats':
                        {'backbone': state['batch_stats']}},
                       convert.resnet31_rules(TINY_R31['layers']))
    for n, b in m.state_dict().items():
        if n.endswith(('running_mean', 'running_var')):
            close(b, sd[f'backbone.{n}'].numpy())


def test_resnet31_geometry_of_the_shipped_configs():
    """48 x 160 crops give SAR's 6 x 40 x 512 map; 32 x 160 give the
    NRTR-R31 configs' 2 x 20 and 8 x 40 (40 and 320 tokens)."""
    def shape(cfg_path, h):
        bb = dict(load_config(cfg_path)['model']['backbone'])
        bb.pop('type')
        with torch.no_grad():
            return tuple(ResNet31OCR(**bb).eval()(torch.zeros(1, h, 160, 3))
                         .shape)
    assert shape(SAR_CFG, 48) == (1, 6, 40, 512)
    assert shape(NRTR_R31_CFG, 32) == (1, 2, 20, 512)
    assert shape(NRTR_R31_CFG.replace('1by16_1by8', '1by8_1by4'), 32) == (
        1, 8, 40, 512)


# ---------------------------------------------------------- encoders --

@pytest.mark.parametrize('kw', [
    dict(), dict(enc_gru=True), dict(enc_bi_rnn=True), dict(mask=False)],
    ids=['lstm', 'gru', 'bidirectional', 'unmasked'])
def test_sar_encoder_matches_jax(kw):
    """The holistic feature at the last valid column of each row (ratios
    1, 0.5, 0.8, 0.05 over 10 columns: columns 9, 4, 7, 0)."""
    feat = randn(4, 3, 10, 16, seed=2)
    vr = np.array([1.0, 0.5, 0.8, 0.05], np.float32)
    jm = JaxSAREncoder(d_model=16, d_enc=12, **kw)
    v = jax_init_vars(jm, jnp.asarray(feat), jnp.asarray(vr))
    want = jm.apply(v, jnp.asarray(feat), jnp.asarray(vr))
    rules = convert.sar_rules(kw.get('enc_bi_rnn', False))
    m = load_sub(SAREncoder(d_model=16, d_enc=12, **kw).eval(), v, rules,
                 'encoder', 'encoder')
    got = m(torch.from_numpy(feat), torch.from_numpy(vr))
    assert tuple(got.shape) == want.shape == (4, 24 if kw.get('enc_bi_rnn')
                                              else 12)
    close(got, want)


@pytest.mark.parametrize('rnn', ['lstm', 'gru_bidirectional'])
def test_inter_layer_dropout_runs_layer_by_layer(rnn):
    """In training, ``run_layers`` is layer 0, ``dropout`` with the
    caller's generator, then layer 1 (torch's ``dropout=`` and JAX's
    ``enc_do_rnn``, with the port's masks); at rate 0 it is ``forward``."""
    x = torch.from_numpy(randn(3, 7, 8, seed=3))
    enc = SAREncoder(d_model=8, d_enc=6, enc_do_rnn=0.3,
                     enc_gru=rnn != 'lstm',
                     enc_bi_rnn=rnn != 'lstm').train()
    r = enc.rnn_encoder
    got = r.run_layers(x, 0.3, torch.Generator().manual_seed(5))
    cls = torch.nn.LSTM if isinstance(r, torch.nn.LSTM) else torch.nn.GRU
    layers = [cls(8 if k == 0 else 6 * (1 + r.bidirectional), 6,
                  batch_first=True, bidirectional=r.bidirectional)
              for k in range(2)]
    sfx = ['', '_reverse'] if r.bidirectional else ['']
    with torch.no_grad():
        for k, layer in enumerate(layers):
            for n in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh'):
                for s in sfx:
                    getattr(layer, f'{n}_l0{s}').copy_(
                        getattr(r, f'{n}_l{k}{s}'))
    y = dropout(layers[0](x)[0], 0.3, torch.Generator().manual_seed(5))
    close(got, layers[1](y)[0].detach(), 1e-6)
    close(r.run_layers(x, 0.0), r(x)[0].detach(), 0.0)
    assert not torch.allclose(got, r(x)[0])


def test_channel_reduction_encoder_matches_jax():
    feat = randn(2, 3, 5, 16, seed=4)
    jm = JaxChannelReduction(16, 8)
    v = jax_init_vars(jm, jnp.asarray(feat))
    m = load_sub(ChannelReductionEncoder(16, 8), v,
                 [('encoder.layer', 'encoder/layer', 'conv')], 'encoder',
                 'encoder')
    close(m(torch.from_numpy(feat)), jm.apply(v, jnp.asarray(feat)))


# ------------------------------------------------- RobustScanner layers --

def test_dot_product_attention_and_width_mask_match_jax():
    q, k, v = randn(3, 4, 8, seed=5), randn(3, 12, 8, seed=6), randn(
        3, 12, 5, seed=7)
    vr = np.array([1.0, 0.5, 0.2], np.float32)
    jmask = jrs._width_mask(jnp.asarray(vr), 2, 6)
    tmask = trs.width_mask(torch.from_numpy(vr), 2, 6)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask[2].tolist() == [False, False] + [True] * 4 + \
        [False, False] + [True] * 4
    for mask, jm in ((None, None), (tmask, jmask)):
        got = trs.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                        mask)
        close(got, jrs.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                             jm))


def test_position_aware_layer_and_fusion_match_jax():
    x = randn(2, 3, 6, 8, seed=8)
    jm = jrs.PositionAwareLayer(8, 2)
    v = jax_init_vars(jm, jnp.asarray(x))
    m = load_sub(trs.PositionAwareLayer(8, 2), v,
                 convert.robust_scanner_rules(),
                 'decoder/position/position_aware_module',
                 'decoder.position_decoder.position_aware_module')
    close_scaled(m(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))
    a, b = randn(2, 5, 8, seed=9), randn(2, 5, 8, seed=10)
    jf = jrs.RobustScannerFusionLayer(8)
    vf = jax_init_vars(jf, jnp.asarray(a), jnp.asarray(b))
    f = load_sub(trs.RobustScannerFusionLayer(8), vf,
                 convert.robust_scanner_rules(), 'decoder/fusion_module',
                 'decoder.fusion_module')
    close(f(torch.from_numpy(a), torch.from_numpy(b)),
          jf.apply(vf, jnp.asarray(a), jnp.asarray(b)))


# ---------------------------------------------------------------- loss --

def test_sar_loss_and_gradient_match_jax():
    """The last step dropped, the targets shifted by one, the mean over the
    positions that are not ignored (pad 36 here)."""
    logits = randn(3, 7, 36, seed=11, scale=2.0)
    tg = np.array([[0, 3, 4, 1, 36, 36, 36], [0, 5, 1, 36, 36, 36, 36],
                   [0, 7, 8, 9, 10, 2, 1]], np.int64)
    jl = JaxSARLoss(ignore_index=36)

    def f(x):
        return jl(x, {'padded_targets': jnp.asarray(tg)})['loss_ce']
    want, wgrad = f(jnp.asarray(logits)), jax.grad(f)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = SARLoss(ignore_index=36)(x, {'padded_targets': torch.from_numpy(
        tg)})['loss_ce']
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    close(x.grad, wgrad, 1e-7)
    assert not x.grad[:, -1].any() and not x.grad[0, 4:].any()


# ------------------------------------------------------- small models --

LC36 = dict(type='AttnConvertor', dict_type='DICT36', with_unknown=True)


def small_cfg(kind, dropout=0.1, **dec):
    """A small model of ``kind``: SAR's parallel, sequential or beam-search
    decoder, or RobustScanner, on the small ResNet31 (as
    ``tests/test_model_families.py:40-88`` builds them)."""
    bb = dict(type='ResNet31OCR', **TINY_R31)
    if kind == 'robust_scanner':
        return dict(
            type='RobustScanner', label_convertor=LC36, backbone=bb,
            encoder=dict(type='ChannelReductionEncoder', in_channels=16,
                         out_channels=8),
            decoder=dict(type='RobustScannerDecoder', dim_input=16,
                         dim_model=8,
                         hybrid_decoder=dict(type='SequenceAttentionDecoder'),
                         position_decoder=dict(
                             type='PositionAttentionDecoder'), **dec),
            loss=dict(type='SARLoss'), max_seq_len=6)
    dtype = dict(parallel='ParallelSARDecoder',
                 sequential='SequentialSARDecoder',
                 beam='ParallelSARDecoderWithBS')[kind]
    return dict(
        type='SARNet', label_convertor=LC36, backbone=bb,
        encoder=dict(type='SAREncoder', enc_do_rnn=dropout, d_model=16,
                     d_enc=16),
        decoder=dict(type=dtype, d_model=16, d_enc=16, d_k=8,
                     pred_dropout=dropout, pred_concat=True, **dec),
        loss=dict(type='SARLoss'), max_seq_len=6)


def small_models(cfg, seed=0):
    """(JAX recognizer, its variables with perturbed BatchNorm statistics,
    the port's recognizer on the CPU with them loaded)."""
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(
        lambda k: jrec.init_variables(k, (1, 32, 64, 3)))(
        jax.random.PRNGKey(seed)), seed)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    return jrec, v, rec


KINDS = [('parallel', {}), ('parallel', dict(dec_gru=True)),
         ('sequential', {}), ('sequential', dict(dec_gru=True)),
         ('robust_scanner', {})]
KIND_IDS = ['parallel', 'parallel_gru', 'sequential', 'sequential_gru',
            'robust_scanner']


@pytest.mark.parametrize('kind,dec', KINDS, ids=KIND_IDS)
def test_small_models_match_jax(kind, dec):
    """Teacher-forced logits (eval mode) within 1e-5 of their scale, then
    the greedy ``predict`` (mixed valid ratios): probabilities within
    1e-5, the argmax and the texts equal."""
    jrec, v, rec = small_models(small_cfg(kind, **dec))
    img = randn(3, 32, 64, 3, seed=12)
    td = rec.label_convertor.str2tensor(['ab', 'hello', '7'])
    jv = jax.tree.map(jnp.asarray, v)
    want = jrec.module.apply(jv, jnp.asarray(img),
                             targets=jnp.asarray(td['padded_targets']),
                             valid_ratio=jnp.asarray(VR3), train=False)
    with torch.no_grad():
        got = rec.model(torch.from_numpy(img),
                        torch.from_numpy(td['padded_targets']),
                        torch.from_numpy(VR3))
    assert tuple(got.shape) == want.shape
    close_scaled(got, want)
    want = np.asarray(jrec.predict(jv, jnp.asarray(img), jnp.asarray(VR3)))
    got = rec.predict(img, VR3).numpy()
    assert got.shape == want.shape == (3, 6, 38)
    close(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert [r['text'] for r in rec.simple_test(img, VR3)] == [
        r['text'] for r in jrec.simple_test(jv, jnp.asarray(img),
                                            jnp.asarray(VR3))]


def test_sequential_decoder_keeps_the_c_is_h_quirk():
    """Each step's carried cell states are its hidden states; the parallel
    decoder on the same weights carries true cell states, and its greedy
    probabilities part from the sequential decoder's."""
    cfg = small_cfg('sequential')
    _, v, rec = small_models(cfg)
    par = build_recognizer(small_cfg('parallel'), device='cpu')
    sd = {k: t for k, t in rec.model.state_dict().items()
          if not k.startswith('decoder.')}
    dec = rec.model.decoder
    sd.update({f'decoder.{k}': t for k, t in (
        ('conv1x1_1.weight', dec.conv1x1_1.weight[:, :, 0, 0]),
        ('conv1x1_2.weight', dec.conv1x1_2.weight[:, :, 0, 0]))})
    for k, t in dec.state_dict().items():
        m = re.fullmatch(r'rnn_decoder_layer(\d)\.(\w+)', k)
        if m:
            sd[f'decoder.rnn_decoder.{m.group(2)}_l{int(m.group(1)) - 1}'] = t
        elif not k.startswith('conv1x1_'):
            sd[f'decoder.{k}'] = t
    sd.update({f'decoder.{n}.bias': getattr(dec, n).bias
               for n in ('conv1x1_1', 'conv1x1_2')})
    par.model.load_state_dict(sd, strict=True)
    img = torch.from_numpy(randn(2, 32, 64, 3, seed=13))
    with torch.no_grad():
        feat, enc = rec.model.encode_full(img)
        carry, static = dec.decode_init(enc, feat=feat)
        tok = torch.zeros(2, dtype=torch.long)
        _, carry = dec.decode_step(tok, 0, carry, static)
        assert torch.equal(carry[0], carry[1]) and torch.equal(carry[2],
                                                               carry[3])
        _, pcarry = par.model.decoder.decode_step(
            tok, 0, *par.model.decoder.decode_init(enc, feat=feat))
        close(pcarry[0], carry[0].numpy(), 1e-6)   # the first step agrees
        assert not torch.allclose(pcarry[1], pcarry[0])
    assert not np.allclose(par.predict(img).numpy(), rec.predict(img).numpy(),
                           atol=1e-4)


@pytest.mark.parametrize('width', [1, 5])
def test_beam_search_matches_jax_beam_decode(width):
    """``beam_decode`` on the beam-search decoder's model, feat carried and
    tiled, against JAX's on the same encodings: the output within 1e-5
    and its tokens equal; at width 5 ``predict`` takes the same path."""
    cfg = small_cfg('beam', beam_width=width)
    jrec, v, rec = small_models(cfg)
    assert rec.beam_width == width
    img = randn(3, 32, 64, 3, seed=14)
    jv = jax.tree.map(jnp.asarray, v)
    feat, out_enc = jrec.module.apply(jv, jnp.asarray(img),
                                      jnp.asarray(VR3), method='encode_full')
    want = np.asarray(jax_beam_decode(
        lambda m, *a: jrec.module.apply(jv, *a, method=m), feat, out_enc,
        jnp.asarray(VR3), max_seq_len=6, start_idx=rec.label_convertor
        .start_idx, beam_width=width))
    vr = torch.from_numpy(VR3)
    with torch.no_grad():
        tfeat, tenc = rec.model.encode_full(torch.from_numpy(img), vr)
        got = beam_decode(rec.model.decoder, tenc, vr, max_seq_len=6,
                          start_idx=rec.label_convertor.start_idx,
                          beam_width=width, feat=tfeat).numpy()
    close(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if width > 1:
        assert rec.resolved_decode_mode() == 'steps'
        close(rec.predict(img, VR3).numpy(), got, 0.0)
        close(np.asarray(jrec.predict(jv, jnp.asarray(img),
                                      jnp.asarray(VR3))), got)


@pytest.mark.parametrize('kind', ['parallel', 'sequential',
                                  'robust_scanner'])
def test_small_compute_loss_and_gradients_match_jax(kind):
    """Train mode without dropout (BatchNorm on the batch's statistics),
    f32: SARLoss within 1e-5 relative, every gradient within 1e-4 relative
    and 1e-4 of the largest (G), the running statistics within 1e-5."""
    cfg = small_cfg(kind, dropout=0.0)
    jrec, v, rec = small_models(cfg, seed=1)
    td = rec.label_convertor.str2tensor(['ab', 'hello', '', 'x7q'])
    batch = dict(img=randn(4, 32, 64, 3, seed=15),
                 valid_ratio=np.array([1.0, 0.6, 0.8, 1.0], np.float32),
                 padded_targets=td['padded_targets'])
    jv = jax.tree.map(jnp.asarray, v)

    def loss_fn(params):
        total, (_, state) = jrec.compute_loss(
            dict(jv, params=params), jax.tree.map(jnp.asarray, batch),
            jax.random.PRNGKey(0))
        return total, state['batch_stats']
    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jv['params'])
    want = state_dict_from_jax(jax.tree.map(np.asarray, dict(
        params=grads, batch_stats=stats)), cfg)
    total, losses = rec.compute_loss(batch)
    assert set(losses) == {'loss_ce'}
    assert abs(float(total) - float(loss)) <= 1e-5 * abs(float(loss))
    total.backward()
    scale = max(float(want[n].abs().max())
                for n, _ in rec.model.named_parameters())
    for n, p in rec.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=n)
    for n, b in rec.model.state_dict().items():
        if n.endswith(('running_mean', 'running_var')):
            close(b, want[n].numpy())
    assert not rec.model.training


# ------------------------------------------- the decode protocol's feat --

class Recording:
    """Wraps a decoder's ``decode_init`` / ``forward`` and keeps the
    ``feat`` each was given."""

    def __init__(self, decoder):
        self.seen = []
        init, fwd = decoder.decode_init, decoder.forward

        def decode_init(out_enc, valid_ratio=None, feat=None):
            self.seen.append(('decode_init', feat))
            return init(out_enc, valid_ratio, feat=feat)

        def forward(feat, *a, **k):
            self.seen.append(('forward', feat))
            return fwd(feat, *a, **k)
        decoder.decode_init, decoder.forward = decode_init, forward


@pytest.mark.parametrize('kind', ['parallel', 'robust_scanner'])
def test_feat_reaches_the_decoder_on_every_path(kind):
    """The greedy and beam paths hand ``extract_feat``'s map to
    ``decode_init`` (tiled beam-major for the beam), and the training pass
    to the decoder."""
    rec = build_recognizer(small_cfg(kind), device='cpu').init_weights(0)
    rec_ = Recording(rec.model.decoder)
    img = torch.from_numpy(randn(2, 32, 64, 3, seed=16))
    with torch.no_grad():
        feat = rec.model.extract_feat(img)
        rec.predict(img)
        rec.beam_width = 3
        rec.predict(img)
        rec.beam_width = 1
        td = rec.label_convertor.str2tensor(['ab', 'c'])
        rec.compute_loss(dict(img=img, padded_targets=td['padded_targets']),
                         train=False)
    (w1, f1), (w2, f2), (w3, f3) = rec_.seen
    assert (w1, w2, w3) == ('decode_init', 'decode_init', 'forward')
    close(f1, feat.numpy(), 0.0)
    close(f2, feat.repeat_interleave(3, dim=0).numpy(), 0.0)
    close(f3, feat.numpy(), 0.0)


def test_decoders_without_feat_are_called_as_before():
    """Without ``feat``, the decodes call ``decode_init(out_enc,
    valid_ratio)``: a decoder that takes no ``feat`` keyword still
    decodes; NRTR's takes it and ignores it."""
    rec = build_recognizer(small_cfg('parallel'), device='cpu').init_weights(
        0)
    dec = rec.model.decoder
    img = torch.from_numpy(randn(2, 32, 64, 3, seed=17))
    with torch.no_grad():
        feat, enc = rec.model.encode_full(img)

        class Bare:
            def decode_init(self, *a):
                assert len(a) == 2
                return dec.decode_init(*a, feat=feat)

            def decode_step(self, *a, **k):
                return dec.decode_step(*a, **k)
        kw = dict(max_seq_len=6, start_idx=0)
        close(greedy_decode(Bare(), enc, None, **kw),
              greedy_decode(dec, enc, None, feat=feat, **kw).numpy(), 0.0)
    from tps_pp_tpu_torch.apis import nrtr_tps_pp_cfg
    nrtr = build_recognizer(nrtr_tps_pp_cfg(tiny=True), device='cpu')
    out_enc = torch.zeros(2, 64, nrtr.model.decoder.d_model)
    a = nrtr.model.decoder.decode_init(out_enc, None)
    b = nrtr.model.decoder.decode_init(out_enc, None, feat=feat)
    assert len(a[0]) == len(b[0])


# ------------------------------------------------------- decode modes --

def test_sar_and_robust_scanner_resolve_every_mode_to_steps():
    """Whatever the mode, and on the card in bf16 too: a decoder without a
    whole decode runs ``'steps'`` (JAX ``apis/recognizer.py:155-160``)."""
    for kind in ('parallel', 'sequential', 'beam', 'robust_scanner'):
        for mode in ('auto', 'fused40_bf16', 'fused40', 'steps'):
            rec = build_recognizer(dict(small_cfg(kind), decode_mode=mode,
                                        dtype='bfloat16'), device='cpu')
            assert rec.resolved_decode_mode() == 'steps', (kind, mode)
            assert rec.auto_decode_mode('cuda', 64) == 'steps'


def _constant(path, name):
    src = open(os.path.join(REPO, 'tps_pp_tpu_torch/csrc', path)).read()
    return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))


def test_kernel_shape_predicates_agree_with_the_cuda_limits():
    """``encoder_kernel_accepts`` against the constants that
    ``csrc/encoder.cu`` checks (kMaxT, kDk; kGemmLnWidth of ``gemm.cuh``),
    and ``full_decode_accepts`` against those of ``csrc/decode_blocks.cuh``
    (kShortKeys steps, kMaxKeys source tokens) and at the bounds its
    wrapper states: kernel 3 at any token count up to 512, kernels 4-5 at
    d_k 32 or 64 and up to 512 source tokens."""
    assert (tenc.KERNEL_MAX_TOKENS, tenc.KERNEL_DK, tenc.KERNEL_D) == (
        _constant('encoder.cu', 'kMaxT'), _constant('encoder.cu', 'kDk'),
        _constant('gemm.cuh', 'kGemmLnWidth'))
    assert (tfd.KERNEL_MAX_STEPS, tfd.KERNEL_MAX_SOURCE) == (
        _constant('decode_blocks.cuh', 'kShortKeys'),
        _constant('decode_blocks.cuh', 'kMaxKeys'))
    ok = dict(T=64, D=512, n_head=8, DK=64, DI=512)
    assert tenc.encoder_kernel_accepts(**ok)
    for T in (None, 1, 8, 40, 100, 320, 512):
        assert tenc.encoder_kernel_accepts(**dict(ok, T=T)), T
    for k, bad in (('T', 0), ('T', 513), ('DK', 32), ('D', 256),
                   ('DI', 128), ('DI', 384)):
        assert not tenc.encoder_kernel_accepts(**dict(ok, **{k: bad})), k
    ok = dict(D=512, DK=64, DI=256, S=40, TE=64, NC=92)
    assert tfd.full_decode_accepts(**ok)
    for k, good in (('TE', 256), ('TE', 320), ('TE', 512), ('DK', 32),
                    ('S', 256)):
        assert tfd.full_decode_accepts(**dict(ok, **{k: good})), k
    assert tfd.full_decode_accepts(D=256, DK=32, DI=1024, S=25, TE=200,
                                   NC=91)
    for k, bad in (('TE', 513), ('DK', 16), ('DK', 128), ('S', 257),
                   ('D', 1088), ('D', 480)):
        assert not tfd.full_decode_accepts(**dict(ok, **{k: bad})), k


def nrtr_r31_cfg(d_k=64, dtype='bfloat16'):
    """An NRTR on a small ResNet31 whose encoder and decoder kernel 3 and
    4 take, but for their token count (and d_k where asked)."""
    return dict(
        type='NRTR',
        label_convertor=dict(type='AttnConvertor', dict_type='DICT36',
                             with_unknown=True),
        backbone=dict(type='ResNet31OCR', layers=[1, 1, 1, 1],
                      channels=[8, 8, 8, 8, 16, 512],
                      stage4_pool_cfg=dict(kernel_size=(2, 1),
                                           stride=(2, 1)),
                      last_stage_pool=True),
        encoder=dict(type='NRTREncoder', n_layers=1, n_head=512 // d_k,
                     d_k=d_k, d_v=d_k, d_model=512, d_inner=256),
        decoder=dict(type='NRTRDecoder', n_layers=1, n_head=512 // d_k,
                     d_k=d_k, d_v=d_k, d_model=512, d_embedding=512,
                     d_inner=256),
        loss=dict(type='TFLoss'), max_seq_len=6, dtype=dtype)


def test_auto_falls_back_to_steps_where_the_kernels_refuse():
    """On the card, ``'auto'`` picks ``fused40_bf16`` for an NRTR on
    ResNet31 only where the token count is at most 512 and d_k 64; at 32 x
    2080 the 1by16 trunk gives 520 tokens, so ``predict`` (asked as if on
    the card) runs ``'steps'`` from the feature it has, the trunk once, and
    gives the ``'steps'`` recognizer's output. An explicit
    ``'fused40_bf16'`` keeps its path (on the card its kernels raise)."""
    rec = build_recognizer(nrtr_r31_cfg(), device='cpu').init_weights(0)
    assert rec.auto_decode_mode('cuda') == 'fused40_bf16'
    assert rec.auto_decode_mode('cuda', 64) == 'fused40_bf16'
    assert rec.auto_decode_mode('cuda', 40) == 'fused40_bf16'
    assert rec.auto_decode_mode('cuda', 320) == 'fused40_bf16'
    assert rec.auto_decode_mode('cuda', 520) == 'steps'
    assert rec.auto_decode_mode('cpu', 64) == 'steps'
    rec32 = build_recognizer(nrtr_r31_cfg(d_k=32), device='cpu')
    assert rec32.auto_decode_mode('cuda') == 'steps'
    assert rec32.auto_decode_mode('cuda', 64) == 'steps'
    assert build_recognizer(nrtr_r31_cfg(dtype='float32'),
                            device='cpu').auto_decode_mode('cuda', 64) == \
        'steps'
    assert build_recognizer(dict(nrtr_r31_cfg(), decode_mode='fused40'),
                            device='cpu').resolved_decode_mode() == 'fused40'

    img = randn(2, 32, 2080, 3, seed=18)
    steps = build_recognizer(dict(nrtr_r31_cfg(), decode_mode='steps'),
                             device='cpu')
    steps.model.load_state_dict(rec.model.state_dict())
    calls, fused = [], []
    tail = rec.model.backbone.tail
    rec.model.backbone.tail = lambda x: calls.append(1) or tail(x)
    rec.model.decode_full_fused = lambda *a, **k: fused.append(1)
    rec.auto_decode_mode = lambda dt, tokens=None: TextRecognizer \
        .auto_decode_mode(rec, 'cuda', tokens)
    assert rec.resolved_decode_mode() == 'fused40_bf16'
    got = rec.predict(img)
    assert calls == [1] and not fused
    assert rec.resolved_decode_mode(520) == 'steps'
    close(got.float(), steps.predict(img).float().numpy(), 0.0)


# ------------------------------------------------------------- weights --

SHIPPED = [SAR_CFG, SEQ_CFG, RS_CFG, 'beam']
SHIPPED_IDS = ['sar_parallel', 'sar_sequential', 'robust_scanner',
               'sar_beam']


def shipped_cfg(path):
    if path == 'beam':
        cfg = dict(load_config(SAR_CFG)['model'])
        return dict(cfg, decoder=dict(cfg['decoder'],
                                      type='ParallelSARDecoderWithBS'))
    return dict(load_config(path)['model'])


def _random_variables(cfg, shape, seed=0):
    rec = build_jax(cfg)
    shapes = jax.eval_shape(
        lambda: rec.init_variables(jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize('path', SHIPPED, ids=SHIPPED_IDS)
def test_state_dict_round_trips_through_jax_converter(path):
    """The shipped configs at full width: the port's model takes the
    converted weights (strict), and the JAX package's converter gives the
    JAX variables back bit for bit; the rule tables are the JAX
    package's."""
    cfg = shipped_cfg(path)
    v = _random_variables(cfg, (1, 48, 160, 3))
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
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))


def test_nrtr_r31_rule_tables_match_the_jax_package():
    for name in ('1by16_1by8', '1by8_1by4'):
        cfg = dict(load_config(NRTR_R31_CFG.replace('1by16_1by8', name))[
            'model'])
        assert set(convert.rules_for_config(cfg)) == set(
            jtc.rules_for_config(cfg))


def test_init_weights_draws_every_recurrence():
    """The LSTMs, GRUs and cells U(-1/sqrt(H), 1/sqrt(H)), not torch's
    defaults; two builds with one seed equal; SAR's embedding keeps a
    drawn pad row (JAX pins none), RobustScanner's hybrid branch zeroes
    the pad token at lookup."""
    for kind, dec in (('parallel', dict(dec_gru=True)), ('sequential', {}),
                      ('robust_scanner', {})):
        a = build_recognizer(small_cfg(kind, **dec), device='cpu')
        b = build_recognizer(small_cfg(kind, **dec), device='cpu')
        a.init_weights(3), b.init_weights(3)
        for (k, x), y in zip(a.model.state_dict().items(),
                             b.model.state_dict().values()):
            assert torch.equal(x, y), k
        for m in a.model.modules():
            if isinstance(m, (torch.nn.RNNBase, torch.nn.RNNCellBase)):
                w = m.weight_hh if hasattr(m, 'weight_hh') else \
                    m.weight_hh_l0
                bound = m.hidden_size ** -0.5
                bias = m.bias_ih if hasattr(m, 'bias_ih') else m.bias_ih_l0
                assert bound * 0.9 < float(w.abs().max()) <= bound
                assert float(bias.abs().max()) > 0
    pad = a.label_convertor.padding_idx
    rs = a.model.decoder.hybrid_decoder
    assert float(rs.embedding.weight[pad].abs().max()) > 0
    assert not rs._embed(torch.tensor([pad])).any()
    sar = build_recognizer(small_cfg('parallel'), device='cpu')
    sar.init_weights(3)
    assert float(sar.model.decoder.embedding.weight[pad].abs().max()) > 0


# ------------------------------------------------------- entry points --

def _crops(n, seed=0):
    """Seeded BGR uint8 crops of heights 16-48 and widths 8-120: SAR's
    keep-aspect resize to height 32 (the small config's) gives widths
    of 32 and up, padded to 64."""
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (int(g.integers(16, 49)),
                                int(g.integers(8, 121)), 3), np.uint8)
            for _ in range(n)]


def test_init_recognizer_and_model_inference_match_jax(tmp_path):
    """One ``.pth`` of the small SAR (mmcv's wrapper, ``module.``
    prefixes) into both packages' ``init_recognizer``, then
    ``model_inference`` on crops of mixed widths through SAR's test
    pipeline (at 32 x 64), alone and batched (sorted by valid ratio):
    the texts equal, the scores within 1e-5."""
    cfg = small_cfg('parallel')
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(
        lambda k: jrec.init_variables(k, (1, 32, 64, 3)))(
        jax.random.PRNGKey(4)), 4)
    pth = str(tmp_path / 'sar.pth')
    torch.save({'meta': {}, 'state_dict': {
        f'module.{k}': t for k, t in state_dict_from_jax(v, cfg).items()}},
        pth)
    pipeline = [dict(t) for t in load_config(SAR_CFG)['test_pipeline']]
    pipeline[1].update(height=32, min_width=32, max_width=64)
    config = dict(model=cfg, test_pipeline=pipeline)
    jr, jv = jax_init(config, pth, input_shape=(1, 32, 64, 3))
    rec = init_recognizer(config, pth, device='cpu')
    imgs = _crops(8)
    for batch_mode in (False, True):
        want = jax_infer(jr, jv, imgs, batch_mode=batch_mode)
        got = model_inference(rec, imgs, batch_mode=batch_mode)
        assert [r['text'] for r in got] == [r['text'] for r in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g['score'], w['score'], atol=1e-5)


def test_train_cli_then_test_cli_take_the_sar_toy_config(tmp_path):
    """``configs/textrecog/sar/sar_r31_parallel_decoder_toy_dataset.py``
    (SAR at its full width, Adam 1e-3 stepped at epochs 3 and 4), trained
    on the ten toy images once at batch 5 with a checkpoint and an
    evaluation, then ``tools/test.py`` on the checkpoint gives that
    evaluation."""
    base = load_config(TOY_CFG)['data']
    toy = dict(base['test'])
    toy['datasets'] = [dict(toy['datasets'][0])]
    train = [dict(toy['datasets'][0], test_mode=False)]
    opts = ['total_epochs=1', 'log_config.interval=1',
            'data.samples_per_gpu=5', 'data.workers_per_gpu=0',
            f'data.val={toy!r}', f'data.train.datasets={train!r}']
    wd = str(tmp_path / 'wd')
    opt, hist = train_tool.main([TOY_CFG, '--work-dir', wd, '--seed', '1',
                                 '--cfg-options'] + opts, device='cpu')
    assert opt.count == 2 and opt.optimizer.__class__.__name__ == 'Adam'
    assert [h['lr'] for h in hist if 'lr' in h] == [1e-3, 1e-3]
    assert all(np.isfinite(h['loss_ce']) for h in hist if 'loss_ce' in h)
    evals = [h['eval'] for h in hist if 'eval' in h]
    assert len(evals) == 1 and sorted(os.listdir(wd)) == ['epoch_1.pth']
    metrics = test_tool.main([TOY_CFG, os.path.join(wd, 'epoch_1.pth'),
                              '--eval', 'acc', '--cfg-options'] + opts,
                             device='cpu')
    assert metrics == evals[0]
