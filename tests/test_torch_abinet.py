"""The port's ABINet family against the JAX package's, on the CPU in
float32, with the JAX weights carried across by ``state_dict_from_jax``.

A tiny ABINet (ResNetABI of width 4, two encoder layers, two language
layers, three LM + fuser rounds, d_model 64) is built twice: without a
rectifier at strides (2, 1, 2, 1, 1) and with a tiny TPS++ at strides
(1, 2, 2, 1, 1), the full-width config's geometry. Its JAX variables, with
perturbed BatchNorm statistics, go into the port's model, and each JAX
module runs on its own subtree of them:

* modules in eval mode within atol 1e-5: ``ABIConvertor``,
  ``PostNormTransformerLayer`` / ``TransformerEncoder``,
  ``ABIVisionDecoder`` (and the nearest resize at ratios other than 2),
  ``ABILanguageDecoder`` (rows without EOS, with EOS at 0, with tied
  maxima), ``ABIFuser``, ``ResNetABI`` at both stride settings;
* ``ABILoss`` within 1e-6 relative (both sum in float32, in another
  order: values near 6 part by 3 ulps, 1.4e-6);
* the whole recognizer: ``predict`` logits within 1e-4 and
  ``simple_test`` texts equal; ``compute_loss`` in train mode with every
  dropout at 0 (the language decoder's token dropout, 0.1 in both
  packages' code, set to 0 on both sides) within 1e-5, and the BatchNorm
  running statistics after it within 1e-5;
* weights: ``state_dict_from_jax`` -> the JAX package's
  ``convert_state_dict`` -> ``merge_flat`` gives the variables back bit
  for bit (tiny and full width), and ``load_state_dict(strict=True)``
  takes it; the rule tables equal the JAX package's;
* ``train_recognizer`` runs two steps with the convertor's
  ``target_lengths`` reaching ``ABILoss``; ``init_recognizer`` /
  ``model_inference`` from one ``.pth`` read the toy images as JAX's do;
  ``tools/train.py`` then ``tools/test.py`` accept
  ``configs/textrecog/abinet/abinet_tps++.py``.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import perturb_batch_stats

import tps_pp_tpu.models.decoders.abi as jabi_dec
from tps_pp_tpu.apis.inference import init_recognizer as jax_init
from tps_pp_tpu.apis.inference import model_inference as jax_infer
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.convertors.abi import ABIConvertor as JaxABIConvertor
from tps_pp_tpu.losses.abi import ABILoss as JaxABILoss
from tps_pp_tpu.models.backbones.resnet_abi import ResNetABI as JaxResNetABI
from tps_pp_tpu.models.encoders.abi import (
    PostNormTransformerLayer as JaxPostNormLayer,
    TransformerEncoder as JaxTransformerEncoder)
from tps_pp_tpu.models.fusers import ABIFuser as JaxABIFuser
from tps_pp_tpu.models.transformer import PositionalEncoding as JaxPE
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import (ABINetRecognizer, build_recognizer,
                                   init_recognizer, model_inference,
                                   train_recognizer)
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.convertors import ABIConvertor
from tps_pp_tpu_torch.datasets import seeded_rngs
from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
from tps_pp_tpu_torch.losses import ABILoss
from tps_pp_tpu_torch.models.decoders import ABILanguageDecoder
from tps_pp_tpu_torch.models.layers import resize_nearest
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABINET_CFG = os.path.join(REPO, 'configs/textrecog/abinet/abinet_tps++.py')
TOY = os.path.join(REPO, 'tests/data/ocr_toy_dataset')
ATOL = 1e-5
T = 8            # the tiny model's max_seq_len
VR5 = np.array([1.0, 0.6, 0.85, 0.35, 1.0], np.float32)


def tiny_cfg(tps: bool, dropout: float = 0.1):
    """The tiny ABINet: with ``tps`` the full-width config's geometry
    (strides (1, 2, 2, 1, 1), TPS++ at 16 x 32), else ABINet's default
    strides (2, 1, 2, 1, 1) and no rectifier; both give 8 x 16 x 64."""
    cfg = dict(
        type='ABINet',
        label_convertor=dict(type='ABIConvertor', dict_type='DICT36',
                             with_unknown=False, with_padding=False,
                             lower=True),
        backbone=dict(type='ResNetABI', stem_channels=4, base_channels=4,
                      arch_settings=[1, 1, 1, 1, 1],
                      strides=[1, 2, 2, 1, 1] if tps else [2, 1, 2, 1, 1]),
        encoder=dict(
            type='ABIVisionModel',
            encoder=dict(type='TransformerEncoder', n_layers=2, n_head=2,
                         d_model=64, d_inner=64, dropout=dropout,
                         max_len=8 * 16),
            decoder=dict(type='ABIVisionDecoder', in_channels=64,
                         num_channels=16, attn_height=8, attn_width=16)),
        decoder=dict(type='ABILanguageDecoder', d_model=64, n_head=2,
                     d_inner=64, n_layers=2, dropout=dropout,
                     detach_tokens=True, use_self_attn=False),
        fuser=dict(type='ABIFuser', d_model=64),
        loss=dict(type='ABILoss', enc_weight=1.0, dec_weight=1.0,
                  fusion_weight=1.0),
        max_seq_len=T,
        iter_size=3)
    if tps:
        cfg['tpsnet'] = dict(type='TPS_PP', num_img_channel=8,
                             img_size=(16, 32), rectified_img_size=(16, 32),
                             point_size=(2, 8), sample_mode='gather')
    return cfg


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope='module', params=[False, True], ids=['plain', 'tps'])
def tiny(request):
    """(config, JAX recognizer, its variables as numpy with perturbed
    BatchNorm statistics, the port's recognizer with them loaded)."""
    cfg = tiny_cfg(request.param)
    jrec = build_jax(cfg)
    v = jax.jit(lambda key: jrec.init_variables(key, (1, 32, 64, 3)))(
        jax.random.PRNGKey(1))
    v = perturb_batch_stats(v, 1)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    return cfg, jrec, v, rec


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ------------------------------------------------------------- modules --

@pytest.mark.parametrize('strings', [
    ['hello', 'a', 'ABC12'],
    ['', 'abcdefghijklmnopqrstuvwxyz'],     # empty, longer than T
    ['0123456', 'z'],                        # exactly T - 1 characters
])
def test_convertor_matches_jax(strings):
    kw = dict(dict_type='DICT36', with_unknown=False, with_padding=False,
              lower=True, max_seq_len=T)
    lc, jlc = ABIConvertor(**kw), JaxABIConvertor(**kw)
    assert (lc.num_classes(), lc.end_idx, lc.padding_idx) == (38, 36, 37)
    assert (jlc.num_classes(), jlc.end_idx, jlc.padding_idx) == (38, 36, 37)
    got, want = lc.str2tensor(strings), jlc.str2tensor(strings)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got['padded_targets'],
                                  want['padded_targets'])
    np.testing.assert_array_equal(got['target_lengths'],
                                  want['target_lengths'])
    for a, b in zip(got['targets'], want['targets']):
        np.testing.assert_array_equal(a, b)
    # a decode of the padded targets as one-hot scores gives the strings
    # back (lower-cased, cut to T - 1)
    onehot = np.eye(37, dtype=np.float32)[got['padded_targets']]
    idx, scores = lc.tensor2idx(onehot)
    assert (idx, scores) == jlc.tensor2idx(onehot)
    assert lc.idx2str(idx) == [s.lower()[:T - 1] for s in strings]
    logits = randn(3, T, 37, seed=len(strings))
    assert lc.tensor2idx(logits) == jlc.tensor2idx(logits)


def test_post_norm_layer_and_encoder_match_jax(tiny):
    """One layer in self-attention, then the encoder; the layer's cross
    attention with a mask runs in the language decoder's test."""
    _, _, v, rec = tiny
    enc_v = v['params']['encoder']['enc']
    enc = rec.model.encoder.encoder
    x = randn(2, 12, 64, seed=1)
    want = JaxPostNormLayer(64, 64, 2, 0.1).apply(
        {'params': enc_v['layer0']}, jnp.asarray(x))
    close(enc.transformer[0](torch.from_numpy(x)), want)
    feat = randn(2, 8, 16, 64, seed=3)
    want = JaxTransformerEncoder(2, 2, 64, 64, 0.1, 8 * 16).apply(
        {'params': enc_v}, jnp.asarray(feat))
    close(enc(torch.from_numpy(feat)), want)


def test_vision_decoder_matches_jax(tiny):
    cfg, jrec, v, rec = tiny
    jdec = jabi_dec.ABIVisionDecoder(in_channels=64, num_channels=16,
                                     max_seq_len=T, num_chars=38)
    feat = randn(3, 8, 16, 64, seed=4)
    want = jdec.apply({'params': v['params']['encoder']['dec'],
                       'batch_stats': v['batch_stats']['encoder']['dec']},
                      jnp.asarray(feat))
    got = rec.model.encoder.decoder(torch.from_numpy(feat))
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        close(got[k], want[k])


@pytest.mark.parametrize('src,dst', [((8, 16), (8, 32)), ((3, 5), (7, 8)),
                                     ((4, 6), (6, 9)), ((8, 8), (3, 5))])
def test_resize_nearest_matches_jax(src, dst):
    """The vision decoder's resize is (H, W/2) -> (H, W), ratios 1 and 2,
    for every feature its U-Net takes (H a multiple of 8, W of 16); the
    function follows JAX's index rule at other ratios too."""
    x = randn(2, 3, *src, seed=5)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            (2, *dst, 3), method='nearest')
    got = resize_nearest(torch.from_numpy(x), dst)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


def _lm_logits():
    """(6, T, 38) logits: row 0 EOS (36) at 3, row 1 at 0, row 2 none, row
    3 EOS at 5 and at T-1, row 4 at T-1, row 5 EOS tied with another class
    at position 2 (argmax takes the first: class 4, not EOS)."""
    x = randn(6, T, 38, seed=6)
    x[:, :, 36] = -9.0
    for r, t in ((0, 3), (1, 0), (3, 5), (3, T - 1), (4, T - 1)):
        x[r, t, 36] = 9.0
    x[5, 2, 4] = x[5, 2, 36] = 9.0
    return x


def test_language_decoder_matches_jax(tiny):
    _, jrec, v, rec = tiny
    jlm = jabi_dec.ABILanguageDecoder(64, 2, 64, 2, T, 0.1, True, 38,
                                      False, 36)
    logits = _lm_logits()
    lm_v = {'params': v['params']['decoder']}
    want_len = jlm.apply(lm_v, jnp.asarray(logits),
                         method=jabi_dec.ABILanguageDecoder._get_length)
    lm = rec.model.decoder
    got_len = lm.get_length(torch.from_numpy(logits))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_len.numpy(), [4, 2, T, 6, T, T])
    want = jlm.apply(lm_v, None, jnp.asarray(logits))
    got = lm(torch.from_numpy(logits))
    for k in ('feature', 'logits'):
        close(got[k], want[k])


def test_use_self_attn_raises_in_both():
    with pytest.raises(NotImplementedError):
        ABILanguageDecoder(use_self_attn=True)
    jlm = jabi_dec.ABILanguageDecoder(64, 2, 64, 1, T, use_self_attn=True)
    with pytest.raises(AssertionError):
        jlm.init(jax.random.PRNGKey(0), None, jnp.zeros((1, T, 38)))


def test_fuser_matches_jax(tiny):
    _, _, v, rec = tiny
    l_feat, v_feat = randn(2, T, 64, seed=7), randn(2, T, 64, seed=8)
    want = JaxABIFuser(64, T, 38).apply({'params': v['params']['fuser']},
                                       jnp.asarray(l_feat),
                                       jnp.asarray(v_feat))
    got = rec.model.fuser(torch.from_numpy(l_feat), torch.from_numpy(v_feat))
    for k in ('feature', 'logits'):
        close(got[k], want[k])


def test_resnet_abi_matches_jax(tiny):
    cfg, _, v, rec = tiny
    bb = dict(cfg['backbone'])
    del bb['type']
    img = randn(2, 32, 64, 3, seed=9)
    want = JaxResNetABI(**bb).apply(
        {'params': v['params']['backbone'],
         'batch_stats': v['batch_stats']['backbone']}, jnp.asarray(img))
    bb = rec.model.backbone
    got = bb.tail(bb.stem_and_head(torch.from_numpy(img))[0])
    assert tuple(got.shape) == want.shape == (2, 8, 16, 64)
    close(got, want)


@pytest.mark.parametrize('texts', [['ab', 'hello', 'x', 'abcdefghijk'],
                                   ['1', '22', '333', '']])
def test_abi_loss_matches_jax(texts):
    lc = ABIConvertor(dict_type='DICT36', with_unknown=False, max_seq_len=T)
    td = lc.str2tensor(texts)
    n = len(texts)
    outputs = {'out_enc': {'logits': randn(n, T, 37, seed=10)},
               'out_decs': [{'logits': randn(n, T, 37, seed=11 + i)}
                            for i in range(3)],
               'out_fusers': [{'logits': randn(n, T, 37, seed=21 + i)}
                              for i in range(3)]}
    weights = dict(enc_weight=0.5, dec_weight=2.0, fusion_weight=1.5,
                   num_classes=38)
    want = JaxABILoss(**weights)(jax.tree.map(jnp.asarray, outputs), {
        'padded_targets': jnp.asarray(td['padded_targets']),
        'target_lengths': jnp.asarray(td['target_lengths'])})
    got = ABILoss(**weights)(jax.tree.map(torch.from_numpy, outputs), {
        'padded_targets': torch.from_numpy(td['padded_targets']),
        'target_lengths': torch.from_numpy(td['target_lengths'])})
    assert got.keys() == want.keys() == {'loss_visual', 'loss_lang',
                                         'loss_fusion'}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=0)


# --------------------------------------------------------- recognizer --

def test_tiny_predict_and_simple_test_match_jax(tiny):
    cfg, jrec, v, rec = tiny
    assert isinstance(rec, ABINetRecognizer)
    assert rec.resolved_decode_mode() == 'single_pass'
    assert rec.resolved_stem_mode() == 'xla'
    assert rec.model.decoder.pad_idx == rec.label_convertor.end_idx == 36
    assert rec.loss_obj.num_classes == 38
    img = randn(5, 32, 64, 3, seed=12)
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(VR5)))
    got = rec.predict(img, VR5)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (5, T, 38)
    close(got, want, atol=1e-4)
    want = jrec.simple_test(jnp_tree(v), jnp.asarray(img), jnp.asarray(VR5))
    got = rec.simple_test(img, VR5)
    assert [r['text'] for r in got] == [r['text'] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g['score'], w['score'], atol=1e-4)


def test_tiny_compute_loss_in_train_mode_matches_jax(monkeypatch):
    """Dropout 0 everywhere (the token dropout set to 0 on both sides), so
    the train-mode pass is deterministic: batch BatchNorm statistics, the
    training warp of TPS++ and the loss of every branch."""
    monkeypatch.setattr(jabi_dec, 'PositionalEncoding',
                        lambda *a, dropout=0.0, **k: JaxPE(*a, **k))
    cfg = tiny_cfg(True, dropout=0.0)
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(lambda key: jrec.init_variables(
        key, (1, 32, 64, 3)))(jax.random.PRNGKey(2)), 2)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    rec.model.decoder.token_encoder.dropout = 0.0
    td = rec.label_convertor.str2tensor(['hi', 'abc', '', 'text123x', 'q'])
    batch = dict(img=randn(5, 32, 64, 3, seed=13), valid_ratio=VR5,
                 padded_targets=td['padded_targets'],
                 target_lengths=td['target_lengths'])
    total, (losses, state) = jrec.compute_loss(
        jnp_tree(v), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0), train=True)
    got_total, got = rec.compute_loss(batch, torch.Generator())
    assert got.keys() == losses.keys()
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(losses[k]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got_total.detach()), float(total),
                               atol=1e-5, rtol=0)
    want = state_dict_from_jax(dict(params=v['params'], **state), cfg)
    sd = rec.model.state_dict()
    stats = [k for k in sd if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) == len(jax.tree.leaves(state)) == 2 * 23
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


# -------------------------------------------------------------- weights --

def _random_variables(cfg, shape, seed=0):
    """Random float32 leaves in the shapes of the JAX recognizer's
    variables (no JAX init needed for a bit-exact round trip)."""
    rec = build_jax(cfg)
    shapes = jax.eval_shape(
        lambda: rec.init_variables(jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def _full_cfg():
    model = dict(load_config(ABINET_CFG)['model'])
    return dict(model, tpsnet=dict(model['tpsnet'], sample_mode='gather'))


@pytest.mark.parametrize('which', ['tiny', 'tiny_tps', 'full'])
def test_state_dict_round_trips_through_jax_converter(which):
    if which == 'full':
        cfg, shape = _full_cfg(), (1, 32, 128, 3)
    else:
        cfg, shape = tiny_cfg(which == 'tiny_tps'), (1, 32, 64, 3)
    v = _random_variables(cfg, shape)
    sd = convert.state_dict_from_jax(v, cfg)
    model = build_recognizer(cfg, device='cpu').model
    model.load_state_dict(sd, strict=True)
    assert torch.equal(
        sd['decoder.token_encoder.position_table'],
        model.decoder.pos_encoder.position_table)

    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = jtc.filter_rules_to_state(jtc.rules_for_config(cfg), sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('which', ['tiny', 'tiny_tps', 'full'])
def test_rule_tables_match_the_jax_package(which):
    cfg = _full_cfg() if which == 'full' else tiny_cfg(which == 'tiny_tps')
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))


# ---------------------------------------------------------- entry points --

def test_build_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='ABINetRecognizer: no CUDA'):
        build_recognizer(tiny_cfg(True))
    rec = build_recognizer(load_config(ABINET_CFG)['model'], device='cpu')
    assert isinstance(rec, ABINetRecognizer)
    assert rec.device.type == 'cpu'
    assert rec.predict(np.zeros((1, 32, 128, 3), np.float32)).shape == (
        1, 26, 37)


class Crops:
    """Seeded uint8 crops with labels through a train pipeline."""

    def __init__(self, n, pipeline):
        g = np.random.default_rng(0)
        self.imgs = [g.integers(0, 256, (20 + 3 * i, 40 + 7 * i, 3),
                                np.uint8) for i in range(n)]
        self.texts = ['ab', 'hello', '', 'x7'][:n]
        self.pipeline = Compose(pipeline)

    def __len__(self):
        return len(self.imgs)

    def sample(self, i, key=None):
        return self.pipeline(dict(img=self.imgs[i], text=self.texts[i],
                                  img_info=dict(filename=None),
                                  **seeded_rngs(key)))


def narrow(pipeline, width=64, ndarray=False):
    """``pipeline`` resizing to 32 x ``width``, loading ndarrays in place
    of files with ``ndarray``."""
    out = []
    for t in pipeline:
        t = dict(t)
        if ndarray and t['type'] == 'LoadImageFromFile':
            t['type'] = 'LoadImageFromNdarray'
        if t['type'] == 'ResizeOCR':
            t.update(min_width=width, max_width=width)
        out.append(t)
    return out


def test_train_recognizer_passes_target_lengths():
    """Two steps of batch 2 through the ABINet config's train pipeline:
    every step's loss sees the convertor's lengths."""
    rec = build_recognizer(tiny_cfg(True), device='cpu',
                           param_dtype='float32')
    pipeline = narrow(load_config(ABINET_CFG)['train_pipeline'],
                      ndarray=True)
    seen = []
    loss = rec.loss_obj

    def recording(outputs, targets_dict, valid_ratio=None):
        seen.append(targets_dict['target_lengths'].tolist())
        return loss(outputs, targets_dict, valid_ratio)

    rec.loss_obj = recording
    ds = Crops(4, pipeline)
    opt, history = train_recognizer(
        rec, ds, dict(optimizer=dict(type='Adam', lr=1e-4),
                      samples_per_gpu=2, total_epochs=1, log_interval=1))
    assert opt.count == 2 and len(seen) == 2
    assert sorted(sum(seen, [])) == sorted(
        rec.label_convertor.str2tensor(ds.texts)['target_lengths'].tolist())
    for h in history[:2]:
        assert {'loss_visual', 'loss_lang', 'loss_fusion'} <= h.keys()
        assert np.isfinite(h['loss'])


def test_init_recognizer_and_model_inference_match_jax(tmp_path):
    """One ``.pth`` of the tiny ABINet + TPS++ (the reference's keys,
    mmcv's wrapper) into both packages' ``init_recognizer``, then
    ``model_inference`` on the ten toy images through the ABINet test
    pipeline at width 64."""
    cfg = tiny_cfg(True)
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(lambda key: jrec.init_variables(
        key, (1, 32, 64, 3)))(jax.random.PRNGKey(3)), 3)
    pth = str(tmp_path / 'abinet.pth')
    torch.save({'meta': {}, 'state_dict': {
        f'module.{k}': t for k, t in state_dict_from_jax(v, cfg).items()}},
        pth)
    config = dict(model=cfg, test_pipeline=narrow(
        load_config(ABINET_CFG)['test_pipeline']))
    jr, jv = jax_init(config, pth, input_shape=(1, 32, 64, 3))
    rec = init_recognizer(config, pth, device='cpu')
    imgs = [cv2.imread(os.path.join(TOY, f'img_{i}.jpg')) for i in range(10)]
    for batch_mode in (False, True):
        want = jax_infer(jr, jv, imgs, batch_mode=batch_mode)
        got = model_inference(rec, imgs, batch_mode=batch_mode)
        assert [r['text'] for r in got] == [r['text'] for r in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g['score'], w['score'], atol=1e-4)


def test_train_cli_then_test_cli_take_the_abinet_config(tmp_path):
    """``configs/textrecog/abinet/abinet_tps++.py`` with the tiny model and
    its pipelines at width 64: one epoch with a checkpoint, then
    ``tools/test.py`` on it gives the epoch's evaluation."""
    base = load_config(ABINET_CFG)['data']
    test = dict(base['test'], pipeline=narrow(base['test']['pipeline']))
    opts = [f'model={tiny_cfg(True)!r}', 'total_epochs=1',
            'log_config.interval=5', 'data.samples_per_gpu=32',
            'data.workers_per_gpu=0', f'data.val={test!r}',
            f'data.test={test!r}', 'data.train.pipeline='
            f'{narrow(base["train"]["pipeline"])!r}']
    wd = str(tmp_path / 'wd')
    opt, hist = train_tool.main([ABINET_CFG, '--work-dir', wd, '--seed', '1',
                                 '--cfg-options'] + opts, device='cpu')
    assert opt.count == 4        # 100 toy samples at batch 32
    evals = [h['eval'] for h in hist if 'eval' in h]
    assert len(evals) == 1 and sorted(os.listdir(wd)) == ['epoch_1.pth']
    metrics = test_tool.main([ABINET_CFG, os.path.join(wd, 'epoch_1.pth'),
                              '--cfg-options'] + opts, device='cpu')
    assert metrics == evals[0]

