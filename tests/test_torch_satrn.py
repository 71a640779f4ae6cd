"""The port's SATRN family and NRTR's modality-transform trunk against the JAX
package, on the CPU in float32, with the JAX weights carried across by
``state_dict_from_jax``; and the three repairs that these modules needed.

Tolerances (as ``tests/test_torch_sar.py``'s): modules within 1e-5
absolute, or within 1e-5 of the largest magnitude of the output
(``close_scaled``) where float32 sums of hundreds of terms are taken in
other orders; probabilities within 1e-5 and the greedy argmax equal; the
loss within 1e-5 relative, the gradients within 1e-4 relative and 1e-4 of
the largest gradient.

* modules: ``ShallowCNN`` and ``NRTRModalityTransform`` (eval mode, and
  train mode with their BatchNorm statistics), the adaptive 2D positional
  encoding and the encoder's doubled feature, the locality-aware FFN (its
  train-mode running variance the biased one), ``SatrnEncoder`` with and
  without its per-column mask;
* small models (SATRN with ``TFDecoder``, NRTR on the modality transform):
  teacher-forced logits, the greedy ``predict`` on ``steps`` and on the
  whole decode's plain version (the SATRN encoder as a module before it),
  ``compute_loss`` and its gradients;
* the repairs: ``decode_full_fused`` routes by ``SUPPORTS_FUSED_FORWARD``,
  ``'auto'`` asks only the decoder's predicate of a recognizer whose
  encoder does not fuse, and ``rules_for_config`` dispatches on the
  backbone and encoder types (and raises for one it has no rules for);
* entry points: ``init_recognizer`` / ``model_inference`` against JAX's
  with SATRN's test pipeline (its rotation TTA), and the train-then-test
  CLIs on ``nrtr_modality_transform_toy_dataset.py`` and on
  ``satrn_small.py`` over the same toy images.

The five shipped configs at full width are in
``tests/test_torch_transformer_full.py``.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import load_sub, perturb_batch_stats

from tps_pp_tpu.apis.inference import init_recognizer as jax_init
from tps_pp_tpu.apis.inference import model_inference as jax_infer
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.models.backbones import misc as jmisc
from tps_pp_tpu.models.encoders import satrn as jsatrn
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import (build_recognizer, init_recognizer,
                                   model_inference)
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.models.backbones import (NRTRModalityTransform,
                                               ShallowCNN)
from tps_pp_tpu_torch.models.encoders import NRTREncoder, SatrnEncoder
from tps_pp_tpu_torch.models.encoders.nrtr import sequence_mask
from tps_pp_tpu_torch.models.encoders.satrn import (LocalityAwareFeedforward,
                                                    width_mask)
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SATRN_SMALL_CFG = os.path.join(REPO, 'configs/textrecog/satrn/satrn_small.py')
MODALITY_TOY_CFG = os.path.join(
    REPO, 'configs/textrecog/nrtr/nrtr_modality_transform_toy_dataset.py')
ATOL = 1e-5
VR3 = np.array([1.0, 0.5, 0.8], np.float32)
LC36 = dict(type='AttnConvertor', dict_type='DICT36', with_unknown=True)


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


def jax_train(module, v, *args, **kw):
    """(output, new batch_stats) of a train-mode apply without dropout."""
    out, state = module.apply(jax.tree.map(jnp.asarray, v), *args,
                              train=True, mutable=['batch_stats'], **kw)
    return out, jax.tree.map(np.asarray, state['batch_stats'])


def check_stats(module, stats, rules, fp, tp=''):
    """The port's running statistics against JAX's new batch_stats."""
    want = convert.convert_rules(
        {'params': _wrap(_params_like(stats), fp),
         'batch_stats': _wrap(stats, fp)},
        [r for r in rules if r[1].startswith(fp + '/') and r[2] == 'bn'])
    cut = len(tp) + 1 if tp else 0
    got = module.state_dict()
    for k, t in want.items():
        if k.endswith(('running_mean', 'running_var')):
            close(got[k[cut:]], t.numpy())


def _wrap(t, fp):
    for part in reversed(fp.split('/')):
        t = {part: t}
    return t


def _params_like(stats):
    """A params tree with a scale and bias beside every BatchNorm's
    statistics, so that the 'bn' rules find their module."""
    if 'mean' in stats:
        return {'scale': stats['mean'], 'bias': stats['mean']}
    return {k: _params_like(v) for k, v in stats.items()}


# ------------------------------------------------------------ trunks --

@pytest.mark.parametrize('train', [False, True])
def test_shallow_cnn_matches_jax(train):
    x = randn(2, 32, 40, 3, seed=1)
    jm = jmisc.ShallowCNN(input_channels=3, hidden_dim=16)
    v = jax_init_vars(jm, jnp.asarray(x))
    m = load_sub(ShallowCNN(3, 16), v, convert.shallow_cnn_rules(),
                 'backbone', 'backbone').train(train)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    if train:
        want, stats = jax_train(jm, v, jnp.asarray(x))
        check_stats(m, stats, convert.shallow_cnn_rules(), 'backbone',
                    'backbone')
    else:
        want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (2, 8, 10, 16)
    close_scaled(got, want)


@pytest.mark.parametrize('train', [False, True])
def test_modality_transform_matches_jax(train):
    """Conv, ReLU, then BatchNorm, twice; the (h, c) flatten order of the
    JAX package (h-major) reaches the Linear."""
    x = randn(2, 32, 48, 3, seed=2)
    jm = jmisc.NRTRModalityTransform()
    v = jax_init_vars(jm, jnp.asarray(x))
    m = load_sub(NRTRModalityTransform(), v, convert.nrtr_modality_rules(),
                 'backbone', 'backbone').train(train)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    if train:
        want, stats = jax_train(jm, v, jnp.asarray(x))
        check_stats(m, stats, convert.nrtr_modality_rules(), 'backbone',
                    'backbone')
    else:
        want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (2, 1, 12, 512)
    close_scaled(got, want)
    # another flatten order (c-major) gives another output
    with torch.no_grad():
        y = m.bn_2(torch.relu(m.conv_2(m.bn_1(torch.relu(m.conv_1(
            torch.from_numpy(x).permute(0, 3, 1, 2)))))))
        other = m.linear(y.permute(0, 3, 1, 2).reshape(2, 12, 512))
    assert float((other - got[:, 0]).abs().max()) > 1e-2


# ----------------------------------------------------------- encoder --

SATRN_DIMS = dict(n_layers=2, n_head=4, d_k=8, d_v=8, d_model=32,
                  n_position=100, d_inner=64, dropout=0.0)
# the small models' depth: one layer of each transformer
SMALL_LAYERS = 1


@pytest.fixture(scope='module')
def satrn_encoder():
    feat = randn(3, 4, 10, 32, seed=3)
    jm = jsatrn.SatrnEncoder(**SATRN_DIMS)
    v = jax_init_vars(jm, jnp.asarray(feat), valid_ratio=jnp.asarray(VR3))
    m = SatrnEncoder(**SATRN_DIMS)
    # the sinusoid tables are buffers of the module, made from its widths
    sd = convert.convert_rules({k: {'encoder': t} for k, t in v.items()},
                               convert.satrn_rules(SATRN_DIMS['n_layers']))
    sd = {k[len('encoder.'):]: t for k, t in sd.items()}
    sd.update((k, t) for k, t in m.state_dict().items()
              if k.endswith('_position_encoder'))
    m.load_state_dict(sd, strict=True)
    return jm, v, m, feat


def test_positional_encoding_counts_the_feature_twice(satrn_encoder):
    """The positional encoding's output holds its input, and the encoder
    adds it to that input again (``tps_pp_tpu/models/encoders/satrn.py:
    121-123``): the first layer sees 2 feat + h_pos + w_pos, as in JAX."""
    jm, v, m, feat = satrn_encoder
    pe = m.position_enc.eval()
    x = torch.from_numpy(feat)
    jpe = jsatrn.Adaptive2DPositionalEncoding(32, 100, 100, 0.0)
    want = jpe.apply({'params': v['params']['position_enc']},
                     jnp.asarray(feat))
    with torch.no_grad():
        got = pe(x)
        close(got, want)
        gates = [torch.sigmoid(s[2](torch.relu(s[0](x.mean(
            (1, 2), keepdim=True).permute(0, 3, 1, 2)))))
            for s in (pe.h_scale, pe.w_scale)]
        h_pos = gates[0] * pe.h_position_encoder[:, :, :4]
        w_pos = gates[1] * pe.w_position_encoder[:, :, :, :10]
        close(got, x + (h_pos + w_pos).permute(0, 2, 3, 1))
    # what the first layer takes: the feature twice, plus the sinusoids
    seen = []
    layer0 = m.layer_stack[0]
    hook = layer0.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    with torch.no_grad():
        m.eval()(x)
    hook.remove()
    close(seen[0].reshape(3, 4, 10, 32),
          np.asarray(want) + feat)


def test_width_mask_is_built_per_column():
    """Column j of every row is valid iff j < min(W, ceil(W * ratio)),
    as JAX builds it; NRTR's mask over the flattened tokens differs."""
    vr = torch.tensor([0.31, 0.5, 1.0, 0.0])
    got = width_mask(vr, 4, 10)
    want = np.repeat((np.arange(10)[None] < np.minimum(
        10, np.ceil(10 * vr.numpy()))[:, None])[:, None], 4, 1)
    np.testing.assert_array_equal(got.numpy(), want.reshape(4, 40))
    assert not torch.equal(got, sequence_mask(vr, 40))
    assert width_mask(None, 4, 10) is None


@pytest.mark.parametrize('masked', [True, False])
def test_satrn_encoder_matches_jax(satrn_encoder, masked):
    jm, v, m, feat = satrn_encoder
    vr = VR3 if masked else None
    want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(feat),
                    valid_ratio=None if vr is None else jnp.asarray(vr))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(feat),
                       None if vr is None else torch.from_numpy(vr))
    assert tuple(got.shape) == want.shape == (3, 40, 32)
    close_scaled(got, want)


def test_satrn_encoder_train_mode_matches_jax(satrn_encoder):
    """Train mode without dropout: the locality-aware FFN's BatchNorms on
    the batch's statistics, their running variance the biased one."""
    jm, v, m, feat = satrn_encoder
    m = copy.deepcopy(m).train()
    want, stats = jax_train(jm, v, jnp.asarray(feat),
                            valid_ratio=jnp.asarray(VR3))
    with torch.no_grad():
        got = m(torch.from_numpy(feat), torch.from_numpy(VR3))
    close_scaled(got, want)
    check_stats(m, stats, convert.satrn_rules(SATRN_DIMS['n_layers']),
                'encoder', 'encoder')


def test_locality_aware_feedforward_matches_jax():
    x = randn(2, 4, 6, 16, seed=5)
    jm = jsatrn.LocalityAwareFeedforward(16, 24)
    v = jax_init_vars(jm, jnp.asarray(x))
    rules = [(tp.replace('encoder.layer_stack.0.feed_forward', 'ff'),
              fp.replace('encoder/layer0/feed_forward', 'ff'), kind)
             for tp, fp, kind in convert.satrn_rules(1)
             if '.feed_forward.' in tp]
    m = load_sub(LocalityAwareFeedforward(16, 24), v, rules, 'ff', 'ff')
    with torch.no_grad():
        close_scaled(m.eval()(torch.from_numpy(x)),
                     jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
        got = m.train()(torch.from_numpy(x))
    want, stats = jax_train(jm, v, jnp.asarray(x))
    close_scaled(got, want)
    check_stats(m, stats, rules, 'ff', 'ff')
    n = 2 * 4 * 6
    assert n / (n - 1) > 1.0 + 1e-3     # biased and unbiased differ


# ------------------------------------------------------ small models --

def small_cfg(kind, dropout=0.1, **over):
    """SATRN (ShallowCNN, SatrnEncoder, the decoder as ``TFDecoder``) or
    NRTR on the modality transform, at small widths."""
    if kind == 'satrn':
        return dict(
            type='SATRN', label_convertor=LC36,
            backbone=dict(type='ShallowCNN', input_channels=3,
                          hidden_dim=32),
            encoder=dict(type='SatrnEncoder', **dict(
                SATRN_DIMS, n_layers=SMALL_LAYERS, dropout=dropout)),
            decoder=dict(type='TFDecoder', n_layers=SMALL_LAYERS,
                         d_embedding=32,
                         n_head=4, d_model=32, d_inner=64, d_k=8, d_v=8,
                         dropout=dropout),
            loss=dict(type='TFLoss'), max_seq_len=6, **over)
    return dict(
        type='NRTR', label_convertor=LC36,
        backbone=dict(type='NRTRModalityTransform'),
        encoder=dict(type='NRTREncoder', n_layers=SMALL_LAYERS,
                     dropout=dropout),
        decoder=dict(type='NRTRDecoder', n_layers=SMALL_LAYERS,
                     dropout=dropout),
        loss=dict(type='TFLoss'), max_seq_len=6, **over)


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


@pytest.mark.parametrize('kind', ['satrn', 'modality'])
def test_small_models_match_jax(kind):
    """Teacher-forced logits (eval mode) within 1e-5 of their scale; the
    greedy ``predict`` on ``steps`` and on the whole decode's plain
    version: probabilities within 1e-5 of JAX's, the argmax and the texts
    equal."""
    cfg = small_cfg(kind)
    jrec, v, rec = small_models(cfg)
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
    assert jrec.resolved_decode_mode() == 'steps'
    for mode in ('steps', 'fused40_bf16'):
        rec.decode_mode = mode
        got = rec.predict(img, VR3).numpy()
        assert got.shape == want.shape == (3, 6, 38)
        close(got, want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert [r['text'] for r in rec.simple_test(img, VR3)] == [
        r['text'] for r in jrec.simple_test(jv, jnp.asarray(img),
                                            jnp.asarray(VR3))]


@pytest.mark.parametrize('kind', ['satrn', 'modality'])
def test_small_compute_loss_and_gradients_match_jax(kind):
    """Train mode without dropout (BatchNorm on the batch's statistics),
    f32: TFLoss within 1e-5 relative, every gradient within 1e-4 relative
    and 1e-4 of the largest, the running statistics within 1e-5."""
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
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jv['params'])
    want = state_dict_from_jax(jax.tree.map(np.asarray, dict(
        params=grads, batch_stats=stats)), cfg)
    total, _ = rec.compute_loss(batch)
    assert abs(float(total.detach()) - float(loss)) <= 1e-5 * abs(
        float(loss))
    total.backward()
    scale = max(float(want[n].abs().max())
                for n, _ in rec.model.named_parameters())
    for n, p in rec.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=n)
    for n, b in rec.model.state_dict().items():
        if n.endswith(('running_mean', 'running_var')):
            close(b, want[n].numpy())


# ----------------------------------------------------------- repairs --

def test_decode_full_fused_routes_by_supports_fused_forward():
    """The whole decode's path calls a fusing encoder (NRTR's) with
    ``fused=True`` and runs one that does not fuse (SATRN's) as a module,
    as JAX routes them; before, SATRN's encoder was called with
    ``fused=True`` and raised."""
    assert NRTREncoder.SUPPORTS_FUSED_FORWARD
    assert not SatrnEncoder.SUPPORTS_FUSED_FORWARD
    img = torch.from_numpy(randn(2, 32, 64, 3, seed=7))
    vr = torch.tensor([1.0, 0.5])
    for kind in ('satrn', 'modality'):
        rec = build_recognizer(small_cfg(kind), device='cpu').init_weights(3)
        calls = []
        enc = rec.model.encoder
        fwd = enc.forward
        enc.forward = lambda *a, **k: calls.append(k.get('fused')) or \
            fwd(*a, **k)
        with torch.no_grad():
            got = rec.model.decode_full_fused(img, vr)
            want = rec.model.decoder.fused_full_decode(
                rec.model.encode(rec.model.extract_feat(img), vr), vr)
        assert calls[0] is (True if kind == 'modality' else None), calls
        close(got, want, 1e-6)


def test_auto_asks_only_the_decoder_of_an_encoder_that_does_not_fuse():
    """On the card in bf16 (asked as if there), ``'auto'`` picks the whole
    decode for SATRN whenever the decoder's kernels take it; before, an
    encoder without ``kernel_accepts`` sent every SATRN to ``steps``."""
    def cfg(d_k):
        c = small_cfg('satrn', dtype='bfloat16')
        widths = dict(n_head=2, d_k=d_k, d_v=d_k, d_model=2 * d_k)
        c['backbone'] = dict(c['backbone'], hidden_dim=2 * d_k)
        c['encoder'] = dict(c['encoder'], **widths)
        c['decoder'] = dict(c['decoder'], d_embedding=2 * d_k, **widths)
        return c
    rec = build_recognizer(cfg(32), device='cpu')
    assert not hasattr(rec.model.encoder, 'kernel_accepts')
    assert rec.auto_decode_mode('cuda') == 'fused40_bf16'
    assert rec.auto_decode_mode('cuda', 40) == 'fused40_bf16'
    assert rec.auto_decode_mode('cuda', 513) == 'steps'
    assert rec.auto_decode_mode('cpu', 40) == 'steps'
    assert build_recognizer(cfg(16), device='cpu').auto_decode_mode(
        'cuda', 40) == 'steps'              # d_k 16: kernel 4 refuses
    nrtr = build_recognizer(small_cfg('modality', dtype='bfloat16'),
                            device='cpu')
    assert nrtr.auto_decode_mode('cuda', 40) == 'fused40_bf16'


@pytest.mark.parametrize('kind', ['satrn', 'modality'])
def test_rules_for_config_dispatches_on_the_types(kind):
    """The backbone's and the encoder's types pick their tables, as in
    JAX; before, any backbone but ResNet31 was read as ResNetABI and any
    encoder as NRTR's."""
    cfg = small_cfg(kind)
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))
    for key in ('backbone', 'encoder', 'decoder'):
        bad = dict(cfg, **{key: dict(cfg[key], type='Unported')})
        with pytest.raises(ValueError, match=f'{key} type .Unported.'):
            convert.rules_for_config(bad)


# ------------------------------------------------------- entry points --

def _crops(n, seed=0):
    """Seeded BGR uint8 crops of heights 16-48 and widths 8-120, and a
    tall one (60 x 20), which the rotation TTA turns."""
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (int(g.integers(16, 49)),
                                int(g.integers(8, 121)), 3), np.uint8)
            for _ in range(n)] + [g.integers(0, 256, (60, 20, 3), np.uint8)]


def test_init_recognizer_and_model_inference_match_jax(tmp_path):
    """One ``.pth`` of the small SATRN into both packages'
    ``init_recognizer``, then ``model_inference`` through SATRN's test
    pipeline (32 x 100, the rotation TTA), alone and batched: the texts
    equal, the scores within 1e-5."""
    cfg = small_cfg('satrn')
    jrec = build_jax(cfg)
    v = perturb_batch_stats(jax.jit(
        lambda k: jrec.init_variables(k, (1, 32, 100, 3)))(
        jax.random.PRNGKey(4)), 4)
    pth = str(tmp_path / 'satrn.pth')
    torch.save({'meta': {}, 'state_dict': state_dict_from_jax(v, cfg)}, pth)
    pipeline = [dict(t) for t in load_config(SATRN_SMALL_CFG)[
        'test_pipeline']]
    config = dict(model=cfg, test_pipeline=pipeline)
    jr, jv = jax_init(config, pth, input_shape=(1, 32, 100, 3))
    rec = init_recognizer(config, pth, device='cpu')
    imgs = _crops(2)
    for batch_mode in (False, True):
        want = jax_infer(jr, jv, imgs, batch_mode=batch_mode)
        got = model_inference(rec, imgs, batch_mode=batch_mode)
        assert [r['text'] for r in got] == [r['text'] for r in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g['score'], w['score'], atol=1e-5)


@pytest.mark.parametrize('config', ['modality_toy', 'satrn_small'])
def test_train_cli_then_test_cli_take_the_configs(tmp_path, config):
    """The modality transform's toy config and ``satrn_small.py`` (at its
    full width, over the same ten toy images in place of its datasets),
    trained once at batch 5 with a checkpoint and an evaluation, then
    ``tools/test.py`` on the checkpoint gives that evaluation."""
    base = load_config(MODALITY_TOY_CFG)['data']
    path = MODALITY_TOY_CFG if config == 'modality_toy' else SATRN_SMALL_CFG
    toy = dict(base['test'])
    toy['datasets'] = [dict(toy['datasets'][0])]
    train = [dict(toy['datasets'][0], test_mode=False)]
    pipes = load_config(path)
    val = dict(toy, pipeline=pipes['test_pipeline'])
    train = dict(type='UniformConcatDataset', datasets=train,
                 pipeline=pipes['train_pipeline'])
    opts = ['total_epochs=1', 'log_config.interval=1',
            'data.samples_per_gpu=5', 'data.workers_per_gpu=0',
            f'data.val={val!r}', f'data.test={val!r}', f'data.train={train!r}']
    wd = str(tmp_path / 'wd')
    opt, hist = train_tool.main([path, '--work-dir', wd, '--seed', '1',
                                 '--cfg-options'] + opts, device='cpu')
    assert opt.count == 2 and opt.optimizer.__class__.__name__ == 'Adam'
    assert all(np.isfinite(h['loss_ce']) for h in hist if 'loss_ce' in h)
    evals = [h['eval'] for h in hist if 'eval' in h]
    assert len(evals) == 1 and sorted(os.listdir(wd)) == ['epoch_1.pth']
    metrics = test_tool.main([path, os.path.join(wd, 'epoch_1.pth'),
                              '--eval', 'acc', '--cfg-options'] + opts,
                             device='cpu')
    assert metrics == evals[0]
