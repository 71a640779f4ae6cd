"""The port's deployment export (``tps_pp_tpu_torch/utils/export.py``) and
its operators on the CPU, against the JAX package's ``utils/export.py``.

* The tiny CRNN of ``tests/test_export.py`` on the JAX weights: the
  port's ``export_serialized`` -> ``load_serialized`` output within 1e-5
  of JAX's ``load_serialized(...).call`` and of the port's ``predict``;
  ``ExportedRecognizer`` texts equal to JAX's.
* The tiny NRTR + TPS++ (the flagship's topology at toy widths) on the JAX
  weights: the exported graph holds the path's operators
  (``tps_sampler``, ``encoder_forward``, ``full_decode``; the fused step's
  and the fused stem's where they run), its output equals the eager
  ``predict`` exactly (the same plain versions run) and, on the whole
  decode, JAX's ``predict`` in argmax and within 1e-6 (the tolerance of
  ``tests/test_torch_flagship.py``); ``aot_compile`` on the CPU equals
  ``predict``; ``ExportedRecognizer`` pads a smaller batch.
* Greedy ``steps`` with its early exit, which a trace and ``aot_compile``
  take in its device form (``greedy_decode(device_exit=True)``): the
  tiny NRTR on the module step and on ``use_fused_step``, a tiny SAR and
  a tiny RobustScanner,
  each row forced to emit EOS at a chosen step (at step 0, mid-sequence,
  never): the exported program and the CPU ``aot_compile`` equal the
  eager ``predict`` (which reads the exit on the host) exactly.
* ``torch.library.opcheck`` on every operator of ``torch.ops.tps_pp``
  with CPU inputs (schema, fake kernel, dynamic-shape tracing); the step
  operators with and without their ``skip`` flag.
* The ``export_model`` CLI's ``export``, ``aot`` and ``test`` modes.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_util import jax_flagship, jax_recognizer, jnp_tree

import jax
import jax.numpy as jnp

from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.utils import export as jexport

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.datasets.pipelines.cv_ops import png_encode
from tps_pp_tpu_torch.models.decoders import NRTRDecoder
from tps_pp_tpu_torch.models.encoders.nrtr import NRTREncoder, sequence_mask
from tps_pp_tpu_torch.ops import _lib, tps
from tps_pp_tpu_torch.tools import export_model
from tps_pp_tpu_torch.utils import export
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
VR5 = np.array([1.0, 0.6, 0.85, 0.35, 1.0], np.float32)
CRNN_CFG = dict(
    type='CRNNNet',
    label_convertor=dict(type='CTCConvertor', dict_type='DICT36',
                         with_unknown=False, lower=True),
    backbone=dict(type='VeryDeepVgg', leaky_relu=False, input_channels=1),
    decoder=dict(type='CRNNDecoder', in_channels=512, rnn_flag=False),
    loss=dict(type='CTCLoss'),
    max_seq_len=8,
)


@pytest.fixture(scope='module')
def crnn():
    """(JAX recognizer, its variables, the port's on the same weights)."""
    jrec = build_jax(CRNN_CFG)
    v = jax.tree.map(np.asarray, jrec.init_variables(
        jax.random.PRNGKey(0), (2, 32, 100, 1)))
    rec = build_recognizer(CRNN_CFG, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, CRNN_CFG), strict=True)
    return jrec, v, rec


def test_crnn_serialized_roundtrip_matches_jax(crnn):
    jrec, v, rec = crnn
    img = np.random.default_rng(1).standard_normal(
        (2, 32, 100, 1)).astype(np.float32)
    ones = np.ones((2,), np.float32)
    want = np.asarray(jexport.load_serialized(jexport.export_serialized(
        jrec, jnp_tree(v), batch=2, input_shape=(32, 100, 1))).call(
            jnp.asarray(img), jnp.asarray(ones)))
    blob = export.export_serialized(rec, 2, (32, 100, 1))
    assert isinstance(blob, bytes) and len(blob) > 1000
    with torch.no_grad():
        got = export.load_serialized(blob).module()(
            torch.from_numpy(img), torch.from_numpy(ones)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, rec.predict(img).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_crnn_exported_recognizer_matches_jax(crnn):
    jrec, v, rec = crnn
    img = np.random.default_rng(0).standard_normal(
        (2, 32, 100, 1)).astype(np.float32)
    want = jexport.ExportedRecognizer(jrec, jnp_tree(v), batch=4,
                                      input_shape=(32, 100, 1)).simple_test(
                                          img)
    got = export.ExportedRecognizer(rec, 4, (32, 100, 1)).simple_test(img)
    assert [r['text'] for r in got] == [r['text'] for r in want]
    assert [r['text'] for r in got] == \
        [r['text'] for r in rec.simple_test(img)]


@pytest.fixture(scope='module')
def tiny():
    """The tiny flagship's JAX weights and config, a batch of 5 and JAX's
    ``steps`` probabilities on it."""
    jrec, v, cfg = jax_flagship(tiny=True, seed=2)
    img = np.random.default_rng(2).standard_normal((5, 32, 64, 3)).astype(
        np.float32)
    probs = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                    jnp.asarray(VR5)))
    return v, cfg, img, probs


def port(cfg, v, decode_mode, fused_step=False, stem_mode='xla',
         early_exit=True):
    cfg = dict(cfg, decode_mode=decode_mode, stem_mode=stem_mode,
               early_exit=early_exit,
               decoder=dict(cfg['decoder'], use_fused_step=fused_step))
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    return rec


# (decode mode, fused step, stem mode, early exit) -> the operators the
# exported graph holds
PATHS = {
    'fused40_bf16': (('fused40_bf16', False, 'xla', True),
                     {'tps_sampler', 'encoder_forward', 'full_decode'}),
    'fused40': (('fused40', False, 'xla', True),
                {'tps_sampler', 'encoder_forward', 'full_decode'}),
    'fused40_bf16, fused stem': (
        ('fused40_bf16', False, 'fused', True),
        {'basic_block_cp', 'tps_sampler', 'encoder_forward', 'full_decode'}),
    'steps, use_fused_step, no early exit': (
        ('steps', True, 'xla', False),
        {'tps_sampler', 'self_attn_step', 'cross_ffn_step'}),
}


def operators(ep):
    return {str(n.target).split('.')[1] for n in ep.graph.nodes
            if str(n.target).startswith('tps_pp.')}


@pytest.mark.parametrize('path', list(PATHS))
def test_flagship_export_holds_the_operators_and_matches(tiny, path):
    v, cfg, img, probs = tiny
    (mode, fused_step, stem_mode, early_exit), ops = PATHS[path]
    rec = port(cfg, v, mode, fused_step, stem_mode, early_exit)
    assert rec.resolved_decode_mode() == mode
    ep = export.load_serialized(export.export_serialized(rec, 5,
                                                         (32, 64, 3)))
    assert operators(ep) == ops
    with torch.no_grad():
        got = ep.module()(torch.from_numpy(img), torch.from_numpy(VR5))
    eager = rec.predict(img, VR5, bucket_batch=False)
    assert torch.equal(got, eager)
    if mode == 'fused40_bf16':
        # the whole decode against JAX's steps decode, as
        # tests/test_torch_flagship.py holds predict
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      probs.argmax(-1))
        np.testing.assert_allclose(got.numpy(), probs, atol=1e-6, rtol=0)


def test_flagship_export_matches_jax_fused_decode(tiny, monkeypatch):
    """JAX's ``fused40_bf16`` (its Pallas kernels in interpret mode, which
    round to bf16 inside) against the port's exported program: argmax
    equal, within atol 2e-2 / rtol 5e-2, the JAX kernel's own contract
    (as ``tests/test_torch_flagship.py`` holds ``fused40``)."""
    import tps_pp_tpu.ops.pallas_encoder as pe
    import tps_pp_tpu.ops.pallas_full_decode as pfd
    for mod, name in ((pe, 'fused_encoder_forward'),
                      (pfd, 'full_greedy_decode')):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **k: _f(
            *a, **dict(k, interpret=True)))
    v, cfg, img, _ = tiny
    jrec = jax_recognizer(cfg, 'fused40_bf16')
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(VR5)))
    rec = port(cfg, v, 'fused40_bf16')
    with torch.no_grad():
        got = export.load_serialized(export.export_serialized(
            rec, 5, (32, 64, 3))).module()(torch.from_numpy(img),
                                           torch.from_numpy(VR5)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=5e-2)


def test_aot_compile_on_the_cpu_equals_predict(tiny):
    v, cfg, img, _ = tiny
    rec = port(cfg, v, 'fused40_bf16')
    call = export.aot_compile(rec, 5, (32, 64, 3))
    assert call.graph is None and call.captured_launches == {}
    got = call(torch.from_numpy(img), torch.from_numpy(VR5))
    assert torch.equal(got, rec.predict(img, VR5, bucket_batch=False))
    with pytest.raises(ValueError, match='compiled for images'):
        call(torch.from_numpy(img[:4]), torch.from_numpy(VR5[:4]))


def test_exported_recognizer_pads_to_its_batch(tiny):
    v, cfg, img, _ = tiny
    rec = port(cfg, v, 'fused40_bf16')
    er = export.ExportedRecognizer(rec, 8, (32, 64, 3))
    got = er.simple_test(img, VR5)
    want = rec.simple_test(img, VR5)
    assert [r['text'] for r in got] == [r['text'] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g['score'], w['score'], atol=1e-6)
    with pytest.raises(ValueError, match='compiled batch'):
        er.simple_test(np.concatenate([img, img]))


def test_steps_with_early_exit_does_not_export(tiny):
    """(Its name is from when the path refused to export.) Greedy
    ``steps`` with its early exit exports and captures: the program and
    the CPU ``aot_compile`` equal the eager ``predict`` on random weights,
    where no row emits EOS."""
    v, cfg, img, _ = tiny
    rec = port(cfg, v, 'steps')
    eager = rec.predict(img, VR5, bucket_batch=False)
    ep = export.load_serialized(export.export_serialized(rec, 5,
                                                         (32, 64, 3)))
    with torch.no_grad():
        got = ep.module()(torch.from_numpy(img), torch.from_numpy(VR5))
    assert torch.equal(got, eager)
    call = export.aot_compile(rec, 5, (32, 64, 3))
    assert torch.equal(call(torch.from_numpy(img), torch.from_numpy(VR5)),
                       eager)


# step at which each of the five rows is forced to emit EOS (-1: never)
FINISH = {'at_0': [0, 0, 0, 0, 0], 'mid': [2, 4, 1, 3, 0],
          'never': [2, -1, 4, 1, 0]}
# a tiny SAR with the parallel decoder (tests/test_torch_sar.py small_cfg)
SAR_CFG = dict(
    type='SARNet',
    label_convertor=dict(type='AttnConvertor', dict_type='DICT36',
                         with_unknown=True),
    backbone=dict(type='ResNet31OCR', layers=[1, 1, 1, 1],
                  channels=[8, 8, 8, 8, 16, 16, 16]),
    encoder=dict(type='SAREncoder', enc_do_rnn=0.1, d_model=16, d_enc=16),
    decoder=dict(type='ParallelSARDecoder', d_model=16, d_enc=16, d_k=8,
                 pred_dropout=0.1, pred_concat=True),
    loss=dict(type='SARLoss'), max_seq_len=6)
# and a tiny RobustScanner on the same trunk
RS_CFG = dict(
    SAR_CFG, type='RobustScanner',
    encoder=dict(type='ChannelReductionEncoder', in_channels=16,
                 out_channels=8),
    decoder=dict(type='RobustScannerDecoder', dim_input=16, dim_model=8,
                 hybrid_decoder=dict(type='SequenceAttentionDecoder'),
                 position_decoder=dict(type='PositionAttentionDecoder')))


def force_exit(rec, finish):
    """Replace row n's probabilities at step finish[n] by a one-hot EOS
    (the decoder's ``decode_step`` wrapped on the instance)."""
    dec = rec.model.decoder
    step, end = dec.decode_step, rec.label_convertor.end_idx
    finish = torch.tensor(finish)

    def decode_step(token, t, carry, static, plain=False, **kw):
        probs, carry = step(token, t, carry, static, plain=plain, **kw)
        eos = F.one_hot(torch.tensor(end), probs.shape[-1]).to(probs.dtype)
        return torch.where((finish == t)[:, None], eos, probs), carry
    dec.decode_step = decode_step


@pytest.mark.parametrize('finish', list(FINISH))
@pytest.mark.parametrize('model', ['nrtr', 'nrtr, use_fused_step', 'sar',
                                   'robust_scanner'])
def test_steps_early_exit_export_equals_eager(tiny, model, finish):
    v, cfg, img, _ = tiny
    if model in ('sar', 'robust_scanner'):
        rec = build_recognizer(SAR_CFG if model == 'sar' else RS_CFG,
                               device='cpu').init_weights(0)
    else:
        rec = port(cfg, v, 'steps', fused_step='fused' in model)
    force_exit(rec, FINISH[finish])
    eager = rec.predict(img, VR5, bucket_batch=False)
    stop = max(FINISH[finish]) if min(FINISH[finish]) >= 0 else None
    end = rec.label_convertor.end_idx
    if stop is not None:
        assert (eager[:, stop + 1:] == 0).all()
        assert (eager[:, stop].argmax(-1) == end).any()
    else:
        assert (eager.sum(-1) > 0.99).all()
    ep = export.load_serialized(export.export_serialized(rec, 5,
                                                         (32, 64, 3)))
    with torch.no_grad():
        got = ep.module()(torch.from_numpy(img), torch.from_numpy(VR5))
    assert torch.equal(got, eager)
    call = export.aot_compile(rec, 5, (32, 64, 3))
    assert torch.equal(call(torch.from_numpy(img), torch.from_numpy(VR5)),
                       eager)


# ---------------------------------------------------------- opcheck

def _tiny_sampler_args(N=2):
    rng = np.random.default_rng(0)
    fid = tps.build_C_cell_centers((2, 4))
    P = tps.build_P_cell_centers(8, 4)
    mats = [tps.build_inv_delta_C(fid), tps.build_P_hat(fid, P), P]
    cp = fid[None] + 0.03 * rng.standard_normal((N, 8, 2))
    score = np.tanh(rng.standard_normal((N, 32, 8)))
    feat = rng.uniform(-1, 1, (N, 8, 16, 6))
    return [torch.tensor(a, dtype=torch.float32)
            for a in [feat, cp, score] + mats]


def _op_cases():
    """(operator, CPU arguments) of every operator, at small widths."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    ops = torch.ops.tps_pp
    enc = NRTREncoder(n_layers=1, n_head=2, d_k=8, d_v=8, d_model=32,
                      d_inner=64)
    ew = enc.folded_weights(torch.float32)
    from tps_pp_tpu_torch.ops.encoder import WEIGHT_ORDER as EO
    from tps_pp_tpu_torch.ops.full_decode import _WEIGHT_ORDER as DO
    dec = NRTRDecoder(n_layers=1, d_embedding=32, n_head=2, d_model=32,
                      d_inner=64, d_k=8, d_v=8, max_seq_len=4,
                      num_classes=7, start_idx=1, padding_idx=6)
    dw = dec.packed_weights(torch.float32)
    sw = {k: v[0] for k, v in NRTRDecoder(
        n_layers=1, d_embedding=32, n_head=2, d_model=32, d_inner=64,
        d_k=8, d_v=8, max_seq_len=4).step_weights().items()}
    mask = sequence_mask(torch.tensor([1.0, 0.5]), 6)
    cf = [sw[k] for k in ('wq2', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1', 'w2',
                          'b2', 'ln3_s', 'ln3_b')]
    x2d = r(4, 2 * 4 * 6)
    return {
        'tps_sampler': (ops.tps_sampler,
                        (*_tiny_sampler_args(), [4, 8], 'dense')),
        'tps_sampler_twostage': (ops.tps_sampler,
                                 (*_tiny_sampler_args(), [4, 8],
                                  'twostage')),
        'encoder_forward': (ops.encoder_forward,
                            (r(2, 6, 32), mask, [ew[k] for k in EO], 2)),
        'encoder_attention': (ops.encoder_attention,
                              (r(12, 48), mask, 2)),
        'gemm': (ops.gemm, (r(8, 16), r(16, 32), r(32), None, True,
                            torch.float32, False, None, None)),
        'gemm_ln': (ops.gemm_ln, (r(8, 16), r(16, 32), None, r(8, 32),
                                  False, torch.bfloat16, True, r(32),
                                  r(32))),
        'full_decode': (ops.full_decode,
                        (r(2, 6, 32), mask, [dw[k] for k in DO], 2, 1, 5,
                         'bfloat16')),
        'full_decode_int8': (ops.full_decode,
                             (r(2, 6, 32), mask, [dw[k] for k in DO], 2, 1,
                              None, 'int8')),
        'self_attn_step': (ops.self_attn_step,
                           (r(2, 32), r(2, 2, 5, 8), r(2, 2, 5, 8), 2,
                            sw['wqkv'], sw['wfc1'], sw['ln1_s'],
                            sw['ln1_b'])),
        'cross_ffn_step': (ops.cross_ffn_step,
                           (r(2, 32), r(2, 2, 6, 8), r(2, 2, 6, 8), mask,
                            *cf)),
        'self_attn_step_skip': (ops.self_attn_step,
                                (r(2, 32), r(2, 2, 5, 8), r(2, 2, 5, 8), 2,
                                 sw['wqkv'], sw['wfc1'], sw['ln1_s'],
                                 sw['ln1_b'], torch.tensor(True))),
        'cross_ffn_step_skip': (ops.cross_ffn_step,
                                (r(2, 32), r(2, 2, 6, 8), r(2, 2, 6, 8),
                                 mask, *cf, torch.tensor(False))),
        'grid_sample_fwd': (ops.grid_sample_fwd,
                            (r(2, 5, 7, 3), r(2, 3, 4, 2) * 0.6)),
        'conv3x3_cp': (ops.conv3x3_cp, (x2d, r(5, 36), r(5, 1), 4, 6,
                                        True)),
        'basic_block_cp': (ops.basic_block_cp,
                           (x2d, r(3, 4), r(3, 1), r(4, 27), r(4, 1), 4, 6,
                            True)),
    }


OP_CASES = ['tps_sampler', 'tps_sampler_twostage', 'encoder_forward',
            'encoder_attention', 'gemm', 'gemm_ln', 'full_decode',
            'full_decode_int8', 'self_attn_step', 'cross_ffn_step',
            'self_attn_step_skip', 'cross_ffn_step_skip',
            'grid_sample_fwd', 'conv3x3_cp', 'basic_block_cp']


def test_every_operator_has_a_case():
    assert {c.replace('_twostage', '').replace('_int8', '').replace(
        '_skip', '') for c in OP_CASES} == set(_lib.OP_KERNELS)


@pytest.mark.parametrize('case', OP_CASES)
def test_opcheck(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


# ---------------------------------------------------------- the CLI

def write_config(tmp_path, cfg):
    path = tmp_path / 'tiny_cfg.py'
    path.write_text(f'model = {cfg!r}\n')
    return str(path)


def test_export_model_cli_modes(tiny, tmp_path):
    v, cfg, img, _ = tiny
    cfg = dict(cfg, decode_mode='fused40_bf16')
    cfg_path = write_config(tmp_path, cfg)
    pth = str(tmp_path / 'tiny.pth')
    torch.save({'state_dict': state_dict_from_jax(v, cfg)}, pth)
    common = ['--checkpoint', pth, '--batch', '4', '--height', '32',
              '--width', '64', '--device', 'cpu']
    art = str(tmp_path / 'tiny.pt2')
    out = export_model.main(['export', cfg_path, art] + common)
    assert out['bytes'] > 1000 and out['export_s'] > 0
    out = export_model.main(['aot', cfg_path, '-'] + common)
    assert out['device'] == 'cpu' and out['captured_launches'] == {}
    rec = port(v=v, cfg=cfg, decode_mode='fused40_bf16')
    out = export_model.main(['test', cfg_path, art] + common)
    zeros = rec.simple_test(np.zeros((4, 32, 64, 3), np.float32))
    assert out['shape'] == [4, cfg['max_seq_len'],
                            rec.label_convertor.num_classes() - 1]
    assert out['texts'] == [r['text'] for r in zeros[:3]]
    crop = (np.random.default_rng(0).uniform(0, 255, (20, 50, 3))).astype(
        np.uint8)
    png = tmp_path / 'crop.png'
    png.write_bytes(png_encode(crop))
    out = export_model.main(['test', cfg_path, art, '--image', str(png)] +
                            common)
    from tps_pp_tpu_torch.datasets.pipelines.cv_ops import resize_u8
    x = resize_u8(crop, 64, 32).astype(np.float32) / 255.0
    want = rec.simple_test(np.repeat(x[None], 4, 0))
    assert out['texts'] == [r['text'] for r in want[:3]]
