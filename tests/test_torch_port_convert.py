"""Weights carried from the JAX package into the PyTorch port: the port's
``state_dict_from_jax`` fed back through the JAX package's own
``convert_state_dict`` + ``merge_flat`` must give the original variables bit
for bit. That also proves the port's keys are the reference's torch names.
The flagship (tiny and full), and the transformer family's five shipped
configs on its other trunks (SATRN academic and small, NRTR on the
modality transform and on ResNet31 1by16 and 1by8) at full width; the two
DBNet configs (R18-FPNC, R50-DCNv2-FPNC), for which the JAX converter has
no table, through the port's rules; so are the three shipped Mask R-CNN
configs, whose box head's first layer the port reads flattened (C, 7, 7)
where JAX flattens (7, 7, C); and the shipped SDMGR configs (with and
without the UNet16) and the BERT-softmax NER config, through
``sdmgr_rules`` and ``ner_rules``.
"""
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tps_pp_tpu.apis.flagship import nrtr_tps_pp_cfg
from tps_pp_tpu.apis.train_det import build_detector_module as jax_det
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.utils import torch_convert as jtc

from tps_pp_tpu_torch.apis import build_detector_module, build_recognizer
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.utils import convert

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# config, crop width
TRANSFORMER_CONFIGS = {
    'satrn_academic': ('configs/textrecog/satrn/satrn_academic.py', 100),
    'satrn_small': ('configs/textrecog/satrn/satrn_small.py', 100),
    'nrtr_modality': (
        'configs/textrecog/nrtr/nrtr_modality_transform_academic.py', 160),
    'nrtr_r31_1by16': (
        'configs/textrecog/nrtr/nrtr_r31_1by16_1by8_academic.py', 160),
    'nrtr_r31_1by8': (
        'configs/textrecog/nrtr/nrtr_r31_1by8_1by4_academic.py', 160),
}
MASKRCNN_CONFIGS = [f'configs/textdet/maskrcnn/mask_rcnn_r50_fpn_160e_{d}.py'
                    for d in ('ctw1500', 'icdar2015', 'icdar2017')]
DBNET_CONFIGS = {
    'r18': 'configs/textdet/dbnet/dbnet_r18_fpnc_1200e_icdar2015.py',
    'r50_dcn': 'configs/textdet/dbnet/dbnet_r50dcnv2_fpnc_1200e_icdar2015.py',
}


def _random_variables(cfg, tiny, seed=0, shape=None):
    """Random float32 leaves in the shapes of the JAX recognizer's
    variables (no JAX init needed for a bit-exact round trip)."""
    rec = build_jax(cfg)
    shape = shape or ((1, 32, 64, 3) if tiny else (1, 32, 128, 3))
    shapes = jax.eval_shape(
        lambda: rec.init_variables(jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def _round_trip(cfg, v):
    """state_dict_from_jax(v) loads strictly into the port's model of
    ``cfg``, and the JAX converter gives ``v`` back bit for bit."""
    sd = convert.state_dict_from_jax(v, cfg)
    # the keys are exactly the port model's
    model = build_recognizer(cfg, device='cpu').model
    model.load_state_dict(sd, strict=True)

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


@pytest.mark.parametrize('tiny', [True, False])
def test_state_dict_round_trips_through_jax_converter(tiny):
    cfg = nrtr_tps_pp_cfg(tiny=tiny)
    _round_trip(cfg, _random_variables(cfg, tiny))


@pytest.mark.parametrize('tiny', [True, False])
def test_rule_tables_match_the_jax_package(tiny):
    cfg = nrtr_tps_pp_cfg(tiny=tiny)
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))


@pytest.mark.parametrize('name', list(TRANSFORMER_CONFIGS))
def test_transformer_configs_round_trip_through_jax_converter(name):
    """The five configs at full width; the sinusoid tables (the SATRN
    encoder's and the decoder's) are buffers made from the config."""
    path, width = TRANSFORMER_CONFIGS[name]
    cfg = dict(load_config(os.path.join(REPO, path))['model'])
    assert set(convert.rules_for_config(cfg)) == set(
        jtc.rules_for_config(cfg))
    _round_trip(cfg, _random_variables(cfg, False, shape=(1, 32, width, 3)))


@pytest.mark.parametrize('name', list(DBNET_CONFIGS))
def test_dbnet_configs_round_trip_through_jax_converter(name):
    """``state_dict_from_jax`` of random variables loads strictly into the
    port's detector; the JAX converter, given the port's rules, with each
    transposed convolution handed over as the plain convolution that
    computes the same (its kernel flipped, in and out swapped), gives the
    variables back bit for bit."""
    cfg = dict(load_config(os.path.join(REPO, DBNET_CONFIGS[name]))['model'])
    module = jax_det(cfg)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                     shapes)
    sd = convert.state_dict_from_jax(v, cfg)
    build_detector_module(cfg).load_state_dict(sd, strict=True)
    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = []
    for tp, fp, kind in convert.rules_for_config(cfg):
        if kind == 'conv_transpose':
            w = sd_np[f'{tp}.weight']                    # (in, out, kh, kw)
            sd_np[f'{tp}.weight'] = np.ascontiguousarray(
                w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])
            kind = 'conv'
        rules.append((tp, fp, kind))
    rules = jtc.filter_rules_to_state(rules, sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('path', MASKRCNN_CONFIGS)
def test_maskrcnn_configs_round_trip_through_jax_converter(path):
    """Random variables in the shapes of the JAX ``MaskRCNNDetector``'s
    ``{'main', 'box', 'mask'}`` at full width: ``state_dict_from_jax``
    loads strictly into the port's model; the JAX converter, given the
    port's rules, the transposed convolution handed over as the plain one
    that computes the same and ``shared_fcs.0`` with its columns put back
    in JAX's (7, 7, C) order (a plain ``'linear'``), gives the merged
    variables back bit for bit."""
    from tps_pp_tpu.apis.train_det import _build
    from tps_pp_tpu.models.textdet import maskrcnn as jm
    from tps_pp_tpu.registry import BACKBONES, NECKS
    cfg = dict(load_config(os.path.join(REPO, path))['model'])
    rpn = dict(cfg['rpn_head'])
    rpn.pop('type')
    module = jm.MaskRCNNModule(
        backbone=_build(BACKBONES, cfg['backbone']),
        neck=_build(NECKS, cfg['neck']), rpn_head=jm.RPNHead(**rpn),
        box_head=jm.BoxHead(), mask_head=jm.MaskHead())
    shapes = jax.eval_shape(lambda: jm.MaskRCNNDetector(
        module).init_variables(jax.random.PRNGKey(0), (1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                     shapes)
    sd = convert.state_dict_from_jax(v, cfg)
    build_detector_module(cfg).load_state_dict(sd, strict=True)
    sd_np = {k: t.numpy() for k, t in sd.items()}
    rules = []
    for tp, fp, kind in convert.rules_for_config(cfg):
        w = sd_np.get(f'{tp}.weight')
        if kind == 'conv_transpose':
            sd_np[f'{tp}.weight'] = np.ascontiguousarray(
                w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])
            kind = 'conv'
        elif kind == 'linear_hwc7':
            out = w.shape[0]
            sd_np[f'{tp}.weight'] = np.ascontiguousarray(
                w.reshape(out, -1, 49).transpose(0, 2, 1).reshape(out, -1))
            kind = 'linear'
        rules.append((tp, fp, kind))
    main = v['main']
    merged_v = dict(main, params=dict(main['params'], box=v['box']['params'],
                                      mask=v['mask']['params']))
    rules = jtc.filter_rules_to_state(rules, sd_np)
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, merged_v),
                            jtc.convert_state_dict(sd_np, rules))
    want = jax.tree_util.tree_flatten_with_path(merged_v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for p, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                      err_msg=jax.tree_util.keystr(p))


KIE_NER_CONFIGS = {
    'sdmgr_unet16': 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py',
    'sdmgr_novisual': 'configs/kie/sdmgr/sdmgr_novisual_60e_wildreceipt.py',
    'sdmgr_openset': ('configs/kie/sdmgr/'
                      'sdmgr_novisual_60e_wildreceipt_openset.py'),
    'bert_softmax': 'configs/ner/bert_softmax/bert_softmax_cluener_18e.py',
}


def _kie_ner_variables(cfg):
    """The shapes of JAX ``train_kie``'s SDMGR variables (``{'params':
    {'head', 'unet'}, 'batch_stats'}``, the UNet where the config has
    ``visual_modality``) or of the JAX ``NerClassifierModule``'s."""
    from tps_pp_tpu.models import common as jcommon
    from tps_pp_tpu.models.kie import sdmgr as jsdmgr
    from tps_pp_tpu.models.ner import bert as jbert

    def kw(c):
        c = dict(c)
        c.pop('type')
        return c
    key = jax.random.PRNGKey(0)
    if cfg['type'] == 'NerClassifier':
        module = jbert.NerClassifierModule(
            encoder=jbert.BertEncoder(**kw(cfg['encoder'])),
            decoder=jbert.FCDecoder(**kw(cfg['decoder'])))
        return jax.eval_shape(lambda: module.init(
            key, jnp.zeros((1, 8), jnp.int32)))
    head = jsdmgr.SDMGRHead(**kw(cfg['head']))
    rel, texts = jnp.zeros((4, 4, 5)), jnp.zeros((4, 32), jnp.int32)
    if not cfg.get('visual_modality'):
        return jax.eval_shape(lambda: {'params': {'head': head.init(
            key, rel, texts)['params']}})
    unet = jcommon.UNet(**kw(cfg['backbone']))

    def init():
        uv = unet.init(key, jnp.zeros((1, 32, 32, 3)))
        hv = head.init(key, rel, texts, jnp.zeros((4, 16)))
        return {'params': {'head': hv['params'], 'unet': uv['params']},
                'batch_stats': uv['batch_stats']}
    return jax.eval_shape(init)


@pytest.mark.parametrize('name', list(KIE_NER_CONFIGS))
def test_kie_ner_configs_round_trip_through_jax_converter(name):
    """``state_dict_from_jax`` of random variables loads strictly into the
    port's SDMGR / NerClassifier; the JAX converter, given
    ``rules_for_config``'s table (``sdmgr_rules`` / ``ner_rules``), gives
    them back bit for bit (the UNet's statistics under ``unet``, where
    ``state_dict_from_jax`` reads them)."""
    from tps_pp_tpu_torch.models.kie import build_sdmgr
    from tps_pp_tpu_torch.models.ner import NerClassifier
    cfg = dict(load_config(os.path.join(REPO, KIE_NER_CONFIGS[name]))
               ['model'])
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                     _kie_ner_variables(cfg))
    sd = convert.state_dict_from_jax(v, cfg)
    model = (NerClassifier(cfg) if cfg['type'] == 'NerClassifier'
             else build_sdmgr(cfg))
    model.load_state_dict(sd, strict=True)
    rules = convert.rules_for_config(cfg)
    assert rules == (convert.ner_rules(cfg) if cfg['type'] == 'NerClassifier'
                     else convert.sdmgr_rules(cfg))
    assert any(r[0].startswith('backbone.') for r in rules) == \
        (name == 'sdmgr_unet16')
    if 'batch_stats' in v:
        v = dict(v, batch_stats={'unet': v['batch_stats']})
    sd_np = {k: t.numpy() for k, t in sd.items()}
    merged = jtc.merge_flat(jax.tree.map(np.zeros_like, v),
                            jtc.convert_state_dict(
                                sd_np, jtc.filter_rules_to_state(rules,
                                                                 sd_np)))
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(merged)[0])
    assert len(got) == len(want)
    for p, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                      err_msg=jax.tree_util.keystr(p))
