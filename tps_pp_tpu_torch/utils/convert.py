"""JAX variables -> the port's ``state_dict`` (the inverse of
``tps_pp_tpu/utils/torch_convert.py``).

``state_dict_from_jax(variables, cfg)`` carries weights made by the JAX
package (its ``{'params', 'batch_stats'}`` trees, as numpy arrays or
anything ``np.asarray`` takes) into the port. The rule tables are copies of
the JAX package's for the modules the port has: (reference torch prefix,
flax path, kind). Keys are the reference's torch names, so the result also
has the layout of the reference's checkpoints; ``tests/test_torch_port_
convert.py`` feeds it back through the JAX package's own converter and
requires the original variables bit for bit.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.transformer import sinusoid_position_table

Rule = Tuple[str, str, str]


def resnet_abi_rules(arch=(3, 4, 6, 6, 3)) -> List[Rule]:
    """ResNetABI / ResNetABI_v2_large (reference names
    conv1/bn1/layer{i}.{j})."""
    rules = [('backbone.conv1', 'backbone/conv1', 'conv'),
             ('backbone.bn1', 'backbone/bn1', 'bn')]
    for li, blocks in enumerate(arch):
        for b in range(blocks):
            tp = f'backbone.layer{li + 1}.{b}'
            fp = f'backbone/layer{li + 1}/block{b}'
            rules += [(f'{tp}.conv1', f'{fp}/conv1', 'conv_nobias'),
                      (f'{tp}.bn1', f'{fp}/bn1', 'bn'),
                      (f'{tp}.conv2', f'{fp}/conv2', 'conv_nobias'),
                      (f'{tp}.bn2', f'{fp}/bn2', 'bn')]
            if b == 0:     # the first block of a stage may downsample
                rules += [(f'{tp}.downsample.0', f'{fp}/downsample_conv',
                           'conv_nobias'),
                          (f'{tp}.downsample.1', f'{fp}/downsample_bn', 'bn')]
    return rules


def resnet31_rules(layers=(1, 2, 5, 3)) -> List[Rule]:
    """ResNet31OCR (JAX ``torch_convert.py:509-539``): the reference's
    ``conv1_1`` / ``bn1_1``, ``conv1_2`` / ``bn1_2``, ``block{k}.{b}``
    (with ``downsample.{0,1}`` where the width changes) and ``conv{k}`` /
    ``bn{k}``."""
    rules = [('backbone.conv1_1', 'backbone/stem1/conv', 'conv'),
             ('backbone.bn1_1', 'backbone/stem1/bn', 'bn'),
             ('backbone.conv1_2', 'backbone/stem2/conv', 'conv'),
             ('backbone.bn1_2', 'backbone/stem2/bn', 'bn')]
    for si, blocks in enumerate(layers):
        k = si + 2
        for b in range(blocks):
            tp, bp = f'backbone.block{k}.{b}', f'backbone/block{k}/block{b}'
            rules += [(f'{tp}.conv1', f'{bp}/conv1', 'conv_nobias'),
                      (f'{tp}.bn1', f'{bp}/bn1', 'bn'),
                      (f'{tp}.conv2', f'{bp}/conv2', 'conv_nobias'),
                      (f'{tp}.bn2', f'{bp}/bn2', 'bn'),
                      (f'{tp}.downsample.0', f'{bp}/downsample_conv',
                       'conv_nobias'),
                      (f'{tp}.downsample.1', f'{bp}/downsample_bn', 'bn')]
        rules += [(f'backbone.conv{k}', f'backbone/conv{k}/conv', 'conv'),
                  (f'backbone.bn{k}', f'backbone/conv{k}/bn', 'bn')]
    return rules


def sar_rules(enc_bi_rnn: bool = False) -> List[Rule]:
    """SAREncoder + ParallelSARDecoder (JAX ``torch_convert.py:335-353``):
    the encoder's two scans from one two-layer ``rnn_encoder`` (with
    ``enc_bi_rnn`` also their reverse directions, a rule the JAX table has
    not), ``linear``, and the decoder's ``conv1x1_1`` / ``conv3x3_1`` /
    ``conv1x1_2``, its two scans from one two-layer ``rnn_decoder``,
    ``embedding`` and ``prediction``."""
    rules = [('encoder.rnn_encoder', 'encoder/rnn0_fwd', 'lstm'),
             ('encoder.rnn_encoder', 'encoder/rnn1_fwd', 'lstm_l1')]
    if enc_bi_rnn:
        rules += [('encoder.rnn_encoder', 'encoder/rnn0_bwd', 'lstm_reverse'),
                  ('encoder.rnn_encoder', 'encoder/rnn1_bwd',
                   'lstm_l1_reverse')]
    return rules + [
        ('encoder.linear', 'encoder/linear', 'linear'),
        ('decoder.conv1x1_1', 'decoder/conv1x1_1', 'linear'),
        ('decoder.conv3x3_1', 'decoder/conv3x3_1', 'conv'),
        ('decoder.conv1x1_2', 'decoder/conv1x1_2', 'linear'),
        ('decoder.rnn_decoder', 'decoder/rnn0', 'lstm'),
        ('decoder.rnn_decoder', 'decoder/rnn1', 'lstm_l1'),
        ('decoder.embedding', 'decoder/embedding', 'embed'),
        ('decoder.prediction', 'decoder/prediction', 'linear')]


def sequential_sar_rules() -> List[Rule]:
    """SequentialSARDecoder (JAX ``torch_convert.py:356-372``): the same
    flax modules from the reference's cells ``rnn_decoder_layer1/2`` and
    1x1 ``Conv2d`` projections."""
    return [
        ('decoder.conv1x1_1', 'decoder/conv1x1_1', 'conv1x1_as_dense'),
        ('decoder.conv3x3_1', 'decoder/conv3x3_1', 'conv'),
        ('decoder.conv1x1_2', 'decoder/conv1x1_2', 'conv1x1_as_dense'),
        ('decoder.rnn_decoder_layer1', 'decoder/rnn0', 'lstm_cell'),
        ('decoder.rnn_decoder_layer2', 'decoder/rnn1', 'lstm_cell'),
        ('decoder.embedding', 'decoder/embedding', 'embed'),
        ('decoder.prediction', 'decoder/prediction', 'linear')]


def robust_scanner_rules(rnn_layers: int = 2) -> List[Rule]:
    """ChannelReductionEncoder + RobustScannerDecoder (JAX
    ``torch_convert.py:412-439``): the hybrid branch's ``embedding`` and
    its scans from one stacked ``sequence_layer``, the position branch's
    ``embedding``, the position-aware module's scans from one stacked
    ``rnn`` and its ``mixer.0`` / ``mixer.2``, the fusion and the
    classifier."""
    hd, pd = 'decoder.hybrid_decoder', 'decoder.position_decoder'
    pam, fpam = (f'{pd}.position_aware_module',
                 'decoder/position/position_aware_module')
    rules = [('encoder.layer', 'encoder/layer', 'conv'),
             (f'{hd}.embedding', 'decoder/hybrid/embedding', 'embed')]
    rules += [(f'{hd}.sequence_layer', f'decoder/hybrid/rnns_{i}',
               f'lstm_l{i}' if i else 'lstm') for i in range(rnn_layers)]
    rules.append((f'{pd}.embedding', 'decoder/position/embedding', 'embed'))
    rules += [(f'{pam}.rnn', f'{fpam}/rnn{i}', f'lstm_l{i}' if i else 'lstm')
              for i in range(rnn_layers)]
    return rules + [
        (f'{pam}.mixer.0', f'{fpam}/mixer0', 'conv'),
        (f'{pam}.mixer.2', f'{fpam}/mixer1', 'conv'),
        ('decoder.fusion_module.linear_layer',
         'decoder/fusion_module/linear_layer', 'linear'),
        ('decoder.prediction', 'decoder/prediction', 'linear')]


def shallow_cnn_rules() -> List[Rule]:
    """ShallowCNN (JAX ``torch_convert.py:554-563``): the reference's two
    ConvModules ``conv1`` / ``conv2``, each ``.conv`` and ``.bn``."""
    return [('backbone.conv1.conv', 'backbone/conv1', 'conv_nobias'),
            ('backbone.conv1.bn', 'backbone/bn1', 'bn'),
            ('backbone.conv2.conv', 'backbone/conv2', 'conv_nobias'),
            ('backbone.conv2.bn', 'backbone/bn2', 'bn')]


def nrtr_modality_rules() -> List[Rule]:
    """NRTRModalityTransform (JAX ``torch_convert.py:541-551``): ``conv_1``,
    ``bn_1``, ``conv_2``, ``bn_2`` and ``linear``."""
    return [('backbone.conv_1', 'backbone/conv_1', 'conv'),
            ('backbone.bn_1', 'backbone/bn_1', 'bn'),
            ('backbone.conv_2', 'backbone/conv_2', 'conv'),
            ('backbone.bn_2', 'backbone/bn_2', 'bn'),
            ('backbone.linear', 'backbone/linear', 'linear')]


def satrn_rules(n_layers: int = 12) -> List[Rule]:
    """SatrnEncoder (JAX ``torch_convert.py:375-409``): the positional
    encoding's gates ``h_scale.{0,2}`` / ``w_scale.{0,2}``, and per layer
    ``norm1`` / ``norm2``, the attention's four linears and the
    locality-aware FFN's three ConvModules (``depthwise_conv.bn`` from the
    flax ``depthwise_bn``), then ``layer_norm``."""
    pe, fpe = 'encoder.position_enc', 'encoder/position_enc'
    rules = [(f'{pe}.{a}_scale.{i}', f'{fpe}/{a}_scale_{j}', 'conv')
             for a in ('h', 'w') for i, j in ((0, 0), (2, 1))]
    for i in range(n_layers):
        tp, fp = f'encoder.layer_stack.{i}', f'encoder/layer{i}'
        ff, fff = f'{tp}.feed_forward', f'{fp}/feed_forward'
        rules += [(f'{tp}.norm1', f'{fp}/norm1', 'ln'),
                  (f'{tp}.norm2', f'{fp}/norm2', 'ln')]
        rules += _attn_rules(f'{tp}.attn', f'{fp}/attn')
        rules += [(f'{ff}.conv1.conv', f'{fff}/conv1/conv', 'conv_nobias'),
                  (f'{ff}.conv1.bn', f'{fff}/conv1/bn', 'bn'),
                  (f'{ff}.depthwise_conv.conv', f'{fff}/depthwise_conv',
                   'conv_nobias'),
                  (f'{ff}.depthwise_conv.bn', f'{fff}/depthwise_bn', 'bn'),
                  (f'{ff}.conv2.conv', f'{fff}/conv2/conv', 'conv_nobias'),
                  (f'{ff}.conv2.bn', f'{fff}/conv2/bn', 'bn')]
    return rules + [('encoder.layer_norm', 'encoder/layer_norm', 'ln')]


def tps_pp_rules() -> List[Rule]:
    """TPS_PP (reference tps_pp.py:499-626 and DGAB.py names)."""
    p = 'tpsnet'
    rules = [(f'{p}.{n}.conv', f'{p}/{n}/conv', 'conv')
             for n in ('down0', 'down1', 'down2', 'down0_1', 'down1_1',
                       'down_feat')]
    rules += [(f'{p}.MSFA.conv.k_encoder.{i}.conv', f'{p}/MSFA/enc{i}/conv',
               'conv') for i in range(4)]
    rules += [(f'{p}.MSFA.conv.k_decoder.{i}.1.conv', f'{p}/MSFA/dec{i}/conv',
               'conv') for i in range(4)]
    at, af = f'{p}.MSFA.conv.atten', f'{p}/MSFA/atten'
    rules += [
        (f'{at}.channel_attention.shared_MLP.0',
         f'{af}/channel_attention/fc1', 'conv1x1_as_dense_nobias'),
        (f'{at}.channel_attention.shared_MLP.2',
         f'{af}/channel_attention/fc2', 'conv1x1_as_dense_nobias'),
        (f'{at}.spatial_attention.conv2d', f'{af}/spatial_attention/conv',
         'conv'),
    ]
    t, f = f'{p}.TPE', f'{p}/TPE'
    rules += [
        (f'{t}.atten.0.norm1', f'{f}/atten0/norm1', 'ln'),
        (f'{t}.atten.0.norm2', f'{f}/atten0/norm2', 'ln'),
        (f'{t}.atten.0.attn.mlp_w.0', f'{f}/atten0/attn/mlp_w',
         'linear_nobias'),
        (f'{t}.atten.0.attn.mlp_h.0', f'{f}/atten0/attn/mlp_h',
         'linear_nobias'),
        (f'{t}.atten.0.attn.proj', f'{f}/atten0/attn/proj', 'linear'),
        (f'{t}.atten.0.mlp.fc1', f'{f}/atten0/mlp_fc1', 'linear'),
        (f'{t}.atten.0.mlp.fc2', f'{f}/atten0/mlp_fc2', 'linear'),
        (f'{t}.localization_fc1.0', f'{f}/loc_fc1_0', 'linear'),
        (f'{t}.localization_fc1.2', f'{f}/loc_fc1_1', 'linear'),
        (f'{t}.localization_fc2', f'{f}/loc_fc2', 'linear'),
        (f'{t}.p_linear.0', f'{f}/p_linear_0', 'linear'),
        (f'{t}.p_linear.1', f'{f}/p_linear_1', 'linear'),
        (f'{t}.feat_linear.0', f'{f}/feat_linear_0', 'linear'),
        (f'{t}.feat_linear.1', f'{f}/feat_linear_1', 'linear'),
    ]
    return rules


def crnn_rules(rnn_flag: bool = True) -> List[Rule]:
    """VeryDeepVgg + CRNNDecoder (JAX ``torch_convert.py:210-227``): the
    reference's ``cnn.conv{i}`` / ``cnn.batchnorm{i}``, and each BiLSTM's
    ``rnn`` (one torch ``nn.LSTM`` from the flax ``fwd`` and ``bwd``
    subtrees) and ``embedding``. Without ``rnn_flag`` the decoder is the
    reference's 1x1 conv ``decoder.decoder`` from the flax ``conv1x1``
    Dense (a rule the JAX table has not)."""
    rules = [(f'backbone.cnn.conv{i}', f'backbone/conv{i}', 'conv')
             for i in range(7)]
    rules += [(f'backbone.cnn.batchnorm{i}', f'backbone/batchnorm{i}', 'bn')
              for i in (2, 4, 6)]
    if not rnn_flag:
        return rules + [('decoder.decoder', 'decoder/conv1x1',
                         'conv1x1_as_dense')]
    for j in (0, 1):
        tp, fp = f'decoder.decoder.{j}', f'decoder/rnn{j}'
        rules += [(f'{tp}.rnn', f'{fp}/fwd', 'lstm'),
                  (f'{tp}.rnn', f'{fp}/bwd', 'lstm_reverse'),
                  (f'{tp}.embedding', f'{fp}/embedding', 'linear')]
    return rules


def tps_preprocessor_rules() -> List[Rule]:
    """RARE's TPS-STN (JAX ``torch_convert.py:566-586``): the
    LocalizationNetwork's ``conv`` Sequential (conv, bn, relu, pool) x 4,
    ``localization_fc1.0`` and ``localization_fc2``."""
    ln, fl = 'preprocessor.LocalizationNetwork', 'preprocessor/localization'
    rules = []
    for i, idx in enumerate((0, 4, 8, 12)):
        rules += [(f'{ln}.conv.{idx}', f'{fl}/conv{i}', 'conv_nobias'),
                  (f'{ln}.conv.{idx + 1}', f'{fl}/bn{i}', 'bn')]
    return rules + [(f'{ln}.localization_fc1.0', f'{fl}/fc1', 'linear'),
                    (f'{ln}.localization_fc2', f'{fl}/fc2', 'linear')]


def _attn_rules(tp: str, fp: str) -> List[Rule]:
    return [(f'{tp}.{n}', f'{fp}/{n}', 'linear_nobias')
            for n in ('linear_q', 'linear_k', 'linear_v', 'fc')]


def nrtr_encoder_rules(n_layers: int) -> List[Rule]:
    rules = []
    for i in range(n_layers):
        tp, fp = f'encoder.layer_stack.{i}', f'encoder/layer{i}'
        rules += _attn_rules(f'{tp}.attn', f'{fp}/attn') + [
            (f'{tp}.norm1', f'{fp}/norm1', 'ln'),
            (f'{tp}.norm2', f'{fp}/norm2', 'ln'),
            (f'{tp}.mlp.w_1', f'{fp}/mlp/w_1', 'linear'),
            (f'{tp}.mlp.w_2', f'{fp}/mlp/w_2', 'linear')]
    return rules + [('encoder.layer_norm', 'encoder/layer_norm', 'ln')]


def nrtr_decoder_rules(n_layers: int) -> List[Rule]:
    rules = []
    for i in range(n_layers):
        tp, fp = f'decoder.layer_stack.{i}', f'decoder/layer_stack_{i}'
        for a in ('self_attn', 'enc_attn'):
            rules += _attn_rules(f'{tp}.{a}', f'{fp}/{a}')
        rules += [(f'{tp}.norm{j}', f'{fp}/norm{j}', 'ln') for j in (1, 2, 3)]
        rules += [(f'{tp}.mlp.w_1', f'{fp}/mlp/w_1', 'linear'),
                  (f'{tp}.mlp.w_2', f'{fp}/mlp/w_2', 'linear')]
    return rules + [
        ('decoder.trg_word_emb', 'decoder/trg_word_emb', 'embed'),
        ('decoder.layer_norm', 'decoder/layer_norm', 'ln'),
        ('decoder.classifier', 'decoder/classifier', 'linear')]


def tf_common_rules(n_layers: int = 3) -> List[Rule]:
    """TFCommonDecoder: per layer the attention's four linears (no bias,
    JAX's ``qkv_bias=False``), ``norm1``, ``mlp.w_1`` / ``w_2``, ``norm2``;
    then ``cls``. The names mirror the flax modules (``layer{i}`` as
    ``layer_stack.{i}``): JAX's ``torch_convert.py`` has no table for this
    decoder (it gives it NRTR's, which its flax tree does not have)."""
    rules = []
    for i in range(n_layers):
        tp, fp = f'decoder.layer_stack.{i}', f'decoder/layer{i}'
        rules += _attn_rules(f'{tp}.attn', f'{fp}/attn') + [
            (f'{tp}.norm1', f'{fp}/norm1', 'ln'),
            (f'{tp}.mlp.w_1', f'{fp}/mlp/w_1', 'linear'),
            (f'{tp}.mlp.w_2', f'{fp}/mlp/w_2', 'linear'),
            (f'{tp}.norm2', f'{fp}/norm2', 'ln')]
    return rules + [('decoder.cls', 'decoder/cls', 'linear')]


def _post_norm_layer_rules(tp: str, fp_attn: str, fp_norm1: str,
                           fp_norm2: str, fp_fc1: str,
                           fp_fc2: str) -> List[Rule]:
    """One mmcv BaseTransformerLayer (attention, norm, ffn, norm)."""
    return [(f'{tp}.attentions.0.attn', fp_attn, 'torch_mha'),
            (f'{tp}.norms.0', fp_norm1, 'ln'),
            (f'{tp}.norms.1', fp_norm2, 'ln'),
            (f'{tp}.ffns.0.layers.0.0', fp_fc1, 'linear'),
            (f'{tp}.ffns.0.layers.1', fp_fc2, 'linear')]


def abinet_rules(n_enc_layers: int = 3, n_lang_layers: int = 4,
                 language: bool = True, fuser: bool = True) -> List[Rule]:
    """The ABINet recognizer's vision model, language decoder and fuser
    (JAX ``torch_convert.py:442-506`` with the recognizer's prefixes,
    ``:672-681``); ``language`` / ``fuser`` False leave those out."""
    rules = []
    for i in range(n_enc_layers):
        fp = f'encoder/enc/layer{i}'
        rules += _post_norm_layer_rules(
            f'encoder.encoder.transformer.{i}', f'{fp}/attn', f'{fp}/norm1',
            f'{fp}/norm2', f'{fp}/ffn_fc1', f'{fp}/ffn_fc2')
    for i in range(4):
        rules += [
            (f'encoder.decoder.k_encoder.{i}.conv',
             f'encoder/dec/k_enc{i}/conv', 'conv_nobias'),
            (f'encoder.decoder.k_encoder.{i}.bn', f'encoder/dec/k_enc{i}/bn',
             'bn'),
            (f'encoder.decoder.k_decoder.{i}.1.conv',
             f'encoder/dec/k_dec{i}/conv', 'conv_nobias'),
            (f'encoder.decoder.k_decoder.{i}.1.bn',
             f'encoder/dec/k_dec{i}/bn', 'bn')]
    rules += [('encoder.decoder.project', 'encoder/dec/project', 'linear'),
              ('encoder.decoder.cls', 'encoder/dec/cls', 'linear')]
    if language:
        rules.append(('decoder.proj', 'decoder/proj', 'linear_nobias'))
        for i in range(n_lang_layers):
            rules += _post_norm_layer_rules(
                f'decoder.decoder_layers.{i}', f'decoder/cross{i}',
                f'decoder/norm{i}_1', f'decoder/norm{i}_2',
                f'decoder/ffn{i}_fc1', f'decoder/ffn{i}_fc2')
        rules.append(('decoder.cls', 'decoder/cls', 'linear'))
    if fuser:
        rules += [('fuser.w_att', 'fuser/w_att', 'linear'),
                  ('fuser.cls', 'fuser/cls', 'linear')]
    return rules


def _abinet_position_tables(cfg: Mapping) -> Dict[str, torch.Tensor]:
    """The ABINet recognizer's four sinusoid tables (buffers, as in the
    reference), sized as ``ABINetRecognizer`` builds them: the encoder's
    ``max_len`` x ``d_model``, the vision decoder's and the language
    decoder's ``max_seq_len`` (the model's where they leave it out) x
    their widths."""
    T = int(cfg.get('max_seq_len', 40))
    vision = cfg['encoder']
    enc = vision.get('encoder') or {}
    vdec = dict(vision.get('decoder') or {})
    if 'decoder' in vision:
        vdec.setdefault('max_seq_len', T)
    sizes = {'encoder.encoder.pos_encoder': (enc.get('max_len', 8 * 32),
                                             enc.get('d_model', 512)),
             'encoder.decoder.pos_encoder': (vdec.get('max_seq_len', 40),
                                             vdec.get('in_channels', 512))}
    if cfg.get('decoder'):
        lang = cfg['decoder']
        n, d = lang.get('max_seq_len', T), lang.get('d_model', 512)
        sizes['decoder.token_encoder'] = sizes['decoder.pos_encoder'] = (n,
                                                                         d)
    return {f'{k}.position_table': torch.from_numpy(
        sinusoid_position_table(int(n), int(d)))
        for k, (n, d) in sizes.items()}


def moran_rules() -> List[Rule]:
    """MORAN's offset net (JAX ``models/rectifiers/moran.py``): five 3x3
    convs with bias ``conv{i}`` and their BatchNorms ``bn{i}``. The
    reference's names cannot be read (its tree is absent, and JAX's
    ``torch_convert.py`` has no MORAN table), so they mirror the flax
    module's."""
    p = 'preprocessor'
    return [r for i in range(5) for r in (
        (f'{p}.conv{i}', f'{p}/conv{i}', 'conv'),
        (f'{p}.bn{i}', f'{p}/bn{i}', 'bn'))]


def spin_rules(offsets: bool = True) -> List[Rule]:
    """SPIN (JAX ``models/rectifiers/spin.py``): the trunk's
    ``spt_conv{i}`` / ``spt_bn{i}``, the structure branch's
    ``fc1_conv{i}`` / ``fc1_bn{i}``, ``fc1_linear``, ``fc1_bn1d`` and
    ``fc2``, and with ``offsets`` the AIN branch's ``offset_conv1`` /
    ``offset_bn1`` / ``offset_conv2``. Names mirror the flax module's, as
    for MORAN."""
    p = 'preprocessor'
    rules = []
    for stem, n in (('spt', 3), ('fc1', 3)):
        for i in range(n):
            rules += [(f'{p}.{stem}_conv{i}', f'{p}/{stem}_conv{i}',
                       'conv_nobias'),
                      (f'{p}.{stem}_bn{i}', f'{p}/{stem}_bn{i}', 'bn')]
    rules += [(f'{p}.fc1_linear', f'{p}/fc1_linear', 'linear'),
              (f'{p}.fc1_bn1d', f'{p}/fc1_bn1d', 'bn'),
              (f'{p}.fc2', f'{p}/fc2', 'linear')]
    if offsets:
        rules += [(f'{p}.offset_conv1', f'{p}/offset_conv1', 'conv_nobias'),
                  (f'{p}.offset_bn1', f'{p}/offset_bn1', 'bn'),
                  (f'{p}.offset_conv2', f'{p}/offset_conv2', 'conv')]
    return rules


def preprocessor_rules(cfg: Mapping) -> List[Rule]:
    """The rules of the config's image-space preprocessor, dispatched on
    its type; none for no preprocessor or the identity, a ``ValueError``
    for a type without rules."""
    pre = cfg.get('preprocessor') or {}
    pre_type = pre.get('type')
    if pre_type in (None, 'BasePreprocessor'):
        return []
    if pre_type == 'TPSPreprocessor':
        return tps_preprocessor_rules()
    if pre_type == 'MORAN':
        return moran_rules()
    if pre_type == 'SPIN':
        return spin_rules(bool(pre.get('offsets', True)))
    raise ValueError(f'no conversion rules for preprocessor type '
                     f'{pre_type!r}')


def seg_rules(n_levels: int = 4) -> List[Rule]:
    """FPNOCR + SegHead with MMOCR 0.4.0's names (``fpn_ocr.py``,
    ``seg_head.py``): ``neck.lateral_convs.{i}``,
    ``neck.smooth_convs_1x1.{i}`` and ``neck.smooth_convs_3x3.{i}``, each a
    ``ConvModule`` (``.conv`` without bias, ``.bn``), ``head.seg_conv``
    (the same) and ``head.pred_conv``. JAX's ``torch_convert.py`` has no
    seg table and the reference tree is absent, so these names are read
    from MMOCR's modules, not checked against a reference checkpoint."""
    rules = []

    def conv_module(tp, fp):
        return [(f'{tp}.conv', f'{fp}/conv', 'conv_nobias'),
                (f'{tp}.bn', f'{fp}/bn', 'bn')]
    for i in range(n_levels):
        rules += conv_module(f'neck.lateral_convs.{i}', f'neck/lateral{i}')
    for i in range(n_levels - 1):
        rules += conv_module(f'neck.smooth_convs_1x1.{i}',
                             f'neck/smooth1x1_{i}')
        rules += conv_module(f'neck.smooth_convs_3x3.{i}',
                             f'neck/smooth3x3_{i}')
    return rules + conv_module('head.seg_conv', 'head/seg_conv') + [
        ('head.pred_conv', 'head/pred_conv', 'conv')]


def resnet_det_rules(stage_blocks=(2, 2, 2, 2)) -> List[Rule]:
    """ResNetDet (DBNet-R18's trunk) with mmdet ``ResNet``'s names:
    ``conv1`` / ``bn1``, ``layer{i}.{j}.conv{k}`` / ``bn{k}`` and
    ``downsample.{0,1}``."""
    rules = [('backbone.conv1', 'backbone/stem_conv', 'conv_nobias'),
             ('backbone.bn1', 'backbone/stem_bn', 'bn')]
    for si, blocks in enumerate(stage_blocks):
        for b in range(blocks):
            tp = f'backbone.layer{si + 1}.{b}'
            fp = f'backbone/layer{si + 1}_block{b}'
            rules += [(f'{tp}.conv1', f'{fp}/conv1', 'conv_nobias'),
                      (f'{tp}.bn1', f'{fp}/bn1', 'bn'),
                      (f'{tp}.conv2', f'{fp}/conv2', 'conv_nobias'),
                      (f'{tp}.bn2', f'{fp}/bn2', 'bn'),
                      (f'{tp}.downsample.0', f'{fp}/downsample_conv',
                       'conv_nobias'),
                      (f'{tp}.downsample.1', f'{fp}/downsample_bn', 'bn')]
    return rules


def resnet_det50_rules(stage_blocks=(3, 4, 6, 3),
                       stage_with_dcn=(False,) * 4) -> List[Rule]:
    """ResNetDet50 with mmdet ``ResNet``'s names (``conv1..3`` /
    ``bn1..3`` in each Bottleneck); a DCNv2 ``conv2`` has mmcv's
    ``conv2.weight`` (the JAX ``kernel``) and ``conv2.conv_offset``."""
    rules = [('backbone.conv1', 'backbone/stem_conv', 'conv_nobias'),
             ('backbone.bn1', 'backbone/stem_bn', 'bn')]
    for si, blocks in enumerate(stage_blocks):
        for b in range(blocks):
            tp = f'backbone.layer{si + 1}.{b}'
            fp = f'backbone/layer{si + 1}_block{b}'
            for k in (1, 2, 3):
                rules += [(f'{tp}.conv{k}', f'{fp}/conv{k}', 'conv_nobias'),
                          (f'{tp}.bn{k}', f'{fp}/bn{k}', 'bn')]
            if stage_with_dcn[si]:
                rules.append((f'{tp}.conv2.conv_offset',
                              f'{fp}/conv2/conv_offset', 'conv'))
            rules += [(f'{tp}.downsample.0', f'{fp}/downsample_conv',
                       'conv_nobias'),
                      (f'{tp}.downsample.1', f'{fp}/downsample_bn', 'bn')]
    return rules


def fpnc_rules(n_levels: int = 4) -> List[Rule]:
    """FPNC with MMOCR 0.4.0's names: ``neck.lateral_convs.{i}.conv`` and
    ``neck.smooth_convs.{i}.conv`` (``ConvModule`` without norm or
    bias)."""
    rules = []
    for i in range(n_levels):
        rules += [(f'neck.lateral_convs.{i}.conv', f'neck/lateral{i}',
                   'conv_nobias'),
                  (f'neck.smooth_convs.{i}.conv', f'neck/smooth{i}',
                   'conv_nobias')]
    return rules


def db_head_rules() -> List[Rule]:
    """DBHead with MMOCR 0.4.0's names: each branch an ``nn.Sequential``,
    ``.0`` the 3x3 conv, ``.1`` / ``.4`` the norms, ``.3`` / ``.6`` the
    transposed convolutions."""
    rules = []
    for br in ('binarize', 'threshold'):
        rules += [(f'head.{br}.0', f'head/{br}/conv', 'conv_nobias'),
                  (f'head.{br}.1', f'head/{br}/bn1', 'bn'),
                  (f'head.{br}.3', f'head/{br}/up1', 'conv_transpose'),
                  (f'head.{br}.4', f'head/{br}/bn2', 'bn'),
                  (f'head.{br}.6', f'head/{br}/up2', 'conv_transpose')]
    return rules


def dbnet_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of a DBNet config, on ResNetDet or ResNetDet50. JAX's
    ``torch_convert.py`` has no detection table and the reference tree is
    absent, so the names are read from MMOCR 0.4.0's and mmdet's modules,
    not checked against a reference checkpoint."""
    n = len(cfg['neck'].get('in_channels', (64, 128, 256, 512)))
    return _det_trunk_rules(cfg) + fpnc_rules(n) + db_head_rules()


def _det_trunk_rules(cfg: Mapping) -> List[Rule]:
    """The rules of a detector's ResNetDet or ResNetDet50 trunk."""
    bb = cfg['backbone']
    if bb.get('type') == 'ResNetDet':
        return resnet_det_rules(tuple(bb.get('stage_blocks', (2, 2, 2, 2))))
    if bb.get('type') == 'ResNetDet50':
        dcn = (tuple(bb.get('stage_with_dcn', (False,) * 4))
               if bb.get('dcn') else (False,) * 4)
        return resnet_det50_rules(
            tuple(bb.get('stage_blocks', (3, 4, 6, 3))), dcn)
    raise ValueError(f'no conversion rules for backbone type '
                     f'{bb.get("type")!r}')


def fpem_ffm_rules(n_levels: int = 4, fpem_repeat: int = 2) -> List[Rule]:
    """FPEM_FFM with MMOCR 0.4.0's names (``fpem_ffm.py``):
    ``neck.reduce_conv_c{2..5}.{0,1}`` (1x1 conv with bias, BN) and
    ``neck.fpems.{r}.{up,down}_add{1..3}.{depthwise_conv, pointwise_conv,
    bn}``."""
    rules = []
    for i in range(n_levels):
        rules += [(f'neck.reduce_conv_c{i + 2}.0', f'neck/reduce{i}', 'conv'),
                  (f'neck.reduce_conv_c{i + 2}.1', f'neck/reduce_bn{i}',
                   'bn')]
    for r in range(fpem_repeat):
        for name in ('up_add1', 'up_add2', 'up_add3', 'down_add1',
                     'down_add2', 'down_add3'):
            tp, fp = f'neck.fpems.{r}.{name}', f'neck/fpem{r}/{name}'
            rules += [(f'{tp}.depthwise_conv', f'{fp}/depthwise', 'conv'),
                      (f'{tp}.pointwise_conv', f'{fp}/pointwise', 'conv'),
                      (f'{tp}.bn', f'{fp}/bn', 'bn')]
    return rules


def fpnf_rules(n_levels: int = 4) -> List[Rule]:
    """FPNF with MMOCR 0.4.0's names (``fpnf.py``), each a ``ConvModule``
    (``.conv`` without bias, ``.bn``): ``neck.lateral_convs.{i}``,
    ``neck.fpn_convs.{i}`` and ``neck.output_convs``."""
    rules = []

    def conv_module(tp, fp):
        return [(f'{tp}.conv', f'{fp}_conv', 'conv_nobias'),
                (f'{tp}.bn', f'{fp}_bn', 'bn')]
    for i in range(n_levels):
        rules += conv_module(f'neck.lateral_convs.{i}', f'neck/lateral{i}')
    for i in range(n_levels - 1):
        rules += conv_module(f'neck.fpn_convs.{i}', f'neck/fpn{i}')
    return rules + conv_module('neck.output_convs', 'neck/output')


def panet_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of a PANet config (ResNetDet or ResNetDet50,
    FPEM_FFM, PANHead's ``head.out_conv``). JAX's ``torch_convert.py`` has
    no detection table and the reference tree is absent, so the names are
    read from MMOCR 0.4.0's modules, not checked against a reference
    checkpoint."""
    neck = cfg['neck']
    return _det_trunk_rules(cfg) + fpem_ffm_rules(
        len(neck.get('in_channels', (64, 128, 256, 512))),
        int(neck.get('fpem_repeat', 2))) + [
        ('head.out_conv', 'head/out_conv', 'conv')]


def psenet_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of a PSENet config (ResNetDet50, FPNF, PSEHead's
    ``head.out_conv``), MMOCR 0.4.0's names as ``panet_rules``."""
    return _det_trunk_rules(cfg) + fpnf_rules(len(cfg['neck'].get(
        'in_channels', (256, 512, 1024, 2048)))) + [
        ('head.out_conv', 'head/out_conv', 'conv')]


def fpn_det_rules(n_levels: int = 3) -> List[Rule]:
    """FPNDet with mmdet ``FPN``'s names: ``neck.lateral_convs.{i}.conv``
    and ``neck.fpn_convs.{i}.conv`` (``ConvModule``s with a bias, no
    norm)."""
    rules = []
    for i in range(n_levels):
        rules += [(f'neck.lateral_convs.{i}.conv', f'neck/lateral{i}', 'conv'),
                  (f'neck.fpn_convs.{i}.conv', f'neck/fpn{i}', 'conv')]
    return rules


def fcenet_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of an FCENet config (ResNetDet50 with or without
    DCNv2, FPNDet, FCEHead's ``out_conv_cls`` / ``out_conv_reg``). The
    head is ``head`` here as in the other detectors (MMOCR 0.4.0 names it
    ``bbox_head``). JAX's ``torch_convert.py`` has no detection table and
    the reference tree is absent, so the names are read from MMOCR 0.4.0's
    and mmdet's modules, not checked against a reference checkpoint."""
    n = len(cfg['neck'].get('in_channels', (512, 1024, 2048)))
    return _det_trunk_rules(cfg) + fpn_det_rules(n) + [
        ('head.out_conv_cls', 'head/out_conv_cls', 'conv'),
        ('head.out_conv_reg', 'head/out_conv_reg', 'conv')]


def fpn_unet_rules() -> List[Rule]:
    """FPN_UNet with MMOCR 0.4.0's names (``fpn_unet.py``): ``neck.up4``
    (a transposed convolution) and ``neck.up_block{0..3}.{conv1x1,
    conv3x3, deconv}``."""
    rules = [('neck.up4', 'neck/up4', 'conv_transpose')]
    for i in range(4):
        tp, fp = f'neck.up_block{i}', f'neck/up_block{i}'
        rules += [(f'{tp}.conv1x1', f'{fp}/conv1x1', 'conv'),
                  (f'{tp}.conv3x3', f'{fp}/conv3x3', 'conv'),
                  (f'{tp}.deconv', f'{fp}/deconv', 'conv_transpose')]
    return rules


def textsnake_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of a TextSnake config (ResNetDet50, FPN_UNet,
    TextSnakeHead's ``out_conv``), unchecked as ``fcenet_rules``."""
    return _det_trunk_rules(cfg) + fpn_unet_rules() + [
        ('head.out_conv', 'head/out_conv', 'conv')]


def drrg_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of a DRRG config (its trunk, FPN_UNet, DRRGHead's
    ``out_conv`` and its GCN with MMOCR 0.4.0's names: ``head.gcn.conv1``
    .. ``conv4``, ``head.gcn.classifier.0/1/2``), unchecked as
    ``fcenet_rules``. The flax paths are those of ``state_dict_from_jax``'s
    merged tree: the JAX detector's ``net`` variables with its ``gcn``
    parameters under ``gcn``."""
    rules = _det_trunk_rules(cfg) + fpn_unet_rules() + [
        ('head.out_conv', 'head/out_conv', 'conv')]
    rules += [(f'head.gcn.conv{i}', f'gcn/conv{i}', 'graph_conv')
              for i in range(1, 5)]
    return rules + [('head.gcn.classifier.0', 'gcn/cls_fc1', 'linear'),
                    ('head.gcn.classifier.1', 'gcn', 'prelu'),
                    ('head.gcn.classifier.2', 'gcn/cls_fc2', 'linear')]


def maskrcnn_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of an OCRMaskRCNN config with mmdet's names: its
    trunk, FPNDet, ``rpn_head.rpn_conv`` / ``rpn_cls`` / ``rpn_reg``,
    ``roi_head.bbox_head.shared_fcs.{0,1}`` / ``fc_cls`` / ``fc_reg``
    (``shared_fcs.0``'s rows permuted from JAX's (7, 7, C) flattening to
    mmdet's (C, 7, 7), kind ``'linear_hwc7'``) and
    ``roi_head.mask_head.convs.{0..3}.conv`` / ``upsample`` /
    ``conv_logits``; unchecked as ``fcenet_rules``. The flax paths are
    those of ``state_dict_from_jax``'s merged tree: the JAX detector's
    ``main`` variables with its ``box`` and ``mask`` parameters under
    ``box`` and ``mask``."""
    n = len(cfg['neck'].get('in_channels', (256, 512, 1024, 2048)))
    rules = _det_trunk_rules(cfg) + fpn_det_rules(n) + [
        (f'rpn_head.{m}', f'rpn_head/{m}', 'conv')
        for m in ('rpn_conv', 'rpn_cls', 'rpn_reg')]
    box, mask = 'roi_head.bbox_head', 'roi_head.mask_head'
    rules += [(f'{box}.shared_fcs.0', 'box/fc1', 'linear_hwc7'),
              (f'{box}.shared_fcs.1', 'box/fc2', 'linear'),
              (f'{box}.fc_cls', 'box/cls', 'linear'),
              (f'{box}.fc_reg', 'box/reg', 'linear')]
    rules += [(f'{mask}.convs.{i}.conv', f'mask/conv{i}', 'conv')
              for i in range(4)]
    return rules + [(f'{mask}.upsample', 'mask/up', 'conv_transpose'),
                    (f'{mask}.conv_logits', 'mask/logits', 'conv')]


def _double_conv_rules(tp: str, fp: str) -> List[Rule]:
    return [r for k in range(2) for r in (
        (f'{tp}.conv{k}', f'{fp}/conv{k}', 'conv_nobias'),
        (f'{tp}.bn{k}', f'{fp}/bn{k}', 'bn'))]


def unet_rules(num_stages: int = 5) -> List[Rule]:
    """The UNet's names, which mirror the flax modules (``enc{i}``,
    ``up{i}``, ``dec{i}``, each double convolution's ``conv{k}`` /
    ``bn{k}``): the reference's UNet is built of mmcv blocks whose
    layout (a BatchNorm and ReLU after the 1x1 up convolution) the JAX
    package does not follow, so its checkpoint names cannot be taken
    over."""
    rules = []
    for i in range(num_stages):
        rules += _double_conv_rules(f'backbone.enc{i}', f'unet/enc{i}')
    for i in range(num_stages - 1):
        rules.append((f'backbone.up{i}', f'unet/up{i}', 'conv'))
        rules += _double_conv_rules(f'backbone.dec{i}', f'unet/dec{i}')
    return rules


def sdmgr_rules(cfg: Mapping, visual=None) -> List[Rule]:
    """The rule table of an SDMGR config with MMOCR 0.4.0's head names
    (``head.node_embed``, ``head.rnn``, ``head.edge_embed``,
    ``head.gnn_layers.{i}.{in_fc, coef_fc, out_fc}``, ``head.node_cls``,
    ``head.edge_cls``; with the visual modality ``head.fusion.{linear0,
    linear1, merge_linears0.{c}, merge_linears1.{c}, linear_out}`` and the
    UNet, ``unet_rules``). JAX's ``torch_convert.py`` has no KIE table and
    the reference tree is absent, so the names are read from MMOCR
    0.4.0's modules, not checked against a reference checkpoint (MMOCR
    calls the head ``bbox_head``). ``visual`` defaults to the config's
    ``visual_modality``. The flax paths are those of JAX ``train_kie``'s
    variables with the UNet's statistics under ``unet``
    (``state_dict_from_jax``)."""
    head = cfg.get('head') or {}
    if visual is None:
        visual = bool(cfg.get('visual_modality'))
    rules = [('head.node_embed', 'head/node_embed', 'embed'),
             ('head.rnn', 'head/rnn', 'lstm'),
             ('head.edge_embed', 'head/edge_embed', 'linear')]
    for i in range(int(head.get('num_gnn', 2))):
        rules += [(f'head.gnn_layers.{i}.{m}', f'head/gnn{i}/{m}', 'linear')
                  for m in ('in_fc', 'coef_fc', 'out_fc')]
    rules += [('head.node_cls', 'head/node_cls', 'linear'),
              ('head.edge_cls', 'head/edge_cls', 'linear')]
    if not visual:
        return rules
    tp, fp = 'head.fusion', 'head/fusion'
    rules += [(f'{tp}.linear0', f'{fp}/linear0', 'linear'),
              (f'{tp}.linear1', f'{fp}/linear1', 'linear'),
              (f'{tp}.linear_out', f'{fp}/linear_out', 'linear')]
    for c in range(8):
        rules += [(f'{tp}.merge_linears0.{c}', f'{fp}/m0_{c}', 'linear'),
                  (f'{tp}.merge_linears1.{c}', f'{fp}/m1_{c}', 'linear')]
    bb = cfg.get('backbone') or {}
    return rules + unet_rules(int(bb.get('num_stages', 5)))


def ner_rules(cfg: Mapping) -> List[Rule]:
    """The rule table of a NerClassifier config with MMOCR 0.4.0's names
    (its in-tree BERT: ``encoder.bert.embeddings.*``,
    ``encoder.bert.encoder.layer.{i}.{attention.self.{query, key, value},
    attention.output.{dense, LayerNorm}, intermediate.dense,
    output.{dense, LayerNorm}}``, ``decoder.classifier``), unchecked as
    ``sdmgr_rules``. The port has no pooler, as JAX has none: a reference
    checkpoint's ``encoder.bert.pooler.*`` goes unread."""
    n = int((cfg.get('encoder') or {}).get('num_hidden_layers', 12))
    tp, fp = 'encoder.bert', 'encoder'
    rules = [(f'{tp}.embeddings.{m}', f'{fp}/{m}', 'embed')
             for m in ('word_embeddings', 'position_embeddings',
                       'token_type_embeddings')]
    rules.append((f'{tp}.embeddings.LayerNorm', f'{fp}/embeddings_ln', 'ln'))
    for i in range(n):
        lt, lf = f'{tp}.encoder.layer.{i}', f'{fp}/layer{i}'
        rules += [(f'{lt}.attention.self.{m}', f'{lf}_attn/linear_{m[0]}',
                   'linear') for m in ('query', 'key', 'value')]
        rules += [(f'{lt}.attention.output.dense', f'{lf}_attn/fc', 'linear'),
                  (f'{lt}.attention.output.LayerNorm', f'{lf}_ln1', 'ln'),
                  (f'{lt}.intermediate.dense', f'{lf}_ffn1', 'linear'),
                  (f'{lt}.output.dense', f'{lf}_ffn2', 'linear'),
                  (f'{lt}.output.LayerNorm', f'{lf}_ln2', 'ln')]
    return rules + [('decoder.classifier', 'decoder/cls', 'linear')]


def rules_for_config(cfg: Mapping) -> List[Rule]:
    """The rule table of an NRTR, SATRN, ABINet (+ TPS_PP), CRNN, SAR
    (parallel, sequential, beam search), RobustScanner or SegRecognizer
    config, with its image-space preprocessor (TPS-STN, MORAN, SPIN),
    dispatched on its preprocessor, backbone, encoder and decoder types as
    JAX's ``rules_for_config`` (``torch_convert.py:604-684``), or of a
    DBNet, PANet, PSENet, FCENet, TextSnake, DRRG or OCRMaskRCNN detector
    (``dbnet_rules``, ``panet_rules``, ``psenet_rules``, ``fcenet_rules``,
    ``textsnake_rules``, ``drrg_rules``, ``maskrcnn_rules``), of an SDMGR
    (``sdmgr_rules``) or of a NerClassifier (``ner_rules``); a type
    without rules raises a ``ValueError``."""
    if cfg.get('type') == 'SDMGR':
        return sdmgr_rules(cfg)
    if cfg.get('type') == 'NerClassifier':
        return ner_rules(cfg)
    det = {'DBNet': dbnet_rules, 'PANet': panet_rules,
           'PSENet': psenet_rules, 'FCENet': fcenet_rules,
           'TextSnake': textsnake_rules, 'DRRG': drrg_rules,
           'OCRMaskRCNN': maskrcnn_rules}.get(cfg.get('type'))
    if det is not None:
        return det(cfg)
    if cfg.get('type') == 'SegRecognizer':    # no preprocessor, as JAX
        bb = cfg['backbone']
        if bb.get('type') != 'ResNet31OCR':
            raise ValueError(f'no conversion rules for backbone type '
                             f'{bb.get("type")!r}')
        return resnet31_rules(tuple(bb.get('layers', (1, 2, 5, 3)))) + \
            seg_rules(len(cfg['neck'].get('in_channels',
                                          (128, 256, 512, 512))))
    pre_rules = preprocessor_rules(cfg)
    dec = cfg.get('decoder') or {}
    if dec.get('type') == 'CRNNDecoder':
        return pre_rules + crnn_rules(bool(dec.get('rnn_flag', False)))
    bb = cfg['backbone']
    bb_type = bb.get('type')
    if bb_type == 'ResNet31OCR':
        rules = pre_rules + resnet31_rules(tuple(bb.get('layers',
                                                        (1, 2, 5, 3))))
    elif bb_type in ('ResNetABI', 'ResNetABI_v2_large'):
        rules = pre_rules + resnet_abi_rules(tuple(bb.get(
            'arch_settings', (3, 4, 6, 6, 3))))
    elif bb_type == 'NRTRModalityTransform':
        rules = pre_rules + nrtr_modality_rules()
    elif bb_type == 'ShallowCNN':
        rules = pre_rules + shallow_cnn_rules()
    else:
        raise ValueError(f'no conversion rules for backbone type {bb_type!r}')
    if cfg.get('tpsnet'):
        rules += tps_pp_rules()
    if cfg.get('type') == 'ABINet':
        vision = cfg['encoder'].get('encoder') or {}
        return rules + abinet_rules(
            int(vision.get('n_layers', 3)),
            int((cfg.get('decoder') or {}).get('n_layers', 4)),
            language=bool(cfg.get('decoder')), fuser=bool(cfg.get('fuser')))
    enc = cfg.get('encoder') or {}
    enc_type = enc.get('type')
    if enc_type == 'SAREncoder':
        rules += [r for r in sar_rules(bool(enc.get('enc_bi_rnn', False)))
                  if r[0].startswith('encoder.')]
    elif enc_type == 'ChannelReductionEncoder':
        rules.append(('encoder.layer', 'encoder/layer', 'conv'))
    elif enc_type == 'NRTREncoder':
        rules += nrtr_encoder_rules(int(enc.get('n_layers', 6)))
    elif enc_type == 'SatrnEncoder':
        rules += satrn_rules(int(enc.get('n_layers', 12)))
    elif enc:
        raise ValueError(f'no conversion rules for encoder type {enc_type!r}')
    dec_type = dec.get('type')
    if dec_type in ('ParallelSARDecoder', 'ParallelSARDecoderWithBS'):
        return rules + [r for r in sar_rules() if r[0].startswith('decoder.')]
    if dec_type == 'SequentialSARDecoder':
        return rules + sequential_sar_rules()
    if dec_type == 'RobustScannerDecoder':
        return rules + [r for r in robust_scanner_rules()
                        if r[0].startswith('decoder.')]
    if dec_type in ('NRTRDecoder', 'TFDecoder'):
        return rules + nrtr_decoder_rules(int(dec.get('n_layers', 6)))
    if dec_type == 'TFCommonDecoder':
        return rules + tf_common_rules(int(dec.get('n_layers', 3)))
    raise ValueError(f'no conversion rules for decoder type {dec_type!r}')


def _leaf(tree, path: str):
    for part in path.split('/'):
        if not isinstance(tree, Mapping) or part not in tree:
            return None
        tree = tree[part]
    return np.asarray(tree)


_LSTM_KIND = re.compile(r'lstm(?:_l(\d+))?(_reverse)?')


def _torch_entries(kind: str, get) -> Dict[str, np.ndarray]:
    """One module's torch tensors (by state_dict suffix) from its flax
    leaves; ``get(tree, name)`` reads a leaf."""
    if kind in ('conv', 'conv_nobias'):
        out = {'weight': np.transpose(get('params', 'kernel'), (3, 2, 0, 1))}
    elif kind in ('conv1x1_as_dense', 'conv1x1_as_dense_nobias'):
        out = {'weight': get('params', 'kernel').T[:, :, None, None]}
    elif kind in ('linear', 'linear_nobias'):
        out = {'weight': get('params', 'kernel').T}
    elif kind == 'linear_hwc7':
        # a Dense over a flattened (7, 7, C) RoI in JAX; the port flattens
        # the NCHW RoI (C, 7, 7), so the kernel's rows are permuted
        k = get('params', 'kernel')
        k = k.reshape(49, -1, k.shape[-1]).transpose(1, 0, 2)
        out = {'weight': np.ascontiguousarray(k.reshape(-1, k.shape[-1]).T),
               'bias': get('params', 'bias')}
    elif kind == 'conv_transpose':
        # flax's ConvTranspose (transpose_kernel=False) correlates the
        # dilated input with its (kh, kw, in, out) kernel; torch's
        # ConvTranspose2d (in, out, kh, kw) scatters, the kernel flipped
        k = get('params', 'kernel')[::-1, ::-1]
        out = {'weight': np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))}
    elif kind == 'ln':
        out = {'weight': get('params', 'scale')}
    elif kind == 'bn':
        out = {'weight': get('params', 'scale'),
               'running_mean': get('batch_stats', 'mean'),
               'running_var': get('batch_stats', 'var'),
               'num_batches_tracked': np.zeros((), np.int64)}
    elif kind == 'embed':
        return {'weight': get('params', 'embedding')}
    elif kind == 'graph_conv':      # DRRG's GraphConv: (2 in, out), as is
        return {'weight': get('params', 'weight'),
                'bias': get('params', 'bias')}
    elif kind == 'prelu':           # a slope vector beside the GCN's layers
        return {'weight': get('params', 'prelu_alpha')}
    elif _LSTM_KIND.fullmatch(kind):
        # the inverse of JAX's 'lstm' kinds: one direction of one layer of
        # a torch nn.LSTM (or nn.GRU: the same names), 'lstm_l{k}' the
        # layer k, gate order i, f, g, o (r, z, n) in both
        m = _LSTM_KIND.fullmatch(kind)
        sfx = f'_l{m.group(1) or 0}{m.group(2) or ""}'
        return {f'{n}{sfx}': get('params', n)
                for n in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
    elif kind == 'lstm_cell':
        # a torch LSTMCell / GRUCell: one layer's weights, unsuffixed
        return {n: get('params', n)
                for n in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
    elif kind == 'torch_mha':
        # the inverse of JAX's 'torch_mha' rule: q;k;v rows packed
        qkv = ('linear_q', 'linear_k', 'linear_v')
        return {
            'in_proj_weight': np.concatenate(
                [get('params', f'{n}/kernel').T for n in qkv]),
            'in_proj_bias': np.concatenate(
                [get('params', f'{n}/bias') for n in qkv]),
            'out_proj.weight': get('params', 'fc/kernel').T,
            'out_proj.bias': get('params', 'fc/bias')}
    else:
        raise ValueError(kind)
    if kind in ('conv', 'conv1x1_as_dense', 'linear', 'ln', 'bn',
                'conv_transpose'):
        out['bias'] = get('params', 'bias')
    return out


def convert_rules(variables: Mapping, rules: List[Rule]
                  ) -> Dict[str, torch.Tensor]:
    """Torch tensors by reference name for each rule whose flax module is
    in ``variables``; only a stage's optional downsample may be absent."""
    sd = {}
    for tp, fp, kind in rules:
        probe = ('weight_ih' if kind.startswith('lstm') else
                 {'ln': 'scale', 'bn': 'scale', 'embed': 'embedding',
                  'torch_mha': 'fc/kernel', 'graph_conv': 'weight',
                  'prelu': 'prelu_alpha'}.get(kind, 'kernel'))
        if _leaf(variables['params'], f'{fp}/{probe}') is None:
            if '.downsample.' in tp:
                continue
            raise KeyError(f'{fp}: not in the JAX variables')
        entries = _torch_entries(
            kind, lambda tree, name: _leaf(variables[tree], f'{fp}/{name}'))
        for k, v in entries.items():
            sd[f'{tp}.{k}'] = torch.tensor(np.array(v))
    return sd


def state_dict_from_jax(variables: Mapping, cfg: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """JAX recognizer, detector, KIE or NER variables -> a ``state_dict``
    that the model of ``build_recognizer(cfg)`` (NRTR, SATRN, ABINet, CRNN,
    SAR, RobustScanner or SegRecognizer), ``build_detector_module(cfg)``
    (DBNet, PANet, PSENet, FCENet, TextSnake, DRRG, OCRMaskRCNN),
    ``build_sdmgr(cfg)`` or ``NerClassifier(cfg)`` takes
    with ``load_state_dict(strict=True)``; DRRG's are the JAX
    ``TextDetector``'s ``{'net': ..., 'gcn': ...}``, Mask R-CNN's the JAX
    ``MaskRCNNDetector.init_variables``' ``{'main', 'box', 'mask'}``. The
    sinusoid tables, buffers as in the reference, are made from the
    config. An SDMGR's variables are JAX ``train_kie``'s (``{'params':
    {'head', 'unet'}, 'batch_stats'}``, the UNet's statistics at the top of
    ``batch_stats``; the UNet's rules where ``unet`` is there), a
    NerClassifier's JAX ``NerClassifierModule``'s. The head's fusion
    comes along where its parameters are there."""
    if cfg.get('type') == 'SDMGR':
        params = variables['params']
        rules = sdmgr_rules(cfg, 'fusion' in params['head'])
        if 'unet' in params:
            variables = dict(variables, batch_stats={
                'unet': variables.get('batch_stats', {})})
        else:
            rules = [r for r in rules if not r[0].startswith('backbone.')]
        return convert_rules(variables, rules)
    if cfg.get('type') == 'DRRG':
        net = variables['net']
        variables = dict(net, params=dict(net['params'],
                                          gcn=variables['gcn']['params']))
    elif cfg.get('type') == 'OCRMaskRCNN':
        main = variables['main']
        variables = dict(main, params=dict(main['params'],
                                           box=variables['box']['params'],
                                           mask=variables['mask']['params']))
    sd = convert_rules(variables, rules_for_config(cfg))
    if cfg.get('type') == 'ABINet':
        sd.update(_abinet_position_tables(cfg))
        return sd
    enc = cfg.get('encoder') or {}
    if enc.get('type') == 'SatrnEncoder':
        d, n = int(enc.get('d_model', 512)), int(enc.get('n_position', 100))
        table = torch.from_numpy(sinusoid_position_table(n, d)[0]).t()
        pe = 'encoder.position_enc'
        sd[f'{pe}.h_position_encoder'] = table.reshape(1, d, n, 1).clone()
        sd[f'{pe}.w_position_encoder'] = table.reshape(1, d, 1, n).clone()
    if (cfg.get('decoder') or {}).get('type') == 'TFCommonDecoder':
        dec = cfg['decoder']
        sd['decoder.pos_encoder.position_table'] = torch.from_numpy(
            sinusoid_position_table(int(cfg.get('max_seq_len', dec.get(
                'max_seq_len', 64))), int(dec.get('d_model', 512))))
    if 'decoder.trg_word_emb.weight' not in sd:      # no position table
        return sd
    d = sd['decoder.trg_word_emb.weight'].shape[1]
    sd['decoder.position_enc.position_table'] = torch.from_numpy(
        sinusoid_position_table(int(cfg['decoder'].get('n_position', 200)),
                                d))
    return sd


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a torch checkpoint on the CPU: a bare one, or
    mmcv's ``{'meta': ..., 'state_dict': ...}`` wrapper, with any DDP
    ``module.`` prefix dropped (as ``tps_pp_tpu/utils/torch_convert.py:
    750-761`` reads them). Unpickled with ``weights_only=True``: tensors and
    plain containers only."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    return {k[len('module.'):] if k.startswith('module.') else k: v
            for k, v in sd.items()}
