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

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.transformer import sinusoid_position_table

Rule = Tuple[str, str, str]


def resnet_abi_rules(arch=(3, 4, 6, 6, 3)) -> List[Rule]:
    """ResNetABI_v2_large (reference names conv1/bn1/layer{i}.{j})."""
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


def rules_for_config(cfg: Mapping) -> List[Rule]:
    """The rule table of an NRTR (+ TPS_PP) recognizer config."""
    rules = resnet_abi_rules(tuple(cfg['backbone'].get(
        'arch_settings', (3, 4, 6, 6, 3))))
    if cfg.get('tpsnet'):
        rules += tps_pp_rules()
    rules += nrtr_encoder_rules(int(cfg['encoder'].get('n_layers', 6)))
    return rules + nrtr_decoder_rules(int(cfg['decoder'].get('n_layers', 6)))


def _leaf(tree, path: str):
    for part in path.split('/'):
        if not isinstance(tree, Mapping) or part not in tree:
            return None
        tree = tree[part]
    return np.asarray(tree)


def _torch_entries(kind: str, get) -> Dict[str, np.ndarray]:
    """One module's torch tensors (by state_dict suffix) from its flax
    leaves; ``get(tree, name)`` reads a leaf."""
    if kind in ('conv', 'conv_nobias'):
        out = {'weight': np.transpose(get('params', 'kernel'), (3, 2, 0, 1))}
    elif kind == 'conv1x1_as_dense_nobias':
        out = {'weight': get('params', 'kernel').T[:, :, None, None]}
    elif kind in ('linear', 'linear_nobias'):
        out = {'weight': get('params', 'kernel').T}
    elif kind == 'ln':
        out = {'weight': get('params', 'scale')}
    elif kind == 'bn':
        out = {'weight': get('params', 'scale'),
               'running_mean': get('batch_stats', 'mean'),
               'running_var': get('batch_stats', 'var'),
               'num_batches_tracked': np.zeros((), np.int64)}
    elif kind == 'embed':
        return {'weight': get('params', 'embedding')}
    else:
        raise ValueError(kind)
    if kind in ('conv', 'linear', 'ln', 'bn'):
        out['bias'] = get('params', 'bias')
    return out


def convert_rules(variables: Mapping, rules: List[Rule]
                  ) -> Dict[str, torch.Tensor]:
    """Torch tensors by reference name for each rule whose flax module is
    in ``variables``; only a stage's optional downsample may be absent."""
    sd = {}
    for tp, fp, kind in rules:
        probe = {'ln': 'scale', 'bn': 'scale', 'embed': 'embedding'}.get(
            kind, 'kernel')
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
    """JAX recognizer variables -> a ``state_dict`` that
    ``TextRecognizer(cfg).model.load_state_dict`` takes with
    ``strict=True``."""
    sd = convert_rules(variables, rules_for_config(cfg))
    d = sd['decoder.trg_word_emb.weight'].shape[1]
    sd['decoder.position_enc.position_table'] = torch.from_numpy(
        sinusoid_position_table(int(cfg['decoder'].get('n_position', 200)),
                                d))
    return sd
