"""Shared helpers of the ``test_torch_*.py`` files: JAX reference models and
their weights carried into the PyTorch port, at small sizes on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tps_pp_tpu.apis.flagship import nrtr_tps_pp_cfg
from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.utils.convert import convert_rules, state_dict_from_jax


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_batch_stats(variables, seed=0):
    """Non-trivial BatchNorm affines and running statistics, so that eval
    BatchNorm is exercised (a fresh init has mean 0 and var 1)."""
    rng = np.random.default_rng(seed)
    v = to_numpy(variables)

    def walk(p, s):
        for k in s:
            if isinstance(s[k], dict) and 'mean' in s[k]:
                n = s[k]['mean'].shape
                s[k]['mean'] = rng.normal(0, 0.2, n).astype(np.float32)
                s[k]['var'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]['scale'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]['bias'] = rng.normal(0, 0.2, n).astype(np.float32)
            elif isinstance(s[k], dict):
                walk(p[k], s[k])
    walk(v['params'], v.get('batch_stats', {}))
    return v


def jax_flagship(tiny=True, seed=0, dropout=None):
    """(JAX recognizer on the ``steps`` decode and the gather sampler, its
    variables as numpy with perturbed BatchNorm statistics, the config).
    ``dropout`` overrides the encoder's and decoder's rate."""
    cfg = nrtr_tps_pp_cfg(tiny=tiny)
    if dropout is not None:
        cfg = dict(cfg, encoder=dict(cfg['encoder'], dropout=dropout),
                   decoder=dict(cfg['decoder'], dropout=dropout))
    jrec = jax_recognizer(cfg)
    shape = (1, 32, 64, 3) if tiny else (1, 32, 128, 3)
    v = jax.jit(lambda key: jrec.init_variables(key, shape))(
        jax.random.PRNGKey(seed))
    return jrec, perturb_batch_stats(v, seed), cfg


def jax_recognizer(cfg, decode_mode='steps', **decoder):
    """The JAX recognizer of ``cfg`` with the gather sampler, on
    ``decode_mode``, with ``decoder`` overriding decoder options."""
    return build_jax(dict(cfg, decode_mode=decode_mode,
                          tpsnet=dict(cfg['tpsnet'], sample_mode='gather'),
                          decoder=dict(cfg['decoder'], **decoder)))


def port_from_jax(cfg, variables, **overrides):
    """The port's recognizer, on the CPU, with the JAX variables loaded
    (strict)."""
    rec = build_recognizer(dict(cfg, **overrides), device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(variables, cfg),
                              strict=True)
    return rec


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def load_sub(module, variables, rules, fp, tp=''):
    """Load the JAX variables of one module (its subtree's ``{'params',
    'batch_stats'}``) into the port's ``module`` through ``rules``, whose
    flax paths start with ``fp`` (a '/' path) and torch names with
    ``tp``."""
    def wrap(t):
        for part in reversed(fp.split('/')):
            t = {part: t}
        return t
    sd = convert_rules({k: wrap(t) for k, t in variables.items()},
                       [r for r in rules if r[1].startswith(fp + '/')])
    cut = len(tp) + 1 if tp else 0
    module.load_state_dict({k[cut:]: t for k, t in sd.items()}, strict=True)
    return module
