"""The port's conv building blocks and the tiny ResNetABI_v2_large trunk
against the JAX package, in eval BatchNorm, at rtol/atol 1e-5 (float32 on
the CPU; the two sides sum convolutions in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_flagship, jnp_tree, perturb_batch_stats
from torch_port_util import port_from_jax

from tps_pp_tpu.models import layers as jl

from tps_pp_tpu_torch.models import layers as tl
from tps_pp_tpu_torch.utils.convert import convert_rules

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(x):
    return torch.tensor(np.asarray(x))


def _run_port(mod, x):
    with torch.no_grad():
        return tl.nchw_to_nhwc(mod.eval()(tl.nhwc_to_nchw(_nhwc(x)))).numpy()


@pytest.mark.parametrize('stride,use_norm', [(1, False), (2, True)])
def test_conv_module(stride, use_norm):
    x = np.random.default_rng(0).standard_normal((2, 9, 12, 5)).astype(
        np.float32)
    jm = jl.ConvModule(8, 3, stride=stride, padding=1, use_norm=use_norm)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v.setdefault('batch_stats', {})
    want = np.asarray(jm.apply(jnp_tree(v), jnp.asarray(x)))
    kinds = [('bn', 'bn', 'bn')] if use_norm else []
    rules = [('conv', 'conv', 'conv_nobias' if use_norm else 'conv')] + kinds
    pm = tl.ConvModule(5, 8, 3, stride=stride, padding=1, use_norm=use_norm)
    pm.load_state_dict(convert_rules(v, rules), strict=True)
    np.testing.assert_allclose(_run_port(pm, x), want, **TOL)


@pytest.mark.parametrize('stride,downsample', [(1, False), (2, True),
                                               ((2, 1), True)])
def test_basic_block_conv1x1(stride, downsample):
    x = np.random.default_rng(1).standard_normal((2, 8, 16, 6)).astype(
        np.float32)
    planes = 6 if not downsample else 12
    jm = jl.BasicBlock(planes, stride=stride, use_conv1x1=True,
                       use_downsample=downsample)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                            seed=1)
    want = np.asarray(jm.apply(jnp_tree(v), jnp.asarray(x)))
    rules = [('conv1', 'conv1', 'conv_nobias'), ('bn1', 'bn1', 'bn'),
             ('conv2', 'conv2', 'conv_nobias'), ('bn2', 'bn2', 'bn')]
    if downsample:
        rules += [('downsample.0', 'downsample_conv', 'conv_nobias'),
                  ('downsample.1', 'downsample_bn', 'bn')]
    pm = tl.BasicBlock(6, planes, stride, use_downsample=downsample)
    pm.load_state_dict(convert_rules(v, rules), strict=True)
    np.testing.assert_allclose(_run_port(pm, x), want, **TOL)


@pytest.mark.parametrize('scale', [2, (2, 1), (1, 3)])
def test_upsample_nearest(scale):
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    want = np.asarray(jl.upsample_nearest(jnp.asarray(x), scale))
    got = tl.nchw_to_nhwc(tl.upsample_nearest(tl.nhwc_to_nchw(_nhwc(x)),
                                              scale)).numpy()
    np.testing.assert_array_equal(got, want)


def test_resnet_abi_v2_large_trunk():
    jrec, v, cfg = jax_flagship(tiny=True)
    rec = port_from_jax(cfg, v)
    img = np.random.default_rng(3).standard_normal((3, 32, 64, 3)).astype(
        np.float32)
    jv = jnp_tree(v)
    x_j, skips_j = jrec.module.apply(
        jv, jnp.asarray(img), method=lambda m, i: m.backbone.stem_and_head(i))
    tail_j = jrec.module.apply(jv, x_j,
                               method=lambda m, i: m.backbone.tail(i))
    bb = rec.model.backbone
    with torch.no_grad():
        x_p, skips_p = bb.stem_and_head(_nhwc(img))
        tail_p = bb.tail(_nhwc(x_j))
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), **TOL)
    assert len(skips_p) == len(skips_j) == 2
    for sp, sj in zip(skips_p, skips_j):
        np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **TOL)
    assert tail_p.shape == (3, 4, 8, 64)
    np.testing.assert_allclose(tail_p.numpy(), np.asarray(tail_j), **TOL)
