"""The fused stem of the port (``ops/stem.py``) against the JAX package's
(``ops/pallas_stem.py``, its Pallas kernels in interpret mode), on the CPU
in float32:

* ``conv3x3_cp_plain`` and ``basic_block_cp_plain`` against the Pallas ops
  on the same weights: atol 2e-5 and 3e-5, the JAX ops' own contract
  (tests/test_pallas_stem.py); the BatchNorm fold against JAX's, and the
  folded block against the port's ``BasicBlock`` module;
* ``fused_stem_forward`` against the JAX function with a zero stem-conv
  bias (the same formulation on both sides: 1e-4), and with a nonzero one
  against the JAX module stem ``stem_and_head`` (1e-4), which the JAX
  function does not match: it drops that bias;
* the tiny recognizer's ``predict`` with ``stem_mode='fused'`` against
  JAX's: argmax equal, probabilities within 1e-5 (both sides run the same
  formulation in float32; tests/test_pallas_stem.py:111-112 allows 2e-3
  for the fused stem against the module stem).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (jax_flagship, jax_recognizer, jnp_tree,
                             perturb_batch_stats, port_from_jax)

from tps_pp_tpu.ops import pallas_stem as jstem

from tps_pp_tpu_torch.models.layers import BasicBlock
from tps_pp_tpu_torch.ops import stem

torch.set_num_threads(2)


def _conv_inputs(seed, N, H, W, C, Cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, C, Cout))).astype(np.float32)
    b = rng.standard_normal((Cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize('relu', [False, True])
@pytest.mark.parametrize('H', [6, 5])
def test_conv3x3_cp_plain_matches_pallas(relu, H):
    N, W, C, Cout = 2, 16, 8, 12
    x, w, b = _conv_inputs(H, N, H, W, C, Cout)
    want = jstem.conv3x3_cp(jstem.nhwc_to_cp(jnp.asarray(x)),
                            jstem.hwio_to_taps(jnp.asarray(w)),
                            jnp.asarray(b)[:, None], H=H, W=W, relu=relu,
                            bn=2, interpret=True)
    x2d = stem.nhwc_to_cp(torch.from_numpy(x))
    taps = stem.hwio_to_taps(torch.from_numpy(w))
    np.testing.assert_array_equal(taps.numpy(),
                                  np.asarray(jstem.hwio_to_taps(w)))
    got = stem.conv3x3_cp_plain(x2d, taps, torch.from_numpy(b)[:, None],
                                H=H, W=W, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    # torch's OIHW weights give the same tap rows; the layouts round-trip
    assert torch.equal(stem.oihw_to_taps(
        torch.from_numpy(w).permute(3, 2, 0, 1)), taps)
    assert torch.equal(stem.cp_to_nhwc(x2d, (N, H, W)), torch.from_numpy(x))
    # on CPU tensors the wrapper is the plain version, and launches nothing
    before = stem.conv3x3_cp.launches
    assert torch.equal(stem.conv3x3_cp(
        x2d, taps, torch.from_numpy(b)[:, None], H=H, W=W, relu=relu), got)
    assert stem.conv3x3_cp.launches == before


def _block(seed, cin, planes, downsample=False):
    """A port BasicBlock in eval mode with random weights and perturbed
    BatchNorm statistics and affines (as tests/test_pallas_stem.py:44-53),
    so that a fault of the fold cannot hide behind the defaults."""
    rng = np.random.default_rng(seed)
    blk = BasicBlock(cin, planes, use_downsample=downsample).eval()
    with torch.no_grad():
        for name, t in blk.state_dict().items():
            if t.dtype != torch.float32:
                continue
            if name.endswith(('running_mean', 'bias')):
                t += torch.from_numpy(0.3 * rng.standard_normal(
                    t.shape).astype(np.float32))
            elif name.endswith(('running_var', 'bn1.weight', 'bn2.weight',
                                '1.weight')):
                t *= torch.from_numpy(np.exp(0.3 * rng.standard_normal(
                    t.shape)).astype(np.float32))
            else:
                t.copy_(torch.from_numpy((rng.standard_normal(t.shape) /
                                          np.sqrt(t[0].numel())).astype(
                                              np.float32)))
    return blk


def _jax_fold(conv_w_oihw, bn):
    """The JAX package's fold_bn on the same parameters (HWIO kernel)."""
    params = dict(scale=jnp.asarray(bn.weight.detach().numpy()),
                  bias=jnp.asarray(bn.bias.detach().numpy()))
    stats = dict(mean=jnp.asarray(bn.running_mean.numpy()),
                 var=jnp.asarray(bn.running_var.numpy()))
    k = jnp.asarray(conv_w_oihw.detach().permute(2, 3, 1, 0).numpy())
    return jstem.fold_bn(k, params, stats)


# (residual, C_in, planes, H, b1 made positive): two small blocks, then the
# stem's three channel patterns (layer1's 32 -> 32 -> 32, layer2's block0
# 32 -> 64 -> 64 without the residual, its blocks 64 -> 64 -> 64) at an odd
# height with b1 > 0, so that a y of relu(b1) in place of the SAME padding
# would show at the first and last rows
_BLOCK_CASES = [pytest.param(True, 16, 16, 6, False, id='True'),
                pytest.param(False, 8, 16, 6, False, id='False'),
                pytest.param(True, 32, 32, 5, True, id='layer1'),
                pytest.param(False, 32, 64, 5, True, id='layer2_block0'),
                pytest.param(True, 64, 64, 5, True, id='layer2_blocks')]


@pytest.mark.parametrize('residual,cin,planes,H,positive_b1', _BLOCK_CASES)
def test_basic_block_cp_plain_matches_pallas(residual, cin, planes, H,
                                             positive_b1):
    N, W = 2, 16
    blk = _block(int(residual) + (cin if positive_b1 else 0), cin, planes)
    if positive_b1:     # shift bn1's beta so that every folded b1 is >= 0.5
        with torch.no_grad():
            _, b1 = stem.fold_bn(blk.conv1.weight[:, :, 0, 0], blk.bn1)
            blk.bn1.bias += (0.5 - b1.min()).clamp(min=0)
    w1, b1 = stem.fold_bn(blk.conv1.weight[:, :, 0, 0], blk.bn1)
    assert not positive_b1 or float(b1.detach().min()) >= 0.5 - 1e-6
    w2, b2 = stem.fold_bn(blk.conv2.weight, blk.bn2)
    jw1, jb1 = _jax_fold(blk.conv1.weight, blk.bn1)
    jw2, jb2 = _jax_fold(blk.conv2.weight, blk.bn2)
    np.testing.assert_allclose(w1.detach().numpy(), np.asarray(jw1)[0, 0].T,
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(b1.detach().numpy(), np.asarray(jb1),
                               rtol=1e-6, atol=1e-7)
    taps = stem.oihw_to_taps(w2.detach())
    np.testing.assert_allclose(taps.numpy(),
                               np.asarray(jstem.hwio_to_taps(jw2)),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(b2.detach().numpy(), np.asarray(jb2),
                               rtol=1e-6, atol=1e-7)

    x = np.random.default_rng(7).standard_normal(
        (N, H, W, cin)).astype(np.float32)
    t = stem.nhwc_to_cp(torch.from_numpy(x))
    args = (w1.detach(), b1.detach()[:, None], taps, b2.detach()[:, None])
    got = stem.basic_block_cp_plain(t, *args, H=H, W=W, residual=residual)
    want = jstem.basic_block_cp(jnp.asarray(t.numpy()),
                                *(jnp.asarray(a.numpy()) for a in args),
                                H=H, W=W, residual=residual, bn=1,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=0)
    before = stem.basic_block_cp.launches
    assert torch.equal(stem.basic_block_cp(t, *args, H=H, W=W,
                                           residual=residual), got)
    assert stem.basic_block_cp.launches == before
    if residual:    # the folded block is the module's eval forward
        with torch.no_grad():
            ref = blk(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(
            stem.cp_to_nhwc(got, (N, H, W)).numpy(),
            ref.permute(0, 2, 3, 1).numpy(), atol=3e-5, rtol=1e-4)


def _trunk(arch, seed, conv1_bias=None):
    """The tiny flagship's JAX variables (perturbed BatchNorm statistics)
    with the trunk's stage depths ``arch`` and optionally a stem-conv bias;
    the port's recognizer on the same weights."""
    jrec, v, cfg = jax_flagship(tiny=True, seed=seed)
    if arch is not None:
        cfg = dict(cfg, backbone=dict(cfg['backbone'], arch_settings=arch))
        jrec = jax_recognizer(cfg)
        v = jax.jit(lambda k: jrec.init_variables(k, (1, 32, 64, 3)))(
            jax.random.PRNGKey(seed))
        v = perturb_batch_stats(v, seed)
    if conv1_bias is not None:
        b = v['params']['backbone']['conv1']['bias']
        v['params']['backbone']['conv1']['bias'] = np.full(
            b.shape, conv1_bias, np.float32) + 0.1 * np.random.default_rng(
                seed).standard_normal(b.shape).astype(np.float32)
    return jrec, v, cfg, port_from_jax(cfg, v)


def _img(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 64, 3)).astype(np.float32)


@pytest.mark.parametrize('arch', [None, [2, 3, 1, 1, 1]])
def test_fused_stem_matches_jax_fused_stem(arch):
    """Zero stem-conv bias (a fresh init): the two fused stems compute the
    same function in the same formulation. ``arch`` None is the tiny
    trunk (one block a stage); [2, 3, ...] reaches layer1's second block
    and layer2's blocks after the first."""
    _, v, _, rec = _trunk(arch, seed=5)
    assert not np.any(v['params']['backbone']['conv1']['bias'])
    img = _img(5)
    want_x, want_skips = jstem.fused_stem_forward(
        jnp_tree(v['params']['backbone']),
        jnp_tree(v['batch_stats']['backbone']), jnp.asarray(img),
        dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        x, skips = stem.fused_stem_forward(rec.model.backbone,
                                           torch.from_numpy(img),
                                           torch.float32)
    assert x.shape == want_x.shape
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), atol=1e-4,
                               rtol=0)
    for a, b in zip(skips, want_skips, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_fused_stem_folds_the_conv_bias():
    """With a nonzero stem-conv bias the port's fused stem matches the JAX
    module stem (``stem_and_head``); the JAX fused stem drops the bias and
    parts from it by about the bias itself (0.5 here) at skip 0."""
    jrec, v, _, rec = _trunk(None, seed=6, conv1_bias=0.5)
    img = _img(6)
    want_x, want_skips = jrec.module.apply(
        jnp_tree(v), jnp.asarray(img),
        method=lambda m, i: m.backbone.stem_and_head(i))
    with torch.no_grad():
        x, skips = stem.fused_stem_forward(rec.model.backbone,
                                           torch.from_numpy(img),
                                           torch.float32)
        mx, mskips = rec.model.backbone.eval().stem_and_head(
            torch.from_numpy(img))
    for got, want, mod in zip([x] + skips, [want_x] + list(want_skips),
                              [mx] + mskips, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), mod.numpy(), atol=1e-4,
                                   rtol=0)
    _, jskips = jstem.fused_stem_forward(
        jnp_tree(v['params']['backbone']),
        jnp_tree(v['batch_stats']['backbone']), jnp.asarray(img),
        dtype=jnp.float32, interpret=True)
    assert float(np.abs(np.asarray(jskips[0]) -
                        np.asarray(want_skips[0])).max()) > 0.4


def test_predict_fused_stem_matches_jax():
    jrec, v, cfg, _ = _trunk(None, seed=7)
    jrec = jax_recognizer(dict(cfg, stem_mode='fused'))
    rec = port_from_jax(cfg, v, stem_mode='fused', decode_mode='fused40_bf16')
    assert jrec.resolved_stem_mode() == rec.resolved_stem_mode() == 'fused'
    img = _img(7, 3)
    vr = np.array([1.0, 0.6, 0.8], np.float32)
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(vr)))
    got = rec.predict(img, vr).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resolved_stem_mode():
    """'auto' and 'xla' run the module stem, 'fused' the fused one where
    the trunk has the flagship's geometry; other modes raise."""
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    cfg = nrtr_tps_pp_cfg(tiny=True)
    for mode, want in (('auto', 'xla'), ('xla', 'xla'), ('fused', 'fused')):
        rec = build_recognizer(dict(cfg, stem_mode=mode), device='cpu')
        assert rec.resolved_stem_mode() == want
    for backbone in (dict(strides=[2, 1, 2, 1, 2]), dict(stem_channels=8)):
        rec = build_recognizer(dict(cfg, stem_mode='fused', backbone=dict(
            cfg['backbone'], **backbone)), device='cpu')
        assert rec.resolved_stem_mode() == 'xla'
    rec = build_recognizer(dict(cfg, stem_mode='fused', tpsnet=None),
                           device='cpu')
    assert rec.resolved_stem_mode() == 'xla'
    with pytest.raises(ValueError, match='stem_mode'):
        build_recognizer(dict(cfg, stem_mode='pallas'), device='cpu')


def test_fused_stem_weights_follow_the_model():
    """The folded weights are cached per weights stamp: after an in-place
    update of a BatchNorm statistic (as a training step makes) the fused
    stem serves the new weights; an odd height raises."""
    _, _, _, rec = _trunk(None, seed=8)
    bb = rec.model.backbone.eval()
    img = torch.from_numpy(_img(8))
    with torch.no_grad():
        before, _ = stem.fused_stem_forward(bb, img, torch.float32)
        bb.layer2[0].bn2.running_mean.add_(0.5)
        after, _ = stem.fused_stem_forward(bb, img, torch.float32)
        ref, _ = bb.stem_and_head(img)
    assert float((after - before).abs().max()) > 1e-2
    np.testing.assert_allclose(after.numpy(), ref.numpy(), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match='even H and W'):
        stem.fused_stem_forward(bb, img[:, :31], torch.float32)
