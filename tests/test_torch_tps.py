"""TPS++ in the port against the JAX package: the static builders
(bit-equal), ``build_P_prime``, the bilinear sampler on one grid, the plain
rectification sampler against the Pallas kernel in interpret mode (rtol/atol
1e-4, the JAX kernel's own contract, tests/test_pallas_tps.py) and the tiny
TPS_PP module (1e-4). The two-stage variant and the second map
(``with_mp``) likewise against ``tps_grid_sample_fused`` in interpret mode:
float32 at 1e-4, bfloat16 within one bf16 ulp of the output, odd heights
included; and the tiny recognizer serving through the two-stage variant
against JAX's (``sample_mode='pallas'``, ``TPS_SAMPLER_VARIANT``).

The grid is ill-conditioned in float32: its 35-term sums cancel, and JAX's
and torch's f32 grids each sit ~1.5e-6 from a float64 grid, in different
directions. The sampler multiplies a grid error by (W-1)/2 and by the
feature's step between neighbouring pixels, so the 1e-4 comparison of the
whole rectification uses spatially smooth features (as conv outputs are);
the sampler's own arithmetic is checked on white noise with the same grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_flagship, jnp_tree, port_from_jax

from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.ops import tps as jtps
from tps_pp_tpu.ops.grid_sample import grid_sample as jgrid_sample
from tps_pp_tpu.ops.pallas_tps import tps_grid_sample_fused

from tps_pp_tpu_torch.ops import tps as ttps
from tps_pp_tpu_torch.ops.grid_sample import grid_sample as tgrid_sample
from tps_pp_tpu_torch.ops import tps_sampler as tsampler
from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler, tps_sampler_plain

torch.set_num_threads(2)


def _inputs(seed, N, C, Hr, Wr, Hg, Wg, point_size=(2, 8), smooth=False):
    rng = np.random.default_rng(seed)
    F = point_size[0] * point_size[1]
    fid = ttps.build_C_cell_centers(point_size)
    P = ttps.build_P_cell_centers(Wr, Hr)
    inv, P_hat, P = (np.asarray(m, np.float32) for m in (
        ttps.build_inv_delta_C(fid), ttps.build_P_hat(fid, P), P))
    cp = (fid[None] + 0.03 * rng.standard_normal((N, F, 2))).astype(
        np.float32)
    score = np.tanh(rng.standard_normal((N, Hr * Wr, F))).astype(np.float32)
    if smooth:      # coarse noise, bilinearly upsampled 8x
        coarse = torch.from_numpy(rng.standard_normal(
            (N, C, Hg // 8 + 2, Wg // 8 + 2)).astype(np.float32))
        feat = torch.nn.functional.interpolate(
            coarse, size=(Hg, Wg), mode='bilinear', align_corners=True)
        feat = feat.permute(0, 2, 3, 1).contiguous().numpy()
    else:
        feat = rng.standard_normal((N, Hg, Wg, C)).astype(np.float32)
    return feat, cp, score, inv, P_hat, P


@pytest.mark.parametrize('point_size', [(2, 8), (2, 16), (3, 5)])
def test_static_builders_bit_equal(point_size):
    fid = ttps.build_C_cell_centers(point_size)
    np.testing.assert_array_equal(fid, jtps.build_C_cell_centers(point_size))
    np.testing.assert_array_equal(ttps.build_inv_delta_C(fid),
                                  jtps.build_inv_delta_C(fid))
    P = ttps.build_P_cell_centers(64, 16)
    np.testing.assert_array_equal(P, jtps.build_P_cell_centers(64, 16))
    np.testing.assert_array_equal(ttps.build_P_hat(fid, P),
                                  jtps.build_P_hat(fid, P))


def test_build_P_prime():
    """5e-6 absolute: both f32 grids are ~1.5e-6 from the float64 one."""
    feat, cp, score, inv, P_hat, P = _inputs(0, 2, 8, 8, 32, 16, 64)
    want = np.asarray(jtps.build_P_prime(*map(jnp.asarray,
                                              (cp, score, inv, P_hat, P))))
    got = ttps.build_P_prime(*map(torch.from_numpy,
                                  (cp, score, inv, P_hat, P))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize('Hg', [16, 15])
def test_grid_sample_matches_jax(Hg):
    """One grid, white-noise features: the [0,1] grid goes into the [-1,1]
    border/align_corners sampler unchanged, with points outside the
    image clamped to its edge."""
    rng = np.random.default_rng(Hg)
    feat = rng.standard_normal((2, Hg, 64, 8)).astype(np.float32)
    grid = rng.uniform(-0.2, 1.2, (2, 8, 32, 2)).astype(np.float32)
    want = np.asarray(jgrid_sample(jnp.asarray(feat), jnp.asarray(grid),
                                   'border', True))
    got = tgrid_sample(torch.from_numpy(feat), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('Hg', [16, 15])
def test_plain_sampler_matches_pallas_kernel(Hg):
    """Odd feature height included (15)."""
    N, C, Hr, Wr, Wg = 2, 8, 8, 32, 64
    feat, cp, score, inv, P_hat, P = _inputs(Hg, N, C, Hr, Wr, Hg, Wg,
                                             smooth=True)
    want, mp = tps_grid_sample_fused(
        *map(jnp.asarray, (feat, feat[:, ::2, ::2], cp, score, inv, P_hat,
                           P)), (Hr, Wr), tile=64, interpret=True,
        with_mp=False)
    assert mp is None
    args = [torch.from_numpy(a) for a in (feat, cp, score, inv, P_hat, P)]
    got = tps_sampler_plain(*args, (Hr, Wr))
    assert got.shape == (N, Hr, Wr, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # on CPU tensors the wrapper is the plain version, and launches nothing
    before = tps_sampler.launches
    np.testing.assert_array_equal(tps_sampler(*args, (Hr, Wr)).numpy(),
                                  got.numpy())
    assert tps_sampler.launches == before


def test_tps_pp_module():
    jrec, v, cfg = jax_flagship(tiny=True, seed=4)
    # control points that move: loc_fc2 starts at zero weight
    rng = np.random.default_rng(4)
    k = v['params']['tpsnet']['TPE']['loc_fc2']['kernel']
    v['params']['tpsnet']['TPE']['loc_fc2']['kernel'] = (
        0.05 * rng.standard_normal(k.shape)).astype(np.float32)
    rec = port_from_jax(cfg, v)
    img = rng.standard_normal((3, 32, 64, 3)).astype(np.float32)

    def jax_tps(m, i):
        x, skips = m.backbone.stem_and_head(i)
        return m.tpsnet(x, skips)

    want = jrec.module.apply(jnp_tree(v), jnp.asarray(img), method=jax_tps)
    with torch.no_grad():
        x, skips = rec.model.backbone.stem_and_head(torch.from_numpy(img))
        got = rec.model.tpsnet(x, skips)
    for key in ('control_point', 'pc_score', 'output'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert float(np.ptp(got['control_point'].numpy())) > 0


def _bf16_ulps(got, want, floor=0.25):
    """|got - want| in units of the bf16 ulp at the larger magnitude, or at
    ``floor`` below it."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize('Hg,Hi', [(16, 8), (15, 7)])
@pytest.mark.parametrize('variant,dtype', [('dense', 'float32'),
                                           ('twostage', 'float32'),
                                           ('twostage', 'bfloat16')])
def test_fused_sampler_with_mp_matches_pallas_kernel(variant, dtype, Hg, Hi):
    """Both variants, both maps (``with_mp``), odd heights included. The
    dense variant keeps float32 bilinear weights where the Pallas kernel
    rounds them to the feature type, so it is compared in float32 only.

    bf16: on JAX's grid the two-stage warp is bit-equal to the Pallas
    kernel's (same weights, same rounding points); the whole function,
    whose float32 grid differs from JAX's by ~1e-6, is within one bf16 ulp
    of the output, taken at magnitude 0.25 or more: near 0 the outputs are
    sums of O(1) taps that cancel, and a 1e-6 move of a weight there is
    many ulps of the small sum."""
    N, C, Hr, Wr, Wg, Wi = 2, 8, 8, 32, 64, 32
    feat, cp, score, inv, P_hat, P = _inputs(Hg + Hi, N, C, Hr, Wr, Hg, Wg,
                                             smooth=True)
    img = _inputs(Hi, N, C, Hr, Wr, Hi, Wi, smooth=True)[0]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tps_args = (cp, score, inv, P_hat, P)
    want = tps_grid_sample_fused(
        jnp.asarray(feat, jdt), jnp.asarray(img, jdt),
        *map(jnp.asarray, tps_args), (Hr, Wr), tile=64, interpret=True,
        with_mp=True, variant=variant)
    maps = [torch.from_numpy(a).to(tdt) for a in (feat, img)]
    mats = [torch.from_numpy(a) for a in tps_args]
    got = tsampler.tps_grid_sample_fused(*maps, *mats, (Hr, Wr),
                                         with_mp=True, variant=variant)
    jgrid = torch.tensor(np.asarray(jtps.build_P_prime(
        *map(jnp.asarray, tps_args))))
    for g, w, m in zip(got, want, maps, strict=True):
        assert g.shape == (N, Hr, Wr, C) and g.dtype == tdt
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == 'float32':
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert float(_bf16_ulps(g, w).max()) <= 1.0
            np.testing.assert_array_equal(
                tsampler.warp_twostage(m, jgrid).float().numpy(),
                w.reshape(N, Hr * Wr, C))
    # without the second map: the same rectified map, and no second output
    rect, mp = tsampler.tps_grid_sample_fused(
        maps[0], None, *mats, (Hr, Wr), with_mp=False, variant=variant)
    assert mp is None and torch.equal(rect, got[0])


def test_sampler_variant_is_read_per_call(monkeypatch):
    """``variant=None`` reads TPS_SAMPLER_VARIANT at each call (the JAX
    package bakes it in at trace time); an unknown variant raises; on CPU
    tensors nothing is launched."""
    feat, cp, score, inv, P_hat, P = _inputs(3, 2, 8, 8, 32, 16, 64)
    args = [torch.from_numpy(feat).to(torch.bfloat16)] + [
        torch.from_numpy(a) for a in (cp, score, inv, P_hat, P)] + [(8, 32)]
    dense = tsampler.tps_sampler_plain(*args)
    twostage = tsampler.tps_sampler_plain_twostage(*args)
    assert not torch.equal(dense, twostage)
    before = (tps_sampler.launches, tps_sampler.launches_twostage)
    monkeypatch.delenv('TPS_SAMPLER_VARIANT', raising=False)
    assert torch.equal(tps_sampler(*args), dense)
    monkeypatch.setenv('TPS_SAMPLER_VARIANT', 'twostage')
    assert torch.equal(tps_sampler(*args), twostage)
    assert torch.equal(tps_sampler(*args, variant='dense'), dense)
    monkeypatch.setenv('TPS_SAMPLER_VARIANT', 'onehot')
    with pytest.raises(ValueError, match='variant'):
        tps_sampler(*args)
    assert (tps_sampler.launches, tps_sampler.launches_twostage) == before


def _interpret_tps(monkeypatch):
    import tps_pp_tpu.ops.pallas_tps as ptps
    orig = ptps.tps_grid_sample_fused
    monkeypatch.setattr(ptps, 'tps_grid_sample_fused', lambda *a, **k: orig(
        *a, **dict(k, interpret=True)))


@pytest.mark.parametrize('variant', ['dense', 'twostage'])
def test_tiny_recognizer_pallas_sample_mode_matches_jax(monkeypatch,
                                                         variant):
    """``sample_mode='pallas'`` serves through the variant that
    TPS_SAMPLER_VARIANT names, on both sides (fresh recognizers after the
    variable is set; JAX's Pallas kernel in interpret mode): argmax equal,
    probabilities within 1e-5 in float32."""
    _interpret_tps(monkeypatch)
    monkeypatch.setenv('TPS_SAMPLER_VARIANT', variant)
    _, v, cfg = jax_flagship(tiny=True, seed=9)
    k = v['params']['tpsnet']['TPE']['loc_fc2']['kernel']
    v['params']['tpsnet']['TPE']['loc_fc2']['kernel'] = (
        0.05 * np.random.default_rng(9).standard_normal(k.shape)).astype(
            np.float32)
    cfg = dict(cfg, tpsnet=dict(cfg['tpsnet'], sample_mode='pallas'))
    jrec = build_jax(dict(cfg, decode_mode='steps'))
    rec = port_from_jax(cfg, v)
    img = np.random.default_rng(9).standard_normal((3, 32, 64, 3)).astype(
        np.float32)
    vr = np.array([1.0, 0.5, 0.8], np.float32)
    want = np.asarray(jrec.predict(jnp_tree(v), jnp.asarray(img),
                                   jnp.asarray(vr)))
    launched = (tps_sampler.launches, tps_sampler.launches_twostage)
    got = rec.predict(img, vr).numpy()
    assert (tps_sampler.launches, tps_sampler.launches_twostage) == launched
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
