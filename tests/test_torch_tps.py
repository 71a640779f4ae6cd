"""TPS++ in the port against the JAX package: the static builders
(bit-equal), ``build_P_prime``, the bilinear sampler on one grid, the plain
rectification sampler against the Pallas kernel in interpret mode (rtol/atol
1e-4, the JAX kernel's own contract, tests/test_pallas_tps.py) and the tiny
TPS_PP module (1e-4).

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

from tps_pp_tpu.ops import tps as jtps
from tps_pp_tpu.ops.grid_sample import grid_sample as jgrid_sample
from tps_pp_tpu.ops.pallas_tps import tps_grid_sample_fused

from tps_pp_tpu_torch.ops import tps as ttps
from tps_pp_tpu_torch.ops.grid_sample import grid_sample as tgrid_sample
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
