"""The port's training warp (``tps_pp_tpu_torch/ops/grid_sample.py``) against
the JAX package on the CPU, in float32: the plain forward and backward
against JAX ``grid_sample`` and its ``jax.vjp``, and against the Pallas
kernels ``grid_sample_pallas``, ``grid_sample_grad`` and
``grid_sample_grad_img`` in interpret mode; ``gradcheck`` of
``GridSampleFunction`` in float64; the wrappers' CPU dispatch.

Tolerances are ``tests/test_grid_sample_vjp.py``'s for float32: values
1e-5 / 1e-6, d_img 1e-5, d_grid rtol 1e-4 / atol 1e-5. Inputs cover sample
points inside the map, beyond it (clamped to the border) and on interior
pixel centres. Against ``jax.vjp`` exact border ties are kept out:
``jnp.clip``'s derivative is 0.5 there, where the Pallas kernel and the
port pass the whole gradient (1); against the Pallas kernel they are in.
The pixel centres are exact where size - 1 is a power of two (5, 9, 17,
33); elsewhere 2p/(size-1) - 1 rounds, the centre lands one ulp to either
side, and which side depends on how an implementation orders its f32
unnormalization, so the comparisons with the Pallas kernel's gradient use
those sizes only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tps_pp_tpu.ops.grid_sample import _gather_impl
from tps_pp_tpu.ops.grid_sample import grid_sample as jgrid_sample
from tps_pp_tpu.ops.pallas_grid_sample import (grid_sample_grad,
                                               grid_sample_grad_img,
                                               grid_sample_pallas)

from tps_pp_tpu_torch.ops import grid_sample as tgs

torch.set_num_threads(2)


def _case(seed, N=2, H=7, W=13, C=6, Ho=4, Wo=6, ties=False):
    """img, grid, cot as float32 numpy. The grid spans [-1.3, 1.3]; its
    first row holds interior pixel centres, and with ``ties`` its second
    row holds exact border points (g = -1 and g = 1 on each axis)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((N, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (N, Ho, Wo, 2)).astype(np.float32)
    grid[:, 0, :, 0] = 2 * rng.integers(1, W - 1, (N, Wo)) / (W - 1) - 1
    grid[:, 0, :, 1] = 2 * rng.integers(1, H - 1, (N, Wo)) / (H - 1) - 1
    if ties:
        grid[:, 1, :, 0] = rng.choice([-1.0, 1.0], (N, Wo))
        grid[:, 1, :, 1] = rng.uniform(-0.9, 0.9, (N, Wo))
        grid[:, 2, :, 1] = rng.choice([-1.0, 1.0], (N, Wo))
        grid[:, 2, :, 0] = rng.uniform(-0.9, 0.9, (N, Wo))
    cot = rng.standard_normal((N, Ho, Wo, C)).astype(np.float32)
    return img, grid, cot


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('seed,H,W', [(0, 7, 13), (1, 16, 32), (2, 5, 9)])
def test_forward_matches_jax_and_pallas(seed, H, W):
    img, grid, _ = _case(seed, H=H, W=W, ties=True)
    want = np.asarray(jgrid_sample(jnp.asarray(img), jnp.asarray(grid)))
    pallas = np.asarray(grid_sample_pallas(jnp.asarray(img),
                                           jnp.asarray(grid),
                                           interpret=True))
    ti, tg = _t(img, grid)
    for got in (tgs.grid_sample_plain(ti, tg), tgs.grid_sample(ti, tg),
                tgs.grid_sample_forward(ti, tg)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5,
                                   atol=1e-6)
    # the gather + lerp the backward differentiates is the same function
    np.testing.assert_allclose(tgs._gather_lerp(ti, tg).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('seed,H,W', [(3, 7, 13), (4, 16, 32)])
def test_backward_matches_jax_vjp(seed, H, W):
    img, grid, cot = _case(seed, H=H, W=W)
    _, pull = jax.vjp(lambda im, gr: _gather_impl(im, gr, 'border', True),
                      jnp.asarray(img), jnp.asarray(grid))
    want_img, want_grid = (np.asarray(a) for a in pull(jnp.asarray(cot)))
    d_img, d_grid = tgs.grid_sample_grad_plain(*_t(grid, cot, img))
    assert d_img.dtype == d_grid.dtype == torch.float32
    np.testing.assert_allclose(d_img.numpy(), want_img, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_grid.numpy(), want_grid, rtol=1e-4,
                               atol=1e-5)
    d_img_only = tgs.grid_sample_grad_img_plain(*_t(grid, cot), H, W)
    np.testing.assert_allclose(d_img_only.numpy(), want_img, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('seed,H,W', [(5, 5, 9), (6, 17, 33), (7, 9, 17)])
def test_backward_matches_pallas_kernels(seed, H, W):
    """Kernel 9 (fused VJP) and kernel 10 (d_img only) of the JAX package
    in interpret mode, exact border ties included."""
    img, grid, cot = _case(seed, H=H, W=W, ties=True)
    want_img, want_grid = (np.asarray(a) for a in grid_sample_grad(
        jnp.asarray(grid), jnp.asarray(cot), jnp.asarray(img), tile=8,
        interpret=True))
    want_img10 = np.asarray(grid_sample_grad_img(
        jnp.asarray(grid), jnp.asarray(cot), H, W, tile=8, interpret=True))
    tg, tc, ti = _t(grid, cot, img)
    for d_img, d_grid in (tgs.grid_sample_grad_plain(tg, tc, ti),
                          tgs.grid_sample_grad(tg, tc, ti)):
        np.testing.assert_allclose(d_img.numpy(), want_img, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(d_grid.numpy(), want_grid, rtol=1e-4,
                                   atol=1e-5)
    for d_img in (tgs.grid_sample_grad_img_plain(tg, tc, H, W),
                  tgs.grid_sample_grad_img(tg, tc, H, W)):
        np.testing.assert_allclose(d_img.numpy(), want_img10, rtol=1e-5,
                                   atol=1e-5)


def test_border_ties_pass_the_whole_gradient():
    """At g = -1 exactly the clip passes the gradient (v[1] - v[0] along
    x); at g = 1 the far tap clamps onto the near one and it is 0."""
    img = np.zeros((1, 3, 4, 2), np.float32)
    img[0, :, :, 0] = np.arange(4) ** 2          # x-steps 1, 3, 5
    grid = np.array([[[[-1.0, 0.0], [1.0, 0.0]]]], np.float32)
    cot = np.zeros((1, 1, 2, 2), np.float32)
    cot[..., 0] = 1.0
    _, d_grid = tgs.grid_sample_grad_plain(*_t(grid, cot, img))
    np.testing.assert_allclose(d_grid.numpy()[0, 0, :, 0], [1.5, 0.0])


def test_gradcheck_away_from_kinks():
    """float64, sample points at least 0.2 pixel from a pixel edge and
    from the border, so the finite differences cross no kink."""
    rng = np.random.default_rng(8)
    N, H, W, C = 2, 5, 7, 3
    px = rng.integers(0, W - 1, (N, 3, 4)) + rng.uniform(0.2, 0.8, (N, 3, 4))
    py = rng.integers(0, H - 1, (N, 3, 4)) + rng.uniform(0.2, 0.8, (N, 3, 4))
    grid = torch.from_numpy(np.stack([2 * px / (W - 1) - 1,
                                      2 * py / (H - 1) - 1], -1))
    img = torch.from_numpy(rng.standard_normal((N, H, W, C)))
    grid.requires_grad_(True)
    img.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda im, gr: tgs.GridSampleFunction.apply(im, gr, False),
        (img, grid), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('plain', [False, True])
def test_function_backward_routes_and_dtypes(plain):
    """On CPU tensors the function's backward is the plain VJP whichever
    route it takes: the full one when the grid needs a gradient, d_img only
    when it does not. d_img comes back in the image's dtype; no kernel is
    launched."""
    img, grid, cot = _case(9)
    launches = [f.launches for f in (tgs.grid_sample_forward,
                                     tgs.grid_sample_grad,
                                     tgs.grid_sample_grad_img)]
    for grid_grad in (True, False):
        ti = torch.from_numpy(img).to(torch.bfloat16).requires_grad_(True)
        tg = torch.from_numpy(grid).requires_grad_(grid_grad)
        out = tgs.grid_sample(ti, tg, plain=plain)
        assert out.dtype == torch.bfloat16
        out.backward(torch.from_numpy(cot).to(torch.bfloat16))
        assert ti.grad.dtype == torch.bfloat16
        d_img, d_grid = tgs.grid_sample_grad_plain(
            tg.detach(), torch.from_numpy(cot).to(torch.bfloat16),
            ti.detach())
        np.testing.assert_array_equal(ti.grad.float().numpy(),
                                      d_img.to(torch.bfloat16).float())
        if grid_grad:
            np.testing.assert_array_equal(tg.grad.numpy(), d_grid.numpy())
        else:
            assert tg.grad is None
    assert [f.launches for f in (tgs.grid_sample_forward,
                                 tgs.grid_sample_grad,
                                 tgs.grid_sample_grad_img)] == launches
