"""The port's CUDA kernels against their plain versions, and the wrappers'
dispatch. This file imports neither JAX nor the JAX package, so that on a
machine with a card and without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The kernel tests carry ``requires_cuda`` and skip without a card; the
tolerances are those of ``chip_smoke.py``, at the flagship's widths.
"""
import numpy as np
import pytest
import torch

from tps_pp_tpu_torch.models.decoders import NRTRDecoder
from tps_pp_tpu_torch.models.encoders.nrtr import NRTREncoder, sequence_mask
from tps_pp_tpu_torch.ops import tps
from tps_pp_tpu_torch.ops.encoder import encoder_forward, encoder_forward_plain
from tps_pp_tpu_torch.ops.full_decode import full_decode, full_decode_plain
from tps_pp_tpu_torch.ops.grid_sample import (
    GridSampleFunction, grid_sample_forward, grid_sample_grad,
    grid_sample_grad_img, grid_sample_grad_img_plain, grid_sample_grad_plain,
    grid_sample_plain)
from tps_pp_tpu_torch.ops.tps_sampler import tps_sampler, tps_sampler_plain

torch.set_num_threads(2)
BF = torch.bfloat16


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: a kernel has no CPU mode to run in."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to launch the kernels')
    return torch.device('cuda')


def _sampler_args(device, N=4):
    rng = np.random.default_rng(0)
    fid = tps.build_C_cell_centers((2, 16))
    P = tps.build_P_cell_centers(64, 16)
    mats = [tps.build_inv_delta_C(fid), tps.build_P_hat(fid, P), P]
    cp = fid[None] + 0.03 * rng.standard_normal((N, 32, 2))
    score = np.tanh(rng.standard_normal((N, 1024, 32)))
    feat = rng.uniform(-1, 1, (N, 32, 128, 64))
    args = [torch.tensor(a, dtype=torch.float32, device=device)
            for a in [feat, cp, score] + mats]
    args[0] = args[0].to(BF)
    return args


def _encoder_args(device):
    torch.manual_seed(0)
    enc = NRTREncoder().to(device, BF)
    x = torch.randn((4, 64, 512), generator=torch.Generator().manual_seed(0))
    mask = sequence_mask(torch.tensor([1.0, 0.5, 0.3, 0.9]), 64)
    return x.to(device, BF), mask.to(device), enc.folded_weights(BF)


def _decoder_args(device):
    torch.manual_seed(0)
    dec = NRTRDecoder(max_seq_len=40).to(device, BF)
    out_enc = torch.randn((8, 64, 512),
                          generator=torch.Generator().manual_seed(0))
    mask = sequence_mask(torch.tensor([1.0, 0.5, 0.3, 0.9] * 2), 64)
    return (out_enc.to(device, BF), mask.to(device),
            dec.packed_weights(BF))


def _warp_args(device, dtype, N=4, scale=1.0):
    """The training warp at the flagship's shapes: a (N, 32, 128, 64) map,
    a (N, 16, 64) grid over [-1.3, 1.3]^2 (in range, on the clamped border
    and beyond it, with exact pixel centres in the first row), a
    cotangent of ``scale``."""
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (N, 32, 128, 64))
    grid = rng.uniform(-1.3, 1.3, (N, 16, 64, 2))
    grid[:, 0, :, 0] = 2 * rng.integers(1, 127, (N, 64)) / 127 - 1
    grid[:, 0, :, 1] = 2 * rng.integers(1, 31, (N, 64)) / 31 - 1
    cot = scale * rng.uniform(-1, 1, (N, 16, 64, 64))
    return (torch.tensor(img, dtype=dtype, device=device),
            torch.tensor(grid, dtype=torch.float32, device=device),
            torch.tensor(cot, dtype=dtype, device=device))


@pytest.mark.parametrize('op', ['tps_sampler', 'encoder', 'full_decode',
                                'grid_sample_forward', 'grid_sample_grad',
                                'grid_sample_grad_img'])
def test_wrappers_refuse_non_cuda_devices(op):
    """A wrapper runs the plain version for CPU tensors only; on any other
    device it launches its kernel or raises, and never falls back."""
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='CUDA tensors'):
        if op == 'tps_sampler':
            tps_sampler(*_sampler_args(meta, N=1), (16, 64))
        elif op == 'encoder':
            encoder_forward(*_encoder_args(meta), 8)
        elif op == 'full_decode':
            full_decode(*_decoder_args(meta), 8, 91, 91)
        else:
            img, grid, cot = _warp_args(meta, torch.float32, N=1)
            if op == 'grid_sample_forward':
                grid_sample_forward(img, grid)
            elif op == 'grid_sample_grad':
                grid_sample_grad(grid, cot, img)
            else:
                grid_sample_grad_img(grid, cot, 32, 128)


@pytest.mark.requires_cuda
def test_tps_sampler_kernel(cuda_device):
    """One bf16 rounding of each output: 2e-2 absolute (inputs in
    [-1, 1])."""
    args = _sampler_args(cuda_device)
    before = tps_sampler.launches
    got = tps_sampler(*args, (16, 64))
    want = tps_sampler_plain(*args, (16, 64))
    torch.cuda.synchronize()
    assert tps_sampler.launches == before + 1
    assert got.dtype == BF and got.shape == (4, 16, 64, 64)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.requires_cuda
def test_encoder_kernel(cuda_device):
    """Both versions round to bf16 at the same points; an f32 sum in
    another order moves a rounding by one ulp now and then, which drifts
    through six layers: eight bf16 ulps, absolute at magnitude 1 and
    relative above."""
    x, mask, w = _encoder_args(cuda_device)
    before = encoder_forward.launches
    got = encoder_forward(x, mask, w, 8)
    want = encoder_forward_plain(x, mask, w, 8)
    torch.cuda.synchronize()
    assert encoder_forward.launches == before + 1
    d = (got.float() - want.float()).abs()
    assert bool((d <= 6.25e-2 + 3.125e-2 * want.float().abs()).all())


@pytest.mark.requires_cuda
def test_full_decode_kernel(cuda_device):
    """Argmax equal unless the first differing step is a near-tie of the
    plain version (top-2 gap < 1e-3); probabilities before it within the
    JAX bf16 contract (atol 2e-2, rtol 5e-2)."""
    out_enc, mask, w = _decoder_args(cuda_device)
    before = full_decode.launches
    got = full_decode(out_enc, mask, w, 8, 91, 91)
    want = full_decode_plain(out_enc, mask, w, 8, 91, 91)
    torch.cuda.synchronize()
    assert full_decode.launches == before + 1
    ka, pa = got.argmax(-1), want.argmax(-1)
    for r in range(got.shape[0]):
        diff = torch.nonzero(ka[r] != pa[r])
        stop = got.shape[1] if diff.numel() == 0 else int(diff[0, 0])
        if stop < got.shape[1]:
            top2 = torch.topk(want[r, stop], 2).values
            assert float(top2[0] - top2[1]) < 1e-3
        torch.testing.assert_close(got[r, :stop], want[r, :stop],
                                   atol=2e-2, rtol=5e-2)


# the warp's bounds (chip_smoke.py's): bf16 as the sampler and as the JAX
# package's bf16 VJP test (tests/test_grid_sample_vjp.py:180-193); f32 as
# its f32 tests. In f32 both versions round 64-term channel sums, which
# d_grid scales by (W-1)/2 = 63.5: at unit cotangents that rounding reaches
# ~2e-5 absolute, above the f32 atol of 1e-5, so the f32 check runs at a
# cotangent scale of 1e-3 (a training step's are far smaller still).
WARP_BOUNDS = {
    torch.bfloat16: dict(fwd=(2e-2, 0.0), d_img=(5e-2, 5e-2),
                         d_grid=(0.1, 5e-2), cot_scale=1.0),
    torch.float32: dict(fwd=(1e-5, 0.0), d_img=(1e-5, 0.0),
                        d_grid=(1e-5, 1e-4), cot_scale=1e-3),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_grid_sample_kernels(cuda_device, dtype):
    """Kernels 8, 9 and 10 against their plain versions. d_img is a sum of
    f32 atomics in a varying order, so it may differ from the plain
    version's in its last bits; the bounds allow for that."""
    b = WARP_BOUNDS[dtype]
    img, grid, cot = _warp_args(cuda_device, dtype, scale=b['cot_scale'])
    counts = [f.launches for f in (grid_sample_forward, grid_sample_grad,
                                   grid_sample_grad_img)]
    out = grid_sample_forward(img, grid)
    d_img, d_grid = grid_sample_grad(grid, cot, img)
    d_img10 = grid_sample_grad_img(grid, cot, 32, 128)
    want_d_img, want_d_grid = grid_sample_grad_plain(grid, cot, img)
    torch.cuda.synchronize()
    assert [f.launches for f in (grid_sample_forward, grid_sample_grad,
                                 grid_sample_grad_img)] == [
        n + 1 for n in counts]
    assert out.dtype == dtype and d_img.dtype == d_grid.dtype == torch.float32
    atol, rtol = b['fwd']
    torch.testing.assert_close(out.float(),
                               grid_sample_plain(img, grid).float(),
                               atol=atol, rtol=rtol)
    atol, rtol = b['d_img']
    torch.testing.assert_close(d_img, want_d_img, atol=atol, rtol=rtol)
    torch.testing.assert_close(d_img10, grid_sample_grad_img_plain(
        grid, cot, 32, 128), atol=atol, rtol=rtol)
    atol, rtol = b['d_grid']
    torch.testing.assert_close(d_grid, want_d_grid, atol=atol, rtol=rtol)


@pytest.mark.requires_cuda
def test_grid_sample_function_routes(cuda_device):
    """Under autograd the forward is kernel 8 and the backward kernel 9, or
    kernel 10 when the grid needs no gradient; d_img comes back in the
    image's dtype."""
    img, grid, cot = _warp_args(cuda_device, torch.bfloat16)
    img.requires_grad_(True)
    for grid_grad in (True, False):
        g = grid.clone().requires_grad_(grid_grad)
        counts = [f.launches for f in (grid_sample_forward, grid_sample_grad,
                                       grid_sample_grad_img)]
        GridSampleFunction.apply(img, g, False).backward(cot)
        torch.cuda.synchronize()
        got = [f.launches - n for f, n in zip(
            (grid_sample_forward, grid_sample_grad, grid_sample_grad_img),
            counts)]
        assert got == ([1, 1, 0] if grid_grad else [1, 0, 1])
        assert img.grad.dtype == torch.bfloat16
        assert (g.grad is not None) == grid_grad
        img.grad = None
