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

from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.models.decoders import NRTRDecoder
from tps_pp_tpu_torch.models.encoders.nrtr import NRTREncoder, sequence_mask
from tps_pp_tpu_torch.ops import _lib, tps
from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                              cross_ffn_step_plain,
                                              self_attn_step,
                                              self_attn_step_plain)
from tps_pp_tpu_torch.ops.encoder import (encoder_attention,
                                          encoder_attention_plain,
                                          encoder_forward,
                                          encoder_forward_plain)
from tps_pp_tpu_torch.ops.full_decode import (full_decode, full_decode_plain,
                                              graph_bytes)
from tps_pp_tpu_torch.ops.gemm import gemm, gemm_plain
from tps_pp_tpu_torch.ops.grid_sample import (
    GridSampleFunction, grid_sample_forward, grid_sample_grad,
    grid_sample_grad_img, grid_sample_grad_img_plain, grid_sample_grad_plain,
    grid_sample_plain, grid_sample_plan)
from tps_pp_tpu_torch.ops.stem import (basic_block_cp, basic_block_cp_plain,
                                      conv3x3_cp, conv3x3_cp_plain,
                                      fused_stem_forward, stem_plan)
from tps_pp_tpu_torch.ops.tps_sampler import (tps_grid_sample_fused,
                                              tps_sampler, tps_sampler_plain,
                                              tps_sampler_plain_twostage,
                                              warp_twostage)

torch.set_num_threads(2)
BF = torch.bfloat16


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: a kernel has no CPU mode to run in."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to launch the kernels')
    return torch.device('cuda')


def _sampler_args(device, N=4, dtype=BF):
    rng = np.random.default_rng(0)
    fid = tps.build_C_cell_centers((2, 16))
    P = tps.build_P_cell_centers(64, 16)
    mats = [tps.build_inv_delta_C(fid), tps.build_P_hat(fid, P), P]
    cp = fid[None] + 0.03 * rng.standard_normal((N, 32, 2))
    score = np.tanh(rng.standard_normal((N, 1024, 32)))
    feat = rng.uniform(-1, 1, (N, 32, 128, 64))
    args = [torch.tensor(a, dtype=torch.float32, device=device)
            for a in [feat, cp, score] + mats]
    args[0] = args[0].to(dtype)
    return args


def _encoder_args(device, N=4, T=64):
    """The flagship encoder's folded weights and N images of T tokens; N=4
    has valid ratios 1, 0.5, 0.3, 0.9, any other N seeded ones in
    [0.3, 1] with the second image's keys all masked (ratio 0)."""
    torch.manual_seed(0)
    enc = NRTREncoder().to(device, BF)
    x = torch.randn((N, T, 512), generator=torch.Generator().manual_seed(0))
    if N == 4:
        vr = torch.tensor([1.0, 0.5, 0.3, 0.9])
    else:
        vr = torch.from_numpy(np.random.default_rng(N).uniform(
            0.3, 1.0, N).astype(np.float32))
        vr[1:2] = 0.0
    mask = sequence_mask(vr, T)
    return x.to(device, BF), mask.to(device), enc.folded_weights(BF)


# the whole decode's widths: the flagship's (and NRTR's, SATRN-academic's)
# and SATRN-small's, (d_model, d_k, d_inner) with 8 heads
DECODER_WIDTHS = {'dk64': (512, 64, 256), 'dk32': (256, 32, 1024)}


def _decoder_args(device, TE=64, width='dk64'):
    D, DK, DI = DECODER_WIDTHS[width]
    torch.manual_seed(0)
    dec = NRTRDecoder(max_seq_len=40, d_embedding=D, d_model=D, d_k=DK,
                      d_v=DK, d_inner=DI).to(device, BF)
    out_enc = torch.randn((8, TE, D),
                          generator=torch.Generator().manual_seed(0))
    mask = sequence_mask(torch.tensor([1.0, 0.5, 0.3, 0.9] * 2), TE)
    return (out_enc.to(device, BF), mask.to(device),
            dec.packed_weights(BF))


def _step_args(device, N=8, T=41, TE=64, dtype=BF, mask='masked'):
    """The per-step kernels' inputs at the flagship's widths: x, caches
    with random values in every slot and encoder K/V in ``dtype``; one
    layer's step weights of a random decoder. ``mask='masked'``: valid
    ratios from 0 to 1 over the rows, the first row with no valid key and
    the second (for N > 1) with a single one; ``'all_valid'``: ones."""
    g = torch.Generator().manual_seed(0)
    dec = NRTRDecoder(n_layers=1, max_seq_len=T - 1)
    w = {k: v[0].to(device) for k, v in dec.step_weights().items()}

    def r(*shape):
        return torch.randn(shape, generator=g).to(device, dtype)
    if mask == 'all_valid':
        m = torch.ones((N, TE), device=device)
    else:
        vr = torch.linspace(0.0, 1.0, N)
        vr[1:2] = 1.0 / TE
        m = sequence_mask(vr, TE).to(device)
    return (r(N, 512), r(N, 8, T, 64), r(N, 8, T, 64), r(N, 8, TE, 64),
            r(N, 8, TE, 64), m, w)


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


def _block_args(device, cin, cmid, cout, N=2, H=32, W=128, dtype=BF,
                seed=0):
    """A folded BasicBlock's (C, P) input and weights: t (cin, N*H*W) in
    [-1, 1], w1 (cmid, cin), wt (cout, 9*cmid) with variance 1/fan_in,
    biases in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.uniform(-scale, scale, shape),
                            dtype=torch.float32, device=device).to(dt)
    return (r(cin, N * H * W), r(cmid, cin, scale=(3 / cin) ** 0.5),
            r(cmid, 1, scale=0.5, dt=torch.float32),
            r(cout, 9 * cmid, scale=(3 / (9 * cmid)) ** 0.5),
            r(cout, 1, scale=0.5, dt=torch.float32))


@pytest.mark.parametrize('op', ['tps_sampler', 'tps_sampler_twostage',
                                'tps_grid_sample_fused', 'encoder', 'gemm',
                                'encoder_attention',
                                'full_decode', 'full_decode_int8',
                                'self_attn_step', 'cross_ffn_step',
                                'grid_sample_forward', 'grid_sample_grad',
                                'grid_sample_grad_img', 'conv3x3_cp',
                                'basic_block_cp'])
def test_wrappers_refuse_non_cuda_devices(op):
    """A wrapper runs the plain version for CPU tensors only; on any other
    device it launches its kernel or raises, and never falls back."""
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='CUDA tensors'):
        if op == 'tps_sampler':
            tps_sampler(*_sampler_args(meta, N=1), (16, 64))
        elif op == 'tps_sampler_twostage':
            tps_sampler(*_sampler_args(meta, N=1), (16, 64),
                        variant='twostage')
        elif op == 'tps_grid_sample_fused':
            feat, *rest = _sampler_args(meta, N=1)
            tps_grid_sample_fused(feat, feat[:, ::2, ::2], *rest, (16, 64))
        elif op == 'conv3x3_cp':
            t, _, _, wt, b2 = _block_args(meta, 32, 32, 32, N=1)
            conv3x3_cp(t, wt, b2, H=32, W=128)
        elif op == 'basic_block_cp':
            basic_block_cp(*_block_args(meta, 32, 32, 32, N=1), H=32, W=128)
        elif op == 'encoder':
            encoder_forward(*_encoder_args(meta), 8)
        elif op == 'gemm':
            gemm(torch.zeros((64, 64), dtype=BF, device=meta),
                 torch.zeros((64, 128), dtype=BF, device=meta))
        elif op == 'encoder_attention':
            encoder_attention(torch.zeros((64, 3 * 512), dtype=BF,
                                          device=meta),
                              torch.ones((1, 64), device=meta), 8)
        elif op.startswith('full_decode'):
            full_decode(*_decoder_args(meta), 8, 91, 91,
                        enc_dtype='int8' if op.endswith('int8')
                        else 'bfloat16')
        elif op == 'self_attn_step':
            x, ck, cv, _, _, _, w = _step_args(meta)
            self_attn_step(x, ck, cv, 0, w['wqkv'], w['wfc1'], w['ln1_s'],
                           w['ln1_b'])
        elif op == 'cross_ffn_step':
            x, _, _, ek, ev, mask, w = _step_args(meta)
            cross_ffn_step(x, ek, ev, mask, *(w[k] for k in _CROSS_W))
        else:
            img, grid, cot = _warp_args(meta, torch.float32, N=1)
            if op == 'grid_sample_forward':
                grid_sample_forward(img, grid)
            elif op == 'grid_sample_grad':
                grid_sample_grad(grid, cot, img)
            else:
                grid_sample_grad_img(grid, cot, 32, 128)


def test_check_reports_the_kernels_limits():
    """An entry point refuses arguments outside its limits with
    cudaErrorInvalidValue, which the wrappers raise as a ValueError; any
    other error is a RuntimeError."""
    _lib.check(0, 'op')
    with pytest.raises(ValueError, match="op: arguments outside the kernel"):
        _lib.check(1, 'op')
    with pytest.raises(RuntimeError, match='CUDA error 700'):
        _lib.check(700, 'op')


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
def test_tps_sampler_kernel_f32(cuda_device):
    """The kernel on a float32 map (an f32 model's rectifier), output in
    float32. The f32 grid is ill-conditioned (35-term sums over
    inv_delta_C's entries near 56 cancel), so both versions carry its
    rounding, in sums of another order: each is held against the same
    function with the grid in float64, and the kernel may be off by at most
    twice what the plain version is (the two versions part by up to ~1e-3
    on an H100)."""
    args = _sampler_args(cuda_device, dtype=torch.float32)
    before = tps_sampler.launches
    got = tps_sampler(*args, (16, 64))
    want = tps_sampler_plain(*args, (16, 64))
    feat, cp, score, inv, P_hat, P = (a.double() for a in args)
    exact = grid_sample_plain(feat, tps.build_P_prime(
        cp, score, inv, P_hat, P).reshape(-1, 16, 64, 2)).float()
    torch.cuda.synchronize()
    assert tps_sampler.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (4, 16, 64, 64)
    plain_err = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= 2 * plain_err


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [BF, torch.float32])
def test_tps_sampler_twostage_kernel(cuda_device, dtype):
    """Kernel 2. bf16: one rounding of the output, and of an x-weight,
    apart: 2e-2 absolute (inputs in [-1, 1]). float32: held, as kernel 1,
    against the same function with the grid in float64; the kernel may be
    off by at most twice what the plain version is."""
    args = _sampler_args(cuda_device, dtype=dtype)
    before = (tps_sampler.launches, tps_sampler.launches_twostage)
    got = tps_sampler(*args, (16, 64), variant='twostage')
    want = tps_sampler_plain_twostage(*args, (16, 64))
    torch.cuda.synchronize()
    assert (tps_sampler.launches, tps_sampler.launches_twostage) == (
        before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == (4, 16, 64, 64)
    if dtype == BF:
        assert float((got.float() - want.float()).abs().max()) <= 2e-2
        return
    feat, cp, score, inv, P_hat, P = (a.double() for a in args)
    exact = warp_twostage(feat, tps.build_P_prime(
        cp, score, inv, P_hat, P)).reshape(got.shape).float()
    plain_err = float((want - exact).abs().max())
    assert float((got - exact).abs().max()) <= 2 * plain_err


@pytest.mark.requires_cuda
@pytest.mark.parametrize('variant', ['dense', 'twostage'])
@pytest.mark.parametrize('Hg,Hi', [(32, 16), (31, 15)])
def test_tps_grid_sample_fused_kernel(cuda_device, variant, Hg, Hi):
    """Both maps from one launch (``with_mp``), odd heights included, each
    against its plain version within 2e-2 (bf16); the rectified map equal
    to the one of a launch without the second map."""
    feat, *rest = _sampler_args(cuda_device)
    feat = feat[:, :Hg].contiguous()
    img = feat[:, ::2, ::2][:, :Hi].contiguous()
    before = (tps_sampler.launches, tps_sampler.launches_twostage)
    rect, mp = tps_grid_sample_fused(feat, img, *rest, (16, 64),
                                     variant=variant)
    alone = tps_sampler(feat, *rest, (16, 64), variant=variant)
    torch.cuda.synchronize()
    two = variant == 'twostage'
    assert (tps_sampler.launches, tps_sampler.launches_twostage) == (
        before[0] + 2 * (not two), before[1] + 2 * two)
    plain = tps_sampler_plain_twostage if two else tps_sampler_plain
    for got, m in ((rect, feat), (mp, img)):
        assert got.shape == (4, 16, 64, 64) and got.dtype == BF
        want = plain(m, *rest, (16, 64))
        assert float((got.float() - want.float()).abs().max()) <= 2e-2
    assert torch.equal(rect, alone)


# kernels 11-12 against their plain versions: bf16 outputs of O(1) values,
# both versions rounding y and the output at the same points; an f32 sum in
# another order moves a rounding by one ulp now and then: two bf16 ulps,
# relative, and 2e-2 absolute near 0. float32: sums of up to 9 * 64 terms
# in another order
STEM_BOUNDS = {BF: (2e-2, 2 ** -7), torch.float32: (1e-4, 1e-4)}
# the three BasicBlock shapes of the flagship's stem: layer1, layer2's
# block0 at full resolution (its stride-2 main path), layer2's blocks 1-3
STEM_SHAPES = {'layer1': (32, 32, 32, 32, 128, True),
               'layer2_block0': (32, 64, 64, 32, 128, False),
               'layer2_blocks': (64, 64, 64, 16, 64, True)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [BF, torch.float32])
@pytest.mark.parametrize('relu', [False, True])
def test_conv3x3_cp_kernel(cuda_device, dtype, relu):
    """Kernel 11 at the stem's width; an odd image height (31) too."""
    atol, rtol = STEM_BOUNDS[dtype]
    for H in (32, 31):
        t, _, _, wt, b2 = _block_args(cuda_device, 32, 32, 32, H=H,
                                      dtype=dtype)
        before = conv3x3_cp.launches
        got = conv3x3_cp(t, wt, b2, H=H, W=128, relu=relu)
        want = conv3x3_cp_plain(t, wt, b2, H=H, W=128, relu=relu)
        torch.cuda.synchronize()
        assert conv3x3_cp.launches == before + 1 and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('W,H,N', [(16, 32, 3), (32, 31, 5), (128, 31, 7),
                                   (128, 32, 300)])
def test_conv3x3_cp_band_walk(cuda_device, W, H, N):
    """Kernel 11 in bf16 at W = 16, 32 and 128: groups of 256 / W rows, and
    blocks whose walks cross image boundaries (more images than blocks,
    odd heights with a short last band), against the plain version."""
    atol, rtol = STEM_BOUNDS[BF]
    t, _, _, wt, b2 = _block_args(cuda_device, 32, 32, 32, N=N, H=H, W=W)
    before = conv3x3_cp.launches
    got = conv3x3_cp(t, wt, b2, H=H, W=W, relu=True)
    want = conv3x3_cp_plain(t, wt, b2, H=H, W=W, relu=True)
    torch.cuda.synchronize()
    assert conv3x3_cp.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [BF, torch.float32])
@pytest.mark.parametrize('shape', list(STEM_SHAPES))
def test_basic_block_cp_kernel(cuda_device, dtype, shape):
    """Kernel 12 at the three shapes of the stem."""
    cin, cmid, cout, H, W, residual = STEM_SHAPES[shape]
    args = _block_args(cuda_device, cin, cmid, cout, H=H, W=W, dtype=dtype)
    before = basic_block_cp.launches
    got = basic_block_cp(*args, H=H, W=W, residual=residual)
    want = basic_block_cp_plain(*args, H=H, W=W, residual=residual)
    torch.cuda.synchronize()
    assert basic_block_cp.launches == before + 1 and got.dtype == dtype
    assert got.shape == (cout, 2 * H * W)
    atol, rtol = STEM_BOUNDS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('W,H,N,cin,cmid,cout,residual', [
    (16, 31, 3, 32, 32, 32, True), (32, 31, 5, 32, 64, 64, False),
    (64, 15, 300, 64, 64, 64, True), (128, 31, 300, 32, 64, 64, False),
    (128, 33, 7, 32, 64, 32, True), (64, 17, 9, 16, 48, 16, True)])
def test_basic_block_cp_band_walk(cuda_device, W, H, N, cin, cmid, cout,
                                  residual):
    """Kernel 12 in bf16 at W = 16 to 128: groups of 256 / W rows, walks
    that cross image boundaries (more groups than blocks, odd heights with a
    short last band), C_mid != C_in with and without the residual, and a
    48-wide C_mid (a 16-wide last chunk of the first stage), against the
    plain version."""
    atol, rtol = STEM_BOUNDS[BF]
    args = _block_args(cuda_device, cin, cmid, cout, N=N, H=H, W=W)
    before = basic_block_cp.launches
    got = basic_block_cp(*args, H=H, W=W, residual=residual)
    want = basic_block_cp_plain(*args, H=H, W=W, residual=residual)
    torch.cuda.synchronize()
    assert basic_block_cp.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('shape', list(STEM_SHAPES))
def test_basic_block_cp_zero_halo(cuda_device, shape):
    """b1 = +0.5 everywhere, so relu(b1) = 0.5 where y is SAME padding: a
    window row or column outside the image that took relu(b1) instead of
    zero would move the first and last rows and columns of the output by
    far more than the bound (checked on the weights); odd heights."""
    cin, cmid, cout, H, W, residual = STEM_SHAPES[shape]
    atol, rtol = STEM_BOUNDS[BF]
    t, w1, b1, wt, b2 = _block_args(cuda_device, cin, cmid, cout, N=3,
                                    H=H - 1, W=W)
    b1 = torch.full_like(b1, 0.5)
    got = basic_block_cp(t, w1, b1, wt, b2, H=H - 1, W=W, residual=residual)
    want = basic_block_cp_plain(t, w1, b1, wt, b2, H=H - 1, W=W,
                                residual=residual)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    # what one halo row of 0.5 would add to an output row
    halo = (0.5 * wt.float().reshape(cout, 3, 3, cmid)[:, 0].sum((1, 2)))
    assert float(halo.abs().max()) > 10 * atol


@pytest.mark.requires_cuda
def test_stem_plans(cuda_device):
    """The bf16 plans at the stem's shapes over a batch of 512: groups of
    at most 256 pixels, a ring of at least a fresh group's R + 2 rows, no
    more blocks than groups or than two an SM, within the shared memory;
    kernel 11's plan at layer1's shape as kernel 12's; and a shape that no
    plan fits raises, nothing launched."""
    props = torch.cuda.get_device_properties(cuda_device)
    for shape, (cin, cmid, cout, H, W, _) in STEM_SHAPES.items():
        plan = stem_plan(cin, cmid, cout, 512, H, W)
        R, NR = plan['R'], plan['NR']
        assert R * W <= 256 and NR >= R + 2, (shape, plan)
        assert plan['blocks'] <= min(512 * -(-H // R),
                                     2 * props.multi_processor_count)
        assert plan['smem'] <= 227 * 1024
    conv = stem_plan(32, 32, 32, 512, 32, 128, block=False)
    assert (conv['R'], conv['NR']) == tuple(
        stem_plan(32, 32, 32, 512, 32, 128)[k] for k in ('R', 'NR'))
    before = basic_block_cp.launches
    with pytest.raises(ValueError, match='outside the kernel'):
        stem_plan(64, 64, 64, 1, 2, 4096)
    with pytest.raises(ValueError, match='outside the kernel'):
        basic_block_cp(*_block_args(cuda_device, 64, 64, 64, N=1, H=2,
                                    W=4096), H=2, W=4096)
    assert basic_block_cp.launches == before


@pytest.mark.requires_cuda
def test_stem_kernels_refuse_their_limits(cuda_device):
    """Channels not a multiple of 16, or a residual across widths, are
    outside the kernels' limits: a ValueError, nothing launched."""
    before = (conv3x3_cp.launches, basic_block_cp.launches)
    t, w1, b1, wt, b2 = _block_args(cuda_device, 24, 24, 24)
    with pytest.raises(ValueError, match='outside the kernel'):
        conv3x3_cp(t, wt, b2, H=32, W=128)
    with pytest.raises(ValueError, match='outside the kernel'):
        basic_block_cp(*_block_args(cuda_device, 32, 64, 64), H=32, W=128,
                       residual=True)
    assert (conv3x3_cp.launches, basic_block_cp.launches) == before


@pytest.mark.requires_cuda
def test_predict_fused_stem(cuda_device):
    """The full-width flagship serves a batch of 4 in bf16 with
    ``stem_mode='fused'``: seven block launches per ``predict`` (layer1's
    three, layer2's four), argmax against the plain path under the decode
    rule; and a float32 model's fused stem within the float32 bounds of
    its plain version."""
    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='fused40_bf16')
    rec = build_recognizer(dict(cfg, stem_mode='fused')).init_weights(0)
    assert rec.resolved_stem_mode() == 'fused'
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 128, 3)).astype(np.float32))
    before = basic_block_cp.launches
    got = rec.predict(img)
    torch.cuda.synchronize()
    assert basic_block_cp.launches == before + 7
    rec.plain = True
    _assert_decode_rule(got, rec.predict(img))
    bb = rec.model.backbone.float()
    with torch.inference_mode():
        x, skips = fused_stem_forward(bb, img.cuda(), torch.float32)
        xp, skips_p = fused_stem_forward(bb, img.cuda(), torch.float32,
                                         plain=True)
    for a, b in zip([x] + skips, [xp] + skips_p):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# the GEMM's products of the main path, (N, K) at the flagship's widths:
# the encoder's QKV, fc, W1, W2 and the whole decode's encoder K/V
# projection, each with the epilogue its caller gives it
_GEMM_CASES = {
    'qkv': (1536, 512, dict(bias=True)),
    'fc': (512, 512, dict(residual=True, out_dtype=torch.float32, ln=True)),
    'w1': (256, 512, dict(bias=True, gelu=True)),
    'w2': (512, 256, dict(bias=True, residual=True,
                          out_dtype=torch.float32, ln=True)),
    'w2_final': (512, 256, dict(bias=True, residual=True,
                                out_dtype=torch.float32, ln=True,
                                affine=True)),
    'kv_projection': (6144, 512, dict()),
    'f32_residual': (768, 256, dict(bias=True, residual=True,
                                    out_dtype=torch.float32)),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize('M', [64, 192, 4096])
@pytest.mark.parametrize('case', sorted(_GEMM_CASES))
def test_gemm_kernel(cuda_device, case, M):
    """The tensor-core GEMM against the plain product on the same bf16
    operands, at the main path's (N, K) and each epilogue; M = 64 and 192
    leave the last 128-row tile half empty. f32 outputs differ by the sum's
    order (1e-4 at magnitude 1); bf16 ones by one rounding (two ulps)."""
    N, K, opt = _GEMM_CASES[case]
    g = torch.Generator().manual_seed(M + N + K)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(cuda_device)

    a = r(M, K).to(BF)
    b = r(K, N, scale=K ** -0.5).to(BF)
    kw = dict(out_dtype=opt.get('out_dtype', BF), gelu=opt.get('gelu', False),
              ln=opt.get('ln', False))
    if opt.get('bias'):
        kw['bias'] = r(N, scale=0.5)
    if opt.get('residual'):
        kw['residual'] = r(M, N)
    if opt.get('affine'):
        kw['ln_s'], kw['ln_b'] = r(N, scale=0.5) + 1.0, r(N, scale=0.2)
    before = gemm.launches
    got = gemm(a, b, **kw)
    want = gemm_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1
    if not kw['ln']:
        got, want = (got,), (want,)
    for gt, wt in zip(got, want):
        if gt.dtype == torch.float32:
            torch.testing.assert_close(gt, wt, atol=1e-4, rtol=1e-4)
        else:
            torch.testing.assert_close(gt.float(), wt.float(), atol=2e-2,
                                       rtol=2 ** -7)


@pytest.mark.requires_cuda
def test_gemm_kernel_refuses_its_limits(cuda_device):
    a = torch.zeros((64, 64), dtype=BF, device=cuda_device)
    with pytest.raises(ValueError, match='outside the kernel'):
        gemm(a, torch.zeros((64, 384), dtype=BF, device=cuda_device))
    with pytest.raises(ValueError, match='outside the kernel'):
        gemm(a, torch.zeros((64, 256), dtype=BF, device=cuda_device),
             out_dtype=torch.float32, ln=True)
    with pytest.raises(ValueError, match='outside the kernel'):
        gemm(torch.zeros((64, 32), dtype=BF, device=cuda_device),
             torch.zeros((32, 128), dtype=BF, device=cuda_device))


@pytest.mark.requires_cuda
@pytest.mark.parametrize('N', [1, 3, 64])
def test_encoder_attention_kernel(cuda_device, N):
    """The attention kernel against its plain version at the flagship's
    width, with masks that include an image with every key masked (uniform
    weights over its own keys). Both round p and the output to bf16 at the
    same points: two ulps, 2e-2 absolute near 0."""
    g = torch.Generator().manual_seed(N)
    qkv = torch.randn((N * 64, 3 * 512), generator=g).to(cuda_device, BF)
    vr = torch.rand((N,), generator=g) * 0.7 + 0.3
    vr[N // 2] = 0.0
    mask = sequence_mask(vr, 64).to(cuda_device)
    assert not bool(mask[N // 2].any())
    before = encoder_attention.launches
    got = encoder_attention(qkv, mask, 8)
    want = encoder_attention_plain(qkv, mask, 8)
    torch.cuda.synchronize()
    assert encoder_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T', [1, 8, 40, 64, 100, 320, 512])
def test_encoder_attention_kernel_any_tokens(cuda_device, T):
    """The attention at the token counts of the NRTR configs (8-40 on the
    1by16 trunk and the modality transform, 64-320 on the 1by8 trunk) and
    at its bounds, against the plain version, as above; the fully masked
    image spreads its weights over its own T keys only."""
    N = 3
    g = torch.Generator().manual_seed(T)
    qkv = torch.randn((N * T, 3 * 512), generator=g).to(cuda_device, BF)
    mask = sequence_mask(torch.tensor([0.7, 0.0, 1.0]), T).to(cuda_device)
    got = encoder_attention(qkv, mask, 8)
    want = encoder_attention_plain(qkv, mask, 8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)
    v = qkv[T:2 * T, 1024:].float()
    torch.testing.assert_close(got[T:2 * T].float(),
                               v.mean(0, keepdim=True).expand(T, 512),
                               atol=2e-2, rtol=2 ** -7)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T', [8, 40, 64, 100, 320])
def test_encoder_kernel_any_tokens(cuda_device, T):
    """Kernel 3 at the NRTR configs' token counts (and 100, which is no
    multiple of 16), with the bounds of the flagship's test below."""
    x, mask, w = _encoder_args(cuda_device, 7, T)
    before = encoder_forward.launches
    got = encoder_forward(x, mask, w, 8)
    want = encoder_forward_plain(x, mask, w, 8)
    torch.cuda.synchronize()
    assert encoder_forward.launches == before + 1
    d = (got.float() - want.float()).abs()
    assert bool((d <= 6.25e-2 + 3.125e-2 * want.float().abs()).all())


@pytest.mark.requires_cuda
def test_encoder_kernel_refuses_its_limits(cuda_device):
    x, mask, w = _encoder_args(cuda_device, 1, 513)
    with pytest.raises(ValueError, match='1-512 tokens'):
        encoder_forward(x, mask, w, 8)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('N', [1, 3, 4, 64, 512])
def test_encoder_kernel(cuda_device, N):
    """Both versions round to bf16 at the same points; an f32 sum in
    another order moves a rounding by one ulp now and then, which drifts
    through six layers: eight bf16 ulps, absolute at magnitude 1 and
    relative above."""
    x, mask, w = _encoder_args(cuda_device, N)
    before = encoder_forward.launches
    got = encoder_forward(x, mask, w, 8)
    want = encoder_forward_plain(x, mask, w, 8)
    torch.cuda.synchronize()
    assert encoder_forward.launches == before + 1
    d = (got.float() - want.float()).abs()
    assert bool((d <= 6.25e-2 + 3.125e-2 * want.float().abs()).all())


_CROSS_W = ('wq2', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1', 'w2', 'b2', 'ln3_s',
            'ln3_b')


def test_build_recognizer_defaults_to_cuda(monkeypatch):
    """With no ``device``, the recognizer is built on the card, and without
    one it raises: no fall back to the CPU."""
    cfg = nrtr_tps_pp_cfg(tiny=True)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_recognizer(cfg)
    assert build_recognizer(cfg, device='cpu').device.type == 'cpu'


@pytest.mark.requires_cuda
def test_build_recognizer_on_the_card(cuda_device):
    rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True))
    assert rec.device.type == 'cuda'
    assert next(rec.model.parameters()).is_cuda


def _assert_decode_rule(got, want, atol=2e-2, rtol=5e-2, near_tie=1e-3):
    """Argmax equal unless the first differing step is a near-tie of the
    plain version (top-2 gap < ``near_tie``); probabilities before it
    within (atol, rtol), by default the JAX bf16 contract."""
    ka, pa = got.argmax(-1), want.argmax(-1)
    for r in range(got.shape[0]):
        diff = torch.nonzero(ka[r] != pa[r])
        stop = got.shape[1] if diff.numel() == 0 else int(diff[0, 0])
        if stop < got.shape[1]:
            top2 = torch.topk(want[r, stop], 2).values
            assert float(top2[0] - top2[1]) < near_tie
        torch.testing.assert_close(got[r, :stop], want[r, :stop],
                                   atol=atol, rtol=rtol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('enc_dtype', ['bfloat16', 'int8'])
def test_full_decode_kernel(cuda_device, enc_dtype):
    """Kernels 4 (bf16 encoder K/V) and 5 (int8), under the decode
    rule."""
    out_enc, mask, w = _decoder_args(cuda_device)
    before = (full_decode.launches, full_decode.launches_int8)
    got = full_decode(out_enc, mask, w, 8, 91, 91, enc_dtype)
    want = full_decode_plain(out_enc, mask, w, 8, 91, 91, enc_dtype)
    torch.cuda.synchronize()
    q8 = enc_dtype == 'int8'
    assert (full_decode.launches, full_decode.launches_int8) == (
        before[0] + (not q8), before[1] + q8)
    _assert_decode_rule(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('enc_dtype', ['bfloat16', 'int8'])
@pytest.mark.parametrize('width,TE', [('dk32', 200), ('dk64', 320),
                                      ('dk32', 320), ('dk64', 512)])
def test_full_decode_kernel_wider(cuda_device, enc_dtype, width, TE):
    """Kernels 4 and 5 at SATRN-small's head width (d_k 32, over its 200
    source tokens) and over more than 256 source tokens (NRTR on the 1by8
    trunk: 320), under the decode rule; int8 with one scale per (layer, K
    or V, head) at either width."""
    out_enc, mask, w = _decoder_args(cuda_device, TE, width)
    got = full_decode(out_enc, mask, w, 8, 91, 91, enc_dtype)
    want = full_decode_plain(out_enc, mask, w, 8, 91, 91, enc_dtype)
    torch.cuda.synchronize()
    assert full_decode.last_steps == 40
    _assert_decode_rule(got, want)


@pytest.mark.requires_cuda
def test_full_decode_kernel_refuses_its_limits(cuda_device):
    out_enc, mask, w = _decoder_args(cuda_device, 513)
    with pytest.raises(ValueError, match='512 source tokens'):
        full_decode(out_enc, mask, w, 8, 91, 91)


def _decode_inputs(device, N, seed=0):
    g = np.random.default_rng(seed)
    out_enc = torch.tensor(g.standard_normal((N, 64, 512)),
                           dtype=torch.float32).to(device, BF)
    vr = torch.tensor(g.uniform(0.3, 1.0, N), dtype=torch.float32)
    return out_enc, sequence_mask(vr, 64).to(device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('enc_dtype', ['bfloat16', 'int8'])
@pytest.mark.parametrize('N', [1, 3, 64, 512])
def test_full_decode_graph_buckets(cuda_device, N, enc_dtype):
    """The captured decode at the serving buckets' widths: the first call
    captures, a replay gives the same bits (the split-K sums are taken in
    a fixed order), both under the decode rule against the plain version,
    and all 40 steps run without an exit."""
    _, _, w = _decoder_args(cuda_device)
    out_enc, mask = _decode_inputs(cuda_device, N)
    args = (out_enc, mask, w, 8, 1, None, enc_dtype)
    captures = full_decode.captures
    got = full_decode(*args)
    again = full_decode(*args)
    torch.cuda.synchronize()
    assert full_decode.captures == captures + 1
    assert full_decode.last_steps == 40
    assert torch.equal(got, again)
    _assert_decode_rule(got, full_decode_plain(*args))


@pytest.mark.requires_cuda
@pytest.mark.parametrize('enc_dtype', ['bfloat16', 'int8'])
def test_full_decode_graph_early_exit(cuda_device, enc_dtype):
    """A classifier bias that makes EOS win: the exit is taken on the
    device, after as many steps as the plain version runs, and the steps
    after it read back as zeros."""
    _, _, w = _decoder_args(cuda_device)
    w = dict(w, bcls=w['bcls'].clone())
    w['bcls'][91] += 100.0
    out_enc, mask = _decode_inputs(cuda_device, 64)
    args = (out_enc, mask, w, 8, 1, 91, enc_dtype)
    got = full_decode(*args)
    steps = full_decode.last_steps
    want = full_decode_plain(*args)
    ran = int((want.abs().sum((0, 2)) > 0).sum())
    assert steps == ran == 1
    assert bool((got[:, steps:] == 0).all())
    _assert_decode_rule(got, want)


@pytest.mark.requires_cuda
def test_full_decode_graph_follows_weight_changes(cuda_device):
    """A graph reads every weight through its pointer: an in-place update
    is served by the next replay with no new capture; another tensor in a
    weight's place is captured again, in place of the old graph. Both
    against the plain version on the new weights."""
    _, _, w = _decoder_args(cuda_device)
    out_enc, mask = _decode_inputs(cuda_device, 8)
    args = (out_enc, mask, w, 8, 1, None)
    before = full_decode(*args)
    captures = full_decode.captures
    with torch.no_grad():
        w['wcls'].add_(0.3 * w['wcls'].float().std().to(w['wcls'].dtype) *
                       torch.randn_like(w['wcls']))
    got = full_decode(*args)
    torch.cuda.synchronize()
    assert full_decode.captures == captures
    assert not torch.equal(got, before)
    _assert_decode_rule(got, full_decode_plain(*args))
    w2 = dict(w, wfc2=w['wfc2'] + 0.3 * w['wfc2'].float().std().to(BF) *
              torch.randn_like(w['wfc2']))
    args2 = (out_enc, mask, w2, 8, 1, None)
    got2 = full_decode(*args2)
    torch.cuda.synchronize()
    assert full_decode.captures == captures + 1
    assert len(graph_bytes(w2)) == 1
    _assert_decode_rule(got2, full_decode_plain(*args2))


# kernels 6 and 7 against their plain versions: outputs of O(1) values,
# one bf16 rounding apart where f32 sums in another order cross a rounding
# boundary, of the output or (float32 activations) of a matmul operand:
# two bf16 ulps, relative, and 2e-2 absolute near 0
STEP_ATOL, STEP_RTOL = 2e-2, 2 ** -7


# N: one row, a ragged band of 16 rows, B_SMALL, full bands, a ragged
# multiple of 16 and the serving batch
STEP_NS = [1, 5, 8, 64, 100, 512]


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [BF, torch.float32])
@pytest.mark.parametrize('t', [0, 1, 20, 39])
@pytest.mark.parametrize('N', STEP_NS)
def test_self_attn_step_kernel(cuda_device, N, t, dtype):
    """Kernel 6: x_out and slot t of the caches within the bounds; every
    other slot bit-equal to before."""
    x, ck, cv, _, _, _, w = _step_args(cuda_device, N=N, dtype=dtype)
    args = (w['wqkv'], w['wfc1'], w['ln1_s'], w['ln1_b'])
    ck0, cv0 = ck.clone(), cv.clone()
    ck_p, cv_p = ck.clone(), cv.clone()
    before = self_attn_step.launches
    got, ck_k, cv_k = self_attn_step(x, ck, cv, t, *args)
    want, _, _ = self_attn_step_plain(x, ck_p, cv_p, t, *args)
    torch.cuda.synchronize()
    assert self_attn_step.launches == before + 1 and ck_k is ck
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=STEP_ATOL,
                               rtol=STEP_RTOL)
    for k, p, k0 in ((ck, ck_p, ck0), (cv, cv_p, cv0)):
        torch.testing.assert_close(k[:, :, t].float(), p[:, :, t].float(),
                                   atol=STEP_ATOL, rtol=STEP_RTOL)
        keep = torch.arange(k.shape[2], device=k.device) != t
        assert torch.equal(k[:, :, keep], k0[:, :, keep])
        assert torch.equal(p[:, :, keep], k0[:, :, keep])


@pytest.mark.requires_cuda
@pytest.mark.parametrize('mask', ['masked', 'all_valid'])
@pytest.mark.parametrize('dtype', [BF, torch.float32])
@pytest.mark.parametrize('N', STEP_NS)
def test_cross_ffn_step_kernel(cuda_device, N, dtype, mask):
    """Kernel 7, with masked keys (a row with none valid, a row with one)
    or all keys valid; the encoder K/V untouched."""
    x, _, _, ek, ev, m, w = _step_args(cuda_device, N=N, dtype=dtype,
                                       mask=mask)
    ek0, ev0 = ek.clone(), ev.clone()
    args = (x, ek, ev, m) + tuple(w[k] for k in _CROSS_W)
    before = cross_ffn_step.launches
    got = cross_ffn_step(*args)
    want = cross_ffn_step_plain(*args)
    torch.cuda.synchronize()
    assert cross_ffn_step.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=STEP_ATOL,
                               rtol=STEP_RTOL)
    assert torch.equal(ek, ek0) and torch.equal(ev, ev0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('skip', ['set', 'unset'])
@pytest.mark.parametrize('dtype', [BF, torch.float32])
@pytest.mark.parametrize('t', [0, 1, 20, 39])
@pytest.mark.parametrize('N', STEP_NS)
def test_step_kernels_skip_flag(cuda_device, N, t, dtype, skip):
    """Kernels 6 and 7 with the device exit's ``skip`` flag: set, both
    give x and leave the caches as they were, bit-equal to their plain
    versions; unset, within the bounds above, the caches as in
    ``test_self_attn_step_kernel``."""
    x, ck, cv, ek, ev, m, w = _step_args(cuda_device, N=N, dtype=dtype,
                                         mask='masked')
    flag = torch.tensor(skip == 'set', device=cuda_device)
    sa = (w['wqkv'], w['wfc1'], w['ln1_s'], w['ln1_b'], flag)
    cf = (x, ek, ev, m) + tuple(w[k] for k in _CROSS_W) + (flag,)
    ck0, cv0 = ck.clone(), cv.clone()
    ck_p, cv_p = ck.clone(), cv.clone()
    before = (self_attn_step.launches, cross_ffn_step.launches)
    got, _, _ = self_attn_step(x, ck, cv, t, *sa)
    want, _, _ = self_attn_step_plain(x, ck_p, cv_p, t, *sa)
    got7 = cross_ffn_step(*cf)
    want7 = cross_ffn_step_plain(*cf)
    torch.cuda.synchronize()
    assert (self_attn_step.launches, cross_ffn_step.launches) == (
        before[0] + 1, before[1] + 1)
    if skip == 'set':
        for a in (got, want, got7, want7):
            assert torch.equal(a, x)
        for c in (ck, cv, ck_p, cv_p):
            assert torch.equal(c, ck0 if c is ck or c is ck_p else cv0)
        return
    for g, p in ((got, want), (got7, want7)):
        torch.testing.assert_close(g.float(), p.float(), atol=STEP_ATOL,
                                   rtol=STEP_RTOL)
    for k, p, k0 in ((ck, ck_p, ck0), (cv, cv_p, cv0)):
        torch.testing.assert_close(k[:, :, t].float(), p[:, :, t].float(),
                                   atol=STEP_ATOL, rtol=STEP_RTOL)
        keep = torch.arange(k.shape[2], device=k.device) != t
        assert torch.equal(k[:, :, keep], k0[:, :, keep])


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [BF, torch.float32])
@pytest.mark.parametrize('TE', [257, 320, 512])
def test_cross_ffn_step_kernel_more_source_tokens(cuda_device, TE, dtype):
    """Kernel 7 over more than 256 encoder keys (its attention is the
    whole decode's, widened to 512), as above."""
    x, _, _, ek, ev, m, w = _step_args(cuda_device, N=64, TE=TE,
                                       dtype=dtype)
    args = (x, ek, ev, m) + tuple(w[k] for k in _CROSS_W)
    got = cross_ffn_step(*args)
    want = cross_ffn_step_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=STEP_ATOL,
                               rtol=STEP_RTOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('fused_step', [False, True])
def test_predict_float32_steps(cuda_device, fused_step):
    """A float32 model serves through ``steps`` on the card: the sampler
    kernel (and, with ``use_fused_step``, kernels 6 and 7) in float32,
    against the recognizer's plain path. The tiny flagship, its decoder at
    d_k = 64 with one head where the fused step needs it. Both under the
    decode rule; the module decode differs from its plain path only by the
    f32 sampler (1e-3 on its output, see above), so its probabilities are
    held within 1e-3."""
    cfg = nrtr_tps_pp_cfg(tiny=True, decode_mode='steps')
    if fused_step:
        cfg['decoder'] = dict(cfg['decoder'], n_head=1, d_k=64, d_v=64,
                              use_fused_step=True)
    rec = build_recognizer(cfg).init_weights(0)
    assert rec.dtype == torch.float32 and rec.resolved_decode_mode() == 'steps'
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 32, 64, 3)).astype(np.float32))
    vr = [1.0, 0.5, 0.8, 0.3, 0.95, 0.6]
    counts = (tps_sampler.launches, self_attn_step.launches,
              cross_ffn_step.launches)
    got = rec.predict(img, vr)
    torch.cuda.synchronize()
    launched = [f.launches - n for f, n in zip(
        (tps_sampler, self_attn_step, cross_ffn_step), counts)]
    assert launched[0] == 1 and (min(launched[1:]) > 0) == fused_step
    rec.plain = True
    want = rec.predict(img, vr)
    assert bool(torch.isfinite(got).all())
    if fused_step:
        _assert_decode_rule(got, want)
    else:
        _assert_decode_rule(got, want, atol=1e-3, rtol=0.0)


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
    """Kernels 8, 9 and 10 against their plain versions. d_img is summed by
    shared-memory f32 atomics in a varying order, so it may differ from the
    plain version's in its last bits; the bounds allow for that."""
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


# ---- kernels 9 and 10: the band plan and the grids that stress it ------

def _pixel_grid(px, py, H, W):
    """(N, Ho, Wo, 2) float32 grid in the [-1, 1] convention from pixel
    coordinates (align_corners=True: pixel 0 at -1, pixel W-1 at 1)."""
    return np.stack([2 * np.asarray(px) / (W - 1) - 1,
                     2 * np.asarray(py) / (H - 1) - 1], -1)


def _check_warp_grads(device, dtype, grid, H=32, W=128, C=64, seed=2):
    """Kernels 9 and 10 against their plain versions on ``grid`` (numpy,
    (N, Ho, Wo, 2)) with a random map and cotangent; returns the kernels'
    d_img (9, 10)."""
    b = WARP_BOUNDS[dtype]
    rng = np.random.default_rng(seed)
    N, Ho, Wo = grid.shape[:3]
    img = torch.tensor(rng.uniform(-1, 1, (N, H, W, C)), dtype=dtype,
                       device=device)
    cot = torch.tensor(b['cot_scale'] * rng.uniform(-1, 1, (N, Ho, Wo, C)),
                       dtype=dtype, device=device)
    grid = torch.tensor(grid, dtype=torch.float32, device=device)
    d_img, d_grid = grid_sample_grad(grid, cot, img)
    d_img10 = grid_sample_grad_img(grid, cot, H, W)
    want_img, want_grid = grid_sample_grad_plain(grid, cot, img)
    torch.cuda.synchronize()
    atol, rtol = b['d_img']
    torch.testing.assert_close(d_img, want_img, atol=atol, rtol=rtol)
    torch.testing.assert_close(d_img10, grid_sample_grad_img_plain(
        grid, cot, H, W), atol=atol, rtol=rtol)
    atol, rtol = b['d_grid']
    torch.testing.assert_close(d_grid, want_grid, atol=atol, rtol=rtol)
    return d_img, d_img10


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_grid_sample_grad_band_edges(cuda_device, dtype):
    """Every sample's top tap on the last row of a band of the plan
    (y0 = r0 + rows - 1), so its bottom tap falls in the next band (the
    last band's clamps onto itself): each straddling sample is read by two
    CTAs, and only the first writes its d_grid."""
    H, W = 32, 128
    rows = grid_sample_plan(4, H, W, 64)['rows']
    rng = np.random.default_rng(0)
    edges = np.arange(rows - 1, H, rows)
    py = edges[rng.integers(0, len(edges), (4, 16, 64))] + rng.uniform(
        0.05, 0.95, (4, 16, 64))
    py = np.minimum(py, H - 1)
    px = rng.uniform(0, W - 1, (4, 16, 64))
    _check_warp_grads(cuda_device, dtype, _pixel_grid(px, py, H, W))


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('case', ['last_row_col', 'quadrant', 'one_pixel',
                                  'chunks'])
def test_grid_sample_grad_grids(cuda_device, dtype, case):
    """``last_row_col``: samples on the last row and column, exactly and
    beyond the border (the far taps clamp onto the near ones, ties pass
    d_grid); ``quadrant``: TPS++'s own [0, 1]^2 grid, which leaves the
    upper half of the rows without samples; ``one_pixel``: every sample of
    an image on one pixel, all warps adding to the same addresses;
    ``chunks``: 2,560 samples an image, three lists of a CTA."""
    H, W = 32, 128
    rng = np.random.default_rng(1)
    shape = (4, 40, 64) if case == 'chunks' else (4, 16, 64)
    if case == 'last_row_col':
        px = rng.choice([W - 1.0, W - 1.5, W - 1 + 1e-3, W + 5.0,
                         rng.uniform(0, W - 1)], shape)
        py = rng.choice([H - 1.0, H - 1.5, H + 3.0, rng.uniform(0, H - 1)],
                        shape)
        grid = _pixel_grid(px, py, H, W)
    elif case == 'quadrant':
        grid = rng.uniform(0, 1, shape + (2,))
    elif case == 'one_pixel':
        grid = np.broadcast_to(rng.uniform(-1, 1, (4, 1, 1, 2)),
                               shape + (2,)).copy()
    else:
        grid = rng.uniform(-1.1, 1.1, shape + (2,))
    _check_warp_grads(cuda_device, dtype, grid)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_grid_sample_grad_writes_every_pixel(cuda_device, dtype):
    """d_img comes from ``torch.empty``: a pixel the kernels failed to
    write would hold what the allocator's block held before. With the
    memory just freed from a NaN-filled tensor of d_img's size and every
    sample on row 0 (wy = 0), d_img is exactly 0 below row 0."""
    H, W, C, N = 32, 128, 64, 4
    rng = np.random.default_rng(3)
    grid = _pixel_grid(rng.uniform(0, W - 1, (N, 16, 64)),
                       np.zeros((N, 16, 64)), H, W)
    # blocks of d_img's size for the image (float32), kernel 9's d_img
    # and kernel 10's, and one more, all held at once and then freed
    nans = [torch.full((N, H, W, C), float('nan'), device=cuda_device)
            for _ in range(4)]
    del nans
    d_img, d_img10 = _check_warp_grads(cuda_device, dtype, grid, H, W, C)
    for d in (d_img, d_img10):
        assert not bool(torch.isnan(d).any())
        assert bool((d[:, 1:] == 0).all())
        assert bool((d[:, 0] != 0).any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(1, 4, 256, 256, (8, 16)),
                                   (3, 5, 6, 2, (7, 9))])
def test_grid_sample_grad_other_plans(cuda_device, dtype, shape):
    """(N, H, W, C, (Ho, Wo)): 256 channels of 256 columns, whose row of
    C does not fit, so the plan splits channels into slabs (and d_grid
    sums over all of them); C=2 with an odd Ho * Wo."""
    N, H, W, C, (Ho, Wo) = shape
    plan = grid_sample_plan(N, H, W, C)
    if C == 256:
        assert plan['slab'] < C or plan['rows'] == 1, plan
    rng = np.random.default_rng(4)
    grid = rng.uniform(-1.1, 1.1, (N, Ho, Wo, 2))
    _check_warp_grads(cuda_device, dtype, grid, H, W, C)
    assert grid_sample_grad.last_plan == grid_sample_grad_img.last_plan \
        == plan


@pytest.mark.requires_cuda
def test_grid_sample_plan(cuda_device):
    """The plan at the flagship's training shape is the one the kernels
    ran: bands of whole rows at all 64 channels, two or more CTAs an SM,
    one CTA an (image, band), within the shared memory; a shape no plan
    fits raises, nothing launched."""
    img, grid, cot = _warp_args(cuda_device, torch.bfloat16)
    plan = grid_sample_plan(4, 32, 128, 64)
    grid_sample_grad(grid, cot, img)
    grid_sample_grad_img(grid, cot, 32, 128)
    assert grid_sample_grad.last_plan == grid_sample_grad_img.last_plan \
        == plan
    assert plan['slab'] == 64 and 1 <= plan['rows'] <= 32
    assert plan['ctas_per_sm'] >= 2
    assert plan['blocks'] == 4 * -(-32 // plan['rows'])
    assert plan['rows'] * 128 * 64 * 4 < plan['smem'] <= 227 * 1024
    before = (grid_sample_grad.launches, grid_sample_grad_img.launches)
    with pytest.raises(ValueError, match='outside the kernel'):
        grid_sample_plan(1, 2, 20000, 2)
    big = torch.zeros((1, 2, 20000, 2), device=cuda_device)
    g = torch.zeros((1, 2, 2, 2), device=cuda_device)
    with pytest.raises(ValueError, match='outside the kernel'):
        grid_sample_grad(g, torch.zeros((1, 2, 2, 2), device=cuda_device),
                         big)
    assert (grid_sample_grad.launches,
            grid_sample_grad_img.launches) == before


# ---- kernels 8, 9 and 10 at odd channel counts: the narrow path --------

def _odd_warp_args(device, dtype, C, N=4, H=32, W=100, scale=1.0, seed=5):
    """A (N, H, W, C) crop, a (N, H, W) grid over [-1.3, 1.3]^2 (in range,
    on the clamped border and beyond it; exact pixel centres in the first
    row, the last column and the last row) and a cotangent of ``scale``:
    the shapes of the CTC family's TPS-STN warp."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (N, H, W, C))
    grid = rng.uniform(-1.3, 1.3, (N, H, W, 2))
    grid[:, 0, :, 0] = 2 * rng.integers(0, W, (N, W)) / (W - 1) - 1
    grid[:, 0, :, 1] = 2 * rng.integers(0, H, (N, W)) / (H - 1) - 1
    grid[:, 1, :, 0] = 1.0
    grid[:, 2, :, 1] = 1.0
    cot = scale * rng.uniform(-1, 1, (N, H, W, C))
    return (torch.tensor(img, dtype=dtype, device=device),
            torch.tensor(grid, dtype=torch.float32, device=device),
            torch.tensor(cot, dtype=dtype, device=device))


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('C', [1, 3])
def test_grid_sample_kernels_odd_channels(cuda_device, dtype, C):
    """Kernels 8, 9 and 10 on the narrow path (C = 1, CRNN-TPS's crops, and
    C = 3) against their plain versions, within the even path's bounds;
    the plan's slab is all of C, and a whole 32 x 100 image fits one
    CTA."""
    b = WARP_BOUNDS[dtype]
    img, grid, cot = _odd_warp_args(cuda_device, dtype, C,
                                    scale=b['cot_scale'])
    counts = [f.launches for f in (grid_sample_forward, grid_sample_grad,
                                   grid_sample_grad_img)]
    out = grid_sample_forward(img, grid)
    d_img, d_grid = grid_sample_grad(grid, cot, img)
    d_img10 = grid_sample_grad_img(grid, cot, 32, 100)
    want_d_img, want_d_grid = grid_sample_grad_plain(grid, cot, img)
    torch.cuda.synchronize()
    assert [f.launches for f in (grid_sample_forward, grid_sample_grad,
                                 grid_sample_grad_img)] == [
        n + 1 for n in counts]
    assert out.dtype == dtype and out.shape == img.shape
    atol, rtol = b['fwd']
    torch.testing.assert_close(out.float(),
                               grid_sample_plain(img, grid).float(),
                               atol=atol, rtol=rtol)
    atol, rtol = b['d_img']
    torch.testing.assert_close(d_img, want_d_img, atol=atol, rtol=rtol)
    torch.testing.assert_close(d_img10, grid_sample_grad_img_plain(
        grid, cot, 32, 100), atol=atol, rtol=rtol)
    atol, rtol = b['d_grid']
    torch.testing.assert_close(d_grid, want_d_grid, atol=atol, rtol=rtol)
    plan = grid_sample_plan(4, 32, 100, C)
    assert grid_sample_grad.last_plan == grid_sample_grad_img.last_plan \
        == plan
    assert plan['slab'] == C and plan['rows'] == 32 and plan['blocks'] == 4


@pytest.mark.requires_cuda
@pytest.mark.parametrize('C', [1, 3])
def test_grid_sample_odd_channels_other_grids(cuda_device, C):
    """The narrow path's backward on a plan of several bands (a tall map),
    on one pixel (every thread adding to the same addresses) and on a
    chunked list (more samples than a list holds), in float32."""
    for H, W, shape, grid_case in ((300, 100, (2, 16, 64), 'uniform'),
                                   (32, 100, (2, 16, 64), 'one_pixel'),
                                   (32, 100, (2, 40, 64), 'uniform')):
        rng = np.random.default_rng(6)
        if grid_case == 'one_pixel':
            grid = np.broadcast_to(rng.uniform(-1, 1, (2, 1, 1, 2)),
                                   shape + (2,)).copy()
        else:
            grid = rng.uniform(-1.1, 1.1, shape + (2,))
        _check_warp_grads(cuda_device, torch.float32, grid, H, W, C)
        if H == 300:
            assert grid_sample_plan(2, H, W, C)['rows'] < H


@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('map_hw,out_hw,C', [((3, 11), (32, 100), 1),
                                            ((2, 8), (32, 128), 3)])
def test_grid_sample_offset_upsamples(cuda_device, dtype, map_hw, out_hw,
                                      C):
    """The preprocessors' offset samples: MORAN's 3 x 11 one-channel map
    and SPIN's 2 x 8 three-channel map sampled up on the identity grid of
    the crop (``float64 np.linspace`` rounded to float32), B=64: kernel 8
    and kernels 9-10 against their plain versions, thousands of samples
    adding into a few dozen source pixels an image."""
    from tps_pp_tpu_torch.models.rectifiers.moran import identity_grid
    grid = np.broadcast_to(identity_grid(*out_hw), (64,) + out_hw + (2,))
    rng = np.random.default_rng(9)
    img = torch.tensor(rng.uniform(-1, 1, (64,) + map_hw + (C,)),
                       dtype=dtype, device=cuda_device)
    g = torch.tensor(grid, dtype=torch.float32, device=cuda_device)
    atol, rtol = WARP_BOUNDS[dtype]['fwd']
    torch.testing.assert_close(grid_sample_forward(img, g).float(),
                               grid_sample_plain(img, g).float(),
                               atol=atol, rtol=rtol)
    _check_warp_grads(cuda_device, dtype, grid.copy(), *map_hw, C)
    assert grid_sample_plan(64, *map_hw, C)['blocks'] == 64


@pytest.mark.requires_cuda
def test_grid_sample_function_routes_at_one_channel(cuda_device):
    """Under autograd at C = 1: kernel 8 forward, kernel 9 backward with a
    grid gradient, kernel 10 without; d_img in the image's dtype."""
    img, grid, cot = _odd_warp_args(cuda_device, torch.bfloat16, 1)
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
        img.grad = None


@pytest.mark.requires_cuda
@pytest.mark.parametrize('mode,fused_step', [('fused40_bf16', False),
                                             ('steps', True)])
def test_two_threads_first_calls_on_one_card(cuda_device, mode, fused_step):
    """Two replicas of the flagship on one card, their first calls made
    from two host threads at once (``predict(mesh=)`` runs a thread a
    card; here two share one): the kernels' host caches (shared memory
    caps, cluster occupancy, SM counts) and the whole decode's graph
    captures are shared between the threads; each output equals its
    replica's single-thread result, bit for bit."""
    import copy
    import threading
    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode=mode)
    cfg['decoder'] = dict(cfg['decoder'], use_fused_step=fused_step)
    rec = build_recognizer(cfg, device=cuda_device).init_weights(0)
    g = np.random.default_rng(3)
    imgs = [torch.from_numpy(g.standard_normal((64, 32, 128, 3)).astype(
        np.float32)).to(cuda_device, BF) for _ in range(2)]
    vr = torch.ones(64, device=cuda_device)
    solo = [copy.deepcopy(rec.model) for _ in range(2)]
    pair = [copy.deepcopy(rec.model) for _ in range(2)]

    def run(model, x):
        with torch.inference_mode():
            return rec._predict_impl(model, x, vr)

    want = [run(m, x) for m, x in zip(solo, imgs)]
    torch.cuda.synchronize()
    got = [None, None]
    start = threading.Barrier(2)

    def worker(i):
        with torch.cuda.device(cuda_device):
            start.wait()
            got[i] = run(pair[i], imgs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)
