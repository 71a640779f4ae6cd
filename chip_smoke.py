#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tps_pp_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at its path's shapes, then drives
the paths of the full-width NRTR + TPS++ flagship (random weights from a
seed):

* serving (bf16), through ``TextRecognizer.simple_test`` on a batch of 512
  crops and a small batch with mixed valid ratios, on each of the JAX
  package's serving decodes: ``fused40_bf16`` (B=512 and 5), ``fused40``
  (int8 encoder K/V; B=512 and 5) and ``steps`` with a ``use_fused_step``
  decoder (B=512 and 8, the small-batch regime it is kept for); and
  ``fused40_bf16`` with ``stem_mode='fused'`` (kernel 12, seven launches a
  ``predict``) and with the two-stage sampler (``sample_mode='pallas'``,
  ``TPS_SAMPLER_VARIANT=twostage``: kernel 2, and kernel 1 not at all),
  B=512 and 5 each. Each path runs with the launch counts set to 0 just
  before it, and its kernels must carry it; its argmax must agree with its
  plain path (the recognizer's ``plain`` switch); the paths are timed in
  turns. A float32 model then serves B=8 through ``steps``, with and
  without ``use_fused_step`` and with the fused stem (the kernels' float32
  variants), against its plain path;
* training (f32 parameters and Adam state, bf16 autocast, B=256, Adam at
  1e-4 with grad clip 5.0, random DICT90 labels): one step from the same
  weights and batch on the kernel path and on the plain path must agree
  (the loss in f32 and bf16 compute; in f32 compute also the grad norm
  and the gradient that reaches the loss only through the warp's d_grid);
  five steps with dropout 0.1 must give finite losses through the
  grid_sample kernels; both paths are timed. The d_img-only backward
  kernel is driven through ``GridSampleFunction`` with a detached grid.

The 3x3 convolution of the fused stem (kernel 11) has no caller in either
package; it is driven as an op, at the stem's width over the batch of 512.
The band walk's plan at each stem shape (kernels 11 and 12 in bf16) is
logged, and the module stem is timed against the fused stem.

For every kernel it reports the time, the plain version's time, the time of
one PyTorch call that computes the same function where there is one, and
the bound: the larger of the bytes it must move (each input read once,
each output written once) over the card's memory rate and its operations
over the peak rate of their type (bf16 tensor cores for the matmuls, f32
for the rest), at this run's shapes and steps.

It imports nothing of JAX and nothing of the JAX package.

Output: progress lines, then one JSON line with the kernels, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises; without a CUDA
device it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

B = 512          # serving batch (bench.py's)
N_DECODE = 64    # batch of the decode kernel check
B_SMALL = 8      # the small batch the fused step is kept for
SEED = 0
# the H100 SXM's published peaks (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and f32 FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12

# tolerances of the kernel-vs-plain checks (both sides in bf16 on the card)
SAMPLER_ATOL = 2e-2
# the encoder's two versions round the same values to bf16 at the same
# points; they part where an f32 sum taken in another order crosses a bf16
# rounding boundary (one ulp, 2^-8 relative), and that drifts through six
# layers: allow eight ulps, absolute at magnitude 1 and relative above
ENCODER_ATOL, ENCODER_RTOL = 6.25e-2, 3.125e-2
# decode: argmax equal, or the first differing step is a near-tie of the
# plain version; probabilities before it within the JAX bf16 contract
NEAR_TIE, DECODE_ATOL, DECODE_RTOL = 1e-3, 2e-2, 5e-2
# the bf16 `steps` decodes round the residual stream to bf16 after every
# call (the JAX kernels with use_fused_step as the module path), where the
# whole decode keeps it f32: there one bf16 ulp anywhere upstream moves
# the step-0 probabilities by ~2e-3, and even the module `steps` decode,
# with no decode kernel, parts from itself at top-2 gaps of ~2e-3 when
# only the sampler's version changes. So the fused-step path's near-tie is
# measured in each run (steps_tie_widths): that module decode's widest
# gap, its own sensitivity to one ulp upstream, times TIE_MULT, and
# never below NEAR_TIE. The fused-step kernels against their plain
# versions on one encoding, and the path against its plain path, must part
# only within it. Likewise the fused stem (stem_tie_widths): it perturbs
# every activation of the trunk by bf16 roundings on top of the
# sampler's, encoder's and decode's kernels, so its path's near-tie is
# TIE_MULT times the widest gap at which the decode parts when only the
# stem's rounding changes (module stem against the fused stem, all plain).
# Readings over several seeds: tools/steps_tie_calibration.py, PERF.md
TIE_MULT = 2.0
# the per-step kernels (bf16 outputs of O(1) values): one bf16 rounding
# apart where f32 sums in another order cross a rounding boundary, two
# ulps relative and 2e-2 absolute near 0
STEP_ATOL, STEP_RTOL = 2e-2, 2 ** -7
# the training warp, (atol, rtol): bf16 as the sampler and as the JAX
# package's bf16 VJP test (tests/test_grid_sample_vjp.py:180-193); f32 as
# its f32 tests, at a cotangent scale of 1e-3 (d_grid scales 64-term
# channel sums by (W-1)/2 = 63.5, so unit cotangents put the f32 rounding
# of two summation orders near 2e-5, above the f32 atol)
WARP_BOUNDS = {
    'bfloat16': dict(fwd=(2e-2, 0.0), d_img=(5e-2, 5e-2),
                     d_grid=(0.1, 5e-2), cot_scale=1.0),
    'float32': dict(fwd=(1e-5, 0.0), d_img=(1e-5, 0.0),
                    d_grid=(1e-5, 1e-4), cot_scale=1e-3),
}
# kernels 11-12 (bf16 outputs of O(1) values): both versions round y and
# the output at the same points; an f32 sum in another order moves a
# rounding by one ulp now and then: two bf16 ulps, relative, and 2e-2
# absolute near 0. float32: sums of up to 9 * 64 terms in another order
STEM_BOUNDS = {'bfloat16': (2e-2, 2 ** -7), 'float32': (1e-4, 1e-4)}
# the three BasicBlock shapes of the flagship's stem, (C_in, C_mid, C_out,
# H, W, residual): layer1's blocks, layer2's block0 at full resolution (its
# stride-2 main path), layer2's blocks 1-3
STEM_SHAPES = {'layer1': (32, 32, 32, 32, 128, True),
               'layer2_block0': (32, 64, 64, 32, 128, False),
               'layer2_blocks': (64, 64, 64, 16, 64, True)}
B_TRAIN = 256    # training batch (the JAX package's bench_train.py)
# the training step, kernel path against plain path (dropout 0)
LOSS_RTOL, GRAD_COS_MIN, GRAD_NORM_RTOL = 1e-2, 0.99, 5e-2
TRAIN_OPT = dict(type='Adam', lr=1e-4, grad_clip=dict(max_norm=5.0))


def log(*a):
    print(*a, flush=True)


def card():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, bf16_flops=0, f32_flops=0):
    """(least ms, what binds it) of work that moves ``nbytes`` and does
    ``bf16_flops`` on the tensor cores and ``f32_flops`` elsewhere."""
    mem = nbytes / PEAK_BYTES * 1e3
    ops = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    return (mem, 'bytes') if mem >= ops else (ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def transformer_encoder_yardstick(enc, dtype):
    """One ``nn.TransformerEncoder`` with the weights of the port's
    ``NRTREncoder`` ``enc``: pre-norm layers, erf-GELU, the attention's
    biases zero (NRTR's projections have none), the final LayerNorm; in
    eval mode and ``dtype`` on enc's device. It computes kernel 3's
    function (the mask as ``src_key_padding_mask``, True where a key is
    masked) and is its library yardstick: timed beside it, never called by
    the port. Needs n_head * d_k == d_model, as nn.MultiheadAttention."""
    import torch
    from torch import nn
    first = enc.layer_stack[0]
    D = first.norm1.normalized_shape[0]
    te = nn.TransformerEncoder(
        nn.TransformerEncoderLayer(
            D, enc.n_head, first.mlp.w_1.out_features, dropout=0.0,
            activation='gelu', layer_norm_eps=1e-5, batch_first=True,
            norm_first=True),
        len(enc.layer_stack), norm=nn.LayerNorm(D, eps=1e-5),
        enable_nested_tensor=False)
    with torch.no_grad():
        for src, dst in zip(enc.layer_stack, te.layers):
            a = src.attn
            dst.self_attn.in_proj_weight.copy_(torch.cat(
                [a.linear_q.weight, a.linear_k.weight, a.linear_v.weight]))
            dst.self_attn.in_proj_bias.zero_()
            dst.self_attn.out_proj.weight.copy_(a.fc.weight)
            dst.self_attn.out_proj.bias.zero_()
            for d, m in ((dst.linear1, src.mlp.w_1), (dst.linear2,
                                                      src.mlp.w_2),
                         (dst.norm1, src.norm1), (dst.norm2, src.norm2)):
                d.weight.copy_(m.weight)
                d.bias.copy_(m.bias)
        te.norm.weight.copy_(enc.layer_norm.weight)
        te.norm.bias.copy_(enc.layer_norm.bias)
    return te.to(enc.layer_norm.weight.device, dtype).eval()


def first_divergence(kernel_probs, plain_probs):
    """Per row: (first step whose argmax differs or None, plain top-2 gap
    there)."""
    import torch
    ka, pa = kernel_probs.argmax(-1), plain_probs.argmax(-1)
    out = []
    for r in range(ka.shape[0]):
        diff = torch.nonzero(ka[r] != pa[r])
        if diff.numel() == 0:
            out.append((None, None))
            continue
        t = int(diff[0, 0])
        top2 = torch.topk(plain_probs[r, t].float(), 2).values
        out.append((t, float(top2[0] - top2[1])))
    return out


def check_decode(kernel_probs, plain_probs, what, near_tie=NEAR_TIE):
    """The decode rule; returns (max abs error on the agreeing prefix,
    number of rows that part at a near-tie, their largest top-2 gap)."""
    div = first_divergence(kernel_probs, plain_probs)
    err, ties, widest = 0.0, 0, 0.0
    for r, (t, gap) in enumerate(div):
        if t is not None:
            if not gap < near_tie:
                raise AssertionError(
                    f'{what}: row {r} parts from the plain path at step {t} '
                    f'with a top-2 gap of {gap:.3g} (>= {near_tie})')
            ties += 1
            widest = max(widest, gap)
        stop = kernel_probs.shape[1] if t is None else t
        k, p = kernel_probs[r, :stop].float(), plain_probs[r, :stop].float()
        if stop:
            err = max(err, float((k - p).abs().max()))
            bad = (k - p).abs() > DECODE_ATOL + DECODE_RTOL * p.abs()
            if bool(bad.any()):
                raise AssertionError(f'{what}: row {r} probabilities beyond '
                                     f'atol {DECODE_ATOL} rtol {DECODE_RTOL}')
    return err, ties, widest


def steps_tie_widths(r, img):
    """How far the bf16 ``steps`` decodes of ``r`` (a recognizer whose
    decoder has ``use_fused_step``) part from themselves on ``img``, each
    as (rows that part, widest top-2 gap of the plain side where they
    part), with the probabilities before that held to the decode rule:

    * ``module``: the module decode (no decode kernel) on the encodings of
      the sampler's kernel and of its plain version: the decode's own
      sensitivity to one bf16 ulp upstream;
    * ``kernels``: the fused step's kernels against their plain versions
      on one encoding (the sampler kernel's), so that the sampler drops
      out;
    * ``path``: the kernel path against the plain path, as ``predict``
      gives them with ``r.plain`` False and True.
    """
    import torch
    from tps_pp_tpu_torch.models.decoders import greedy_decode
    dec, lc, n = r.model.decoder, r.label_convertor, img.shape[0]
    with torch.inference_mode():
        ones = torch.ones(n, device=img.device)

        def decode(enc, plain):
            return greedy_decode(dec, enc, ones, max_seq_len=r.max_seq_len,
                                 start_idx=lc.start_idx,
                                 end_idx=lc.end_idx, plain=plain)
        enc_k, enc_p = (r.model.encode_full(img, ones, plain=p)[1]
                        for p in (False, True))
        out = dict(kernels=(decode(enc_k, False), decode(enc_k, True)))
        out['path'] = (out['kernels'][0], decode(enc_p, True))
        dec.use_fused_step = False
        try:
            out['module'] = (decode(enc_k, False), decode(enc_p, False))
        finally:
            dec.use_fused_step = True
    return {k: check_decode(a, b, f'steps_tie_widths {k}', near_tie=1.0)[1:]
            for k, (a, b) in out.items()}


def stem_tie_widths(r, img):
    """How far the ``fused40_bf16`` decode of ``r`` (bf16, the flagship's
    trunk) parts from itself on ``img`` around the fused stem, each as (rows
    that part, widest top-2 gap of the second side where they part), with
    the probabilities before that held to the decode rule:

    * ``module``: the module stem against the fused stem's plain version,
      the rest plain: the decode's sensitivity to the stem's bf16 rounding,
      which no kernel enters;
    * ``kernel``: the fused stem's kernels against their plain versions,
      the rest of the path on its kernels, so that only the stem differs;
    * ``path``: the kernel path against the plain path, both with the fused
      stem, as ``predict`` gives them with ``r.plain`` False and True.
    """
    import torch
    from tps_pp_tpu_torch.ops.stem import fused_stem_forward
    m, n = r.model, img.shape[0]
    end = r.label_convertor.end_idx if r.early_exit else None

    def decode(stem, plain, stem_plain=None):
        stem = None if stem == 'module' else fused_stem_forward(
            m.backbone, img, r.dtype, plain=stem_plain)
        return m.decode_full_fused(img, torch.ones(n, device=img.device),
                                   end_idx=end, plain=plain, stem=stem)

    with torch.inference_mode():
        fused_k, fused_p = (decode('fused', p, p) for p in (False, True))
        out = dict(module=(decode('module', True), fused_p),
                   kernel=(fused_k, decode('fused', False, True)),
                   path=(fused_k, fused_p))
    return {k: check_decode(a, b, f'stem_tie_widths {k}', near_tie=1.0)[1:]
            for k, (a, b) in out.items()}


def check_close(what, got, want, bound):
    """Max abs error of ``got`` against ``want``; raises beyond
    ``bound`` = (atol, rtol)."""
    atol, rtol = bound
    got, want = got.float(), want.float()
    d = (got - want).abs()
    if got.shape != want.shape or bool(
            (d > atol + rtol * want.abs()).any()):
        raise AssertionError(f'{what}: max abs error {float(d.max())} beyond '
                             f'atol {atol} rtol {rtol}')
    return float(d.max())


def warp_inputs(dev, dtype, cot_scale, g):
    """The training warp at the flagship's training shapes: a
    (B_TRAIN, 32, 128, 64) map, a (B_TRAIN, 16, 64) grid over [-1.3, 1.3]^2
    (inside the map, on its clamped border and beyond it, exact pixel
    centres in the first row) and a cotangent of ``cot_scale``."""
    import numpy as np
    import torch
    img = g.uniform(-1, 1, (B_TRAIN, 32, 128, 64))
    grid = g.uniform(-1.3, 1.3, (B_TRAIN, 16, 64, 2))
    grid[:, 0, :, 0] = 2 * g.integers(1, 127, (B_TRAIN, 64)) / 127 - 1
    grid[:, 0, :, 1] = 2 * g.integers(1, 31, (B_TRAIN, 64)) / 31 - 1
    cot = cot_scale * g.uniform(-1, 1, (B_TRAIN, 16, 64, 64))
    return (torch.tensor(img, dtype=dtype, device=dev),
            torch.tensor(grid, dtype=torch.float32, device=dev),
            torch.tensor(cot, dtype=dtype, device=dev))


def warp_checks(dev, g, record, name):
    """Kernels 8, 9 and 10 against their plain versions in bf16 and f32;
    records them with their bf16 errors and times (the training path's
    dtype)."""
    import torch
    from tps_pp_tpu_torch.ops.grid_sample import (
        grid_sample_forward, grid_sample_grad, grid_sample_grad_img,
        grid_sample_grad_img_plain, grid_sample_grad_plain,
        grid_sample_plain)
    errs, timed = {}, None
    for dname in ('float32', 'bfloat16'):
        b = WARP_BOUNDS[dname]
        img, grid, cot = warp_inputs(dev, getattr(torch, dname),
                                     b['cot_scale'], g)
        out = grid_sample_forward(img, grid)
        d_img, d_grid = grid_sample_grad(grid, cot, img)
        d_img10 = grid_sample_grad_img(grid, cot, 32, 128)
        want_img, want_grid = grid_sample_grad_plain(grid, cot, img)
        want_img10 = grid_sample_grad_img_plain(grid, cot, 32, 128)
        torch.cuda.synchronize()
        if out.dtype != img.dtype or d_img.dtype != torch.float32 or \
                d_grid.dtype != torch.float32:
            raise AssertionError(f'grid_sample {dname}: output dtypes')
        errs[dname] = dict(
            fwd=check_close(f'grid_sample_forward {dname}', out,
                            grid_sample_plain(img, grid), b['fwd']),
            d_img=check_close(f'grid_sample_grad d_img {dname}', d_img,
                              want_img, b['d_img']),
            d_grid=check_close(f'grid_sample_grad d_grid {dname}', d_grid,
                               want_grid, b['d_grid']),
            d_img10=check_close(f'grid_sample_grad_img {dname}', d_img10,
                                want_img10, b['d_img']))
        log(f'grid_sample {dname}: max abs errors {errs[dname]} [{name}]')
        timed = (img, grid, cot)
    img, grid, cot = timed
    e = errs['bfloat16']
    src = 'tps_pp_tpu_torch/csrc/grid_sample.cu'
    # the library's sampler (ATen, NCHW views, a grid of the image's type):
    # the same bilinear, border, align_corners function
    img_l, cot_l = img.permute(0, 3, 1, 2), cot.permute(0, 3, 1, 2)
    grid_l = grid.to(img.dtype)
    taps = cot.numel() * 8                   # 4 taps, a multiply-add each
    d_img = nbytes(img) * 2                  # f32
    record('grid_sample_forward', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:126',
           lambda: grid_sample_forward(img, grid),
           lambda: grid_sample_plain(img, grid), e['fwd'], 20,
           nbytes(img, grid, cot), f32_flops=taps,
           fn_lib=lambda: torch.nn.functional.grid_sample(
               img_l, grid_l, mode='bilinear', padding_mode='border',
               align_corners=True))
    record('grid_sample_grad', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:283',
           lambda: grid_sample_grad(grid, cot, img),
           lambda: grid_sample_grad_plain(grid, cot, img),
           max(e['d_img'], e['d_grid']), 10,
           # d_grid is the grid's size
           nbytes(grid, cot, img, grid) + d_img, f32_flops=2 * taps,
           fn_lib=lambda: torch.ops.aten.grid_sampler_2d_backward(
               cot_l, img_l, grid_l, 0, 1, True, [True, True]))
    record('grid_sample_grad_img', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:178',
           lambda: grid_sample_grad_img(grid, cot, 32, 128),
           lambda: grid_sample_grad_img_plain(grid, cot, 32, 128),
           e['d_img10'], 10, nbytes(grid, cot) + d_img, f32_flops=taps,
           fn_lib=lambda: torch.ops.aten.grid_sampler_2d_backward(
               cot_l, img_l, grid_l, 0, 1, True, [True, False]))
    return img, grid, cot


def stem_checks(dev, g, record):
    """Kernels 11 and 12 against their plain versions: float32 on 8 images,
    then bf16 over the batch of B at the stem's shapes, timed; kernel 12
    at its three shapes (layer1's is listed), kernel 11 with the library's
    convolution beside it. Returns the launch count of kernel 11's run as
    an op."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tps_pp_tpu_torch.ops.stem import (basic_block_cp,
                                           basic_block_cp_plain, conv3x3_cp,
                                           conv3x3_cp_plain, stem_plan)
    f32, bf = torch.float32, torch.bfloat16

    def inputs(cin, cmid, cout, n, H, W, dtype):
        """t (cin, n*H*W) in [-1, 1]; w1, wt with variance 1/fan_in;
        biases in [-0.5, 0.5], float32."""
        def r(*shape, scale=1.0, dt=dtype):
            return torch.from_numpy(g.uniform(-scale, scale, shape).astype(
                np.float32)).to(dev, dt)
        return (r(cin, n * H * W), r(cmid, cin, scale=(3 / cin) ** 0.5),
                r(cmid, 1, scale=0.5, dt=f32),
                r(cout, 9 * cmid, scale=(3 / (9 * cmid)) ** 0.5),
                r(cout, 1, scale=0.5, dt=f32))

    errs = {}
    for sname, (cin, cmid, cout, H, W, res) in STEM_SHAPES.items():
        a = inputs(cin, cmid, cout, 8, H, W, f32)
        errs[sname] = check_close(
            f'basic_block_cp float32 {sname}',
            basic_block_cp(*a, H=H, W=W, residual=res),
            basic_block_cp_plain(*a, H=H, W=W, residual=res),
            STEM_BOUNDS['float32'])
    x, _, _, w, b = inputs(32, 32, 32, 8, 32, 128, f32)
    errs['conv3x3_cp'] = check_close(
        'conv3x3_cp float32', conv3x3_cp(x, w, b, H=32, W=128, relu=True),
        conv3x3_cp_plain(x, w, b, H=32, W=128, relu=True),
        STEM_BOUNDS['float32'])
    log(f'stem kernels, float32 on 8 images: max abs errors {errs}')

    src, rep = 'tps_pp_tpu_torch/csrc/stem.cu', 'tps_pp_tpu/ops/pallas_stem.py'
    # kernel 11 as an op at the stem's width, (32, B*32*128) -> 32
    x, _, _, w, b = inputs(32, 32, 32, B, 32, 128, bf)
    conv3x3_cp.launches = 0
    out = conv3x3_cp(x, w, b, H=32, W=128)
    torch.cuda.synchronize()
    launches = conv3x3_cp.launches
    err = check_close('conv3x3_cp', out, conv3x3_cp_plain(x, w, b, H=32,
                                                          W=128),
                      STEM_BOUNDS['bfloat16'])
    # the library's convolution of the same function: NCHW channels-last
    # views of x, OIHW weights, a bf16 bias; never used by the port
    x_l = x.reshape(32, B, 32, 128).permute(1, 0, 2, 3).contiguous(
        memory_format=torch.channels_last)
    w_l = w.reshape(32, 3, 3, 32).permute(0, 3, 1, 2).contiguous()
    b_l = b[:, 0].to(bf)
    lib = F.conv2d(x_l, w_l, b_l, padding=1)
    lib_err = float((lib.permute(1, 0, 2, 3).reshape(32, -1).float() -
                     out.float()).abs().max())
    log(f'conv3x3_cp: launches {launches} as an op; the library '
        f'convolution parts from the kernel by {lib_err:.4g}')
    if launches != 1 or not lib_err <= 0.1:
        raise AssertionError(f'conv3x3_cp: launches {launches}, library '
                             f'error {lib_err}')
    P = x.shape[1]
    record('conv3x3_cp', src, rep + ':93',
           lambda: conv3x3_cp(x, w, b, H=32, W=128),
           lambda: conv3x3_cp_plain(x, w, b, H=32, W=128), err, 10,
           nbytes(x, w, b, out), bf16_flops=2 * P * 32 * 9 * 32,
           fn_lib=lambda: F.conv2d(x_l, w_l, b_l, padding=1))
    del x, w, b, out, x_l, lib

    # kernel 12 at the stem's three shapes over the batch of B, each with
    # the plan of its band walk on this card
    log(f'conv3x3_cp plan at B={B}: '
        f'{stem_plan(32, 32, 32, B, 32, 128, block=False)}')
    for sname, (cin, cmid, cout, H, W, res) in STEM_SHAPES.items():
        log(f'basic_block_cp {sname} plan at B={B} (R output rows a group, '
            f'NR ring slots, blocks, shared memory bytes a block): '
            f'{stem_plan(cin, cmid, cout, B, H, W)}')
        a = inputs(cin, cmid, cout, B, H, W, bf)
        got = basic_block_cp(*a, H=H, W=W, residual=res)
        err = check_close(f'basic_block_cp {sname}', got,
                          basic_block_cp_plain(*a, H=H, W=W, residual=res),
                          STEM_BOUNDS['bfloat16'])
        P = a[0].shape[1]
        record('basic_block_cp', src, rep + ':174',
               lambda a=a, H=H, W=W, res=res: basic_block_cp(
                   *a, H=H, W=W, residual=res),
               lambda a=a, H=H, W=W, res=res: basic_block_cp_plain(
                   *a, H=H, W=W, residual=res), err, 5, nbytes(*a, got),
               bf16_flops=2 * P * (cmid * cin + cout * 9 * cmid),
               listed=sname == 'layer1', label=f'basic_block_cp {sname}')
        del a, got
    return launches


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-30))


def train_slice(dev, g, name, warp_args):
    """The training path of the full-width flagship; returns the launch
    counts of the warp kernels in its runs."""
    import copy

    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.ops.grid_sample import (
        GridSampleFunction, grid_sample_forward, grid_sample_grad,
        grid_sample_grad_img, grid_sample_grad_img_plain)
    from tps_pp_tpu_torch.parallel import build_optimizer, make_train_step
    warps = (grid_sample_forward, grid_sample_grad, grid_sample_grad_img)

    def recognizer(dropout, dtype='bfloat16'):
        cfg = nrtr_tps_pp_cfg(dtype=dtype)
        cfg = dict(cfg, encoder=dict(cfg['encoder'], dropout=dropout),
                   decoder=dict(cfg['decoder'], dropout=dropout))
        return build_recognizer(cfg, device=dev, param_dtype='float32')

    rec = recognizer(0.0).init_weights(SEED)
    state0 = copy.deepcopy(rec.model.state_dict())
    lc = rec.label_convertor
    chars = [c for c in lc.idx2char if len(c) == 1]
    texts = [''.join(g.choice(chars, int(g.integers(1, 26))))
             for _ in range(B_TRAIN)]
    h, w, c = FLAGSHIP_INPUT
    batch = dict(
        img=torch.from_numpy(g.standard_normal((B_TRAIN, h, w, c)).astype(
            np.float32)).to(dev),
        valid_ratio=g.uniform(0.5, 1.0, B_TRAIN).astype(np.float32),
        padded_targets=lc.str2tensor(texts)['padded_targets'])

    def step_fn(r):
        opt, _ = build_optimizer(TRAIN_OPT, r.model.named_parameters())
        return make_train_step(r, opt)

    # ---- check step: the same weights and batch on both paths, dropout 0.
    # In f32 compute the paths differ only by the kernels' rounding, and
    # all three checks hold. In bf16 compute the gradients of a randomly
    # initialised model are dominated by bf16 rounding amplified through
    # the trunk: one bf16 ulp of the warp's output moves them (kernel
    # against plain: cosine 0.92 over all parameters, 0.88-0.92 for
    # localization_fc2; kernel against kernel 1.0), so there the loss is
    # checked and the gradients are reported.
    loc_grads = {}
    for dtype in ('float32', 'bfloat16'):
        rec = recognizer(0.0, dtype)
        got = {}
        for plain in (False, True):
            rec.model.load_state_dict(state0)
            step = step_fn(rec)
            for fn in warps:
                fn.launches = 0
            m = step(batch, plain=plain)
            torch.cuda.synchronize()
            got[plain] = (float(m['loss']), float(m['grad_norm']),
                          rec.model.tpsnet.TPE.localization_fc2.weight.grad
                          .clone(), [fn.launches for fn in warps],
                          torch.cat([p.grad.flatten().float()
                                     for p in rec.model.parameters()]))
        (lk, nk, gk, ck, ak), (lp, np_, gp, cp, ap) = got[False], got[True]
        cos = cosine(gk, gp)
        loc_grads[dtype] = gk
        log(f'train check step, {dtype} compute: loss {lk:.6f} kernel / '
            f'{lp:.6f} plain; grad_norm {nk:.6f} / {np_:.6f}; '
            f'cos(d localization_fc2) {cos:.6f}, cos(all gradients) '
            f'{cosine(ak, ap):.6f}; warp launches kernel path {ck}, plain '
            f'path {cp} [{name}]')
        del ak, ap, got
        if not (np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp)):
            raise AssertionError(f'train {dtype}: loss {lk} vs plain {lp}')
        if ck[0] < 1 or ck[1] < 1 or any(cp):
            raise AssertionError(f'train {dtype}: warp launches {ck} kernel '
                                 f'path, {cp} plain path')
        if dtype == 'bfloat16':
            continue
        if not abs(nk - np_) <= GRAD_NORM_RTOL * abs(np_):
            raise AssertionError(f'train: grad_norm {nk} vs plain {np_}')
        if not cos >= GRAD_COS_MIN:
            raise AssertionError(f'train: cosine of the localization_fc2 '
                                 f'gradient {cos} < {GRAD_COS_MIN}')
    log(f'train check step, kernel path: cos(d localization_fc2) of bf16 '
        f'against f32 compute '
        f'{cosine(loc_grads["bfloat16"], loc_grads["float32"]):.6f} '
        f'[{name}]')
    del rec

    # ---- the training path: five steps with dropout 0.1 ---------------
    rec = recognizer(0.1)
    rec.model.load_state_dict(state0)
    step = step_fn(rec)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for fn in warps:
        fn.launches = 0
    losses = [float(step(batch, gen)['loss']) for _ in range(5)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in warps}
    log(f'train: 5 steps, dropout 0.1, losses {losses}; warp launches '
        f'{launches} [{name}]')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'train: non-finite loss {losses}')
    if launches['grid_sample_forward'] < 5 or \
            launches['grid_sample_grad'] < 5:
        raise AssertionError(f'train: warp kernels not launched {launches}')

    # ---- kernel 10 through the autograd function, grid detached --------
    img, grid, cot = warp_args
    img = img.detach().requires_grad_(True)
    for fn in warps:
        fn.launches = 0
    GridSampleFunction.apply(img, grid, False).backward(cot)
    torch.cuda.synchronize()
    counts = [fn.launches for fn in warps]
    if counts != [1, 0, 1]:
        raise AssertionError(f'detached grid: launches {counts}')
    check_close('GridSampleFunction d_img', img.grad,
                grid_sample_grad_img_plain(grid, cot, 32, 128).to(img.dtype),
                WARP_BOUNDS['bfloat16']['d_img'])
    launches['grid_sample_grad_img'] = counts[2]

    # ---- warm step time, the two paths in turns --------------------------
    times = {False: [], True: []}
    for plain in (False, True, False, True):
        step(batch, gen, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            loss = step(batch, gen, plain=plain)['loss']
        torch.cuda.synchronize()
        times[plain].append((time.perf_counter() - t0) / 3)
        if not bool(torch.isfinite(loss)):
            raise AssertionError('train: non-finite loss while timing')
    for plain, ts in times.items():
        log(f'train B={B_TRAIN} {"plain" if plain else "kernel"} path: '
            f'{min(ts) * 1e3:.2f} ms/step, {B_TRAIN / min(ts):.1f} images/s '
            f'(best of 2 rounds of 3 steps, dropout 0.1) [{name}]')
    return launches


def decode_flops(d, N, steps, TE):
    """(bf16, f32) operations of the whole greedy decode of ``N`` rows over
    ``steps`` steps: the encoder K/V projection, every step's matmuls and
    classifier, and the attention over t + 1 cached and TE encoder keys."""
    L, D, HD, DI, NC, H, DK = (d[k] for k in ('L', 'D', 'HD', 'DI', 'NC',
                                              'H', 'DK'))
    mm = 2 * N * TE * D * L * 2 * HD + steps * (
        2 * N * L * (D * 3 * HD + 3 * HD * D + 2 * D * DI) + 2 * N * D * NC)
    att = sum(4 * N * H * DK * L * (t + 1 + TE) for t in range(steps))
    return mm, att


def decode_graph_checks(w, out_enc, src_mask, lc):
    """The captured decode's exit and weight cache, bf16 and int8 encoder
    K/V: a classifier bias that makes EOS win ends the decode on the device
    after as many steps as the plain version runs (fewer than 40); a weight
    changed in place is served by the next replay (the graph reads it
    through its pointer: no new capture), and another tensor in a weight's
    place by a new capture, each against the plain version on the new
    weights."""
    import torch
    from tps_pp_tpu_torch.ops.full_decode import (full_decode,
                                                  full_decode_plain)
    w = {k: v.clone() for k, v in w.items()}
    bcls = w['bcls'].clone()
    w['bcls'][lc.end_idx] += 100.0
    for enc_dtype in ('bfloat16', 'int8'):
        args = (out_enc, src_mask, w, 8, lc.start_idx, lc.end_idx, enc_dtype)
        got = full_decode(*args)
        steps = full_decode.last_steps
        want = full_decode_plain(*args)
        ran = int((want.abs().sum((0, 2)) > 0).sum())
        check_decode(got, want, f'full_decode {enc_dtype} forced EOS')
        if not steps == ran < want.shape[1] or bool(
                (got[:, steps:] != 0).any()):
            raise AssertionError(f'full_decode {enc_dtype} forced EOS: '
                                 f'{steps} steps run, plain {ran}')
        log(f'full_decode {enc_dtype} forced EOS: {steps} steps run, plain '
            f'{ran}')
    w['bcls'].copy_(bcls)
    args = (out_enc, src_mask, w, 8, lc.start_idx, None)
    before = full_decode(*args)
    captures = full_decode.captures
    g = torch.Generator(device=out_enc.device).manual_seed(SEED)
    # noise at 0.3 of the weights' spread: the outputs move, the weights'
    # scale (at which the near-tie rule was set) stays within 5%
    with torch.no_grad():
        w['wcls'].add_((0.3 * w['wcls'].float().std() * torch.randn(
            w['wcls'].shape, generator=g, device=out_enc.device)).to(
            w['wcls'].dtype))
    got = full_decode(*args)
    err, ties, _ = check_decode(got, full_decode_plain(*args),
                                'full_decode after a weight change')
    if full_decode.captures != captures or torch.equal(got, before):
        raise AssertionError('full_decode: a weight changed in place was '
                             'not served by the replay')
    log(f'full_decode after an in-place weight change: replayed, {ties} '
        f'rows part from the plain version at a near-tie, max abs err '
        f'{err:.4g}')
    w['wfc2'] = w['wfc2'] + (0.3 * w['wfc2'].float().std() * torch.randn(
        w['wfc2'].shape, generator=g, device=out_enc.device)).to(
        w['wfc2'].dtype)
    again = full_decode(*args)
    err, ties, _ = check_decode(again, full_decode_plain(*args),
                                'full_decode after a weight replaced')
    if full_decode.captures != captures + 1 or torch.equal(again, got):
        raise AssertionError('full_decode: a weight replaced by another '
                             'tensor was not captured again')
    log(f'full_decode after a weight replaced by another tensor: '
        f'recaptured, {ties} rows part from the plain version at a '
        f'near-tie, max abs err {err:.4g}')


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device '
                 '(torch.cuda.is_available() is False)')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.models.encoders.nrtr import sequence_mask
    from tps_pp_tpu_torch.ops import _lib, tps as tps_ops
    from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                                  cross_ffn_step_plain,
                                                  self_attn_step,
                                                  self_attn_step_plain)
    from tps_pp_tpu_torch.ops.encoder import (encoder_attention,
                                              encoder_attention_plain,
                                              encoder_forward,
                                              encoder_forward_plain)
    from tps_pp_tpu_torch.ops.gemm import gemm, gemm_plain
    from tps_pp_tpu_torch.ops.full_decode import (_dims, full_decode,
                                                  full_decode_plain,
                                                  graph_bytes)
    from tps_pp_tpu_torch.ops.stem import basic_block_cp, fused_stem_forward
    from tps_pp_tpu_torch.ops.tps_sampler import (
        PLAIN, tps_grid_sample_fused, tps_sampler, tps_sampler_plain,
        tps_sampler_plain_twostage, warp_twostage)

    # plain f32 products on the card stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = card()
    log(f'card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.load()
    log(f'build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}')

    # ---- the flagship, bf16, seeded random weights -----------------------
    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='auto')
    rec = build_recognizer(cfg)
    if rec.device.type != 'cuda':
        raise AssertionError(f'built on {rec.device}, not on the card')
    rec.init_weights(SEED)
    if rec.resolved_decode_mode() != 'fused40_bf16':
        raise AssertionError(f'auto resolved to {rec.resolved_decode_mode()}')
    model = rec.model
    bf, f32 = torch.bfloat16, torch.float32
    g = np.random.default_rng(SEED)
    kernels = []

    def record(name_, src, replaces, fn_k, fn_p, err, reps, moved,
               bf16_flops=0, f32_flops=0, fn_lib=None, calls=1,
               listed=True, label=None):
        """Time the kernel, its plain version and the library call (each
        ``fn`` makes ``calls`` calls) and note the bound of one call; the
        entry goes into the ``kernels`` line when ``listed``, the log line
        in any case (under ``label``, default the name)."""
        bound_ms, bound_by = bound(moved, bf16_flops, f32_flops)
        k = dict(
            name=name_, route='cuda', source=src, replaces=replaces,
            launches=None, max_abs_err=err,
            ms=cuda_ms(fn_k, reps) / calls,
            plain_ms=cuda_ms(fn_p, reps) / calls, bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=None if fn_lib is None else cuda_ms(fn_lib, reps))
        if listed:
            kernels.append(k)
        lib = ('none' if k['library_ms'] is None
               else f'{k["library_ms"]:.4f} ms')
        log(f'{label or name_}: max_abs_err {err:.4g}; {k["ms"]:.4f} ms '
            f'kernel, {k["plain_ms"]:.4f} ms plain, bound {bound_ms:.4f} ms '
            f'({bound_by}), library {lib} [{name}]')

    # ---- kernel 1: TPS++ grid + warp at (B, 32, 128, 64) -> (B, 16, 64, 64)
    tps = model.tpsnet
    inv, P_hat, P = tps.tps_matrices(dev)
    fid = tps_ops.build_C_cell_centers((2, 16))
    feat = torch.from_numpy(g.uniform(-1, 1, (B, 32, 128, 64)).astype(
        np.float32)).to(dev, bf)
    cp = torch.from_numpy((fid[None] + 0.03 * g.standard_normal(
        (B, 32, 2))).astype(np.float32)).to(dev)
    score = torch.from_numpy(np.tanh(g.standard_normal(
        (B, 1024, 32))).astype(np.float32)).to(dev)
    args = (feat, cp, score, inv, P_hat, P, (16, 64))
    out_k = tps_sampler(*args)
    out_p = tps_sampler_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    if not err <= SAMPLER_ATOL:
        raise AssertionError(f'tps_sampler: max abs error {err} > '
                             f'{SAMPLER_ATOL}')
    n_ctrl = inv.shape[0]
    record('tps_sampler', 'tps_pp_tpu_torch/csrc/tps_sampler.cu',
           'tps_pp_tpu/ops/pallas_tps.py:248',
           lambda: tps_sampler(*args), lambda: tps_sampler_plain(*args),
           err, 20, nbytes(feat, cp, score, inv, P_hat, P, out_k),
           # T = inv @ [C'; 0], the modulated P' rows, 4 taps per channel
           f32_flops=B * (2 * n_ctrl * n_ctrl * 2 + 1024 * (
               2 * 32 + 2 * n_ctrl * 2) + 1024 * 64 * 8))

    # ---- kernel 2: the two-stage variant at the same shapes; the second
    # map (with_mp) of both variants ------------------------------------------
    out_k = tps_sampler(*args, variant='twostage')
    out_p = tps_sampler_plain_twostage(*args)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    if not err <= SAMPLER_ATOL:
        raise AssertionError(f'tps_sampler twostage: max abs error {err} > '
                             f'{SAMPLER_ATOL}')
    # float32: the f32 grid's rounding parts the two versions, so each is
    # held against the same function with the grid in float64, the kernel
    # within twice the plain version's error (as kernel 1's float32 test)
    args32 = (feat.float(),) + args[1:]
    got32 = tps_sampler(*args32, variant='twostage')
    want32 = tps_sampler_plain_twostage(*args32)
    f64 = [a.double() for a in args32[:6]]
    exact = warp_twostage(f64[0], tps_ops.build_P_prime(*f64[1:])).reshape(
        got32.shape).float()
    torch.cuda.synchronize()
    err_k = float((got32 - exact).abs().max())
    err_p = float((want32 - exact).abs().max())
    if not err_k <= 2 * err_p:
        raise AssertionError(f'tps_sampler twostage float32: error {err_k} '
                             f'against the float64 grid, plain {err_p}')
    log(f'tps_sampler twostage float32: max abs error against the float64 '
        f'grid {err_k:.4g} kernel, {err_p:.4g} plain')
    del args32, got32, want32, f64, exact
    mp_img = torch.from_numpy(g.uniform(-1, 1, (B, 16, 64, 64)).astype(
        np.float32)).to(dev, bf)
    for variant in ('dense', 'twostage'):
        rect, mp = tps_grid_sample_fused(feat, mp_img, *args[1:],
                                         variant=variant)
        torch.cuda.synchronize()
        errs = [check_close(f'tps_grid_sample_fused {variant} {what}', got,
                            PLAIN[variant](m, *args[1:]), (SAMPLER_ATOL, 0))
                for what, got, m in (('rect', rect, feat), ('mp', mp, mp_img))]
        ms = cuda_ms(lambda v=variant: tps_grid_sample_fused(
            feat, mp_img, *args[1:], variant=v), 20)
        log(f'tps_grid_sample_fused with_mp, {variant}: max abs errors '
            f'{errs[0]:.4g} (rect), {errs[1]:.4g} (mp); {ms:.4f} ms, both '
            f'maps in one launch [{name}]')
    del rect, mp, mp_img
    record('tps_sampler_twostage', 'tps_pp_tpu_torch/csrc/tps_sampler.cu',
           'tps_pp_tpu/ops/pallas_tps.py:86',
           lambda: tps_sampler(*args, variant='twostage'),
           lambda: tps_sampler_plain_twostage(*args), err, 20,
           nbytes(feat, cp, score, inv, P_hat, P, out_k),
           f32_flops=B * (2 * n_ctrl * n_ctrl * 2 + 1024 * (
               2 * 32 + 2 * n_ctrl * 2) + 1024 * 64 * 8))

    # ---- kernels 11 and 12: the fused stem's convolutions ----------------
    conv_launches = stem_checks(dev, g, record)

    # ---- kernel 3: whole encoder at (B, 64, 512) --------------------------
    vr = torch.from_numpy(g.uniform(0.3, 1.0, B).astype(np.float32)).to(dev)
    mask = sequence_mask(vr, 64)
    x = torch.from_numpy(g.standard_normal((B, 64, 512)).astype(
        np.float32)).to(dev, bf)
    w_enc = model.encoder.folded_weights(bf)
    enc_k = encoder_forward(x, mask, w_enc, 8)
    enc_p = encoder_forward_plain(x, mask, w_enc, 8)
    torch.cuda.synchronize()
    d = (enc_k.float() - enc_p.float()).abs()
    err = float(d.max())
    if bool((d > ENCODER_ATOL + ENCODER_RTOL * enc_p.float().abs()).any()):
        raise AssertionError(f'encoder: max abs error {err} beyond atol '
                             f'{ENCODER_ATOL} rtol {ENCODER_RTOL}')
    Le, De, HDe = w_enc['wqkv'].shape[0], 512, w_enc['wfc'].shape[1]
    DIe = w_enc['w1'].shape[2]
    # the library yardstick: nn.TransformerEncoder with the same weights
    te = transformer_encoder_yardstick(model.encoder, bf)
    pad = mask <= 0

    def te_call():
        with torch.no_grad():
            return te(x, src_key_padding_mask=pad)

    err_te = float((te_call().float() - enc_p.float()).abs().max())
    # the encoder's four products and its attention on the products' matmul
    # (bf16) rate; the attention's score and weighted sum are bf16 products
    # too (tps_pp_tpu/ops/pallas_encoder.py:56-70 rounds their operands)
    record('encoder', 'tps_pp_tpu_torch/csrc/encoder.cu',
           'tps_pp_tpu/ops/pallas_encoder.py:178',
           lambda: encoder_forward(x, mask, w_enc, 8),
           lambda: encoder_forward_plain(x, mask, w_enc, 8), err, 5,
           nbytes(x, mask, enc_k, *w_enc.values()),
           bf16_flops=2 * B * 64 * Le * (De * 3 * HDe + HDe * De +
                                         2 * De * DIe) +
           4 * B * 8 * 64 * 64 * 64 * Le, fn_lib=te_call)
    feat_enc = x.reshape(B, 4, 16, De)

    def module_call():
        with torch.no_grad():
            return model.encoder(feat_enc, vr)

    ms_mod = cuda_ms(module_call, 5)
    log(f'encoder, module path (cuBLAS products, f32 attention): '
        f'{ms_mod:.4f} ms; nn.TransformerEncoder max abs difference from '
        f'the plain version {err_te:.4g} [{name}]')
    del te

    # ---- kernel 3's parts alone at its shapes: the GEMM with each
    # product's epilogue (and the whole decode's K/V projection), the
    # attention with a fully masked image ------------------------------------
    Me = B * 64
    y_e = torch.from_numpy(g.standard_normal((Me, De)).astype(
        np.float32)).to(dev, bf)
    x32_e = torch.from_numpy(g.standard_normal((Me, De)).astype(
        np.float32)).to(dev)
    wkv = model.decoder.packed_weights(bf)['wkv_enc']
    parts = (('QKV', y_e, w_enc['wqkv'][0], dict(bias=w_enc['bqkv'][0])),
             ('fc', y_e, w_enc['wfc'][0],
              dict(residual=x32_e, out_dtype=f32, ln=True)),
             ('W1', y_e, w_enc['w1'][0], dict(bias=w_enc['b1'][0],
                                                gelu=True)),
             ('W2', y_e[:, :DIe].contiguous(), w_enc['w2'][Le - 1],
              dict(bias=w_enc['b2'][Le - 1], residual=x32_e, out_dtype=f32,
                   ln=True, ln_s=w_enc['lnf_s'], ln_b=w_enc['lnf_b'])),
             ('decode K/V projection', y_e, wkv, {}))
    for what, a_, b_, kw in parts:
        got = gemm(a_, b_, **kw)
        want = gemm_plain(a_, b_, **kw)
        torch.cuda.synchronize()
        errs = [check_close(f'gemm {what}', gt, wt,
                            (1e-3, 1e-4) if gt.dtype == f32
                            else (2e-2, 2 ** -7))
                for gt, wt in zip(*((got, want) if kw.get('ln')
                                    else ((got,), (want,))))]
        ms_k = cuda_ms(lambda: gemm(a_, b_, **kw), 10)
        ms_t = cuda_ms(lambda: a_ @ b_, 10)
        Nn, Kk = b_.shape[1], b_.shape[0]
        bmin, by = bound(nbytes(a_, b_, got if not kw.get('ln') else got[0],
                                *(t for t in kw.values()
                                  if isinstance(t, torch.Tensor))),
                         2 * Me * Nn * Kk)
        log(f'gemm {what} ({Me} x {Nn} x {Kk}): max abs errors '
            f'{", ".join(f"{e:.4g}" for e in errs)}; {ms_k:.4f} ms kernel, '
            f'{ms_t:.4f} ms torch.matmul (product only), bound {bmin:.4f} '
            f'ms ({by}) [{name}]')
    qkv_e = torch.from_numpy(g.standard_normal((Me, 3 * HDe)).astype(
        np.float32)).to(dev, bf)
    mask_e = mask.clone()
    mask_e[1] = 0.0
    att_k = encoder_attention(qkv_e, mask_e, 8)
    err_a = check_close('encoder attention', att_k,
                        encoder_attention_plain(qkv_e, mask_e, 8),
                        (2e-2, 2 ** -7))
    ms_a = cuda_ms(lambda: encoder_attention(qkv_e, mask_e, 8), 10)
    bmin, by = bound(nbytes(qkv_e, mask_e, att_k), 4 * B * 8 * 64 ** 3)
    log(f'encoder attention (B={B}, one layer; image 1 fully masked): max '
        f'abs error {err_a:.4g}; {ms_a:.4f} ms kernel, bound {bmin:.4f} ms '
        f'({by}) [{name}]')
    del y_e, x32_e, qkv_e, att_k, got, want

    # ---- kernels 4 and 5: whole greedy decode, one captured CUDA graph, at
    # N=64 (listed) and at the serving batch, bf16 and int8 encoder K/V ----
    dec = model.decoder
    lc = rec.label_convertor
    w_dec = dec.packed_weights(bf)
    dd = _dims(w_dec, 8)
    for n_rows in (N_DECODE, B):
        out_enc = enc_p[:n_rows].contiguous()
        src_mask = mask[:n_rows].contiguous()
        for enc_dtype, kname in (('bfloat16', 'full_decode'),
                                 ('int8', 'full_decode_int8')):
            dargs = (out_enc, src_mask, w_dec, 8, lc.start_idx, lc.end_idx,
                     enc_dtype)
            captures = full_decode.captures
            pk = full_decode(*dargs)
            again = full_decode(*dargs)
            pp = full_decode_plain(*dargs)
            torch.cuda.synchronize()
            if full_decode.captures != captures + 1 or \
                    not torch.equal(pk, again):
                raise AssertionError(
                    f'{kname} N={n_rows}: {full_decode.captures - captures} '
                    f'captures in two calls, replay equal to the first call: '
                    f'{torch.equal(pk, again)}')
            err, ties, widest = check_decode(pk, pp, f'{kname} N={n_rows}')
            steps = full_decode.last_steps
            mm_ops, att_ops = decode_flops(dd, n_rows, steps, 64)
            # the encoder K/V that every step reads again, at the memory rate
            kv_ms = nbytes(out_enc) * 2 * dd['L'] * dd['HD'] // dd['D'] // (
                1 + (enc_dtype == 'int8')) / PEAK_BYTES * 1e3
            held = max(v for k, v in graph_bytes(w_dec).items()
                       if k[1] == n_rows and k[3] == (enc_dtype == 'int8'))
            log(f'{kname} N={n_rows}: {ties} of {n_rows} rows part at a '
                f'near-tie (top-2 gap at most {widest:.3g}); {steps} steps '
                f'run; replay equal to the first call; encoder K/V floor '
                f'{kv_ms:.4f} ms a step, {steps * kv_ms:.4f} ms a decode; '
                f'the captured decode holds {held / 2 ** 20:.1f} MiB')
            record(kname, 'tps_pp_tpu_torch/csrc/full_decode.cu',
                   'tps_pp_tpu/ops/pallas_full_decode.py:378',
                   lambda a=dargs: full_decode(*a),
                   lambda a=dargs: full_decode_plain(*a), err, 3,
                   nbytes(out_enc, src_mask, pk, *w_dec.values()),
                   bf16_flops=mm_ops, f32_flops=att_ops,
                   listed=n_rows == N_DECODE, label=f'{kname} N={n_rows}')
    decode_graph_checks(w_dec, enc_p[:N_DECODE].contiguous(),
                        mask[:N_DECODE].contiguous(), lc)

    # ---- kernels 6 and 7: one decode step of one layer at N=B ------------
    ws = {k: v[0] for k, v in dec.step_weights().items()}
    sa_w = (ws['wqkv'], ws['wfc1'], ws['ln1_s'], ws['ln1_b'])
    cf_w = tuple(ws[k] for k in ('wq2', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1',
                                 'w2', 'b2', 'ln3_s', 'ln3_b'))
    T = dec.max_seq_len + 1
    xs = torch.from_numpy(g.standard_normal((B, 512)).astype(
        np.float32)).to(dev, bf)
    ck0 = torch.from_numpy(g.standard_normal((B, 8, T, 64)).astype(
        np.float32)).to(dev, bf)
    cv0 = torch.from_numpy(g.standard_normal((B, 8, T, 64)).astype(
        np.float32)).to(dev, bf)
    with torch.inference_mode():
        ek, ev = (a.contiguous() for a in
                  dec.layer_stack[0].enc_attn.project_kv(enc_p))
    err6 = err7 = 0.0
    # bf16 at B, and the f32 variants at the small batch the f32 model
    # serves
    for dt, n in ((bf, B), (f32, B_SMALL)):
        xd, ckd, cvd, ekd, evd = (a[:n].to(dt).contiguous() for a in
                                  (xs, ck0, cv0, ek, ev))
        for t in (0, 1, 20, T - 2):
            ck, cv, ckp, cvp = (ckd.clone(), cvd.clone(), ckd.clone(),
                                cvd.clone())
            got, _, _ = self_attn_step(xd, ck, cv, t, *sa_w)
            want, _, _ = self_attn_step_plain(xd, ckp, cvp, t, *sa_w)
            torch.cuda.synchronize()
            err6 = max(err6, check_close(f'self_attn_step {dt} N={n} t={t}',
                                         got, want, (STEP_ATOL, STEP_RTOL)))
            for c, cp_, c0 in ((ck, ckp, ckd), (cv, cvp, cvd)):
                err6 = max(err6, check_close(
                    f'self_attn_step {dt} N={n} t={t} cache', c[:, :, t],
                    cp_[:, :, t], (STEP_ATOL, STEP_RTOL)))
                keep = torch.arange(T, device=dev) != t
                if not (torch.equal(c[:, :, keep], c0[:, :, keep]) and
                        torch.equal(cp_[:, :, keep], c0[:, :, keep])):
                    raise AssertionError(f'self_attn_step {dt} N={n} t={t}: '
                                         f'a cache slot other than t changed')
        got = cross_ffn_step(xd, ekd, evd, mask[:n].contiguous(), *cf_w)
        want = cross_ffn_step_plain(xd, ekd, evd, mask[:n].contiguous(),
                                    *cf_w)
        torch.cuda.synchronize()
        err7 = max(err7, check_close(f'cross_ffn_step {dt} N={n}', got, want,
                                     (STEP_ATOL, STEP_RTOL)))
    log(f'self_attn_step at t = 0, 1, 20, {T - 2} and cross_ffn_step '
        f'(bf16 B={B}, f32 B={B_SMALL}): max abs errors {err6:.4g}, '
        f'{err7:.4g}; caches equal outside slot t')
    ck, cv = ck0.clone(), cv0.clone()
    S = dec.max_seq_len
    slot = nbytes(ck[:, :, 0])                  # one slot of K (or V)
    record('self_attn_step', 'tps_pp_tpu_torch/csrc/decode_step.cu',
           'tps_pp_tpu/ops/pallas_decode.py:122',
           lambda: [self_attn_step(xs, ck, cv, t, *sa_w) for t in range(S)],
           lambda: [self_attn_step_plain(xs, ck, cv, t, *sa_w)
                    for t in range(S)], err6, 3,
           # the mean step of the 40: reads t slots, writes slot t
           nbytes(xs, xs, *sa_w) + 2 * slot * ((S - 1) / 2 + 1),
           bf16_flops=2 * B * (512 * 3 * 512 + 512 * 512),
           f32_flops=4 * B * 512 * (S + 1) / 2, calls=S)
    record('cross_ffn_step', 'tps_pp_tpu_torch/csrc/decode_step.cu',
           'tps_pp_tpu/ops/pallas_decode.py:219',
           lambda: cross_ffn_step(xs, ek, ev, mask, *cf_w),
           lambda: cross_ffn_step_plain(xs, ek, ev, mask, *cf_w), err7, 20,
           nbytes(xs, ek, ev, mask, xs, *cf_w),
           bf16_flops=2 * B * (2 * 512 * 512 + 2 * 512 * 256),
           f32_flops=4 * B * 512 * 64)
    del ck, cv, ck0, cv0, ek, ev

    # ---- kernels 8-10: the training warp at B_TRAIN, bf16 and f32 --------
    warp_args = warp_checks(dev, g, record, name)

    # ---- the serving paths through the user's entry point ----------------
    h, w, c = FLAGSHIP_INPUT
    img = torch.from_numpy(g.standard_normal((B, h, w, c)).astype(
        np.float32)).to(dev, bf)
    small = {5: [1.0, 0.55, 0.8, 0.3, 0.95],
             B_SMALL: [1.0, 0.55, 0.8, 0.3, 0.95, 0.6, 0.45, 1.0]}
    rec_fs = build_recognizer(dict(cfg, decoder=dict(
        cfg['decoder'], use_fused_step=True)))
    rec_fs.model.load_state_dict(rec.model.state_dict())
    rec_fs.decode_mode = 'steps'
    widths = steps_tie_widths(rec_fs, img)
    tie_steps = max(NEAR_TIE, TIE_MULT * widths['module'][1])
    log(f'steps near-ties at B={B} (rows that part, widest top-2 gap): '
        f'module decode, kernel vs plain sampler {widths["module"]}; fused '
        f'step, kernels vs plain on one encoding {widths["kernels"]}; fused '
        f'step path vs plain path {widths["path"]}; near-tie of the '
        f'fused-step path {tie_steps:.4g}')
    for k in ('kernels', 'path'):
        if not widths[k][1] < tie_steps:
            raise AssertionError(f'steps {k}: parts at a top-2 gap of '
                                 f'{widths[k][1]:.4g} >= {tie_steps:.4g}')
    sw = stem_tie_widths(rec, img)
    tie_stem = max(NEAR_TIE, TIE_MULT * sw['module'][1])
    log(f'fused stem near-ties at B={B} (rows that part, widest top-2 gap): '
        f'module stem vs the fused stem, both plain {sw["module"]}; fused '
        f'stem kernels vs plain, the rest on kernels {sw["kernel"]}; '
        f'fused-stem path vs plain path {sw["path"]}; near-tie of the '
        f'fused-stem path {tie_stem:.4g}')
    for k in ('kernel', 'path'):
        if not sw[k][1] < tie_stem:
            raise AssertionError(f'fused stem {k}: parts at a top-2 gap of '
                                 f'{sw[k][1]:.4g} >= {tie_stem:.4g}')
    # path: (recognizer, decode mode, stem mode, sampler variant, small
    # batch, near-tie of the argmax rule, {kernel: its count})
    paths = {
        'fused40_bf16': (rec, 'fused40_bf16', 'xla', 'dense', 5, NEAR_TIE, {
            'tps_sampler': lambda: tps_sampler.launches,
            'encoder': lambda: encoder_forward.launches,
            'full_decode': lambda: full_decode.launches}),
        'fused40': (rec, 'fused40', 'xla', 'dense', 5, NEAR_TIE, {
            'tps_sampler': lambda: tps_sampler.launches,
            'encoder': lambda: encoder_forward.launches,
            'full_decode_int8': lambda: full_decode.launches_int8}),
        'steps, use_fused_step': (
            rec_fs, 'steps', 'xla', 'dense', B_SMALL, tie_steps, {
                'tps_sampler': lambda: tps_sampler.launches,
                'self_attn_step': lambda: self_attn_step.launches,
                'cross_ffn_step': lambda: cross_ffn_step.launches}),
        'fused40_bf16, fused stem': (
            rec, 'fused40_bf16', 'fused', 'dense', 5, tie_stem, {
                'basic_block_cp': lambda: basic_block_cp.launches,
                'tps_sampler': lambda: tps_sampler.launches,
                'encoder': lambda: encoder_forward.launches,
                'full_decode': lambda: full_decode.launches}),
        'fused40_bf16, two-stage sampler': (
            rec, 'fused40_bf16', 'xla', 'twostage', 5, NEAR_TIE, {
                'tps_sampler_twostage':
                    lambda: tps_sampler.launches_twostage,
                'encoder': lambda: encoder_forward.launches,
                'full_decode': lambda: full_decode.launches}),
    }
    wrappers = (tps_sampler, encoder_forward, full_decode, self_attn_step,
                cross_ffn_step, basic_block_cp)
    S, NC = rec.max_seq_len, lc.num_classes() - 1

    def serve(r, mode, stem_mode='xla', variant='dense', plain=False):
        """``r`` on decode ``mode``, ``stem_mode`` and the sampler
        ``variant`` (``TPS_SAMPLER_VARIANT``, which the flagship's
        ``sample_mode='pallas'`` reads), the kernels or, with ``plain``,
        their plain versions."""
        r.decode_mode, r.stem_mode, r.plain = mode, stem_mode, plain
        os.environ['TPS_SAMPLER_VARIANT'] = variant
        return r

    path_launches = {}
    for pname, (r, mode, stem_mode, variant, n_small, near_tie,
                counts) in paths.items():
        serve(r, mode, stem_mode, variant)
        im_s, vr_s = img[:n_small].contiguous(), small[n_small]
        for fn in wrappers:
            fn.launches = 0
        full_decode.launches_int8 = tps_sampler.launches_twostage = 0
        res = r.simple_test(img)
        res_s = r.simple_test(im_s, vr_s)
        torch.cuda.synchronize()
        got = {k: f() for k, f in counts.items()}
        log(f'{pname}: launches {got}')
        if min(got.values()) < 1:
            raise AssertionError(f'{pname}: a kernel of the path did not '
                                 f'launch: {got}')
        # the fused stem: 7 blocks a predict (layer1's 3, layer2's 4), two
        # predicts; the two-stage sampler replaces the dense one
        if stem_mode == 'fused' and got['basic_block_cp'] != 7 * 2:
            raise AssertionError(f'{pname}: {got["basic_block_cp"]} block '
                                 f'launches in two predicts, not 14')
        if variant == 'twostage' and tps_sampler.launches:
            raise AssertionError(f'{pname}: the dense sampler launched '
                                 f'{tps_sampler.launches} times')
        if mode.startswith('fused40'):
            # the whole decode of a batch is a replay of its bucket's graph
            captures = full_decode.captures
            r.predict(img)
            torch.cuda.synchronize()
            if full_decode.captures != captures:
                raise AssertionError(f'{pname}: a second batch of {B} '
                                     f'captured its decode again')
        for k, n in got.items():
            path_launches.setdefault(k, n)
        for rr in res + res_s:
            if not isinstance(rr['text'], str) or not np.all(
                    np.isfinite(rr['score'])):
                raise AssertionError(f'{pname}: bad result {rr}')
        if len(res) != B or len(res_s) != n_small:
            raise AssertionError(f'{pname}: wrong number of results')
        log(f'{pname}: {len(res)} + {len(res_s)} results; first texts '
            f'{[rr["text"] for rr in res[:3]]}')
        # argmax of the kernel path against the plain path on both batches
        for what, (im, v) in ((f'B={B}', (img, None)),
                              (f'B={n_small}', (im_s, vr_s))):
            pk = r.predict(im, v)
            r.plain = True
            pp = r.predict(im, v)
            r.plain = False
            if tuple(pk.shape) != (im.shape[0], S, NC) or not bool(
                    torch.isfinite(pk).all()):
                raise AssertionError(f'{pname} {what}: bad output '
                                     f'{tuple(pk.shape)}')
            err, ties, widest = check_decode(pk, pp, f'{pname} {what}',
                                             near_tie)
            same = int((pk.argmax(-1) == pp.argmax(-1)).all(-1).sum())
            log(f'{pname} {what}: argmax equal to the plain path on {same} '
                f'of {im.shape[0]} rows, {ties} part at a near-tie (top-2 '
                f'gap at most {widest:.3g} < {near_tie}); max abs err '
                f'{err:.4g}; step 0 max abs err '
                f'{float((pk[:, 0] - pp[:, 0]).abs().max()):.4g}')
    serve(rec, 'fused40_bf16')

    # ---- a float32 model serves through `steps`, at the small batch: the
    # f32 variants of the sampler, of the step kernels and of the stem's
    # blocks -------------------------------------------------------------
    im_s, vr_s = img[:B_SMALL].contiguous(), small[B_SMALL]
    for fused, stem_mode in ((False, 'xla'), (True, 'xla'),
                             (False, 'fused')):
        cfg32 = nrtr_tps_pp_cfg(decode_mode='steps')
        cfg32['decoder'] = dict(cfg32['decoder'], use_fused_step=fused)
        r32 = build_recognizer(dict(cfg32, stem_mode=stem_mode))
        r32.model.load_state_dict(rec.model.state_dict())
        what = (f'float32 steps{", use_fused_step" if fused else ""}'
                f'{", fused stem" if stem_mode == "fused" else ""}')
        for fn in wrappers:
            fn.launches = 0
        pk = r32.predict(im_s, vr_s)
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in wrappers}
        if r32.dtype != f32 or got['tps_sampler'] < 1 or fused != (
                min(got['self_attn_step'], got['cross_ffn_step']) > 0) or \
                got['basic_block_cp'] != 7 * (stem_mode == 'fused'):
            raise AssertionError(f'{what}: launches {got}')
        r32.plain = True
        pp = r32.predict(im_s, vr_s)
        if tuple(pk.shape) != (B_SMALL, S, NC) or not bool(
                torch.isfinite(pk).all()):
            raise AssertionError(f'{what}: bad output {tuple(pk.shape)}')
        err, ties, widest = check_decode(pk, pp, what)
        log(f'{what} B={B_SMALL}: launches {got}; {ties} rows part from the '
            f'plain path at a near-tie (top-2 gap at most {widest:.3g} < '
            f'{NEAR_TIE}); max abs err {err:.4g}')
        del r32

    # ---- warm throughput at B=512, the paths in turns ---------------------
    # (recognizer, decode mode, stem mode, sampler variant, plain)
    timed = {'fused40_bf16': (rec, 'fused40_bf16', 'xla', 'dense', False),
             'fused40': (rec, 'fused40', 'xla', 'dense', False),
             'steps, use_fused_step': (rec_fs, 'steps', 'xla', 'dense',
                                       False),
             'fused40_bf16, fused stem': (rec, 'fused40_bf16', 'fused',
                                          'dense', False),
             'fused40_bf16, two-stage sampler': (rec, 'fused40_bf16', 'xla',
                                                 'twostage', False),
             'fused40_bf16, plain': (rec, 'fused40_bf16', 'xla', 'dense',
                                     True)}
    times = {k: [] for k in timed}
    for _ in range(2):
        for k, (r, *setting) in timed.items():
            serve(r, *setting)
            r.predict(img)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                r.predict(img)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / 3)
    for k, ts in times.items():
        log(f'slice B={B} {k}: {B / min(ts):.1f} images/s '
            f'({min(ts) * 1e3:.2f} ms/batch, best of 2 rounds of 3) '
            f'[{name}]')
    serve(rec, 'fused40_bf16')
    serve(rec_fs, 'steps')
    rec_fs.predict(img[:B_SMALL])
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        rec_fs.predict(img[:B_SMALL])
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    log(f'slice B={B_SMALL} steps, use_fused_step: {min(ts) * 1e3:.2f} '
        f'ms/batch (best of 5) [{name}]')
    # the module stem against the fused stem (stem + layer1 + layer2), in
    # turns, CUDA events
    stems = {'module': lambda: model.backbone.stem_and_head(img),
             'fused': lambda: fused_stem_forward(model.backbone, img, bf)}
    with torch.inference_mode():
        for k in ('module', 'fused', 'fused', 'module'):
            log(f'stem B={B}, {k}: {cuda_ms(stems[k], 5):.3f} ms (stem + '
                f'layer1 + layer2) [{name}]')
    serve(rec, 'auto')
    os.environ.pop('TPS_SAMPLER_VARIANT')
    del rec, rec_fs, model

    # ---- the training slice ------------------------------------------------
    launches = train_slice(dev, g, name, warp_args)
    path_launches.update(launches)
    path_launches['conv3x3_cp'] = conv_launches
    for k in kernels:
        k['launches'] = path_launches.get(k['name'])
    if any(not k['launches'] for k in kernels):
        raise AssertionError(f'a kernel was not launched: {kernels}')

    for k in kernels:
        k['max_abs_err'] = float(k['max_abs_err'])
    print(json.dumps({'kernels': kernels}), flush=True)
    print(name, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
