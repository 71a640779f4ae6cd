#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tps_pp_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at its path's shapes, then drives
two paths of the full-width NRTR + TPS++ flagship (random weights from a
seed):

* serving (bf16): ``TextRecognizer.simple_test`` on a batch of 512 crops
  and a batch of 5 with mixed valid ratios; the kernels must carry that
  run, its argmax must agree with the plain path, and both paths are timed;
* training (f32 parameters and Adam state, bf16 autocast, B=256, Adam at
  1e-4 with grad clip 5.0, random DICT90 labels): one step from the same
  weights and batch on the kernel path and on the plain path must agree
  (the loss in f32 and bf16 compute; in f32 compute also the grad norm
  and the gradient that reaches the loss only through the warp's d_grid);
  five steps with dropout 0.1 must give finite losses through the
  grid_sample kernels; both paths are timed. The d_img-only backward
  kernel is driven through ``GridSampleFunction`` with a detached grid.

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
SEED = 0

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


def check_decode(kernel_probs, plain_probs, what):
    """The decode rule; returns (max abs error on the agreeing prefix,
    number of rows that part at a near-tie)."""
    div = first_divergence(kernel_probs, plain_probs)
    err, ties = 0.0, 0
    for r, (t, gap) in enumerate(div):
        if t is not None:
            if not gap < NEAR_TIE:
                raise AssertionError(
                    f'{what}: row {r} parts from the plain path at step {t} '
                    f'with a top-2 gap of {gap:.3g} (>= {NEAR_TIE})')
            ties += 1
        stop = kernel_probs.shape[1] if t is None else t
        k, p = kernel_probs[r, :stop].float(), plain_probs[r, :stop].float()
        if stop:
            err = max(err, float((k - p).abs().max()))
            bad = (k - p).abs() > DECODE_ATOL + DECODE_RTOL * p.abs()
            if bool(bad.any()):
                raise AssertionError(f'{what}: row {r} probabilities beyond '
                                     f'atol {DECODE_ATOL} rtol {DECODE_RTOL}')
    return err, ties


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
    record('grid_sample_forward', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:126',
           lambda: grid_sample_forward(img, grid),
           lambda: grid_sample_plain(img, grid), e['fwd'], 20)
    record('grid_sample_grad', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:283',
           lambda: grid_sample_grad(grid, cot, img),
           lambda: grid_sample_grad_plain(grid, cot, img),
           max(e['d_img'], e['d_grid']), 10)
    record('grid_sample_grad_img', src,
           'tps_pp_tpu/ops/pallas_grid_sample.py:178',
           lambda: grid_sample_grad_img(grid, cot, 32, 128),
           lambda: grid_sample_grad_img_plain(grid, cot, 32, 128),
           e['d_img10'], 10)
    return img, grid, cot


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
    from tps_pp_tpu_torch.ops.encoder import (encoder_forward,
                                              encoder_forward_plain)
    from tps_pp_tpu_torch.ops.full_decode import (full_decode,
                                                  full_decode_plain)
    from tps_pp_tpu_torch.ops.tps_sampler import (tps_sampler,
                                                  tps_sampler_plain)

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
    rec = build_recognizer(cfg, device=dev)
    rec.init_weights(SEED)
    if rec.resolved_decode_mode() != 'fused40_bf16':
        raise AssertionError(f'auto resolved to {rec.resolved_decode_mode()}')
    model = rec.model
    bf, f32 = torch.bfloat16, torch.float32
    g = np.random.default_rng(SEED)
    kernels = []

    def record(name_, src, replaces, fn_k, fn_p, err, reps):
        kernels.append(dict(name=name_, route='cuda', source=src,
                            replaces=replaces, launches=None,
                            max_abs_err=err, ms=cuda_ms(fn_k, reps),
                            plain_ms=cuda_ms(fn_p, reps)))
        k = kernels[-1]
        log(f'{name_}: max_abs_err {err:.4g}; {k["ms"]:.4f} ms kernel, '
            f'{k["plain_ms"]:.4f} ms plain [{name}]')

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
    record('tps_sampler', 'tps_pp_tpu_torch/csrc/tps_sampler.cu',
           'tps_pp_tpu/ops/pallas_tps.py:248',
           lambda: tps_sampler(*args), lambda: tps_sampler_plain(*args),
           err, 20)

    # ---- kernel 2: whole encoder at (B, 64, 512) --------------------------
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
    record('encoder', 'tps_pp_tpu_torch/csrc/encoder.cu',
           'tps_pp_tpu/ops/pallas_encoder.py:178',
           lambda: encoder_forward(x, mask, w_enc, 8),
           lambda: encoder_forward_plain(x, mask, w_enc, 8), err, 5)

    # ---- kernel 3: whole greedy decode at N=64, bf16 encoder K/V ---------
    dec = model.decoder
    lc = rec.label_convertor
    w_dec = dec.packed_weights(bf)
    out_enc = enc_p[:N_DECODE].contiguous()
    src_mask = mask[:N_DECODE].contiguous()
    dargs = (out_enc, src_mask, w_dec, 8, lc.start_idx, lc.end_idx)
    pk = full_decode(*dargs)
    pp = full_decode_plain(*dargs)
    torch.cuda.synchronize()
    err, ties = check_decode(pk, pp, 'full_decode')
    log(f'full_decode: {ties} of {N_DECODE} rows part at a near-tie; '
        f'{full_decode.last_steps} steps run')
    record('full_decode', 'tps_pp_tpu_torch/csrc/full_decode.cu',
           'tps_pp_tpu/ops/pallas_full_decode.py:378',
           lambda: full_decode(*dargs), lambda: full_decode_plain(*dargs),
           err, 3)

    # ---- kernels 8-10: the training warp at B_TRAIN, bf16 and f32 --------
    warp_args = warp_checks(dev, g, record, name)

    # ---- the slice through the user's entry point ------------------------
    h, w, c = FLAGSHIP_INPUT
    img = torch.from_numpy(g.standard_normal((B, h, w, c)).astype(
        np.float32)).to(dev, bf)
    img5 = img[:5].contiguous()
    vr5 = [1.0, 0.55, 0.8, 0.3, 0.95]
    wrappers = (tps_sampler, encoder_forward, full_decode)
    for fn in wrappers:
        fn.launches = 0
    res = rec.simple_test(img)
    res5 = rec.simple_test(img5, vr5)
    torch.cuda.synchronize()
    counts = [fn.launches for fn in wrappers]
    for k, n in zip(kernels, counts):
        k['launches'] = n
    log(f'slice launches: {dict(zip([k["name"] for k in kernels], counts))}')
    if min(counts) < 1:
        raise AssertionError(f'a kernel of the path did not launch: {counts}')
    for r in res + res5:
        if not isinstance(r['text'], str) or not np.all(
                np.isfinite(r['score'])):
            raise AssertionError(f'bad result {r}')
    if len(res) != B or len(res5) != 5:
        raise AssertionError('wrong number of results')
    log(f'slice: {len(res)} + {len(res5)} results; first texts '
        f'{[r["text"] for r in res[:3]]}')

    # argmax of the kernel path against the plain path on both batches
    S, NC = rec.max_seq_len, lc.num_classes() - 1
    for what, (im, v) in (('B=512', (img, None)), ('B=5', (img5, vr5))):
        rec.decode_mode = 'fused40_bf16'
        pk = rec.predict(im, v)
        rec.decode_mode = 'plain'
        pp = rec.predict(im, v)
        if tuple(pk.shape) != (im.shape[0], S, NC) or not bool(
                torch.isfinite(pk).all()):
            raise AssertionError(f'{what}: bad output {tuple(pk.shape)}')
        err, ties = check_decode(pk, pp, f'slice {what}')
        same = int((pk.argmax(-1) == pp.argmax(-1)).all(-1).sum())
        log(f'slice {what}: argmax equal to the plain path on {same} of '
            f'{im.shape[0]} rows, {ties} part at a near-tie; max abs err '
            f'{err:.4g}')

    # ---- warm throughput at B=512, the two paths in turns ----------------
    times = {'fused40_bf16': [], 'plain': []}
    for mode in ('fused40_bf16', 'plain', 'fused40_bf16', 'plain'):
        rec.decode_mode = mode
        rec.predict(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            rec.predict(img)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) / 3)
    for mode, ts in times.items():
        log(f'slice B={B} {mode}: {B / min(ts):.1f} images/s '
            f'({min(ts) * 1e3:.2f} ms/batch, best of 2 rounds of 3) '
            f'[{name}]')
    rec.decode_mode = 'auto'
    del rec, model

    # ---- the training slice ------------------------------------------------
    launches = train_slice(dev, g, name, warp_args)
    for k in kernels:
        if k['name'] in launches:
            k['launches'] = launches[k['name']]
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
