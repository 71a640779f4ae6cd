#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tps_pp_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the serving path's shapes,
serves the full-width NRTR + TPS++ flagship (bf16, random weights from a
seed) through ``TextRecognizer.simple_test`` on a batch of 512 crops and a
batch of 5 with mixed valid ratios, checks that the kernels carried that
run and that its argmax agrees with the plain path, and times both paths.
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

    for k in kernels:
        k['max_abs_err'] = float(k['max_abs_err'])
    print(json.dumps({'kernels': kernels}), flush=True)
    print(name, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
