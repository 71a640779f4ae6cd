#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path and training step,
on one CUDA GPU.

    python tools/torch_profile_slice.py [--stages serve,train] [--batch 512]
        [--train-batch 256] [--trace DIR]

Builds the full-width NRTR + TPS++ flagship with seeded random weights.

* ``serve`` (bf16): times each stage of ``decode_full_fused``
  (``extract_feat``, the encoder, the decode with and without the EOS
  check) and ``predict`` on the kernel path and on the plain path, with
  CUDA events; then profiles one ``predict`` on the kernel path.
* ``train`` (f32 parameters and Adam state, bf16 autocast, dropout 0.1,
  Adam at 1e-4 with grad clip 5.0, random DICT90 labels): times the
  forward (``compute_loss``), the backward and the optimizer step of a
  training step on the kernel path and on the plain path, with CUDA
  events; then profiles one step on the kernel path.

A profile reports the device's idle share over the kernel window, the
device time of the grid_sample kernels, and the device time of each
kernel, summed by name. With ``--trace`` the Chrome traces are written
there. Every timing line carries the card's ``nvidia-smi`` name and power
limit.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile


def smi(query):
    return subprocess.run(
        ['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
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


def kernel_table(trace_path):
    """(window ms, busy ms, {kernel name: (ms, count)}) of a Chrome trace's
    device events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and e.get('cat') in
                  ('kernel', 'gpu_memcpy', 'gpu_memset')]
    events.sort(key=lambda e: e['ts'])
    busy, cur = 0.0, None
    for e in events:
        s, f = e['ts'], e['ts'] + e['dur']
        if cur is None or s > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [s, f]
        else:
            cur[1] = max(cur[1], f)
    busy += cur[1] - cur[0]
    window = max(e['ts'] + e['dur'] for e in events) - events[0]['ts']
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        name = e['name'].replace('(anonymous namespace)::', '')
        by_name[name.split('(')[0]][0] += e['dur'] / 1e3
        by_name[name.split('(')[0]][1] += 1
    return window / 1e3, busy / 1e3, by_name


def profiled(fn, what, card, out_dir):
    """Profile one call of ``fn`` and print its device summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = os.path.join(out_dir, f'{what.replace(" ", "_")}_trace.json')
    prof.export_chrome_trace(trace)
    window, busy, by_name = kernel_table(trace)
    warp = [(ms, n) for name, (ms, n) in by_name.items()
            if 'grid_sample' in name or 'grid_sampler' in name]
    print(f'profiled {what}: kernel window {window:.3f} ms, busy '
          f'{busy:.3f} ms, idle share {1 - busy / window:.4f}; grid_sample '
          f'kernels {sum(m for m, _ in warp):.3f} ms in '
          f'{sum(n for _, n in warp)} launches [{card}]', flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if ms >= 0.1:
            print(f'  {ms:9.3f} ms {n:6d}x  {name[:90]}')
    return trace


def serve_stage(dev, card, B, out_dir):
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg

    bf = torch.bfloat16
    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16',
                                           decode_mode='auto'), device=dev)
    rec.init_weights(0)
    m, end_idx = rec.model, rec.label_convertor.end_idx
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, 32, 128, 3)).astype(np.float32)).to(dev, bf)
    vr = torch.ones(B, device=dev)
    with torch.inference_mode():
        feat = m.extract_feat(img)
        enc = m.encoder(feat, vr, fused=True)
        for plain in (False, True):
            path = 'plain' if plain else 'kernel'
            stages = (
                ('extract_feat', 5,
                 lambda: m.extract_feat(img, plain=plain)),
                ('encoder', 5,
                 lambda: m.encoder(feat, vr, fused=True, plain=plain)),
                ('decode, EOS check', 3,
                 lambda: m.decoder.fused_full_decode(
                     enc, vr, end_idx=end_idx, plain=plain)),
                ('decode, no exit', 3,
                 lambda: m.decoder.fused_full_decode(enc, vr, plain=plain)))
            for name, reps, fn in stages:
                print(f'{path:6s} {name:18s} {cuda_ms(fn, reps):9.3f} ms '
                      f'(B={B}) [{card}]', flush=True)
        for mode in ('fused40_bf16', 'plain', 'steps'):
            rec.decode_mode = mode
            print(f'predict {mode:12s} '
                  f'{cuda_ms(lambda: rec.predict(img), 3):9.3f} ms '
                  f'(B={B}) [{card}]', flush=True)
        rec.decode_mode = 'fused40_bf16'
        return profiled(lambda: rec.predict(img), 'predict', card, out_dir)


def train_stage(dev, card, B, out_dir):
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.parallel import build_optimizer

    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16'), device=dev,
                           param_dtype='float32').init_weights(0)
    opt, _ = build_optimizer(dict(type='Adam', lr=1e-4,
                                  grad_clip=dict(max_norm=5.0)),
                             rec.model.named_parameters())
    g = np.random.default_rng(0)
    lc = rec.label_convertor
    chars = [c for c in lc.idx2char if len(c) == 1]
    texts = [''.join(g.choice(chars, int(g.integers(1, 26))))
             for _ in range(B)]
    batch = dict(
        img=torch.from_numpy(g.standard_normal((B,) + FLAGSHIP_INPUT).astype(
            np.float32)).to(dev),
        valid_ratio=g.uniform(0.5, 1.0, B).astype(np.float32),
        padded_targets=lc.str2tensor(texts)['padded_targets'])
    gen = torch.Generator(device=dev).manual_seed(1)

    def step(plain, events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        opt.zero_grad()
        total, _ = rec.compute_loss(batch, gen, plain=plain)
        mark(1)
        total.backward()
        mark(2)
        opt.step()
        mark(3)

    reps = 3
    for plain in (False, True):
        step(plain)
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                  for _ in range(reps)]
        for ev in events:
            step(plain, ev)
        torch.cuda.synchronize()
        ms = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / reps
              for i in range(3)]
        path = 'plain' if plain else 'kernel'
        print(f'train {path:6s} forward {ms[0]:9.3f} ms, backward '
              f'{ms[1]:9.3f} ms, optimizer {ms[2]:8.3f} ms, step '
              f'{sum(ms):9.3f} ms, {B / sum(ms) * 1e3:.1f} images/s '
              f'(B={B}, mean of {reps}) [{card}]', flush=True)
    return profiled(lambda: step(False), 'train step', card, out_dir)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--stages', default='serve,train',
                    help='comma-separated: serve, train')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--train-batch', type=int, default=256)
    ap.add_argument('--trace', help='directory for the Chrome traces')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_profile_slice: no CUDA device')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi('name,power.limit')
    dev = torch.device('cuda')
    out_dir = args.trace or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    traces = []
    stages = args.stages.split(',')
    if 'serve' in stages:
        traces.append(serve_stage(dev, card, args.batch, out_dir))
        torch.cuda.empty_cache()
    if 'train' in stages:
        traces.append(train_stage(dev, card, args.train_batch, out_dir))
    if not args.trace:
        for t in traces:
            os.remove(t)
        os.rmdir(out_dir)


if __name__ == '__main__':
    main()
