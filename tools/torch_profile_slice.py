#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one CUDA GPU.

    python tools/torch_profile_slice.py [--batch 512] [--trace DIR]

Builds the full-width NRTR + TPS++ flagship in bf16 with seeded random
weights, then times each stage of ``decode_full_fused`` (``extract_feat``,
the encoder, the decode with and without the EOS check) and ``predict`` on
the kernel path and on the plain path, with CUDA events. Then it profiles
one ``predict`` on the kernel path with ``torch.profiler``: the device's
idle share over the kernel window and the device time of each kernel,
summed by name. With ``--trace`` it writes the Chrome trace there.
Every timing line carries the card's ``nvidia-smi`` name and power limit.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--trace', help='directory for the Chrome trace')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_profile_slice: no CUDA device')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi('name,power.limit')
    dev, bf, B = torch.device('cuda'), torch.bfloat16, args.batch
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
        rec.predict(img)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rec.predict(img)
            torch.cuda.synchronize()
    out_dir = args.trace or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, 'predict_trace.json')
    prof.export_chrome_trace(trace)
    window, busy, by_name = kernel_table(trace)
    print(f'profiled predict: kernel window {window:.3f} ms, busy '
          f'{busy:.3f} ms, idle share {1 - busy / window:.4f} [{card}]')
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if ms >= 0.1:
            print(f'  {ms:9.3f} ms {n:6d}x  {name[:90]}')
    if not args.trace:
        os.remove(trace)
        os.rmdir(out_dir)


if __name__ == '__main__':
    main()
