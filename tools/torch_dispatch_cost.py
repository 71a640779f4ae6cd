#!/usr/bin/env python3
"""What reaching the port's kernels through PyTorch operators costs on the
host.

    python tools/torch_dispatch_cost.py [--rounds 2] [--batch 512]

Each wrapper of ``tps_pp_tpu_torch/ops`` calls its kernel through an
operator of ``torch.ops.tps_pp`` (``ops/_lib.py`` ``define_op``, registered
with ``torch.library.Library(...).impl``). This times the flagship in bf16
(seed-0 weights, seed-0 ``standard_normal`` crops on the card) by three
routes to the same kernels, in turns:

* ``library``: as shipped;
* ``direct``: each wrapper calls its CUDA kernel's Python function itself,
  with no dispatcher between (the wrappers before the operators);
* ``custom_op``: the same kernels registered again with
  ``torch.library.custom_op`` under the namespace ``tps_pp_co``.

Run from the root of a tree whose package predates the operators (no
``ops._lib.OP_KERNELS``), it times that tree's one route, ``shipped``: so
one call can hold a parent commit against this one, in turns.

For each route: the host microseconds of one call of ``self_attn_step``
and of ``cross_ffn_step`` at B=8 (the median of 10 runs of 200 calls
enqueued back to back, each run timed on the host clock before it
synchronises: the launch queue holds them, so this is the host's cost of a
call, dispatch included); the ms of one ``predict`` of ``B_SMALL`` = 8
crops in ``steps`` with ``use_fused_step`` (kernels 6 and 7 at 240
launches each a decode; the best and the median of 10 after one warm
call) and the images/s of ``--batch`` crops in ``fused40_bf16``
(``bench_torch.py``'s measurement: 2 warm batches, then 6 between two
synchronisations). Prints one line a route and round, then a JSON line
with the best of each and the card. Needs a CUDA GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def op_slots():
    """(module, attribute, operator name) of every wrapper's operator."""
    import torch
    from tps_pp_tpu_torch.ops import (_lib, decode_step, encoder,
                                      full_decode, gemm, grid_sample, stem,
                                      tps_sampler)
    slots = []
    for mod in (decode_step, encoder, full_decode, gemm, grid_sample, stem,
                tps_sampler):
        for attr, val in list(vars(mod).items()):
            for name in _lib.OP_KERNELS:
                if val is getattr(torch.ops.tps_pp, name):
                    slots.append((mod, attr, name))
    return slots


def routes():
    """{route: {operator name: the callable a wrapper calls}}; a tree
    without operators has one route, ``shipped``, and nothing to swap."""
    import torch
    from tps_pp_tpu_torch.ops import (_lib, decode_step, encoder,  # noqa
                                      full_decode, gemm, grid_sample, stem,
                                      tps_sampler)
    if not hasattr(_lib, 'OP_KERNELS'):
        return {'shipped': {}}
    out = {'library': {}, 'direct': {}, 'custom_op': {}}
    for name, (schema, cuda) in _lib.OP_KERNELS.items():
        out['library'][name] = getattr(torch.ops.tps_pp, name)
        out['direct'][name] = cuda
        mutates = ('ck', 'cv') if name == 'self_attn_step' else ()
        out['custom_op'][name] = torch.library.custom_op(
            f'tps_pp_co::{name}', cuda, mutates_args=mutates,
            device_types='cuda', schema=schema)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--rounds', type=int, default=2)
    p.add_argument('--batch', type=int, default=512)
    args = p.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_dispatch_cost: no CUDA device')
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    name = card()
    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='fused40_bf16')
    rec = build_recognizer(cfg).init_weights(0)
    cfg_fs = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='steps')
    cfg_fs['decoder'] = dict(cfg_fs['decoder'], use_fused_step=True)
    rec_fs = build_recognizer(cfg_fs)
    rec_fs.model.load_state_dict(rec.model.state_dict())
    h, w, c = FLAGSHIP_INPUT
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, h, w, c)).astype(np.float32)).to('cuda', torch.bfloat16)
    small = img[:8].contiguous()
    table = routes()
    slots = op_slots() if 'library' in table else []

    def use(route):
        for mod, attr, op in slots:
            setattr(mod, attr, table[route][op])

    def steps_ms():
        rec_fs.predict(small)
        torch.cuda.synchronize()
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            rec_fs.predict(small)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3, float(np.median(ts)) * 1e3

    # one layer's step at B=8, as the steps decode calls it
    from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                                  self_attn_step)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to('cuda', torch.bfloat16)
    sa_w, cf_w = rec_fs.model.decoder._step_layer_args()[0]
    x, ck, cv = r(8, 512), r(8, 8, 41, 64), r(8, 8, 41, 64)
    ek, ev = r(8, 8, 64, 64), r(8, 8, 64, 64)
    mask = torch.ones((8, 64), device='cuda')
    calls = {'self_attn_step': lambda: self_attn_step(x, ck, cv, 5, *sa_w),
             'cross_ffn_step': lambda: cross_ffn_step(x, ek, ev, mask,
                                                      *cf_w)}

    def per_call_us():
        out = {}
        with torch.inference_mode():
            for k, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                runs = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    for _ in range(200):
                        fn()
                    runs.append((time.perf_counter() - t0) / 200 * 1e6)
                    torch.cuda.synchronize()
                out[k] = float(np.median(runs))
        return out

    def images_s():
        with torch.inference_mode():
            for _ in range(2):
                rec._predict_impl(rec.model, img, torch.ones(
                    args.batch, device='cuda'))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(6):
                rec._predict_impl(rec.model, img, torch.ones(
                    args.batch, device='cuda'))
            torch.cuda.synchronize()
        return 6 * args.batch / (time.perf_counter() - t0)

    order = list(table)
    best = {k: {'call_us': {}, 'steps_b8_ms': float('inf'),
                'steps_b8_median_ms': float('inf'), 'images_s': 0.0}
            for k in order}
    for rnd in range(args.rounds):
        for route in (order if rnd % 2 == 0 else order[::-1]):
            use(route)
            us = per_call_us()
            (ms, med), ips = steps_ms(), images_s()
            b = best[route]
            b['call_us'] = {k: min(v, b['call_us'].get(k, v))
                            for k, v in us.items()}
            b['steps_b8_ms'] = min(b['steps_b8_ms'], ms)
            b['steps_b8_median_ms'] = min(b['steps_b8_median_ms'], med)
            b['images_s'] = max(b['images_s'], ips)
            print(f'round {rnd} {route}: host us a call '
                  f'{ {k: round(v, 2) for k, v in us.items()} }; steps, '
                  f'use_fused_step B=8 {ms:.3f} ms (median {med:.3f}); '
                  f'fused40_bf16 B={args.batch} {ips:.1f} images/s '
                  f'[{name}]', flush=True)
    use(order[0])
    print(json.dumps({'card': name, 'root': os.getcwd(), 'best': best}),
          flush=True)


if __name__ == '__main__':
    main()
