#!/usr/bin/env python3
"""Where the time of kernels 9 and 10 (the training warp's VJPs,
``tps_pp_tpu_torch/csrc/grid_sample.cu``) goes, on one CUDA GPU.

Builds ``csrc/grid_sample.cu`` as it is and in variants made by text
substitution, each into its own shared library, and times the two
backward kernels of each at the flagship's training shape (N=256, 16x64
samples of a 32x128x64 bf16 map) on a uniform [-1.3, 1.3]^2 grid and on
TPS++'s own [0, 1]^2 grid, in turns, with CUDA events:

* ``kernel``: the source as it is (checked against the plain version);
* ``no_atomics``: plain shared-memory adds in place of the atomics (wrong
  sums where warps collide; timing only);
* ``no_accumulate``: the listed samples are not added (zero, list, store);
* ``no_store``: the band is not stored;
* ``parent`` (``--parent DIR``): ``DIR/tps_pp_tpu_torch/csrc/grid_sample.cu``,
  an older tree's kernels, for a before-and-after in one run.

Also times a zero fill of d_img's size (what the parent's wrappers paid
before their kernel). Run from the repository root:

    python3 tools/grid_sample_variants.py [--parent DIR] [--reps 20]
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, 'tps_pp_tpu_torch', 'csrc')
N, H, W, C, HO, WO = 256, 32, 128, 64, 16, 64
VARIANTS = {
    'no_atomics': ('''  atomicAdd(p + first, w * (first ? v.y : v.x));
  atomicAdd(p + 1 - first, w * (first ? v.x : v.y));''',
                   '''  p[first] += w * (first ? v.y : v.x);
  p[1 - first] += w * (first ? v.x : v.y);'''),
    'no_accumulate': ('for (int k0 = warp * kU; k0 < nsel;',
                      'for (int k0 = warp * kU; k0 < (nsel & 0);'),
    'no_store': ('''      reinterpret_cast<float4*>(dst)[e] =
          reinterpret_cast<const float4*>(acc)[e];''',
                 '''      if (acc[4 * e] == 12345.f)
        reinterpret_cast<float4*>(dst)[e] =
            reinterpret_cast<const float4*>(acc)[e];'''),
}


def build(sources, out_dir):
    """{name: source text} -> {name: loaded library}, one nvcc each, all
    started together."""
    nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    jobs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        so = os.path.join(out_dir, f'{name}.so')
        cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-shared',
               '-I', CSRC, '-o', so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc {name}: {log[-3000:]}')
        libs[name] = ctypes.CDLL(so)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', help='an older checkout to time beside')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('grid_sample_variants: no CUDA device')
    with open(os.path.join(CSRC, 'grid_sample.cu')) as f:
        src = f.read()
    sources = {'kernel': src}
    for name, (old, new) in VARIANTS.items():
        if old not in src:
            raise RuntimeError(f'variant {name}: its text is not in the '
                               f'source')
        sources[name] = src.replace(old, new)
    if args.parent:
        with open(os.path.join(args.parent, 'tps_pp_tpu_torch', 'csrc',
                               'grid_sample.cu')) as f:
            sources['parent'] = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        run(libs, {k: 'tpk_grid_sample_plan' in v
                   for k, v in sources.items()}, args.reps)


def run(libs, with_plan, reps):
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_grad_img_plain,
                                                  grid_sample_grad_plain)
    dev = torch.device('cuda')
    g = np.random.default_rng(0)
    img = torch.tensor(g.uniform(-1, 1, (N, H, W, C)), dtype=torch.bfloat16,
                       device=dev)
    cot = torch.tensor(g.uniform(-1, 1, (N, HO, WO, C)),
                       dtype=torch.bfloat16, device=dev)
    grids = {'uniform': g.uniform(-1.3, 1.3, (N, HO, WO, 2)),
             'quadrant': g.uniform(0, 1, (N, HO, WO, 2))}
    d_img = torch.empty((N, H, W, C), device=dev)
    d_grid = torch.empty((N, HO, WO, 2), device=dev)
    P = ctypes.c_void_p
    stream = P(torch.cuda.current_stream().cuda_stream)

    def call(name, which, grid):
        lib, tail = libs[name], ()
        if with_plan[name]:
            tail = ((ctypes.c_int * 5)(),)
        else:
            d_img.zero_()          # the older kernels add into zeros
        shape = (N, H, W, C, HO * WO, 1)
        if which == 9:
            rc = lib.tpk_grid_sample_grad(
                P(grid.data_ptr()), P(cot.data_ptr()), P(img.data_ptr()),
                P(d_img.data_ptr()), P(d_grid.data_ptr()), *shape, *tail,
                stream)
        else:
            rc = lib.tpk_grid_sample_grad_img(
                P(grid.data_ptr()), P(cot.data_ptr()), P(d_img.data_ptr()),
                *shape, *tail, stream)
        if rc:
            raise RuntimeError(f'{name} kernel {which}: CUDA error {rc}')

    def ms(fn):
        for _ in range(3):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    for gname, grid_np in grids.items():
        grid = torch.tensor(grid_np, dtype=torch.float32, device=dev)
        want_img, want_grid = grid_sample_grad_plain(grid, cot, img)
        want10 = grid_sample_grad_img_plain(grid, cot, H, W)
        for name in ('kernel', 'parent'):
            if name not in libs:
                continue
            for which, want in ((9, want_img), (10, want10)):
                call(name, which, grid)
                torch.cuda.synchronize()
                err = float((d_img - want).abs().max())
                err_g = (float((d_grid - want_grid).abs().max())
                         if which == 9 else 0.0)
                if not (err <= 5e-2 and err_g <= 0.2):
                    raise AssertionError(f'{name} kernel {which} {gname}: '
                                         f'errors {err}, {err_g}')
        for rnd in range(2):
            order = list(libs) if rnd == 0 else list(libs)[::-1]
            row = {f'{k} {w}': round(ms(lambda k=k, w=w: call(k, w, grid)),
                                     4)
                   for k in order for w in (9, 10)}
            print(f'{gname} grid, round {rnd + 1} (ms): {row}', flush=True)
    print(f'zero fill of d_img ({d_img.numel() * 4 / 1e6:.1f} MB): '
          f'{ms(d_img.zero_):.4f} ms', flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
