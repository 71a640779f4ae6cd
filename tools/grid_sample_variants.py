#!/usr/bin/env python3
"""Where the time of the training warp's kernels goes
(``tps_pp_tpu_torch/csrc/grid_sample.cu``), on one CUDA GPU: kernels 9 and
10 (the VJPs) at the backward shapes, kernel 8's narrow (odd-C) forward at
the forward shapes.

Builds ``csrc/grid_sample.cu`` as it is and in variants made by text
substitution, each into its own shared library, and times the kernels of
each at one shape (``--shape``, its batch changed by ``--batch``), in
turns. The backward shapes:

* ``flagship``: N=256, 16x64 samples of a 32x128x64 bf16 map (the even-C
  path), on a uniform [-1.3, 1.3]^2 grid and on TPS++'s own [0, 1]^2 grid;
* ``crnn_tps``: N=64, 32x100 samples of a 32x100x1 f32 crop (CRNN-TPS's
  training warp, the narrow path), on the config's own initial grid (the
  TPS-STN's fc2 at zero weights and the fiducial bias, as training starts)
  and on a uniform [-1.3, 1.3]^2 grid;
* ``moran``, ``spin``: N=64, f32, MORAN's 3x11x1 and SPIN's 2x8x3 offset
  maps sampled up to 32x100 / 32x128 on the identity grid (the narrow
  path's private band).

Their variants (``--variants``, comma-separated; default all of the
shape's):

* ``kernel``: the source as it is (checked against the plain version);
* ``no_atomics``: plain shared-memory adds in place of the atomics (wrong
  sums where threads collide; timing only);
* ``no_accumulate``: the samples are not added (the narrow path: not read
  either), so the zeroing, the barriers and the store remain;
* ``no_store``: the band is not stored (the narrow path: not added to
  d_img);
* ``empty`` (narrow shapes): the kernel returns at once (the launch of its
  grid);
* ``no_private`` (narrow): the band shared, added by atomics, at any size;
* ``cluster_1``, ``cluster_2`` (narrow): clusters of 1 CTA, or of 2
  whatever the batch (the plan takes 2 while there are fewer images and
  bands than SMs, else 1);
* ``parent`` (``--parent DIR``): ``DIR/tps_pp_tpu_torch/csrc/grid_sample.cu``,
  an older tree's kernels, for a before-and-after in one run.

Each is timed as device time by CUDA graph (``chip_smoke.graph_ms``: 20
calls captured, replayed 5 times between CUDA events), beside ATen's
``grid_sampler_2d_backward`` on the same inputs and a zero fill of d_img's
size. First it prints, for each backward kernel of the source as it is,
the atomic and reduction instructions of its ``sm_90a`` SASS by opcode
(``cuobjdump -sass``): what a shared-memory f32 ``atomicAdd`` compiles
to.

The forward shapes (kernel 8 at an odd C; ``--shape`` takes several,
comma-separated, built once):

* ``crnn_tps_serve``: N=512, 32x100 samples of a 32x100x1 bf16 crop
  (CRNN-TPS's serving warp) on the config's initial grid and on a uniform
  [-1.3, 1.3]^2 grid; ``crnn_tps_fwd32``: the same at N=64 in f32 (the
  training forward), on the initial grid;
* ``moran_serve``, ``spin_serve``: N=512 bf16, MORAN's 3x11x1 and SPIN's
  2x8x3 offset maps sampled up to 32x100 / 32x128 on the identity grid;
  ``moran_fwd32``, ``spin_fwd32``: the same at N=64 in f32.

Their variants:

* ``kernel``: the source as it is, checked against the plain version
  (and, with ``--parent``, its largest difference from the parent's);
* ``empty``: the narrow kernel returns at once (the launch of its grid);
* ``no_gather``: no tap read and no map staged: the grid read, the
  arithmetic and the store (the memory floor);
* ``global_taps``: every map read where it lies (the plan for a map too
  large for shared memory);
* ``run_4``, ``run_16``: at most 4 (16) samples a lane, not 8;
* ``parent`` (``--parent DIR``).

Each is timed by CUDA graph warm (20 calls on the same inputs, which the
50 MB L2 holds after the first) and cold (the calls rotated over copies
of the inputs and outputs that together exceed twice the L2), beside
``F.grid_sample`` timed the same ways (its grid cast to the image's dtype
inside the call, as ``chip_smoke.py`` times it), and the bound: the
image, the grid and the output once at 3.35 TB/s. Run from the
repository root:

    python3 tools/grid_sample_variants.py [--shape crnn_tps] [--batch 140]
        [--parent DIR] [--variants kernel,no_atomics]
    python3 tools/grid_sample_variants.py \
        --shape crnn_tps_serve,moran_serve,spin_serve [--parent DIR]
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, 'tps_pp_tpu_torch', 'csrc')
CRNN_TPS_CONFIG = 'configs/textrecog/tps/crnn_tps_academic_dataset.py'
# (N, H, W, C, Ho, Wo, element type, grids)
SHAPES = {
    'flagship': (256, 32, 128, 64, 16, 64, torch.bfloat16,
                 ('uniform', 'quadrant')),
    'crnn_tps': (64, 32, 100, 1, 32, 100, torch.float32,
                 ('initial', 'uniform')),
    'moran': (64, 3, 11, 1, 32, 100, torch.float32, ('identity',)),
    'spin': (64, 2, 8, 3, 32, 128, torch.float32, ('identity',)),
}
# name: [(text, its replacement), ...]; every text must be in the source
VARIANTS = {
    'no_atomics': [('''  atomicAdd(p + first, w * (first ? v.y : v.x));
  atomicAdd(p + 1 - first, w * (first ? v.x : v.y));''',
                    '''  p[first] += w * (first ? v.y : v.x);
  p[1 - first] += w * (first ? v.x : v.y);'''),
                   ('    atomicAdd(acc + i, v);', '    acc[i] += v;')],
    'no_accumulate': [('for (int k0 = warp * kU; k0 < nsel;',
                       'for (int k0 = warp * kU; k0 < (nsel & 0);'),
                      ('for (int p0 = p_begin; p0 < p_end; p0 += kR) {',
                       'for (int p0 = p_begin; p0 < (p_end & 0); p0 += kR) {')],
    'no_store': [('''      reinterpret_cast<float4*>(dst)[e] =
          reinterpret_cast<const float4*>(acc)[e];''',
                  '''      if (acc[4 * e] == 12345.f)
        reinterpret_cast<float4*>(dst)[e] =
            reinterpret_cast<const float4*>(acc)[e];'''),
                 ('      if (lane == 0) atomicAdd(dst + e, s);',
                  '      if (lane == 0 && s == 12345.f) atomicAdd(dst + e, s);'),
                 ('''      atomicAdd(reinterpret_cast<float4*>(dst) + e,
                reinterpret_cast<const float4*>(acc)[e]);''',
                  '''      if (acc[4 * e] == 12345.f)
        atomicAdd(reinterpret_cast<float4*>(dst) + e,
                  reinterpret_cast<const float4*>(acc)[e]);'''),
                 ('      atomicAdd(dst + e, acc[e]);',
                  '      if (acc[e] == 12345.f) atomicAdd(dst + e, acc[e]);')],
}
NARROW_VARIANTS = {
    'empty': [('  constexpr int G = kC ? kC : 1;  // channels a pass',
               '  if (rows > 0) return;\n'
               '  constexpr int G = kC ? kC : 1;  // channels a pass')],
    'no_private': [('p.priv = row * p.rows * kNarrowThreads <= budget;',
                    'p.priv = 0;')],
    'cluster_1': [('constexpr int kMaxCluster = 2;',
                   'constexpr int kMaxCluster = 1;')],
    'cluster_2': [('p.cluster < kMaxCluster && (long long)N * bands * '
                   'p.cluster < sms', 'p.cluster < kMaxCluster')],
}
PLAN_INTS = 8      # room for any tree's plan (5 ints before the cluster)
# kernel 8's narrow forward: (N, H, W, C, Ho, Wo, element type, grids)
FWD_SHAPES = {
    'crnn_tps_serve': (512, 32, 100, 1, 32, 100, torch.bfloat16,
                       ('initial', 'uniform')),
    'moran_serve': (512, 3, 11, 1, 32, 100, torch.bfloat16, ('identity',)),
    'spin_serve': (512, 2, 8, 3, 32, 128, torch.bfloat16, ('identity',)),
    'crnn_tps_fwd32': (64, 32, 100, 1, 32, 100, torch.float32, ('initial',)),
    'moran_fwd32': (64, 3, 11, 1, 32, 100, torch.float32, ('identity',)),
    'spin_fwd32': (64, 2, 8, 3, 32, 128, torch.float32, ('identity',)),
}
FWD_VARIANTS = {
    'empty': [('  extern __shared__ __align__(16) unsigned char fwd_smem[];',
               '  extern __shared__ __align__(16) unsigned char fwd_smem[];\n'
               '  if (run > 0) return;')],
    'no_gather': [('''  return t.w00 * load1(m + (size_t)t.o00 * C, c) +
         t.w01 * load1(m + (size_t)t.o01 * C, c) +
         t.w10 * load1(m + (size_t)t.o10 * C, c) +
         t.w11 * load1(m + (size_t)t.o11 * C, c);''',
                   '  return t.w00 + t.w01 * t.wx + t.w10 * t.wy + t.w11 '
                   '+ c;'),
                  ('p.taps_shared = staged <= (size_t)kMapSmemMax;',
                   'p.taps_shared = 0;')],
    'global_taps': [('p.taps_shared = staged <= (size_t)kMapSmemMax;',
                     'p.taps_shared = 0;')],
    'run_4': [('constexpr int kFwdMaxRun = 8;',
               'constexpr int kFwdMaxRun = 4;')],
    'run_16': [('constexpr int kFwdMaxRun = 8;',
                'constexpr int kFwdMaxRun = 16;')],
}


def build(sources, out_dir):
    """{name: (source text, include dir)} -> {name: loaded library}, one
    nvcc each, all started together."""
    nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    jobs = {}
    for name, (text, inc) in sources.items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        so = os.path.join(out_dir, f'{name}.so')
        cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-shared',
               '-I', inc, '-o', so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    from tps_pp_tpu_torch.ops._lib import _SIGNATURES
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc {name}: {log[-3000:]}')
        libs[name] = ctypes.CDLL(so)
        for fn in ('tpk_grid_sample_grad', 'tpk_grid_sample_grad_img',
                   'tpk_grid_sample_fwd', 'tpk_grid_sample_fwd_plan'):
            if hasattr(libs[name], fn):     # a parent may lack the plan
                getattr(libs[name], fn).argtypes = _SIGNATURES[fn]
                getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--shape', default='flagship',
                    help=f'one of {sorted(SHAPES)}, or forward shapes of '
                    f'{sorted(FWD_SHAPES)}, comma-separated')
    ap.add_argument('--batch', type=int, help="the shape's N instead")
    ap.add_argument('--parent', help='an older checkout to time beside')
    ap.add_argument('--variants', help='comma-separated variants to build '
                    "(default: all of the shape's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('grid_sample_variants: no CUDA device')
    with open(os.path.join(CSRC, 'grid_sample.cu')) as f:
        src = f.read()
    fwd = args.shape.split(',')
    if all(k in FWD_SHAPES for k in fwd):
        return main_fwd(args, src, fwd)
    if args.shape not in SHAPES:
        sys.exit(f'grid_sample_variants: unknown shape {args.shape}')
    sources = {'kernel': (src, CSRC)}
    sources.update(variant_sources(src, args.shape, args.variants))
    if args.parent:
        pdir = os.path.join(args.parent, 'tps_pp_tpu_torch', 'csrc')
        with open(os.path.join(pdir, 'grid_sample.cu')) as f:
            sources['parent'] = (f.read(), pdir)
    shape = SHAPES[args.shape]
    if args.batch:
        shape = (args.batch,) + shape[1:]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        sass_atomics(os.path.join(tmp, 'kernel.so'))
        run(libs, shape, args.shape)


def main_fwd(args, src, shapes):
    sources = {'kernel': (src, CSRC)}
    sources.update(variant_sources(src, None, args.variants, FWD_VARIANTS))
    if args.parent:
        pdir = os.path.join(args.parent, 'tps_pp_tpu_torch', 'csrc')
        with open(os.path.join(pdir, 'grid_sample.cu')) as f:
            sources['parent'] = (f.read(), pdir)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name in shapes:
            shape = FWD_SHAPES[name]
            if args.batch:
                shape = (args.batch,) + shape[1:]
            run_fwd(libs, shape, name)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def variant_sources(src, shape, variants=None, known=None):
    """{name: (text, include dir)} of the variants named in ``variants``
    (comma-separated; 'kernel' is always built), or of every variant of
    ``shape`` (of ``known`` where given)."""
    if known is None:
        known = dict(VARIANTS)
        if SHAPES[shape][3] % 2:
            known.update(NARROW_VARIANTS)
    names = variants.split(',') if variants else list(known)
    out = {}
    for name in names:
        if name == 'kernel':
            continue
        text = src
        for old, new in known[name]:
            if old not in text:
                raise RuntimeError(f'variant {name}: its text is not in the '
                                   f'source')
            text = text.replace(old, new)
        out[name] = (text, CSRC)
    return out


def sass_atomics(so):
    """Prints {kernel: {opcode: count}} of the atomic and reduction
    instructions (ATOMS, ATOM, ATOMG, RED, REDG) in the backward kernels'
    SASS."""
    tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'cuobjdump')
    out = subprocess.run([tool, '-sass', so], capture_output=True,
                         text=True, check=True).stdout
    found, fn = {}, None
    for line in out.splitlines():
        if 'Function : ' in line:
            fn = line.split('Function : ')[1].strip()
            continue
        if fn is None or 'bwd' not in fn:
            continue
        for op in re.findall(r'\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)',
                             line):
            found.setdefault(fn, {})
            found[fn][op] = found[fn].get(op, 0) + 1
    for fn, ops in sorted(found.items()):
        print(f'SASS atomics of {fn}: {ops}', flush=True)


def make_grid(kind, g, N, Ho, Wo, dev):
    if kind == 'uniform':
        return torch.tensor(g.uniform(-1.3, 1.3, (N, Ho, Wo, 2)),
                            dtype=torch.float32, device=dev)
    if kind == 'quadrant':
        return torch.tensor(g.uniform(0, 1, (N, Ho, Wo, 2)),
                            dtype=torch.float32, device=dev)
    if kind == 'identity':
        from tps_pp_tpu_torch.models.rectifiers.moran import identity_grid
        return torch.tensor(np.broadcast_to(identity_grid(Ho, Wo),
                                            (N, Ho, Wo, 2)), device=dev)
    # 'initial': the CRNN-TPS config's TPS-STN as training starts (fc2 at
    # zero weights and the fiducial bias): the same grid for every crop
    from tps_pp_tpu_torch.config import load_config
    from tps_pp_tpu_torch.models.rectifiers.tps_stn import TPSPreprocessor
    kw = dict(load_config(os.path.join(ROOT, CRNN_TPS_CONFIG))['model'][
        'preprocessor'])
    kw.pop('type')
    pre = TPSPreprocessor(**kw).to(dev)
    pre.reset_localization()
    with torch.no_grad():
        return pre.grid(torch.zeros((N,) + tuple(kw['img_size']) + (
            kw['num_img_channel'],), device=dev)).contiguous()


def run_fwd(libs, shape, shape_name):
    """Kernel 8 of every library at one forward shape: checked against
    the plain version (and the parent's output), then timed warm and cold
    by CUDA graph beside F.grid_sample, in two rounds of opposite order."""
    import torch.nn.functional as F
    from chip_smoke import PEAK_BYTES, cold_copies, graph_ms
    from tps_pp_tpu_torch.ops.grid_sample import grid_sample_plain
    N, H, W, C, HO, WO, dtype, grid_kinds = shape
    dev = torch.device('cuda')
    g = np.random.default_rng(0)
    elt = torch.tensor([], dtype=dtype).element_size()
    call_bytes = N * (H * W * C * elt + HO * WO * 8 + HO * WO * C * elt)
    copies = cold_copies(call_bytes)
    bound_ms = call_bytes / PEAK_BYTES * 1e3
    P = ctypes.c_void_p
    is_bf16 = int(dtype == torch.bfloat16)
    plans = {}
    for name, lib in libs.items():
        if hasattr(lib, 'tpk_grid_sample_fwd_plan'):
            plan = (ctypes.c_int * 8)()
            rc = lib.tpk_grid_sample_fwd_plan(N, H, W, C, HO * WO, is_bf16,
                                              plan)
            plans[name] = list(plan) if rc == 0 else f'error {rc}'
    print(f'{shape_name}: N={N}, {H}x{W}x{C} {dtype} -> {HO}x{WO}; plans '
          f'{plans}; bound {bound_ms:.4f} ms ({call_bytes / 1e6:.3f} MB '
          f'a call); cold: {copies} copies', flush=True)

    def call(name, img, grid, out):
        rc = libs[name].tpk_grid_sample_fwd(
            P(img.data_ptr()), P(grid.data_ptr()), P(out.data_ptr()), N, H,
            W, C, HO * WO, is_bf16,
            P(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f'{name} kernel 8: CUDA error {rc}')

    for gname in grid_kinds:
        grid = make_grid(gname, g, N, HO, WO, dev)
        sets = []
        for i in range(copies):
            img = torch.tensor(g.uniform(-1, 1, (N, H, W, C)), dtype=dtype,
                               device=dev)
            sets.append((img, grid.clone() if i else grid,
                         torch.empty((N, HO, WO, C), dtype=dtype,
                                     device=dev)))
        img, grid, out = sets[0]
        want = grid_sample_plain(img, grid).float()
        got = {}
        for name in libs:
            if name in ('empty', 'no_gather'):
                continue
            out.fill_(float('nan'))
            call(name, img, grid, out)
            torch.cuda.synchronize()
            got[name] = out.float().clone()
            err = float((got[name] - want).abs().max())
            bad = (got[name] - want).abs() > (2e-2 if is_bf16 else 1e-5)
            if bool(bad.any()) or bool(torch.isnan(got[name]).any()):
                raise AssertionError(f'{shape_name} {gname}: {name} max '
                                     f'abs error {err}')
            print(f'{shape_name} {gname} grid: {name} max abs error '
                  f'against the plain version {err:.3g}', flush=True)
        for name in got if 'parent' in got else ():
            diff = float((got[name] - got['parent']).abs().max())
            same = bool(torch.equal(got[name], got['parent']))
            print(f'{shape_name} {gname} grid: {name} largest difference '
                  f'from the parent {diff:.3g} (equal: {same})', flush=True)

        def lib_call(im, gr):
            return F.grid_sample(im.permute(0, 3, 1, 2), gr.to(dtype),
                                 mode='bilinear', padding_mode='border',
                                 align_corners=True)

        for rnd in range(2):
            order = list(libs) if rnd == 0 else list(libs)[::-1]
            row = {}
            for name in order:
                row[name] = (round(graph_ms(lambda n=name: call(n, *sets[0])),
                                   5),
                             round(graph_ms([lambda n=name, s=s: call(n, *s)
                                             for s in sets]), 5))
            row['F.grid_sample'] = (
                round(graph_ms(lambda: lib_call(*sets[0][:2])), 5),
                round(graph_ms([lambda s=s: lib_call(*s[:2])
                                for s in sets]), 5))
            print(f'{shape_name} B={N}, {gname} grid, round {rnd + 1} (ms by '
                  f'CUDA graph, (warm, cold); bound {bound_ms:.4f}): {row}',
                  flush=True)
        del sets, img, grid, out
        torch.cuda.empty_cache()


def run(libs, shape, shape_name):
    from chip_smoke import graph_ms
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_grad_img_plain,
                                                  grid_sample_grad_plain)
    N, H, W, C, HO, WO, dtype, grid_kinds = shape
    dev = torch.device('cuda')
    g = np.random.default_rng(0)
    img = torch.tensor(g.uniform(-1, 1, (N, H, W, C)), dtype=dtype,
                       device=dev)
    cot = torch.tensor(g.uniform(-1, 1, (N, HO, WO, C)), dtype=dtype,
                       device=dev)
    d_img = torch.empty((N, H, W, C), device=dev)
    d_grid = torch.empty((N, HO, WO, 2), device=dev)
    P = ctypes.c_void_p
    plans = {}

    def call(name, which, grid):
        lib, plan = libs[name], (ctypes.c_int * PLAN_INTS)()
        shape_args = (N, H, W, C, HO * WO, int(dtype == torch.bfloat16))
        st = P(torch.cuda.current_stream().cuda_stream)
        if which == 9:
            rc = lib.tpk_grid_sample_grad(
                P(grid.data_ptr()), P(cot.data_ptr()), P(img.data_ptr()),
                P(d_img.data_ptr()), P(d_grid.data_ptr()), *shape_args, plan,
                st)
        else:
            rc = lib.tpk_grid_sample_grad_img(
                P(grid.data_ptr()), P(cot.data_ptr()), P(d_img.data_ptr()),
                *shape_args, plan, st)
        if rc:
            raise RuntimeError(f'{name} kernel {which}: CUDA error {rc}')
        plans[name] = list(plan)

    for gname in grid_kinds:
        grid = make_grid(gname, g, N, HO, WO, dev)
        want_img, want_grid = grid_sample_grad_plain(grid, cot, img)
        want10 = grid_sample_grad_img_plain(grid, cot, H, W)
        for name in ('kernel', 'parent'):
            if name not in libs:
                continue
            errs = []
            for which, want in ((9, want_img), (10, want10)):
                d_img.fill_(float('nan'))
                call(name, which, grid)
                torch.cuda.synchronize()
                errs.append(float((d_img - want).abs().max()))
                if which == 9:
                    errs.append(float((d_grid - want_grid).abs().max()))
            if not (max(errs[0], errs[2]) <= 5e-2 and errs[1] <= 0.2):
                raise AssertionError(f'{name} {gname}: errors {errs}')
            print(f'{gname} grid: {name} plan {plans[name]}, max abs errors '
                  f'against the plain versions {errs[0]:.3g} (9, d_img), '
                  f'{errs[1]:.3g} (9, d_grid), {errs[2]:.3g} (10)',
                  flush=True)
        x_l, c_l = img.float().permute(0, 3, 1, 2), cot.float().permute(
            0, 3, 1, 2)
        aten = {9: lambda: torch.ops.aten.grid_sampler_2d_backward(
                    c_l, x_l, grid, 0, 1, True, [True, True]),
                10: lambda: torch.ops.aten.grid_sampler_2d_backward(
                    c_l, x_l, grid, 0, 1, True, [True, False])}
        for rnd in range(2):
            order = list(libs) if rnd == 0 else list(libs)[::-1]
            row = {f'{k} {w}': round(graph_ms(
                lambda k=k, w=w: call(k, w, grid)), 4)
                for k in order for w in (9, 10)}
            row.update({f'aten {w}': round(graph_ms(fn), 4)
                        for w, fn in aten.items()})
            print(f'{shape_name} B={N}, {gname} grid, round {rnd + 1} (ms '
                  f'by CUDA graph): {row}', flush=True)
    print(f'zero fill of d_img ({d_img.numel() * 4 / 1e6:.3f} MB): '
          f'{graph_ms(d_img.zero_):.4f} ms by CUDA graph', flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
