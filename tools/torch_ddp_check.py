#!/usr/bin/env python3
"""Data parallelism of the PyTorch port against one process.

    python tools/torch_ddp_check.py --world 4 [--device cuda|cpu] [--tiny]
        [--batch 64] [--dtype float32|float64] [--out DIR]

Runs ``train_recognizer`` for one step on one global batch of ``--batch``
seeded uint8 crops through augmentations of the flagship's train pipeline
(each sample with its own key), dropout 0, SGD with the gradients clipped
to norm 1, ``--dtype`` compute (float32 with TF32 off, or float64 on the
CPU, where the model's float32 islands stay): first in one process on the whole
batch, then in ``--world`` processes (ranks joined by ``torchrun``'s
environment: NCCL, one GPU each, or gloo on the CPU), each on its
contiguous share (each rank's log beside its state). Prints one JSON
line with the largest gaps between the
two: the loss and the gradient norm (relative), the parameters and the
buffers (the BatchNorm running statistics) after the step (absolute,
with the entry that parts most), the step counts, each process's
launches of the training warp's kernels (8 and 9; 0 on the CPU), the
files rank 0 wrote, and on the card its ``nvidia-smi`` name and power
limit. ``--tiny`` takes the tiny flagship at 32x64 crops; the default is
the full-width flagship at 32x128. Each process's ``state_dict`` goes to
``--out`` (a temporary directory by default).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--world', type=int, default=2)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--dtype', default='float32',
                   choices=('float32', 'float64'))
    p.add_argument('--out', default=None)
    p.add_argument('--rank-of', default=None,
                   help='(internal) run one rank, writing into this dir')
    return p.parse_args(argv)


def pipeline(width):
    aug = [dict(type='RandomRotateTextDet', max_angle=15),
           dict(type='RandomAffine'),
           dict(type='RandomPerspective', distortion_scale=0.5)]
    return [
        dict(type='LoadImageFromNdarray'),
        dict(type='ResizeOCR', height=32, min_width=width, max_width=width,
             keep_aspect_ratio=False),
        dict(type='RandomWrapper', p=0.5, transforms=[
            dict(type='OneOfWrapper', transforms=aug)]),
        dict(type='RandomWrapper', p=0.5, transforms=[
            dict(type='GaussNoise', var_limit=(20, 20), p=0.5),
            dict(type='MotionBlur', blur_limit=6, p=0.5)]),
        dict(type='ToTensorOCR'),
        dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
             std=[0.229, 0.224, 0.225]),
        dict(type='Collect', keys=['img'])]


class Crops:
    """``n`` seeded uint8 crops with labels through ``pipeline(width)``."""

    def __init__(self, n, width, chars):
        import numpy as np
        from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
        g = np.random.default_rng(0)
        self.imgs = [g.integers(0, 256, (int(g.integers(16, 48)),
                                         int(g.integers(24, 160)), 3),
                                np.uint8) for _ in range(n)]
        self.texts = [''.join(chars[int(i)] for i in g.integers(
            0, len(chars), int(g.integers(1, 9)))) for _ in range(n)]
        self.pipeline = Compose(pipeline(width))

    def __len__(self):
        return len(self.imgs)

    def sample(self, i, key=None):
        from tps_pp_tpu_torch.datasets import seeded_rngs
        rngs = seeded_rngs(key) if key is not None else {}
        return self.pipeline(dict(img=self.imgs[i], text=self.texts[i],
                                  img_info=dict(filename=None), **rngs))


def run_rank(args):
    """One process of the run: train one step, save its state."""
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, TINY_INPUT,
                                       build_recognizer, nrtr_tps_pp_cfg,
                                       train_recognizer)
    from tps_pp_tpu_torch.convertors import BaseConvertor
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_forward,
                                                  grid_sample_grad)
    from tps_pp_tpu_torch.parallel import dist, maybe_init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == 'cpu':
        torch.set_num_threads(1)
    device = maybe_init_distributed(None if args.device == 'cuda'
                                    else 'cpu')
    cfg = nrtr_tps_pp_cfg(tiny=args.tiny)
    cfg = dict(cfg, dtype=args.dtype,
               encoder=dict(cfg['encoder'], dropout=0.0),
               decoder=dict(cfg['decoder'], dropout=0.0))
    width = (TINY_INPUT if args.tiny else FLAGSHIP_INPUT)[1]
    chars = (BaseConvertor.DICT36 if args.tiny else BaseConvertor.DICT90)
    rec = build_recognizer(cfg, device=device)
    opt, history = train_recognizer(
        rec, Crops(args.batch, width, chars), dict(
            samples_per_gpu=args.batch, total_epochs=1, log_interval=1,
            optimizer=dict(type='SGD', lr=0.1),
            optimizer_config=dict(grad_clip=dict(max_norm=1.0))),
        work_dir=os.path.join(args.rank_of, 'wd'), seed=3)
    torch.save(dict(params={k: v.detach().cpu() for k, v in
                            rec.model.named_parameters()},
                    buffers={k: v.cpu() for k, v in
                             rec.model.named_buffers()},
                    loss=history[0]['loss'],
                    grad_norm=history[0]['grad_norm'], count=opt.count,
                    world=dist.world_size(),
                    launches=[grid_sample_forward.launches,
                              grid_sample_grad.launches]),
               os.path.join(args.rank_of, f'rank{dist.rank()}.pt'))
    if dist.is_active():
        torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def launch(args, out_dir, world):
    """Run ``world`` processes of this script (no group for one)."""
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        env.pop(k, None)
    port = str(free_port())
    cmd = [sys.executable, os.path.abspath(__file__), '--device',
           args.device, '--batch', str(args.batch), '--dtype', args.dtype,
           '--rank-of', out_dir]
    if args.tiny:
        cmd.append('--tiny')
    procs = []
    for r in range(world):
        e = dict(env)
        if world > 1:
            e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                     MASTER_ADDR='localhost', MASTER_PORT=port)
        with open(os.path.join(out_dir, f'rank{r}.log'), 'w') as log:
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=e, stdout=log,
                                          stderr=subprocess.STDOUT))
    for r, p in enumerate(procs):
        if p.wait(timeout=900) != 0:
            with open(os.path.join(out_dir, f'rank{r}.log')) as log:
                raise RuntimeError(f'rank {r} exited {p.returncode}: '
                                   f'{log.read()[-4000:]}')


def compare(out):
    """The largest gaps of every rank of the group against one process."""
    import torch
    ref = torch.load(os.path.join(out, 'one', 'rank0.pt'))
    gaps = dict(loss=0.0, grad_norm=0.0, params=0.0, params_key=None,
                buffers=0.0, buffers_key=None, counts=[ref['count']],
                worlds=[ref['world']], launches=[ref['launches']])
    ranks = sorted(f for f in os.listdir(os.path.join(out, 'group'))
                   if f.endswith('.pt'))
    for f in ranks:
        got = torch.load(os.path.join(out, 'group', f))
        gaps['counts'].append(got['count'])
        gaps['worlds'].append(got['world'])
        gaps['launches'].append(got['launches'])
        for k in ('loss', 'grad_norm'):
            gaps[k] = max(gaps[k], abs(got[k] - ref[k]) / abs(ref[k]))
        for part in ('params', 'buffers'):
            if got[part].keys() != ref[part].keys():
                raise AssertionError(f'{part}: keys differ')
            for k, want in ref[part].items():
                gap = float((got[part][k].double()
                             - want.double()).abs().max())
                if gap > gaps[part]:
                    gaps[part], gaps[part + '_key'] = gap, k
    gaps['written'] = sorted(os.listdir(os.path.join(out, 'group', 'wd')))
    return gaps


def main(argv=None):
    args = parse_args(argv)
    if args.dtype == 'float64' and args.device == 'cuda':
        raise SystemExit('float64 runs on the CPU only (the kernels take '
                         'bf16 and float32)')
    if args.rank_of:
        return run_rank(args)
    out = args.out or tempfile.mkdtemp(prefix='ddp_check_')
    launch(args, os.path.join(out, 'one'), 1)
    launch(args, os.path.join(out, 'group'), args.world)
    gaps = compare(out)
    if args.device == 'cuda':
        gaps['card'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps(gaps), flush=True)
    return gaps


if __name__ == '__main__':
    main()
