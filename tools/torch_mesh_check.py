#!/usr/bin/env python3
"""The device mesh of the PyTorch port against one card or one process.

    python tools/torch_mesh_check.py [--device cuda|cpu] [--world 4]
        [--parts predict,test,tp] [--tiny] [--dtype float32|float64]
        [--batch 64] [--out DIR]

Three parts, each printed as one JSON line:

* ``predict``: ``TextRecognizer.predict(mesh=)`` over ``--world`` cards
  (a mesh of local devices) against one card, on the flagship in bf16 at
  B=512 (``--tiny``: the tiny flagship in float32 at B=16): images/s of
  each in turns (1, N, N, 1), the rows whose argmax equals the one-card
  output and, for those that part, the one-card top-2 gap where they first
  part (``chip_smoke.py``'s near-tie rule); each shard against ``predict``
  of its rows alone on card 0 (the largest gap), and those batches of
  B / N rows on card 0 against the one-card batch of B, by the same rule;
* ``test``: ``tps_pp_tpu_torch.tools.test`` on a recognition config over
  seeded PNG crops, in one process on one card and under ``torchrun
  --nproc_per_node`` ``--world`` (gloo on the CPU): whether the metrics
  and the results, in dataset order, are equal;
* ``tp``: one ``train_recognizer`` step with tensor parallelism, data 2 x
  model 2 (``create_mesh(data=2, model=2)`` over four ranks), against one
  process, as ``tools/torch_ddp_check.py`` runs data parallelism: the
  largest gaps of the loss and the gradient norm (relative), and of the
  parameters and buffers after the step (the shards gathered), the local
  shapes of the split parameters after two steps against their placement,
  whether rank 0's checkpoint loads into one process with those weights,
  and each rank's launches of the warp's kernels (8 and 9, and 10) in its
  training run. SGD with the gradients clipped to norm 1, dropout 0.

On the card each line also has the ``nvidia-smi`` name and power limit.
The crops and configs go to ``--out`` (a temporary directory by default).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_ddp_check import Crops, free_port  # noqa: E402

TEST_CROPS = 48


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--world', type=int, default=4)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    p.add_argument('--parts', default='predict,test,tp')
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--dtype', default='float32',
                   choices=('float32', 'float64'))
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--out', default=None)
    p.add_argument('--tp-rank-of', default=None,
                   help='(internal) run one rank of the tp part')
    p.add_argument('--test-run', nargs=3, default=None,
                   metavar=('CONFIG', 'OUT', 'DEVICE'),
                   help='(internal) run tools.test with the PNG loader')
    p.add_argument('--steps', type=int, default=1)
    p.add_argument('--model', type=int, default=2,
                   help='(internal) the model axis of a tp rank')
    return p.parse_args(argv)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()


def sync(dev):
    import torch
    if dev.type == 'cuda':
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ------------------------------------------------------------- predict --

def predict_part(args):
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    from tps_pp_tpu_torch.parallel import create_mesh

    cuda = args.device == 'cuda'
    dev = torch.device('cuda', 0) if cuda else torch.device('cpu')
    cfg = nrtr_tps_pp_cfg(tiny=args.tiny, decode_mode='auto',
                          dtype='bfloat16' if cuda and not args.tiny
                          else 'float32')
    rec = build_recognizer(cfg, device=dev).init_weights(0)
    B, hw = (16, (32, 64)) if args.tiny else (512, (32, 128))
    g = np.random.default_rng(0)
    img = torch.from_numpy(g.standard_normal((B,) + hw + (3,)).astype(
        np.float32))
    devices = ([torch.device('cuda', i) for i in range(args.world)] if cuda
               else [torch.device('cpu')] * args.world)
    mesh = create_mesh(devices=devices)
    one = rec.predict(img)
    got = rec.predict(img, mesh=mesh)
    shard_launches = rec.last_shard_launches
    s = B // args.world
    alone = torch.cat([rec.predict(img[i * s:(i + 1) * s])
                       for i in range(args.world)])
    shard_gap = float((got - alone).abs().max())
    same_rows = int((got.argmax(-1) == one.argmax(-1)).all(-1).sum())
    times = {'1': [], str(args.world): []}
    for k in ('1', str(args.world), str(args.world), '1'):
        m = None if k == '1' else mesh
        rec.predict(img, mesh=m)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            rec.predict(img, mesh=m)
        sync(dev)
        times[k].append((time.perf_counter() - t0) / 3)
    out = dict(part='predict', batch=B, world=args.world,
               mode=rec.resolved_decode_mode(),
               images_per_s={k: B / min(v) for k, v in times.items()},
               ms={k: [1e3 * t for t in v] for k, v in times.items()},
               argmax_rows_equal=same_rows, rows=B,
               max_abs_gap_vs_one=float((got - one).abs().max()),
               parting_vs_one=parting(got, one),
               shard_vs_alone_max_abs=shard_gap,
               alone_vs_one=parting(alone, one),
               shard_launches=shard_launches)
    return out


def parting(probs, ref):
    """Where the rows of ``probs`` part from ``ref`` (chip_smoke.py's
    decode rule): the rows whose argmax differs at some step, the top-2 gap
    of ``ref`` at each such row's first differing step, how many of those
    gaps reach ``NEAR_TIE``, and the widest."""
    from chip_smoke import NEAR_TIE, first_divergence
    gaps = [gap for t, gap in first_divergence(probs, ref) if t is not None]
    return dict(rows=len(gaps), near_tie=NEAR_TIE,
                at_or_over_near_tie=sum(g >= NEAR_TIE for g in gaps),
                widest_gap=max(gaps, default=0.0))


# ---------------------------------------------------------------- test --

def register_png_loader():
    """``LoadPNGFromFile``: ``LoadImageFromFile`` for PNG files through
    ``cv_ops.png_decode`` (the card's machine has no cv2)."""
    from tps_pp_tpu_torch.datasets.pipelines.cv_ops import png_decode
    from tps_pp_tpu_torch.registry import PIPELINES

    if 'LoadPNGFromFile' in PIPELINES._modules:
        return

    @PIPELINES.register_module()
    class LoadPNGFromFile:
        def __init__(self, **kwargs):
            pass

        def __call__(self, results):
            path = os.path.join(results.get('img_prefix') or '',
                                results['img_info']['filename'])
            with open(path, 'rb') as f:
                img = png_decode(f.read())
            results.update(filename=path, img=img, img_shape=img.shape,
                           ori_shape=img.shape)
            return results


def write_test_set(root, tiny, cuda):
    """Seeded PNG crops, their label file and a config naming them."""
    import numpy as np
    from tps_pp_tpu_torch.apis import nrtr_tps_pp_cfg
    from tps_pp_tpu_torch.convertors.base import BaseConvertor
    from tps_pp_tpu_torch.datasets.pipelines.cv_ops import png_encode

    g = np.random.default_rng(5)
    chars = BaseConvertor.DICT36 if tiny else BaseConvertor.DICT90
    os.makedirs(os.path.join(root, 'crops'), exist_ok=True)
    lines = []
    for i in range(TEST_CROPS):
        crop = g.integers(0, 256, (int(g.integers(16, 49)),
                                   int(g.integers(24, 201)), 3), np.uint8)
        with open(os.path.join(root, 'crops', f'c{i}.png'), 'wb') as f:
            f.write(png_encode(crop))
        lines.append(f'c{i}.png ' + ''.join(chars[int(c)] for c in g.integers(
            0, len(chars), int(g.integers(1, 9)))))
    with open(os.path.join(root, 'label.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    width = 64 if tiny else 128
    pipeline = [dict(type='LoadPNGFromFile'),
                dict(type='ResizeOCR', height=32, min_width=width,
                     max_width=width, keep_aspect_ratio=False),
                dict(type='ToTensorOCR'),
                dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
                     std=[0.229, 0.224, 0.225]),
                dict(type='Collect', keys=['img'])]
    model = nrtr_tps_pp_cfg(tiny=tiny, decode_mode='auto',
                            dtype='bfloat16' if cuda and not tiny
                            else 'float32')
    test = dict(type='OCRDataset', ann_file=os.path.join(root, 'label.txt'),
                img_prefix=os.path.join(root, 'crops'),
                loader=dict(type='HardDiskLoader',
                            parser=dict(type='LineStrParser')),
                pipeline=pipeline, test_mode=True)
    path = os.path.join(root, 'mesh_test.py')
    with open(path, 'w') as f:
        f.write(f'model = {model!r}\ntest_pipeline = {pipeline!r}\n'
                f'data = dict(samples_per_gpu=16, test={test!r})\n')
    return path


def test_run(config, out, device):
    """The CLI with the PNG loader; ``device`` ``rank``: the rank's own
    card (torchrun's ``LOCAL_RANK``)."""
    register_png_loader()
    from tps_pp_tpu_torch.tools import test
    test.main([config, '--out', out] + (
        [] if device == 'rank' else ['--device', device]))


def test_part(args, root):
    cuda = args.device == 'cuda'
    config = write_test_set(root, args.tiny, cuda)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        env.pop(k, None)
    me = os.path.abspath(__file__)
    runs = {}
    dev = 'cuda' if cuda else 'cpu'
    cases = [('one card', dict(env, CUDA_VISIBLE_DEVICES='0') if cuda
              else env, [sys.executable, me]),
             ('torchrun', env, [
                 sys.executable, '-m', 'torch.distributed.run',
                 '--nproc_per_node', str(args.world), '--master_port',
                 str(free_port()), me])]
    seconds = {}
    for name, e, cmd in cases:
        out = os.path.join(root, name.replace(' ', '_') + '.json')
        device = ('cuda' if name != 'torchrun' else 'rank') if cuda \
            else 'cpu'
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ['--test-run', config, out, device],
                              cwd=REPO, env=e, capture_output=True,
                              text=True, timeout=900)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: exit {proc.returncode}: '
                               f'{proc.stderr[-4000:]}')
        with open(out) as f:
            runs[name] = json.load(f)
    base = runs['one card']

    def texts_equal(res):
        return sum(a['text'] == b['text']
                   for a, b in zip(res, base['results']))

    def score_gap(res):
        return max((abs(x - y) for a, b in zip(res, base['results'])
                    if a['text'] == b['text']
                    for x, y in zip(a['score'], b['score'])), default=0.0)

    return dict(part='test', world=args.world, crops=TEST_CROPS, device=dev,
                metrics={k: v['metrics'] for k, v in runs.items()},
                metrics_equal={k: v['metrics'] == base['metrics']
                               for k, v in runs.items()},
                results_equal={k: v['results'] == base['results']
                               for k, v in runs.items()},
                texts_equal={k: texts_equal(v['results'])
                             for k, v in runs.items()},
                score_gap={k: score_gap(v['results'])
                           for k, v in runs.items()},
                seconds=seconds)


# ------------------------------------------------------------------ tp --

def tp_rank(args):
    """One rank of the tp part (or the one process): train, save the
    gathered state and the local shapes."""
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, TINY_INPUT,
                                       build_recognizer, nrtr_tps_pp_cfg,
                                       train_recognizer)
    from tps_pp_tpu_torch.convertors import BaseConvertor
    from tps_pp_tpu_torch.ops.grid_sample import (grid_sample_forward,
                                                  grid_sample_grad,
                                                  grid_sample_grad_img)
    from tps_pp_tpu_torch.parallel import (create_mesh, dist,
                                           maybe_init_distributed,
                                           param_sharding, tp)
    from tps_pp_tpu_torch.utils.convert import rules_for_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == 'cpu':
        torch.set_num_threads(1)
    device = maybe_init_distributed(None if args.device == 'cuda'
                                    else 'cpu')
    mesh = (create_mesh(model=args.model) if dist.is_active() else None)
    cfg = nrtr_tps_pp_cfg(tiny=args.tiny)
    cfg = dict(cfg, dtype=args.dtype,
               encoder=dict(cfg['encoder'], dropout=0.0),
               decoder=dict(cfg['decoder'], dropout=0.0))
    width = (TINY_INPUT if args.tiny else FLAGSHIP_INPUT)[1]
    chars = (BaseConvertor.DICT36 if args.tiny else BaseConvertor.DICT90)
    rec = build_recognizer(cfg, device=device)
    data = Crops(args.batch, width, chars)
    warp = (grid_sample_forward, grid_sample_grad, grid_sample_grad_img)
    before = [f.launches for f in warp]
    opt, history = train_recognizer(
        rec, data, dict(samples_per_gpu=args.batch, total_epochs=args.steps,
                        log_interval=1, optimizer=dict(type='SGD', lr=0.1),
                        optimizer_config=dict(grad_clip=dict(max_norm=1.0))),
        work_dir=os.path.join(args.tp_rank_of, 'wd'), seed=3, mesh=mesh)
    # the process's own counts: backward launches come from autograd's
    # device thread, which a thread's launch_scope does not see
    launches = {f.__name__: f.launches - b for f, b in zip(warp, before)}
    sd = tp.gather_state_dict(rec.model)
    params = dict(rec.model.named_parameters())
    want = {}
    if mesh is not None:
        placement = param_sharding(params.items(), mesh,
                                   rules_for_config(cfg))
        for k, d in placement.items():
            shape = list(sd[k].shape)
            if d is not None:
                shape[d] //= mesh.shape['model']
            want[k] = shape
    torch.save(dict(params={k: sd[k].cpu() for k in params},
                    buffers={k: v.cpu() for k, v in sd.items()
                             if k not in params},
                    local={k: list(p.shape) for k, p in params.items()},
                    placement=want,
                    loss=history[0]['loss'],
                    grad_norm=history[0]['grad_norm'], count=opt.count,
                    launches=launches,
                    world=dist.world_size()),
               os.path.join(args.tp_rank_of, f'rank{dist.rank()}.pt'))
    if dist.is_active():
        torch.distributed.destroy_process_group()


def tp_launch(args, out_dir, world, steps, model=2):
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        env.pop(k, None)
    port = str(free_port())
    cmd = [sys.executable, os.path.abspath(__file__), '--device',
           args.device, '--batch', str(args.batch), '--dtype', args.dtype,
           '--steps', str(steps), '--model', str(model),
           '--tp-rank-of', out_dir]
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


def tp_part(args, root):
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    tp_launch(args, os.path.join(root, 'one'), 1, 1)
    tp_launch(args, os.path.join(root, 'tp'), 4, 1)
    tp_launch(args, os.path.join(root, 'tp2'), 4, 2)
    tp_launch(args, os.path.join(root, 'dp'), 2, 1, model=1)
    ref = torch.load(os.path.join(root, 'one', 'rank0.pt'))
    dp = torch.load(os.path.join(root, 'dp', 'rank0.pt'))
    gaps = dict(part='tp', mesh={'data': 2, 'model': 2}, loss=0.0,
                grad_norm=0.0, params=0.0, params_key=None, buffers=0.0,
                buffers_key=None, counts=[ref['count']],
                worlds=[ref['world']], launches=[ref['launches']],
                loss_vs_data_parallel=0.0,
                grad_norm_vs_data_parallel=0.0)
    split_ok = True
    for r in range(4):
        got = torch.load(os.path.join(root, 'tp', f'rank{r}.pt'))
        gaps['counts'].append(got['count'])
        gaps['launches'].append(got['launches'])
        gaps['worlds'].append(got['world'])
        for k in ('loss', 'grad_norm'):
            gaps[k] = max(gaps[k], abs(got[k] - ref[k]) / abs(ref[k]))
            gaps[k + '_vs_data_parallel'] = max(
                gaps[k + '_vs_data_parallel'], abs(got[k] - dp[k]) / abs(dp[k]))
        for part in ('params', 'buffers'):
            if got[part].keys() != ref[part].keys():
                raise AssertionError(f'{part}: keys differ')
            for k, want in ref[part].items():
                gap = float((got[part][k].double()
                             - want.double()).abs().max())
                if gap > gaps[part]:
                    gaps[part], gaps[part + '_key'] = gap, k
        two = torch.load(os.path.join(root, 'tp2', f'rank{r}.pt'))
        split_ok &= two['local'] == two['placement'] and two['count'] == 2
    gaps['split'] = sum(list(ref['params'][k].shape) != shape
                        for k, shape in got['local'].items())
    gaps['placement_after_two_steps'] = bool(split_ok)
    # rank 0's checkpoint of the tp run, in one process
    wd = os.path.join(root, 'tp', 'wd')
    gaps['written'] = sorted(os.listdir(wd))
    cfg = nrtr_tps_pp_cfg(tiny=args.tiny)
    cfg = dict(cfg, dtype=args.dtype)
    one = build_recognizer(cfg, device='cpu')
    ckpt = torch.load(os.path.join(wd, 'epoch_1.pth'), weights_only=True)
    one.model.load_state_dict(ckpt['state_dict'], strict=True)
    tp0 = torch.load(os.path.join(root, 'tp', 'rank0.pt'))
    gaps['checkpoint_max_abs'] = max(
        float((p.detach().double() - tp0['params'][k].double()).abs().max())
        for k, p in one.model.named_parameters())
    return gaps


def main(argv=None):
    args = parse_args(argv)
    if args.test_run:
        return test_run(*args.test_run)
    if args.tp_rank_of:
        return tp_rank(args)
    if args.dtype == 'float64' and args.device == 'cuda':
        raise SystemExit('float64 runs on the CPU only')
    root = args.out or tempfile.mkdtemp(prefix='mesh_check_')
    card = card_line() if args.device == 'cuda' else None
    for part in args.parts.split(','):
        t0 = time.perf_counter()
        if part == 'predict':
            out = predict_part(args)
        elif part == 'test':
            out = test_part(args, os.path.join(root, 'test'))
        elif part == 'tp':
            out = tp_part(args, os.path.join(root, 'tp'))
        else:
            raise SystemExit(f'unknown part {part!r}')
        out['seconds_part'] = time.perf_counter() - t0
        if card:
            out['card'] = card
        print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
