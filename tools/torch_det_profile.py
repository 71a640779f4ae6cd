#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's DBNet forward, on one CUDA GPU.

    python tools/torch_det_profile.py [--configs dbnet_r18,dbnet_r50dcnv2]
        [--reps 5] [--rows 12]

Builds each DBNet config of ``chip_smoke.DET_CONFIGS`` from its file with
seeded random weights (float32, TF32 off) at its batch there (R18 16,
R50-DCNv2 8) on 640 x 640 inputs, then prints, in ms an image:

* the forward on a numpy batch (its pageable copy to the card included)
  and on a tensor already on the card, and the copy alone, with CUDA
  events (the mean of ``--reps`` runs after two);
* a profile of one forward on the card's tensor: the host's time, the
  device's busy time (the kernels' summed time), the idle share of the
  forward's span, the number of kernel launches, and the ``--rows`` ops
  with the most device time.

A forward the host cannot issue as fast as the card runs it shows as an
idle share and a host time above the device's.
"""
import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tps_pp_tpu_torch.apis import init_detector  # noqa: E402


def _device_us(e):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def profile_config(key, reps, rows):
    from torch.profiler import ProfilerActivity, profile
    path, n = chip_smoke.DET_CONFIGS[key]
    dev = torch.device('cuda')
    det = init_detector(os.path.join(ROOT, path), device=dev,
                        seed=chip_smoke.SEED)
    batch = np.random.default_rng(1).random((n, 640, 640, 3),
                                            dtype=np.float32)
    x = torch.as_tensor(batch, device=dev)
    with torch.inference_mode():
        numpy_ms = chip_smoke.cuda_ms(lambda: det.forward(batch), reps) / n
        dev_ms = chip_smoke.cuda_ms(lambda: det.forward(x), reps) / n
        copy_ms = chip_smoke.cuda_ms(
            lambda: torch.as_tensor(batch).to(dev), reps) / n
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            det.forward(x)
            end.record()
            torch.cuda.synchronize()
    span = start.elapsed_time(end)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    host = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3
    print(f'{key} B={n} 640x640 f32: forward on a numpy batch '
          f'{numpy_ms:.3f} ms/image, on the card\'s tensor {dev_ms:.3f}, the '
          f'copy alone {copy_ms:.3f}; profiled forward: span {span / n:.3f}, '
          f'device busy {busy / n:.3f}, idle share '
          f'{1 - busy / span:.3f}, host (profiled) {host / n:.3f} ms/image, '
          f'{len(kernels)} kernel launches [{chip_smoke.card()}]',
          flush=True)
    print(prof.key_averages().table(sort_by='self_cuda_time_total',
                                    row_limit=rows,
                                    max_name_column_width=60), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--configs', default=','.join(chip_smoke.DET_CONFIGS))
    p.add_argument('--reps', type=int, default=5)
    p.add_argument('--rows', type=int, default=12)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit('torch_det_profile: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for key in args.configs.split(','):
        profile_config(key, args.reps, args.rows)
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
