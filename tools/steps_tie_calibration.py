#!/usr/bin/env python3
"""How far the bf16 ``steps`` decodes part from themselves, over several
seeds, on one CUDA GPU: the readings behind ``chip_smoke.py``'s
``STEPS_TIE_MULT``.

    python tools/steps_tie_calibration.py [--seeds 0,1,2,3,4] [--batch 512]

For each seed it builds the full-width flagship (bf16, a decoder with
``use_fused_step``) with that seed's random weights and a batch of random
crops, and measures ``chip_smoke.steps_tie_widths``: the rows that part and
the widest top-2 gap where they part, for the module decode on the
encodings of the sampler's kernel and plain versions (the decode's own
sensitivity), for the fused-step kernels against their plain versions on
one encoding, and for the fused-step path against its plain path. It
prints one line per seed with the gaps' ratios to the module decode's, the
card's ``nvidia-smi`` name and power limit, and one JSON line of all
readings.
"""
import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seeds', default='0,1,2,3,4')
    ap.add_argument('--batch', type=int, default=512)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('steps_tie_calibration: no CUDA device')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    # as chip_smoke.py: plain f32 products on the card stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    name = chip_smoke.card()
    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='steps')
    cfg['decoder'] = dict(cfg['decoder'], use_fused_step=True)
    rec = build_recognizer(cfg)
    readings = []
    for seed in (int(s) for s in args.seeds.split(',')):
        rec.init_weights(seed)
        g = np.random.default_rng(seed)
        img = torch.from_numpy(g.standard_normal(
            (args.batch,) + FLAGSHIP_INPUT).astype(np.float32)).to(
                rec.device, rec.dtype)
        w = chip_smoke.steps_tie_widths(rec, img)
        mod = w['module'][1]
        ratios = {k: (w[k][1] / mod if mod else None)
                  for k in ('kernels', 'path')}
        readings.append(dict(seed=seed, batch=args.batch, **w,
                             ratios=ratios))
        print(f'seed {seed} B={args.batch}: (rows that part, widest top-2 '
              f'gap) module {w["module"]}, kernels {w["kernels"]}, path '
              f'{w["path"]}; ratios to module {ratios} [{name}]',
              flush=True)
    print(json.dumps({'card': name, 'readings': readings}), flush=True)


if __name__ == '__main__':
    main()
