#!/usr/bin/env python3
"""How far the bf16 decodes part from themselves, over several seeds, on
one CUDA GPU: the readings behind ``chip_smoke.py``'s ``TIE_MULT``.

    python tools/steps_tie_calibration.py [--paths steps,stem]
        [--seeds 0,1,2,3,4] [--batch 512]

For each seed it builds the full-width flagship (bf16) with that seed's
random weights and a batch of random crops, and measures, as the rows that
part and the widest top-2 gap where they part:

* ``steps`` (a decoder with ``use_fused_step``):
  ``chip_smoke.steps_tie_widths``: the module decode on the encodings of
  the sampler's kernel and plain versions (the decode's own sensitivity),
  the fused-step kernels against their plain versions on one encoding, and
  the fused-step path against its plain path;
* ``stem`` (``fused40_bf16``): ``chip_smoke.stem_tie_widths``: the module
  stem against the fused stem's plain version (the decode's sensitivity to
  the stem's rounding), the fused stem's kernels against their plain
  versions, and the fused-stem path against its plain path.

It prints one line per seed and path with the gaps' ratios to the first
reading's, the card's ``nvidia-smi`` name and power limit, and one JSON
line of all readings.
"""
import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--paths', default='steps,stem')
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
    # path: (widths of (recognizer, img), the reference reading, the others)
    paths = {'steps': (chip_smoke.steps_tie_widths, 'module',
                       ('kernels', 'path')),
             'stem': (chip_smoke.stem_tie_widths, 'module',
                      ('kernel', 'path'))}
    readings = []
    for seed in (int(s) for s in args.seeds.split(',')):
        rec.init_weights(seed)
        g = np.random.default_rng(seed)
        img = torch.from_numpy(g.standard_normal(
            (args.batch,) + FLAGSHIP_INPUT).astype(np.float32)).to(
                rec.device, rec.dtype)
        for path in args.paths.split(','):
            widths, ref, others = paths[path]
            w = widths(rec, img)
            mod = w[ref][1]
            ratios = {k: (w[k][1] / mod if mod else None) for k in others}
            readings.append(dict(decode=path, seed=seed, batch=args.batch,
                                 widths=w, ratios=ratios))
            print(f'{path} seed {seed} B={args.batch}: (rows that part, '
                  f'widest top-2 gap) {w}; ratios to {ref} {ratios} '
                  f'[{name}]', flush=True)
    print(json.dumps({'card': name, 'readings': readings}), flush=True)


if __name__ == '__main__':
    main()
