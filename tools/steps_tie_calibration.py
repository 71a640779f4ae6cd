#!/usr/bin/env python3
"""How far the bf16 decodes part from themselves, over several seeds, on
one CUDA GPU: the readings behind ``chip_smoke.py``'s ``TIE_MULT``.

    python tools/steps_tie_calibration.py [--paths steps,stem,transformer]
        [--seeds 0,1,2,3,4] [--batch 512] [--config nrtr_modality]

For each seed it builds a full-width model (bf16) with that seed's random
weights and a batch of random crops, and measures, as the rows that part
and the widest top-2 gap where they part:

* ``steps`` (the flagship, a decoder with ``use_fused_step``):
  ``chip_smoke.steps_tie_widths``: the module decode on the encodings of
  the sampler's kernel and plain versions (the decode's own sensitivity),
  the fused-step kernels against their plain versions on one encoding, and
  the fused-step path against its plain path;
* ``stem`` (the flagship, ``fused40_bf16``): ``chip_smoke.stem_tie_widths``:
  the module stem against the fused stem's plain version (the decode's
  sensitivity to the stem's rounding), the fused stem's kernels against
  their plain versions, and the fused-stem path against its plain path;
* ``transformer`` (``--config``, a key of ``chip_smoke.TRANSFORMER_CONFIGS``,
  ``'auto'`` on crops of its width with random valid ratios):
  ``chip_smoke.transformer_tie_widths``: the plain whole decode against
  itself on an encoding one bf16 ulp away and on the float32 encoder's,
  kernel 4 against its plain version on one encoding; and the path against
  its plain path.

It prints one line per seed and path with the ratios of each reading to
the sensitivity that sets its width (the kernels' to the first reading,
the path's to the upstream rounding's), the card's ``nvidia-smi`` name and
power limit, and one JSON line of all readings.
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
    ap.add_argument('--config', default='nrtr_modality',
                    help='the transformer path\'s model, a key of '
                    'chip_smoke.TRANSFORMER_CONFIGS')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('steps_tie_calibration: no CUDA device')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    # as chip_smoke.py: plain f32 products on the card stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    name = chip_smoke.card()
    paths = args.paths.split(',')

    def flagship(seed, g):
        img = torch.from_numpy(g.standard_normal(
            (args.batch,) + FLAGSHIP_INPUT).astype(np.float32)).to(
                rec.device, rec.dtype)
        return rec, (img,)

    def transformer(seed, g):
        path, width = chip_smoke.TRANSFORMER_CONFIGS[args.config]
        cfg = load_config(os.path.join(root, path))
        merge_cli_options(cfg, {'model.dtype': 'bfloat16'})
        r = build_recognizer(dict(cfg['model']))
        r.init_weights(seed)
        x = g.standard_normal((args.batch, 32, width, 3)).astype(np.float32)
        wd = g.choice(np.arange(32, width + 1, 4), args.batch)
        for i, w in enumerate(wd):
            x[i, :, w:] = 0.0
        x = torch.from_numpy(x).to(r.device, r.dtype)
        v = torch.from_numpy((wd / width).astype(np.float32)).to(r.device)
        return r, (x, v)

    def transformer_widths(r, x, v):
        w = chip_smoke.transformer_tie_widths(r, x, v, 'calibration')[0]
        r.plain = False
        out = r.predict(x, v)
        r.plain = True
        w['path'] = chip_smoke.check_decode(out, r.predict(x, v),
                                            'calibration path',
                                            near_tie=1.0)[1:]
        return w

    # path: (model and inputs of (seed, rng), widths of (model, *inputs),
    # (reading, the reading that sets its width) pairs)
    table = {'steps': (flagship, chip_smoke.steps_tie_widths,
                       (('kernels', 'module'), ('path', 'module'))),
             'stem': (flagship, chip_smoke.stem_tie_widths,
                      (('kernel', 'module'), ('path', 'module'))),
             'transformer': (transformer, transformer_widths,
                             (('kernel', 'ulp'), ('path', 'encoder')))}
    rec = None
    if {'steps', 'stem'} & set(paths):
        cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='steps')
        cfg['decoder'] = dict(cfg['decoder'], use_fused_step=True)
        rec = build_recognizer(cfg)
    readings = []
    for seed in (int(s) for s in args.seeds.split(',')):
        if {'steps', 'stem'} & set(paths):
            rec.init_weights(seed)
        for path in paths:
            make, widths, pairs = table[path]
            model, inputs = make(seed, np.random.default_rng(seed))
            w = widths(model, *inputs)
            ratios = {k: (w[k][1] / w[ref][1] if w[ref][1] else None)
                      for k, ref in pairs}
            readings.append(dict(decode=path, seed=seed, batch=args.batch,
                                 widths=w, ratios=ratios))
            print(f'{path} seed {seed} B={args.batch}: (rows that part, '
                  f'widest top-2 gap) {w}; ratios {ratios} (to '
                  f'{dict(pairs)}) [{name}]', flush=True)
            if model is not rec:
                del model
                torch.cuda.empty_cache()
    print(json.dumps({'card': name, 'readings': readings}), flush=True)


if __name__ == '__main__':
    main()
