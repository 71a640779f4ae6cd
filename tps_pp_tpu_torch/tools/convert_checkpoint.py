"""Check a reference checkpoint against a config and write it weights-only
(counterpart of ``tools/convert_checkpoint.py``):

    python -m tps_pp_tpu_torch.tools.convert_checkpoint CKPT.pth OUT.pth \\
        --config CONFIG [--input-shape H W C] [--device cpu] [--no-verify]

The port's ``state_dict`` keys are the reference's, so the JAX CLI's
conversion is a check here: every key of the ``.pth`` must fall under a
module of the config's rule table (``utils.convert.rules_for_config``) or
be a buffer of the config's model (the sinusoid tables, BatchNorm
counters), and every module of the table must be in it (but a stage's
optional downsample). A key left over raises a ``ValueError`` naming it;
the model then loads the weights strictly. OUT is ``{'state_dict': ...}``.
Unless ``--no-verify``, OUT is read back through ``init_recognizer`` and
its predictions on two random crops must equal the in-memory model's, bit
for bit, and be finite. The model runs on the card, or on the CPU with
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional


def check_coverage(sd: Dict, cfg, buffers) -> None:
    """Raise a ``ValueError`` unless the rule table of the model config
    ``cfg`` covers every key of ``sd`` but ``buffers``, and every module
    of the table but a downsample is in ``sd``."""
    from ..utils.convert import rules_for_config
    prefixes = [tp + '.' for tp, _, _ in rules_for_config(cfg)]
    left = sorted(k for k in sd if k not in buffers and
                  not any(k.startswith(p) for p in prefixes))
    if left:
        raise ValueError(f'{len(left)} checkpoint keys not covered by the '
                         f'rules of {cfg.get("type")!r} (config/checkpoint '
                         f'mismatch?): {left[:8]}')
    missing = [p[:-1] for p in prefixes if '.downsample.' not in p and
               not any(k.startswith(p) for k in sd)]
    if missing:
        raise ValueError(f'{len(missing)} modules of the config not in the '
                         f'checkpoint: {missing[:8]}')


def main(argv: Optional[List[str]] = None) -> dict:
    import numpy as np
    import torch

    from ..apis.inference import init_recognizer
    from ..config import load_config
    from ..utils.convert import load_pth

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('pth', help='reference torch checkpoint (.pth)')
    p.add_argument('out', help='the weights-only .pth to write')
    p.add_argument('--config', required=True)
    p.add_argument('--input-shape', type=int, nargs=3, default=None,
                   metavar=('H', 'W', 'C'))
    p.add_argument('--device', default=None,
                   help="'cpu' for the CPU; the card when left out")
    p.add_argument('--no-verify', action='store_true')
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    rec = init_recognizer(cfg, device=args.device)
    sd = load_pth(args.pth)
    check_coverage(sd, cfg['model'],
                   {k for k, _ in rec.model.named_buffers()})
    rec.model.load_state_dict(sd, strict=True)
    n_params = sum(t.numel() for t in rec.model.parameters())
    print(f'checked {len(sd)} torch tensors -> {n_params:,} model '
          f'parameters')
    torch.save({'state_dict': sd}, args.out)
    print(f'wrote {args.out} (from {os.path.abspath(args.pth)})')
    out = {'tensors': len(sd), 'params': n_params, 'verified': False}
    if not args.no_verify:
        shape = tuple(args.input_shape or cfg.get('input_shape') or
                      (32, 128, 3))
        rec2 = init_recognizer(cfg, args.out, device=args.device, seed=1)
        img = np.random.default_rng(0).standard_normal(
            (2, *shape)).astype(np.float32)
        a = rec.predict(img).cpu()
        b = rec2.predict(img).cpu()
        if not torch.equal(a, b) or not bool(torch.isfinite(a).all()):
            raise AssertionError('round trip: the file\'s predictions are '
                                 'not the in-memory ones')
        print('round-trip verified: file-loaded predictions identical to '
              'the in-memory model')
        out['verified'] = True
    return out


if __name__ == '__main__':
    main()
