"""Publish a training checkpoint as a weights-only file (counterpart of
``tools/publish_model.py``; the reference's ``tools/publish_model.py``:
strip the optimizer state, append a content hash):

    python -m tps_pp_tpu_torch.tools.publish_model CKPT OUT_PREFIX \\
        [--config CONFIG]

CKPT is a ``.pth`` or a work dir (its newest ``epoch_{n}.pth``). The file
written is ``{'state_dict': ...}`` alone, at
``OUT_PREFIX-<first 8 hex digits of its sha256>.pth``, whose path is
printed. With ``--config`` the weights are first loaded, strictly, into
the config's model on the CPU.
"""
from __future__ import annotations

import argparse
import hashlib
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    import torch

    from ..utils.checkpoint import resolve
    from ..utils.convert import load_pth

    p = argparse.ArgumentParser(description='Publish a checkpoint')
    p.add_argument('checkpoint', help='a .pth or a work dir')
    p.add_argument('out_prefix')
    p.add_argument('--config', default=None,
                   help='check that the weights load into its model')
    args = p.parse_args(argv)
    sd = load_pth(resolve(args.checkpoint))
    if args.config:
        from ..apis.inference import init_recognizer
        init_recognizer(args.config, device='cpu').model.load_state_dict(
            sd, strict=True)
    tmp = args.out_prefix + '.pth.tmp'
    torch.save({'state_dict': sd}, tmp)
    with open(tmp, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    final = f'{args.out_prefix}-{digest}.pth'
    os.replace(tmp, final)
    print('published', final)
    return final


if __name__ == '__main__':
    main()
