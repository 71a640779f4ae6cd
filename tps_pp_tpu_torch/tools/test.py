"""Evaluate a text recognizer on its config's test set, on one GPU
(counterpart of the recognition branch of ``tools/test.py:194-203`` and
``:251-281``):

    python -m tps_pp_tpu_torch.tools.test CONFIG [CHECKPOINT] --eval acc \\
        [--out results.json] [--batch-size N] [--cfg-options k=v ...]

``CHECKPOINT`` is a ``.pth`` / ``.pt`` file with the reference's keys;
without one the weights are random (seed 0). ``--cfg-options`` values are
Python literals where they parse as such, e.g. ``model.dtype=bfloat16``
serves the flagship in bf16 on the kernels. Prints the metrics as JSON;
``--out`` also writes them with every result. One process, one GPU: the
multi-host sharding of the JAX CLI has no counterpart yet. Detection, KIE
and NER configs are not ported (``ROADMAP.md`` queue 1 item 7).
"""
from __future__ import annotations

import argparse
import ast
import json
import logging
from typing import Dict, List, Optional

# model types of the JAX package's other branches
# (tps_pp_tpu/apis/train_det.py:23, tps_pp_tpu/apis/train_kie.py:28-29)
DET_TYPES = ('DBNet', 'PANet', 'PSENet', 'FCENet', 'TextSnake',
             'OCRMaskRCNN', 'DRRG')
KIE_NER_TYPES = ('SDMGR', 'NerClassifier')


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Evaluate a text recognizer')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--eval', default='acc')
    p.add_argument('--out', default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def parse_cfg_options(items: List[str]) -> Dict:
    """``['a.b=v', ...]`` -> ``{'a.b': v}``, ``v`` a Python literal where
    it parses as one, else the string."""
    options = {}
    for kv in items:
        k, v = kv.split('=', 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        options[k] = v
    return options


def main(argv: Optional[List[str]] = None, device=None) -> Dict:
    """Run the evaluation; ``device`` as in ``init_recognizer`` (the GPU
    when None). Returns the metrics."""
    from ..apis import eval_recognizer, init_recognizer
    from ..config import load_config, merge_cli_options
    from ..datasets import build_dataset

    args = parse_args(argv)
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    model_type = cfg['model'].get('type')
    if model_type in DET_TYPES + KIE_NER_TYPES:
        raise NotImplementedError(
            f'{model_type}: detection, KIE and NER evaluation is not ported '
            'yet (ROADMAP.md queue 1 item 7)')
    rec = init_recognizer(cfg, args.checkpoint, device)
    test_ds = build_dataset(cfg['data']['test'], dict(test_mode=True))
    batch = args.batch_size or cfg['data'].get('samples_per_gpu', 64)
    metrics, results = eval_recognizer(rec, test_ds, batch_size=batch,
                                       metric=args.eval, return_results=True)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'metrics': metrics, 'results': results}, f, indent=2)
    return metrics


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    main()
