"""Evaluate a text recognizer or a detector on its config's test set, on
one GPU (counterpart of ``tools/test.py:194-281``):

    python -m tps_pp_tpu_torch.tools.test CONFIG [CHECKPOINT] --eval acc \\
        [--out results.json] [--batch-size N] [--cfg-options k=v ...]

``CHECKPOINT`` is a ``.pth`` / ``.pt`` file with the reference's keys;
without one the weights are random (seed 0). ``--cfg-options`` values are
Python literals where they parse as such, e.g. ``model.dtype=bfloat16``
serves the flagship in bf16 on the kernels. Prints the metrics as JSON;
``--out`` also writes them with every result. One process, one GPU: the
multi-host sharding of the JAX CLI has no counterpart yet.

A DBNet, PANet, PSENet, FCENet, TextSnake, DRRG or OCRMaskRCNN config
(``configs/textdet/{dbnet, panet, psenet, fcenet, textsnake, drrg,
maskrcnn}/``) detects every test image at ``det_img_size`` (640 x 640 unless the config
sets it) in batches of ``--batch-size`` or the config's ``samples_per_gpu``,
logs the ms an image, and scores the boundaries with ``--eval``
(``hmean-iou`` for ``acc``, or ``hmean-ic13``). ``data.test`` is built
through the port's registry, so a ``UniformConcatDataset`` of
``IcdarDataset``s works (the JAX CLI passes it to ``TextDetDataset`` and
fails). KIE and NER raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import ast
import json
import logging
import time
from typing import Dict, List, Optional

from ..apis.detector import DET_TYPES

# model types of the JAX package's KIE and NER branches
# (tps_pp_tpu/apis/train_kie.py:28-29)
KIE_NER_TYPES = ('SDMGR', 'NerClassifier')


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description='Evaluate a text recognizer or a text detector')
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
    if model_type in KIE_NER_TYPES:
        raise NotImplementedError(
            f'{model_type}: KIE and NER evaluation is not ported yet '
            '(ROADMAP.md queue 1, KIE and NER)')
    if model_type in DET_TYPES:
        metrics, results = eval_detector(cfg, args, device)
    else:
        rec = init_recognizer(cfg, args.checkpoint, device)
        test_ds = build_dataset(cfg['data']['test'], dict(test_mode=True))
        batch = args.batch_size or cfg['data'].get('samples_per_gpu', 64)
        metrics, results = eval_recognizer(rec, test_ds, batch_size=batch,
                                           metric=args.eval,
                                           return_results=True)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'metrics': metrics, 'results': results}, f, indent=2)
    return metrics


def eval_detector(cfg, args, device=None):
    """Detect every test image and score the boundaries (the det branch of
    the JAX ``tools/test.py:214-249``); returns (metrics, each image's
    boundaries as lists)."""
    from ..apis.detector import init_detector
    from ..datasets import build_dataset

    det = init_detector(cfg, args.checkpoint,
                        img_size=tuple(cfg.get('det_img_size', (640, 640))),
                        device=device)
    ds = build_dataset(cfg['data']['test'], dict(test_mode=True))
    batch = args.batch_size or cfg['data'].get('samples_per_gpu', 8)
    preds = []
    t0 = time.perf_counter()
    for i in range(0, len(ds), batch):
        imgs = [(ds.sample(j)['img'] * 255).astype('uint8')
                for j in range(i, min(i + batch, len(ds)))]
        preds.extend(det.detect_batch(imgs))
    logging.info('det eval: %d images, %.1f ms/image', len(ds),
                 1e3 * (time.perf_counter() - t0) / max(len(ds), 1))
    metric = 'hmean-iou' if args.eval in ('acc', 'hmean-iou') else args.eval
    return (ds.evaluate(preds, metric=metric),
            [[b.tolist() for b in p] for p in preds])


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    main()
