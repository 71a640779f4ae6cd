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
fails).

An SDMGR or NerClassifier config (``configs/kie/sdmgr/``,
``configs/ner/bert_softmax/``) runs every item of ``data.test`` through
the model one at a time, as the JAX CLI's KIE / NER branch
(``tools/test.py:120-190``): SDMGR's node classes scored by the closed-set
``macro_f1`` (``evaluation.metric_options.macro_f1``'s ``ignores``), or,
on an ``OpensetKIEDataset``, the softmaxed nodes and links
(``edges[:n, :n, 1]``) decoded into key-value pairs and scored by the
openset F1s; NER's per-token argmax scored by the entity F1. It logs the
ms an item (the item's making, the forward and the copy out).
"""
from __future__ import annotations

import argparse
import ast
import json
import logging
import time
from typing import Dict, List, Optional

from ..apis.detector import DET_TYPES
from ..apis.train_kie import KIE_TYPES, NER_TYPES

KIE_NER_TYPES = KIE_TYPES + NER_TYPES


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
        metrics, results = eval_kie_ner(cfg, args, device)
    elif model_type in DET_TYPES:
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



def eval_kie_ner(cfg, args, device=None):
    """The KIE or NER branch of the JAX ``tools/test.py:120-190``; returns
    (metrics, each item's result as lists)."""
    import torch

    from ..apis.train_kie import (build_ner_model, build_sdmgr_apply,
                                  build_task_dataset)
    from ..datasets.kie_dataset import OpensetKIEDataset

    ds = build_task_dataset(cfg, 'test')
    results = []
    if cfg['model']['type'] in KIE_TYPES:
        apply, model, _ = build_sdmgr_apply(cfg, args.checkpoint, ds[0],
                                            device)
        openset = isinstance(ds, OpensetKIEDataset)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            item = ds[i]
            node_cls, edge_cls = apply(model, item)
            if openset:      # the pair decode reads softmaxed nodes, links
                n = int((item['labels'] != -100).sum())
                N = len(item['labels'])
                edges = torch.softmax(edge_cls, -1).reshape(N, N, 2)
                results.append({
                    'filename': item['filename'],
                    'nodes': torch.softmax(node_cls, -1)[:n].cpu().numpy(),
                    'edges': edges[:n, :n, 1].cpu().numpy()})
            else:
                results.append(node_cls.cpu().numpy().argmax(-1))
        item_seconds = time.perf_counter() - t0
        opts = ((cfg.get('evaluation') or {}).get('metric_options')
                or {}).get('macro_f1') or {}
        metrics = ds.evaluate(results, metric=args.eval, **opts)
    else:
        model = build_ner_model(cfg, args.checkpoint, device)
        dev = next(model.parameters()).device
        t0 = time.perf_counter()
        for i in range(len(ds)):
            item = ds[i]
            with torch.inference_mode():
                logits = model(
                    torch.from_numpy(item['input_ids'])[None].to(dev),
                    torch.from_numpy(item['attention_mask'])[None].to(dev))
            results.append(logits.cpu().numpy().argmax(-1)[0])
        item_seconds = time.perf_counter() - t0
        metrics = ds.evaluate(results)
    # the items' making on the host, the forwards and the copies out; the
    # metric's own time is left out
    logging.info('%s eval: %d items, %.2f ms/item', cfg['model']['type'],
                 len(ds), 1e3 * item_seconds / max(len(ds), 1))
    return metrics, [{k: getattr(v, 'tolist', lambda: v)()
                      for k, v in r.items()} if isinstance(r, dict)
                     else r.tolist() for r in results]


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    main()
