"""Evaluate a text recognizer or a detector on its config's test set
(counterpart of ``tools/test.py:34-285``):

    python -m tps_pp_tpu_torch.tools.test CONFIG [CHECKPOINT] --eval acc \\
        [--out results.json] [--batch-size N] [--cfg-options k=v ...] \\
        [--device cpu]
    torchrun --nproc_per_node G -m tps_pp_tpu_torch.tools.test CONFIG ...

``CHECKPOINT`` is a ``.pth`` / ``.pt`` file with the reference's keys;
without one the weights are random (seed 0). ``--cfg-options`` values are
Python literals where they parse as such, e.g. ``model.dtype=bfloat16``
serves the flagship in bf16 on the kernels. Prints the metrics as JSON;
``--out`` also writes them with every result.

Under ``torchrun`` (several processes, one card each, or gloo with
``--device cpu``) each rank evaluates a strided shard of the test set
(``_ShardView``: items rank, rank + P, ...), the shards' results are
gathered with ``all_gather_object`` and put back in dataset order
(``_interleave``), and every rank computes the metrics; only rank 0 prints
and writes. All three branches (recognition, detection, KIE / NER) do
this. Run as one process it evaluates on one card, whatever the machine
has: a mesh of local cards in one process (``predict(mesh=)``) measured
slower than one card (PERF.md, section 6), so the CLI does not build one.

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
import os
import time
from typing import Dict, List, Optional

import torch

from ..apis.detector import DET_TYPES
from ..apis.train_kie import KIE_TYPES, NER_TYPES
from ..parallel import dist

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
    p.add_argument('--device', default=None,
                   help='cpu, or a CUDA device (default: cuda:LOCAL_RANK)')
    return p.parse_args(argv)


class _ShardView:
    """The strided shard of a dataset that rank ``rank`` of ``world``
    evaluates (items rank, rank + world, ...); its ``evaluate`` is a stub,
    the metrics being computed on the gathered results."""

    def __init__(self, ds, rank: int, world: int):
        self.ds = ds
        self.indices = range(rank, len(ds), world)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[self.indices[i]]

    def sample(self, i, key=None):
        get = getattr(self.ds, 'sample', None)
        return (get(self.indices[i], key) if get is not None
                else self.ds[self.indices[i]])

    def evaluate(self, results, **kwargs):
        return {}


def _interleave(per_rank, n_total: int):
    """Dataset order from the strided per-rank result lists."""
    out = [None] * n_total
    for r, res in enumerate(per_rank):
        for j, item in enumerate(res):
            out[r + j * len(per_rank)] = item
    assert all(x is not None for x in out)
    return out


def _collect_results(shard_results, n_total: int):
    """Every rank's results, in dataset order, on every rank (the
    reference's ``collect_results_gpu``; the JAX CLI's
    ``process_allgather``)."""
    if not dist.is_active():
        return shard_results
    per_rank = [None] * dist.world_size()
    torch.distributed.all_gather_object(per_rank, shard_results)
    return _interleave(per_rank, n_total)


def _shard(ds):
    return (_ShardView(ds, dist.rank(), dist.world_size())
            if dist.is_active() else ds)


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
    when None; ``--device`` when given). Joins the process group that
    ``torchrun``'s environment describes. Returns the metrics."""
    from ..apis import eval_recognizer, init_recognizer
    from ..config import load_config, merge_cli_options
    from ..datasets import build_dataset
    from ..parallel import maybe_init_distributed

    args = parse_args(argv)
    device = args.device or device
    joined = not dist.is_active() and 'WORLD_SIZE' in os.environ
    if dist.is_active() or joined:
        device = maybe_init_distributed(device)
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
        _, results = eval_recognizer(rec, _shard(test_ds), batch_size=batch,
                                     metric=args.eval, return_results=True)
        results = _collect_results(results, len(test_ds))
        metrics = test_ds.evaluate(results, metric=args.eval)
    if dist.rank() == 0:
        print(json.dumps(metrics, indent=2))
        if args.out:
            with open(args.out, 'w') as f:
                json.dump({'metrics': metrics, 'results': results}, f,
                          indent=2)
    if joined:
        torch.distributed.destroy_process_group()
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
    shard = _shard(ds)
    batch = args.batch_size or cfg['data'].get('samples_per_gpu', 8)
    preds = []
    t0 = time.perf_counter()
    for i in range(0, len(shard), batch):
        imgs = [(shard.sample(j)['img'] * 255).astype('uint8')
                for j in range(i, min(i + batch, len(shard)))]
        preds.extend(det.detect_batch(imgs))
    logging.info('det eval: %d images, %.1f ms/image', len(shard),
                 1e3 * (time.perf_counter() - t0) / max(len(shard), 1))
    preds = _collect_results(preds, len(ds))
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

    full = build_task_dataset(cfg, 'test')
    ds = _shard(full)
    results = []
    if cfg['model']['type'] in KIE_TYPES:
        apply, model, _ = build_sdmgr_apply(cfg, args.checkpoint, ds[0],
                                            device)
        openset = isinstance(full, OpensetKIEDataset)
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
        results = _collect_results(results, len(full))
        opts = ((cfg.get('evaluation') or {}).get('metric_options')
                or {}).get('macro_f1') or {}
        metrics = full.evaluate(results, metric=args.eval, **opts)
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
        results = _collect_results(results, len(full))
        metrics = full.evaluate(results)
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
