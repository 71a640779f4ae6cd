"""Train a text recognizer or detector (counterpart of ``tools/train.py:
36-109``):

    python -m tps_pp_tpu_torch.tools.train CONFIG [--work-dir WD] \\
        [--load-from CKPT.pth] [--resume-from CKPT.pth|WD] [--seed N] \\
        [--cfg-options k=v ...]

On several GPUs of one host, one process each (recognizers):

    torchrun --nproc_per_node=G -m tps_pp_tpu_torch.tools.train CONFIG ...

``torchrun``'s environment makes each process join an NCCL group on
``cuda:LOCAL_RANK`` (``parallel.maybe_init_distributed``); the config's
``samples_per_gpu`` is the global batch, split over the processes.
``--cfg-options`` values are Python literals where they parse as such.
The datasets of the config load their images from files, which needs cv2
(``LoadImageFromFile``).

A DBNet, PANet, PSENet, FCENet, TextSnake, DRRG or OCRMaskRCNN config
trains through ``train_detector`` on one GPU, ``data.train`` built
through the port's registry (a ``UniformConcatDataset`` of
``IcdarDataset``s, which the JAX CLI passes to ``TextDetDataset`` and
fails on), in batches of
``samples_per_gpu`` (the JAX CLI leaves ``train_detector``'s default of
4; DRRG and Mask R-CNN one page a step, as JAX's loops), for
``total_epochs``, with no augmentation (JAX's loop runs no
``train_pipeline``).

An SDMGR or NerClassifier config trains through ``train_kie`` /
``train_ner`` on one GPU (the JAX CLI's ``tools/train.py:60-67``):
``data.train`` built by its ``type`` (``build_task_dataset``), batches of
``samples_per_gpu``, ``total_epochs`` epochs, a ``.pth`` each.
"""
from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from .test import DET_TYPES, KIE_NER_TYPES, parse_cfg_options


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Train a text recognizer')
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--load-from', default=None)
    p.add_argument('--resume-from', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args(argv)


def train_cfg_of(cfg) -> dict:
    """The ``train_recognizer`` keys of a run config (the JAX CLI's)."""
    data = cfg.get('data', {})
    return dict(
        samples_per_gpu=data.get('samples_per_gpu', 64),
        total_epochs=cfg.get('total_epochs', 12),
        optimizer=cfg.get('optimizer', dict(type='Adam', lr=1e-4)),
        optimizer_config=cfg.get('optimizer_config', {}),
        lr_config=cfg.get('lr_config', {}),
        log_interval=cfg.get('log_config', {}).get('interval', 50),
        workers_per_gpu=data.get('workers_per_gpu', 0))


def main(argv: Optional[List[str]] = None, device=None):
    """Train; ``device`` as in ``build_recognizer`` (the process's GPU
    when None). Returns ``train_recognizer``'s (optimizer, history), or
    ``train_detector``'s, ``train_kie``'s or ``train_ner``'s (model,
    optimizer, history)."""
    from ..apis import build_recognizer, train_recognizer
    from ..config import load_config, merge_cli_options
    from ..datasets import build_dataset
    from ..parallel import maybe_init_distributed

    args = parse_args(argv)
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    model_type = cfg['model'].get('type')
    if model_type in KIE_NER_TYPES:
        from ..apis.train_kie import (KIE_TYPES, build_task_dataset,
                                      train_kie, train_ner)
        data = cfg.get('data', {})
        return (train_kie if model_type in KIE_TYPES else train_ner)(
            cfg, build_task_dataset(cfg, 'train'), work_dir=args.work_dir,
            batch_size=int(data.get('samples_per_gpu', 4)),
            log_interval=cfg.get('log_config', {}).get('interval', 10),
            seed=args.seed, device=device, resume_from=args.resume_from,
            load_from=args.load_from)
    if model_type in DET_TYPES:
        from ..apis.train_det import train_detector
        data = cfg.get('data', {})
        return train_detector(
            cfg, build_dataset(data['train']), work_dir=args.work_dir,
            batch_size=int(data.get('samples_per_gpu', 4)),
            log_interval=cfg.get('log_config', {}).get('interval', 10),
            seed=args.seed, device=device, resume_from=args.resume_from,
            load_from=args.load_from)
    device = maybe_init_distributed(device)
    rec = build_recognizer(cfg['model'], device, param_dtype='float32')
    train_ds = build_dataset(cfg['data']['train'])
    val_ds = (build_dataset(cfg['data']['val'], dict(test_mode=True))
              if 'val' in cfg.get('data', {}) else None)
    return train_recognizer(rec, train_ds, train_cfg_of(cfg),
                            val_dataset=val_ds, work_dir=args.work_dir,
                            resume_from=args.resume_from,
                            load_from=args.load_from, seed=args.seed)


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    main()
