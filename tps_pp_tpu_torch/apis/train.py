"""``train_recognizer``: the training loop (counterpart of
``tps_pp_tpu/apis/train.py:31-136``, the reference's ``apis/train.py``).

Per step: a batch of the seeded shuffling ``DataLoader`` (this rank's share
under a process group), its labels from the recognizer's convertor's
``str2tensor`` (``padded_targets``, and ``target_lengths`` where it makes
them), and ``make_train_step`` with the dropout generator of the step.
Per epoch: a checkpoint (``work_dir``), the evaluation hook
(``eval_recognizer`` on ``val_dataset``, rank 0) and the log.
``load_from`` loads weights only; ``resume_from`` (a ``.pth`` or a work
dir) restores weights, optimizer state and step, and the run goes on
from the epoch the step lies in, so a finished job replays nothing.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..datasets.ocr_dataset import DataLoader
from ..parallel import (OptimizerChain, build_optimizer_from_run_cfg, dist,
                        make_train_step, param_sharding, step_generator, tp)
from ..utils import checkpoint
from ..utils.convert import rules_for_config
from .test import eval_recognizer

logger = logging.getLogger('tps_pp_tpu_torch')


def train_recognizer(rec, train_dataset, cfg: Dict, val_dataset=None,
                     work_dir: Optional[str] = None,
                     resume_from: Optional[str] = None,
                     load_from: Optional[str] = None, seed: int = 0,
                     mesh=None) -> Tuple[OptimizerChain, List[Dict]]:
    """Train ``rec`` (a ``TextRecognizer`` or ``ABINetRecognizer``) on
    ``train_dataset``, from ``rec.init_weights(seed)`` unless
    ``load_from`` / ``resume_from`` say otherwise. ``cfg`` keys (the
    reference's names): ``samples_per_gpu`` (the global batch, rounded
    up to a multiple of the ranks), ``total_epochs``, ``optimizer``,
    ``lr_config``, ``optimizer_config``, ``log_interval``,
    ``workers_per_gpu``. Returns the optimizer chain
    (its state and step count) and the history: the logged metrics of each
    ``log_interval``-th step and each epoch's evaluation. Also logs, each
    epoch, images/s and the seconds the step loop waited on the loader."""
    batch_size = int(cfg.get('samples_per_gpu', 64))
    total_epochs = int(cfg.get('total_epochs', 12))
    log_interval = int(cfg.get('log_interval', 50))
    world, rank = dist.world_size(), dist.rank()
    if mesh is not None:
        if not mesh.distributed and len(mesh.devices) > 1:
            raise ValueError('train_recognizer(mesh=) takes a mesh over the '
                             'ranks of a process group (one card a rank)')
        world, data_rank = mesh.shape['data'], mesh.data_index
    else:
        data_rank = rank
    if batch_size % world:
        batch_size = -(-batch_size // world) * world
        logger.info('batch size rounded up to %d (a multiple of the %d '
                    'ranks)', batch_size, world)
    device = rec.device
    loader = DataLoader(train_dataset, batch_size, shuffle=True, seed=seed,
                        num_workers=int(cfg.get('workers_per_gpu', 0)),
                        pin_memory=device.type == 'cuda', rank=data_rank,
                        world_size=world)
    steps_per_epoch = len(loader)
    optimizer, schedule = build_optimizer_from_run_cfg(
        cfg, rec.model.named_parameters(), steps_per_epoch=steps_per_epoch,
        total_epochs=total_epochs)
    rec.init_weights(seed)
    if load_from:
        checkpoint.load_weights(rec.model, load_from)
    if resume_from:
        meta = checkpoint.restore(rec.model, optimizer, resume_from)
        logger.info('resumed from %s: epoch %s, step %d', resume_from,
                    meta.get('epoch'), optimizer.count)
    dist.broadcast_from_rank0(list(rec.model.parameters())
                              + list(rec.model.buffers()))
    split = mesh is not None and mesh.shape['model'] > 1
    if split:
        tp.shard_model(rec.model, mesh, param_sharding(
            rec.model, mesh, rules_for_config(rec.cfg)))
        tp.shard_optimizer_state(optimizer, rec.model)
        optimizer.set_model_parallel(mesh.group('model'),
                                     tp.sharded_parameters(rec.model))
    ckpt = checkpoint.CheckpointManager(work_dir) if work_dir else None
    train_step = make_train_step(rec, optimizer, mesh)
    start_epoch = min(optimizer.count // max(steps_per_epoch, 1),
                      total_epochs)
    history: List[Dict] = []
    try:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            waited, images = 0.0, 0
            t_fetch = time.perf_counter()
            for it, host_batch in enumerate(loader):
                waited += time.perf_counter() - t_fetch
                td = rec.label_convertor.str2tensor(host_batch['texts'])
                batch = {
                    'img': torch.as_tensor(host_batch['img']).to(
                        device, non_blocking=True),
                    'valid_ratio': torch.as_tensor(
                        host_batch['valid_ratio']).to(device,
                                                      non_blocking=True),
                    'padded_targets': td['padded_targets']}
                # the ABINet convertor's lengths, which ABILoss reads
                # (tps_pp_tpu/apis/train.py:118-119)
                if 'target_lengths' in td:
                    batch['target_lengths'] = td['target_lengths']
                lr = schedule(optimizer.count)
                gen = step_generator(seed + 1, optimizer.count, device,
                                     data_rank)
                metrics = train_step(batch, gen)
                images += len(host_batch['texts']) * world
                if it % log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    ips = images / max(time.perf_counter() - t0, 1e-9)
                    if rank == 0:
                        logger.info('epoch %d iter %d/%d %s img/s=%.1f '
                                    'lr=%.2e', epoch, it, steps_per_epoch, m,
                                    ips, lr)
                    history.append(dict(epoch=epoch, iter=it, lr=lr, **m))
                t_fetch = time.perf_counter()
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            history.append(dict(epoch=epoch, images=images, seconds=seconds,
                                loader_wait=waited))
            if rank == 0:
                logger.info('epoch %d: %d images in %.2f s (%.1f img/s), '
                            '%.2f s waiting on the loader', epoch, images,
                            seconds, images / max(seconds, 1e-9), waited)
            whole = None
            if split and (ckpt is not None or val_dataset is not None):
                whole = (tp.gather_state_dict(rec.model),
                         tp.gather_optimizer_state(optimizer, rec.model))
            if ckpt is not None:
                ckpt.save(epoch + 1, rec.model, optimizer,
                          meta=dict(seed=seed,
                                    config=checkpoint.config_text(cfg)),
                          state=whole)
            if val_dataset is not None and rank == 0:
                res = eval_recognizer(
                    _whole_copy(rec, whole[0]) if split else rec,
                    val_dataset, batch_size=batch_size // world)
                logger.info('epoch %d eval: %s', epoch, res)
                history.append(dict(epoch=epoch, eval=res))
            dist.barrier(device)
    finally:
        loader.close()
    return optimizer, history


def _whole_copy(rec, state_dict):
    """A recognizer of ``rec``'s config holding the whole ``state_dict``,
    for the evaluation of a split model."""
    from .recognizer import _DTYPES, build_recognizer
    name = {v: k for k, v in _DTYPES.items()}[rec.param_dtype]
    whole = build_recognizer(rec.cfg, rec.device, name)
    whole.model.load_state_dict(state_dict, strict=True)
    whole.test_pipeline_cfg = rec.test_pipeline_cfg
    return whole
