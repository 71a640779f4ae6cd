"""``train_recognizer``: the training loop (counterpart of the loop of
``tps_pp_tpu/apis/train.py:108-128``) over an iterable of host batches.

Each batch is ``{'img': (N, H, W, C), 'valid_ratio': (N,), 'texts': [str]}``;
the labels come from the recognizer's ``AttnConvertor.str2tensor``. The
model trains in place from its current weights. The dataset, the loader,
checkpoints, resume and the evaluation hooks are not ported yet.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, List, Tuple

import torch

from ..parallel import (OptimizerChain, build_optimizer_from_run_cfg,
                        make_train_step)

logger = logging.getLogger('tps_pp_tpu_torch')


def train_recognizer(rec, batches: Iterable[Dict], cfg: Dict, seed: int = 0
                     ) -> Tuple[OptimizerChain, List[Dict]]:
    """Train ``rec`` (a ``TextRecognizer``) on ``batches``. ``cfg`` keys
    (the reference's names): ``optimizer``, ``lr_config``,
    ``optimizer_config``, ``total_epochs`` (for poly decay),
    ``steps_per_epoch`` (default: ``len(batches)``, else 1),
    ``log_interval``. Dropout masks come from a generator on the model's
    device seeded with ``seed + 1``. Returns the optimizer chain (its
    state and step count) and the logged metrics."""
    steps_per_epoch = int(cfg.get('steps_per_epoch') or (
        len(batches) if hasattr(batches, '__len__') else 1))
    total_epochs = int(cfg.get('total_epochs', 12))
    log_interval = int(cfg.get('log_interval', 50))
    optimizer, schedule = build_optimizer_from_run_cfg(
        cfg, rec.model.named_parameters(), steps_per_epoch=steps_per_epoch,
        total_epochs=total_epochs)
    train_step = make_train_step(rec, optimizer)
    generator = torch.Generator(device=rec.device).manual_seed(seed + 1)
    history = []
    t0 = time.time()
    for it, host_batch in enumerate(batches):
        td = rec.label_convertor.str2tensor(list(host_batch['texts']))
        batch = {'img': host_batch['img'],
                 'valid_ratio': host_batch.get('valid_ratio'),
                 'padded_targets': td['padded_targets']}
        metrics = train_step(batch, generator)
        if it % log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            ips = len(td['padded_targets']) * (it + 1) / max(
                time.time() - t0, 1e-9)
            logger.info('iter %d %s img/s=%.1f lr=%.2e', it, m, ips,
                        schedule(optimizer.count))
            history.append(dict(iter=it, **m))
    return optimizer, history
