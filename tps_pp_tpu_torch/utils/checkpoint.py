"""Training checkpoints as ``.pth`` files (counterpart of
``tps_pp_tpu/utils/checkpoint.py:22-135``; the reference's mmcv
``CheckpointHook``, ``load_checkpoint`` and ``runner.resume``).

A checkpoint is mmcv's layout: ``{'meta': {'epoch', 'step', 'seed',
'config'}, 'state_dict': ..., 'optimizer': ...}``. The ``state_dict`` has
the reference's keys, those ``init_recognizer`` and ``load_pth`` read; the
optimizer entry is ``OptimizerChain.state_dict()``, the step count with
the torch optimizer's state. The JAX package keeps orbax directories,
which need JAX to read; the port reads and writes ``.pth`` only.

``CheckpointManager`` writes ``epoch_{n}.pth`` into a work dir and keeps
the newest ``MAX_TO_KEEP`` (5, orbax's ``max_to_keep``). Tensors keep
their device in the file; every reader maps them to the CPU. Only rank 0
writes. ``load_weights`` is ``--load-from`` (weights only); ``restore`` is
``--resume-from`` (weights, optimizer state and step), from a ``.pth``
path or a work dir's newest checkpoint. Loading copies into the model's
tensors in place, so the caches derived from the weights
(``weights_stamp``) follow the new values.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from ..parallel import dist
from .convert import load_pth

_NAME = re.compile(r'^epoch_(\d+)\.pth$')
MAX_TO_KEEP = 5     # orbax's max_to_keep in the JAX package


def checkpoints(directory: str) -> Dict[int, str]:
    """``{epoch: path}`` of the ``epoch_{n}.pth`` files in ``directory``."""
    if not os.path.isdir(directory):
        return {}
    return {int(m.group(1)): os.path.join(directory, f)
            for f in os.listdir(directory) if (m := _NAME.match(f))}


def resolve(path: str) -> str:
    """A ``.pth`` path as given; a directory's newest ``epoch_{n}.pth``."""
    if os.path.isdir(path):
        found = checkpoints(path)
        if not found:
            raise FileNotFoundError(f'{path}: no epoch_*.pth checkpoint')
        return found[max(found)]
    if not path.endswith(('.pth', '.pt')):
        raise ValueError(f'{path}: the port reads torch checkpoints (.pth, '
                         '.pt) or a directory of them')
    return path


class CheckpointManager:
    """``epoch_{n}.pth`` files in ``directory``, the newest
    ``MAX_TO_KEEP`` kept."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def save(self, epoch: int, model: torch.nn.Module, optimizer,
             meta: Optional[Dict] = None,
             state: Optional[Tuple[Dict, Dict]] = None) -> Optional[str]:
        """Write ``epoch_{epoch}.pth`` on rank 0 (other ranks write
        nothing and get None); drop the oldest beyond ``MAX_TO_KEEP``.
        ``state``: the (state_dict, optimizer state) to write in place of
        the model's and the optimizer's own (a split model's, gathered
        whole: ``parallel.tp``)."""
        if dist.rank() != 0:
            return None
        sd, osd = state if state is not None else (model.state_dict(),
                                                   optimizer.state_dict())
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f'epoch_{epoch}.pth')
        state = {
            'meta': dict(meta or {}, epoch=epoch, step=optimizer.count),
            'state_dict': sd,
            'optimizer': osd,
        }
        tmp = path + '.tmp'
        torch.save(state, tmp)
        os.replace(tmp, path)
        found = checkpoints(self.directory)
        for old in sorted(found)[:-MAX_TO_KEEP]:
            os.remove(found[old])
        return path


def config_text(cfg) -> str:
    """A config as JSON text for ``meta['config']``."""
    return json.dumps(cfg, default=str, sort_keys=True)


def load_weights(model: torch.nn.Module, path: str):
    """``--load-from``: the checkpoint's weights (strict), nothing else."""
    model.load_state_dict(load_pth(resolve(path)), strict=True)


def restore(model: torch.nn.Module, optimizer, path: str) -> Dict:
    """``--resume-from``: weights, optimizer state and step count from a
    ``.pth`` or a directory's newest checkpoint; returns its ``meta``."""
    ckpt = torch.load(resolve(path), map_location='cpu', weights_only=True)
    model.load_state_dict(ckpt['state_dict'], strict=True)
    optimizer.load_state_dict(ckpt['optimizer'])
    return ckpt['meta']

