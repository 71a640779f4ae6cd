"""Data parallelism over processes (counterpart of ``tps_pp_tpu/parallel/
mesh.py``'s data axis and ``tps_pp_tpu/utils/platform.py:25-51``
``maybe_init_distributed``).

One process a GPU, started by ``torchrun``, which exports ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``. A
single process runs with no group, as the JAX CLI runs without
``jax.distributed``. The batch is split over the ranks: each takes its
share of every global batch (``datasets.DataLoader``), the gradients are
averaged over the ranks after the backward (``parallel.train``), and
train-mode BatchNorm takes its statistics over the global batch
(``models.layers.BatchNorm2d``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def is_active() -> bool:
    """True when a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def maybe_init_distributed(device=None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``WORLD_SIZE`` set): NCCL on the card, gloo on the CPU. Returns the
    process's device: ``cuda:LOCAL_RANK`` unless ``device`` says
    otherwise. Without that environment nothing is initialised."""
    local = int(os.environ.get('LOCAL_RANK', 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device; pass device="cpu" to train '
                               'on the CPU')
        device = f'cuda:{local}'
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if 'WORLD_SIZE' in os.environ and not is_active():
        dist.init_process_group(
            'nccl' if device.type == 'cuda' else 'gloo',
            init_method=(f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}"
                         f":{os.environ['MASTER_PORT']}"),
            rank=int(os.environ['RANK']),
            world_size=int(os.environ['WORLD_SIZE']))
    return device


def broadcast_from_rank0(tensors: Sequence[torch.Tensor]):
    """Rank 0's values into every rank's ``tensors``, in place (a group of
    one runs the collective too)."""
    if is_active():
        for t in tensors:
            dist.broadcast(t.data, src=0)


BUCKET_BYTES = 64 << 20


def all_reduce_mean(tensors: Sequence[torch.Tensor]):
    """Replace each tensor by its mean over the ranks, in buckets of about
    ``BUCKET_BYTES`` flattened into one all-reduce each (a group of one
    runs the collective too)."""
    if not is_active():
        return
    n = world_size()
    bucket, size = [], 0
    for t in list(tensors) + [None]:
        if t is not None:
            bucket.append(t)
            size += t.numel() * t.element_size()
        if bucket and (t is None or size >= BUCKET_BYTES):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat)
            flat.div_(n)
            offset = 0
            for b in bucket:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
            bucket, size = [], 0


def barrier(device: Optional[torch.device] = None):
    if world_size() > 1:
        if device is not None and device.type == 'cuda':
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()
