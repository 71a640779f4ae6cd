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

Under a 2-D mesh (``parallel.mesh``) those reductions run over the data
group, the ranks that hold the same shard of the model: ``use_data_group``
sets it for a block, and ``data_group()`` is what they read (None: the
whole world, which is the data group when there is no model axis).
"""
from __future__ import annotations

import contextlib
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


_DATA_GROUP = None


def data_group():
    """The process group that the gradient mean and BatchNorm's statistics
    reduce over: the mesh's data group inside ``use_data_group``, else None
    (the world)."""
    return _DATA_GROUP


@contextlib.contextmanager
def use_data_group(group):
    """Reduce over ``group`` instead of the world for the block."""
    global _DATA_GROUP
    prev, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield group
    finally:
        _DATA_GROUP = prev


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


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None):
    """Replace each tensor by its mean over the ranks of ``group`` (default:
    ``data_group()``, the world outside a mesh), in buckets of about
    ``BUCKET_BYTES`` flattened into one all-reduce each (a group of one
    runs the collective too)."""
    if not is_active():
        return
    group = group if group is not None else data_group()
    n = dist.get_world_size(group)
    bucket, size = [], 0
    for t in list(tensors) + [None]:
        if t is not None:
            bucket.append(t)
            size += t.numel() * t.element_size()
        if bucket and (t is None or size >= BUCKET_BYTES):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
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
