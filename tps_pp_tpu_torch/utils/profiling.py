"""Profiling and throughput counters (counterpart of
``tps_pp_tpu/utils/profiling.py``).

* ``trace(log_dir)``: a ``torch.profiler`` trace of the block, CPU and
  (where there is a card) CUDA activity, written under ``log_dir`` as a
  Chrome trace (``chrome://tracing``, Perfetto); the JAX package's is a
  ``jax.profiler`` trace for TensorBoard.
* ``ThroughputMeter``: images a second a chip since the last ``reset``.
* ``timed(name, sink)``: adds the block's wall seconds to ``sink[name]``;
  when CUDA is initialised it synchronises the card before each reading
  of the clock, so that the block's queued kernels count in its time.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


def _sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; its Chrome trace is written, once the block
    ends, to ``log_dir/trace_<pid>_<ns>.json``, the path the context
    yields."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f'trace_{os.getpid()}_{time.time_ns()}.json')
    with profile(activities=activities) as prof:
        yield path
        _sync()
    prof.export_chrome_trace(path)


class ThroughputMeter:
    """images/sec/chip counter (the BASELINE metric)."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = n_chips
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int):
        self._images += n_images

    @property
    def images_per_sec_per_chip(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._images / dt / self.n_chips

    def __repr__(self):
        return f'{self.images_per_sec_per_chip:.1f} img/s/chip'


@contextlib.contextmanager
def timed(name: str, sink: Optional[dict] = None):
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
