"""Batch bucketing (counterpart of ``tps_pp_tpu/utils/batching.py:18-34``).

``TextRecognizer.predict`` pads the batch to the next power of two, as the
JAX package does. Padding replicates the last real row: a copy of a real row
emits EOS exactly when that row does, so the decode's all-rows-EOS early exit
is not held up by a garbage row.
"""
import torch


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def pad_rows(tensors, n: int, m: int):
    """Pad dim 0 of each tensor from ``n`` to ``m`` rows by replicating the
    last row. No-op when ``m == n``."""
    if m == n:
        return tuple(tensors)
    return tuple(torch.cat([t, t[-1:].expand(m - n, *t.shape[1:])])
                 for t in tensors)
