"""Greedy decode over the decode_init / decode_step protocol (counterpart of
``tps_pp_tpu/models/decoders/base.py:22-102``, the ``steps`` path).

An autoregressive decoder implements ``decode_init(out_enc, valid_ratio)
-> (carry, static)`` and ``decode_step(token, t, carry, static, plain) ->
(probs, carry)``. ``greedy_decode`` feeds each step's argmax (first index
on ties) back in; ``plain`` asks the step for its kernels' plain versions.
With ``end_idx`` it stops once every row has emitted it; the steps it
skips read back as zeros, as in the JAX loop.

The JAX loop decides its exit on the device (``lax.while_loop``). Here
the all-done flag stays on the device too: each step copies it,
non-blocking, into a pinned host slot and records an event, and the host
reads the flag of the step EXIT_LAG steps behind the one it has just
issued, so that it never waits for the step in flight. The loop stops at
the first step whose flag is set; the steps issued past it are dropped
(their outputs zeroed), so the result is the one of a loop that checks
every step.
"""
from __future__ import annotations

from typing import Optional

import torch

# steps between the one the host issues and the one whose exit flag it reads
EXIT_LAG = 2


def greedy_decode(decoder, out_enc: torch.Tensor, valid_ratio, *,
                  max_seq_len: int, start_idx: int,
                  end_idx: Optional[int] = None,
                  plain: bool = False) -> torch.Tensor:
    """Returns (N, max_seq_len, C') float32 per-step probabilities."""
    N, dev = out_enc.shape[0], out_enc.device
    carry, static = decoder.decode_init(out_enc, valid_ratio)
    token = torch.full((N,), start_idx, dtype=torch.long, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    cuda = dev.type == 'cuda'
    if end_idx is not None:
        # flags[t]: every row done after step t, as the host sees it once
        # events[t] has completed
        flags = torch.zeros((max_seq_len,), dtype=torch.bool,
                            pin_memory=cuda)
        events = []
    out, read, stop = None, 0, None
    for t in range(max_seq_len):
        probs, carry = decoder.decode_step(token, t, carry, static,
                                           plain=plain)
        if out is None:
            out = probs.new_zeros((N, max_seq_len, probs.shape[-1]))
        out[:, t] = probs
        token = probs.argmax(dim=-1)
        if end_idx is None:
            continue
        done |= token == end_idx
        flags[t].copy_(done.all(), non_blocking=True)
        if cuda:
            events.append(torch.cuda.Event())
            events[-1].record()
        if t - read >= EXIT_LAG:
            stop = _first_exit(flags, events, read, read + 1)
            read += 1
            if stop is not None:
                break
    if end_idx is not None and stop is None:
        stop = _first_exit(flags, events, read, max_seq_len)
    if stop is not None:
        out[:, stop + 1:] = 0
    return out


def _first_exit(flags, events, lo, hi):
    """The first step in [lo, hi) whose all-done flag is set, or None,
    waiting for each step's event before it reads its flag."""
    for s in range(lo, hi):
        if events:
            events[s].synchronize()
        if bool(flags[s]):
            return s
    return None
