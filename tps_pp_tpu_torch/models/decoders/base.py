"""Greedy decode over the decode_init / decode_step protocol (counterpart of
``tps_pp_tpu/models/decoders/base.py:22-102``, the ``steps`` path).

An autoregressive decoder implements ``decode_init(out_enc, valid_ratio)
-> (carry, static)`` and ``decode_step(token, t, carry, static, plain) ->
(probs, carry)``. ``greedy_decode`` feeds each step's argmax (first index
on ties) back in; ``plain`` asks the step for its kernels' plain versions.
With ``end_idx`` it stops once every row has emitted it; the steps it
skips read back as zeros, as in the JAX loop.
"""
from __future__ import annotations

from typing import Optional

import torch


def greedy_decode(decoder, out_enc: torch.Tensor, valid_ratio, *,
                  max_seq_len: int, start_idx: int,
                  end_idx: Optional[int] = None,
                  plain: bool = False) -> torch.Tensor:
    """Returns (N, max_seq_len, C') float32 per-step probabilities."""
    N = out_enc.shape[0]
    carry, static = decoder.decode_init(out_enc, valid_ratio)
    token = torch.full((N,), start_idx, dtype=torch.long,
                       device=out_enc.device)
    done = torch.zeros((N,), dtype=torch.bool, device=out_enc.device)
    out = None
    for t in range(max_seq_len):
        probs, carry = decoder.decode_step(token, t, carry, static,
                                           plain=plain)
        if out is None:
            out = probs.new_zeros((N, max_seq_len, probs.shape[-1]))
        out[:, t] = probs
        token = probs.argmax(dim=-1)
        if end_idx is not None:
            done |= token == end_idx
            if bool(done.all()):
                break
    return out
