"""Greedy and beam decodes over the decode_init / decode_step protocol
(counterpart of ``tps_pp_tpu/models/decoders/base.py``: ``greedy_decode``,
the ``steps`` path, and ``beam_decode``).

An autoregressive decoder implements ``decode_init(out_enc, valid_ratio,
feat=None) -> (carry, static)`` and ``decode_step(token, t, carry, static,
plain) -> (probs, carry)``. ``feat``, the backbone's feature map, is what
SAR's and RobustScanner's attention reads (JAX ``decode_init(feat,
out_enc, valid_ratio)``); both decodes hand it to ``decode_init`` when they
are given it, and a decoder that does not read it (NRTR) ignores it.
``greedy_decode`` feeds each step's argmax (first index on ties) back in;
``plain`` asks the step for its kernels' plain versions.
With ``end_idx`` it stops once every row has emitted it; the steps it
skips read back as zeros, as in the JAX loop.

The JAX loop decides its exit on the device (``lax.while_loop``). Here
the exit has two forms with one result, that of a loop that checks the
all-done flag after every step:

* the host exit (default, eager ``predict``): each step copies the flag,
  non-blocking, into a pinned host slot and records an event, and the host
  reads the flag of the step EXIT_LAG steps behind the one it has just
  issued, so that it never waits for the step in flight. The loop stops at
  the first step whose flag is set; the steps issued past it are dropped
  (their outputs zeroed).
* the device exit (``device_exit=True``: a trace or a CUDA-graph capture,
  ``utils/export.py``): all ``max_seq_len`` steps run and the host reads
  nothing. Before each step the flag "every row ended before this step"
  is ``done.all()`` on the device; the step's output is zeroed where it is
  set (``done`` only grows, so that zeroes every step past the first
  all-done one). A decoder whose class sets ``TAKES_SKIP`` gets the flag
  as ``decode_step(..., skip=flag)``; NRTR's fused step hands it to the
  step kernels, which then skip the step's work. The module step and the
  int8 step compute every step: the result is the same, the exit saves
  nothing there.
"""
from __future__ import annotations

from typing import Optional

import torch

# steps between the one the host issues and the one whose exit flag it reads
EXIT_LAG = 2


def _rows(feat, out_enc):
    x = feat if feat is not None else out_enc
    return x.shape[0], x.device


def _feat_kw(feat):
    """``decode_init``'s keyword for ``feat``, none without one, so that a
    decoder that takes no ``feat`` is called as before."""
    return {} if feat is None else {'feat': feat}


def greedy_decode(decoder, out_enc: torch.Tensor, valid_ratio, *,
                  max_seq_len: int, start_idx: int,
                  end_idx: Optional[int] = None,
                  plain: bool = False,
                  feat: Optional[torch.Tensor] = None,
                  device_exit: bool = False) -> torch.Tensor:
    """Returns (N, max_seq_len, C') float32 per-step probabilities; with
    ``end_idx``, ``device_exit`` picks the exit's form (module
    docstring)."""
    N, dev = _rows(feat, out_enc)
    carry, static = decoder.decode_init(out_enc, valid_ratio,
                                        **_feat_kw(feat))
    token = torch.full((N,), start_idx, dtype=torch.long, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    if end_idx is not None and device_exit:
        return _greedy_device_exit(decoder, carry, static, token, done,
                                   max_seq_len, end_idx, plain)
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


def _greedy_device_exit(decoder, carry, static, token, done,
                        max_seq_len: int, end_idx: int, plain: bool):
    """The device exit's loop: every step, each zeroed where every row
    ended before it."""
    skip_kw = getattr(type(decoder), 'TAKES_SKIP', False)
    out = None
    for t in range(max_seq_len):
        ended = done.all()
        kw = {'skip': ended} if skip_kw else {}
        probs, carry = decoder.decode_step(token, t, carry, static,
                                           plain=plain, **kw)
        if out is None:
            out = probs.new_zeros((token.shape[0], max_seq_len,
                                   probs.shape[-1]))
        out[:, t] = torch.where(ended, 0.0, probs)
        token = probs.argmax(dim=-1)
        done |= token == end_idx
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


def beam_decode(decoder, out_enc: torch.Tensor, valid_ratio, *,
                max_seq_len: int, start_idx: int, beam_width: int = 5,
                length_norm: bool = False, plain: bool = False,
                return_ranking: bool = False,
                feat: Optional[torch.Tensor] = None):
    """Beam search over decode_init / decode_step, the JAX package's
    ``beam_decode`` (``tps_pp_tpu/models/decoders/base.py:105-189``) with
    its criterion: beams are ranked by the sum of their tokens' softmax
    scores (divided by t + 1 under ``length_norm``), only beam 0 is live at
    step 0, every step keeps the top ``beam_width`` of the W * C
    candidates, and there is no early exit. Returns (N, max_seq_len, C')
    float32 zeros with the best beam's step scores at its tokens, which the
    convertor's argmax reads back. With ``return_ranking``, also the
    (N, W) final beam totals, best first (the sums, not divided), and the
    (N, T) margin of each step's cut: the W-th kept candidate's rank minus
    the best dropped one's (where a perturbation of the scores can swap a
    beam).

    The decode runs N * W rows, beam-major within each image: the encoder
    output, ``feat`` (where given) and the valid ratios are tiled with
    ``repeat_interleave`` (JAX's ``jnp.repeat(axis=0)``) before
    ``decode_init``. ``decode_step`` writes
    its caches in place, so each step's reindex by parent beam copies every
    carry tensor of N * W rows (``index_select``) and never aliases a
    parent's cache.

    Ties: ``torch.topk`` does not promise JAX's lower-index-first order on
    exact ties, and it is not emulated. On random weights the only exact
    ties are the dead beams at step 0 (all at -1e9), which are never chosen
    while C >= W."""
    (N, dev), W = _rows(feat, out_enc), beam_width
    T = max_seq_len

    def tile(x):
        return None if x is None else x.repeat_interleave(W, dim=0)
    carry, static = decoder.decode_init(tile(out_enc), tile(valid_ratio),
                                        **_feat_kw(tile(feat)))
    tokens = torch.full((N * W,), start_idx, dtype=torch.long, device=dev)
    scores = torch.full((N, W), -1e9, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    tok_hist = torch.zeros((N, W, T), dtype=torch.long, device=dev)
    score_hist = torch.zeros((N, W, T), dtype=torch.float32, device=dev)
    first_row = torch.arange(N, device=dev)[:, None] * W
    cut = torch.zeros((N, T), dtype=torch.float32, device=dev)
    for t in range(T):
        probs, carry = decoder.decode_step(tokens, t, carry, static,
                                           plain=plain)
        C = probs.shape[-1]
        step = probs.float().reshape(N, W * C)
        flat = (scores[:, :, None] + step.reshape(N, W, C)).reshape(N, W * C)
        rank = flat / (t + 1.0) if length_norm else flat
        top = torch.topk(rank, min(W + 1, W * C), dim=1)  # sorted
        top_i = top.indices[:, :W]
        if W * C > W:
            cut[:, t] = top.values[:, W - 1] - top.values[:, W]
        parent, token = top_i // C, top_i % C
        carry = _reindex(carry, (first_row + parent).reshape(-1), N * W)
        hist = parent[..., None].expand(-1, -1, T)
        tok_hist = tok_hist.gather(1, hist)
        score_hist = score_hist.gather(1, hist)
        tok_hist[:, :, t] = token
        score_hist[:, :, t] = step.gather(1, top_i)
        scores = flat.gather(1, top_i)
        tokens = token.reshape(-1)
    # the best beam is column 0 of the sorted top-k
    out = torch.zeros((N, T, C), dtype=torch.float32, device=dev)
    out.scatter_(2, tok_hist[:, 0, :, None], score_hist[:, 0, :, None])
    return (out, scores, cut) if return_ranking else out


def _reindex(tree, rows: torch.Tensor, n_rows: int):
    """Every tensor of ``tree`` (lists and tuples of tensors) whose first
    dimension is ``n_rows``, gathered at ``rows`` into a new tensor; the
    rest as it is."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reindex(x, rows, n_rows) for x in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() and \
            tree.shape[0] == n_rows:
        return tree.index_select(0, rows)
    return tree
