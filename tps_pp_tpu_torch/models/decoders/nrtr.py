"""NRTR transformer decoder (counterpart of
``tps_pp_tpu/models/decoders/nrtr.py``).

Training: ``forward(out_enc, targets, valid_ratio)`` is the teacher-forced
pass (JAX ``decoders/nrtr.py:83-96``): pad & causal self-attention mask,
embedding dropout and the layers' dropout in train mode. Inference: two
greedy paths with one output contract, (N, S, C-1) per-step softmax
probabilities:

* ``decode_init`` / ``decode_step``: the KV-cached module path that
  ``greedy_decode`` drives (the JAX package's ``steps`` mode).
* ``fused_full_decode``: the whole decode through ``ops.full_decode`` (the
  CUDA kernels on CUDA tensors, their plain version on CPU tensors or with
  ``plain=True``), the counterpart of ``decode_mode='fused40_bf16'``. Its
  packed, folded weights are computed once per (device, dtype) and cached
  until a weight changes (``layers.weights_stamp``).

Quirks of the reference kept: the pad embedding row is zeroed at lookup,
the classifier has C-1 outputs (it never predicts <PAD>), and the final
LayerNorm has eps 1e-6 while the per-layer ones have 1e-5.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops.full_decode import (fold_decoder_weights, full_decode,
                                full_decode_plain)
from ...registry import DECODERS
from ..encoders.nrtr import sequence_mask
from ..layers import weights_stamp
from ..transformer import PositionalEncoding, TFDecoderLayer, attend, dropout


@DECODERS.register_module()
class NRTRDecoder(nn.Module):
    IS_AUTOREGRESSIVE = True

    def __init__(self, n_layers=6, d_embedding=512, n_head=8, d_k=64,
                 d_v=64, d_model=512, d_inner=256, n_position=200,
                 dropout=0.1, num_classes=93, max_seq_len=40, start_idx=1,
                 padding_idx=92, use_fused_step=False, kv_dtype='bfloat16'):
        # use_fused_step / kv_dtype choose JAX-side kernels. The port
        # accepts them so that the JAX package's configs build unchanged,
        # and has no use for them.
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.d_model = d_model
        self.max_seq_len = max_seq_len
        self.start_idx, self.padding_idx = start_idx, padding_idx
        self.trg_word_emb = nn.Embedding(num_classes, d_embedding,
                                         padding_idx=padding_idx)
        self.position_enc = PositionalEncoding(d_embedding, n_position)
        self.layer_stack = nn.ModuleList([
            TFDecoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout)
            for _ in range(n_layers)])
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.classifier = nn.Linear(d_model, num_classes - 1)
        self._packed: Dict = {}

    def _embed(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """tokens (N, T) -> (N, T, D): the pad row zeroed at lookup, plus
        the position table from ``offset``."""
        x = self.trg_word_emb(tokens)
        x = torch.where((tokens == self.padding_idx)[..., None],
                        torch.zeros_like(x), x)
        return self.position_enc(x, offset=offset)

    # ---- teacher-forced pass (training) ---------------------------------
    def forward(self, out_enc: torch.Tensor, targets: torch.Tensor,
                valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """out_enc (N, TE, D), targets (N, T) int -> (N, T, C-1) logits.
        ``rng`` draws the dropout masks in train mode."""
        T = targets.shape[1]
        pad = (targets != self.padding_idx)[:, None, :]              # N,1,T
        causal = torch.ones((T, T), dtype=torch.bool,
                            device=targets.device).tril()[None]      # 1,T,T
        trg_mask = (pad & causal).float()[:, None]                   # N,1,T,T
        src_mask = sequence_mask(valid_ratio, out_enc.shape[1])
        if src_mask is not None:
            src_mask = src_mask[:, None, None, :]
        x = dropout(self._embed(targets),
                    self.dropout if self.training else 0.0, rng)
        for layer in self.layer_stack:
            x = layer(x, out_enc, trg_mask, src_mask, rng)
        return self.classifier(self.layer_norm(x))

    # ---- steps path ----------------------------------------------------
    def decode_init(self, out_enc: torch.Tensor, valid_ratio=None):
        """carry: per-layer self-attention K/V caches of max_seq_len + 1
        slots; static: per-layer encoder K/V and the source mask."""
        N = out_enc.shape[0]
        T = self.max_seq_len + 1
        enc_kvs = [layer.enc_attn.project_kv(out_enc)
                   for layer in self.layer_stack]
        caches = [(out_enc.new_zeros((N, self.n_head, T, self.d_k)),
                   out_enc.new_zeros((N, self.n_head, T, self.d_v)))
                  for _ in self.layer_stack]
        src_mask = sequence_mask(valid_ratio, out_enc.shape[1])
        if src_mask is not None:
            src_mask = src_mask[:, None, None, :]
        return caches, (enc_kvs, src_mask)

    def decode_step(self, token, t: int, carry, static):
        """token (N,) -> (probs (N, C-1) float32, carry). The caches are
        updated in place at slot t."""
        enc_kvs, src_mask = static
        x = self._embed(token[:, None], offset=t)
        T = self.max_seq_len + 1
        pos_mask = (torch.arange(T, device=x.device) <= t).float()
        for layer, (ck, cv), (ek, ev) in zip(self.layer_stack, carry,
                                             enc_kvs):
            sa = layer.self_attn
            y = layer.norm1(x)
            q = sa.split(sa.linear_q(y), self.d_k)
            ck[:, :, t:t + 1] = sa.split(sa.linear_k(y), self.d_k)
            cv[:, :, t:t + 1] = sa.split(sa.linear_v(y), self.d_v)
            x = x + sa.fc(attend(q, ck, cv, pos_mask, self.d_k ** -0.5))
            x = x + layer.enc_attn.attend_cached(layer.norm2(x), ek, ev,
                                                 src_mask)
            x = x + layer.mlp(layer.norm3(x))
        logits = self.classifier(self.layer_norm(x)[:, 0])
        return torch.softmax(logits.float(), dim=-1), carry

    # ---- fused path ----------------------------------------------------
    def packed_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Stacked (in, out) weights for ``ops.full_decode``, folded and in
        ``dtype``; computed once per (device, dtype) and weights stamp."""
        key = (self.classifier.weight.device, dtype)
        stamp = weights_stamp(self)
        if self._packed.get(key, (None,))[0] != stamp:
            def lin(m):
                return m.weight.t()
            names = ('ln1_s', 'ln1_b', 'ln2_s', 'ln2_b', 'ln3_s', 'ln3_b',
                     'wqkv', 'wfc1', 'wq2', 'wk2', 'wv2', 'wfc2', 'w1',
                     'b1', 'w2', 'b2')
            raw = {k: [] for k in names}
            for layer in self.layer_stack:
                sa, ca = layer.self_attn, layer.enc_attn
                vals = (layer.norm1.weight, layer.norm1.bias,
                        layer.norm2.weight, layer.norm2.bias,
                        layer.norm3.weight, layer.norm3.bias,
                        torch.cat([lin(sa.linear_q), lin(sa.linear_k),
                                   lin(sa.linear_v)], dim=1),
                        lin(sa.fc), lin(ca.linear_q), lin(ca.linear_k),
                        lin(ca.linear_v), lin(ca.fc), lin(layer.mlp.w_1),
                        layer.mlp.w_1.bias, lin(layer.mlp.w_2),
                        layer.mlp.w_2.bias)
                for k, v in zip(names, vals):
                    raw[k].append(v)
            raw = {k: torch.stack(v) for k, v in raw.items()}
            raw.update(
                lnf_s=self.layer_norm.weight, lnf_b=self.layer_norm.bias,
                embed=self.trg_word_emb.weight,
                wcls=lin(self.classifier), bcls=self.classifier.bias,
                pe=self.position_enc.position_table[0, :self.max_seq_len])
            self._packed[key] = (stamp, fold_decoder_weights(
                raw, self.n_head, dtype))
        return self._packed[key][1]

    def fused_full_decode(self, out_enc: torch.Tensor, valid_ratio=None,
                          end_idx: Optional[int] = None,
                          plain: bool = False) -> torch.Tensor:
        """All max_seq_len greedy steps; with ``end_idx`` the decode stops
        once every row has emitted it. Returns (N, S, C-1) float32."""
        N, TE = out_enc.shape[:2]
        src_mask = sequence_mask(valid_ratio, TE)
        if src_mask is None:
            src_mask = out_enc.new_ones((N, TE), dtype=torch.float32)
        fn = full_decode_plain if plain else full_decode
        return fn(out_enc, src_mask, self.packed_weights(out_enc.dtype),
                  self.n_head, self.start_idx, end_idx)
