"""NRTR transformer decoder (counterpart of
``tps_pp_tpu/models/decoders/nrtr.py``).

Training: ``forward(out_enc, targets, valid_ratio)`` is the teacher-forced
pass (JAX ``decoders/nrtr.py:83-96``): pad & causal self-attention mask,
embedding dropout and the layers' dropout in train mode. Inference: two
greedy paths with one output contract, (N, S, C-1) per-step softmax
probabilities:

* ``decode_init`` / ``decode_step``: the KV-cached path that
  ``greedy_decode`` drives (the JAX package's ``steps`` mode). By default
  it runs the per-layer modules. ``kv_dtype='int8'`` keeps the encoder K/V
  (one absmax scale per row and head) and the self-attention caches (one
  scale per slot) in int8 (JAX ``nrtr.py:98-126,206-243``).
  ``use_fused_step=True`` runs each layer's step as the two functions of
  ``ops.decode_step`` (the CUDA kernels on CUDA tensors, their plain
  versions on CPU tensors or with ``plain=True``), on the unfolded weights
  packed once per weights stamp (JAX ``nrtr.py:323-357``). The two options
  exclude each other, as in JAX.
* ``fused_full_decode``: the whole decode through ``ops.full_decode``, the
  counterpart of ``decode_mode='fused40_bf16'`` (bf16 encoder K/V) and
  ``'fused40'`` (int8 encoder K/V). Its packed, folded weights are computed
  once per (device, dtype) and cached until a weight changes
  (``layers.weights_stamp``).

Quirks of the reference kept: the pad embedding row is zeroed at lookup,
the classifier has C-1 outputs (it never predicts <PAD>), and the final
LayerNorm has eps 1e-6 while the per-layer ones have 1e-5.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops.decode_step import (cross_ffn_step, cross_ffn_step_plain,
                                self_attn_step, self_attn_step_plain)
from ...ops.full_decode import (fold_decoder_weights, full_decode,
                                full_decode_plain)
from ...registry import DECODERS
from ..encoders.nrtr import sequence_mask
from ..layers import weights_stamp
from ..transformer import (NEG_INF, PositionalEncoding, TFDecoderLayer,
                           attend, dropout)


@DECODERS.register_module()
class NRTRDecoder(nn.Module):
    IS_AUTOREGRESSIVE = True

    def __init__(self, n_layers=6, d_embedding=512, n_head=8, d_k=64,
                 d_v=64, d_model=512, d_inner=256, n_position=200,
                 dropout=0.1, num_classes=93, max_seq_len=40, start_idx=1,
                 padding_idx=92, use_fused_step=False, kv_dtype='bfloat16'):
        super().__init__()
        self.use_fused_step, self.kv_dtype = use_fused_step, kv_dtype
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
        slots (with ``kv_dtype='int8'``: (k8, k scales, v8, v scales));
        static: per-layer encoder K/V and the source mask, in the form the
        step takes."""
        N, TE = out_enc.shape[:2]
        T = self.max_seq_len + 1
        enc_kvs = [layer.enc_attn.project_kv(out_enc)
                   for layer in self.layer_stack]
        src_mask = sequence_mask(valid_ratio, TE)
        if self.use_fused_step:
            # ops.decode_step takes contiguous (N, H, TE, DK) K/V and an
            # (N, TE) mask
            enc_kvs = [(k.contiguous(), v.contiguous()) for k, v in enc_kvs]
            if src_mask is None:
                src_mask = out_enc.new_ones((N, TE), dtype=torch.float32)
        elif src_mask is not None:
            src_mask = src_mask[:, None, None, :]
        if self.kv_dtype == 'int8':
            enc_kvs = [self._quantize(k, (2, 3)) + self._quantize(v, (2, 3))
                       for k, v in enc_kvs]
            i8, f32 = torch.int8, torch.float32
            slots = ((self.d_k, i8), (1, f32), (self.d_v, i8), (1, f32))
        else:
            slots = ((self.d_k, out_enc.dtype), (self.d_v, out_enc.dtype))
        caches = [tuple(out_enc.new_zeros((N, self.n_head, T, d), dtype=dt)
                        for d, dt in slots) for _ in self.layer_stack]
        return caches, (enc_kvs, src_mask)

    def decode_step(self, token, t: int, carry, static, plain: bool = False):
        """token (N,) -> (probs (N, C-1) float32, carry). The caches are
        updated in place at slot t. ``plain`` makes the fused step run the
        kernels' plain versions on any device."""
        if self.use_fused_step:
            # the fused step takes 2-tuple caches; int8 caches are 4-tuples
            if self.kv_dtype == 'int8':
                raise ValueError('use_fused_step does not support '
                                 "kv_dtype='int8'")
            return self._fused_decode_step(token, t, carry, static, plain)
        if self.kv_dtype == 'int8':
            return self._decode_step_q8(token, t, carry, static)
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
        return self._head(x[:, 0]), carry

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) -> final LayerNorm, classifier, float32 softmax."""
        logits = self.classifier(self.layer_norm(x))
        return torch.softmax(logits.float(), dim=-1)

    # ---- int8 K/V ------------------------------------------------------
    @staticmethod
    def _quantize(x: torch.Tensor, dims):
        """Absmax int8 quantization over ``dims`` (JAX ``_quantize``):
        (int8 values, float32 scales with ``dims`` kept at size 1);
        ``torch.round`` rounds half to even, as ``jnp.round``."""
        x = x.float()
        scale = x.abs().amax(dim=dims, keepdim=True) / 127.0 + 1e-8
        q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
        return q, scale

    def _attend_q8(self, q, k8, k_scale, v8, v_scale, mask):
        """Attention of q (N, H, 1, dk) over int8 K/V (JAX ``_attend_q8``):
        the K scales (N, H, K, 1) go onto the f32 logits, the V scales onto
        the softmax weights before they are rounded to q's dtype. mask
        broadcasts to (N, H, 1, K), 0 = masked. Returns (N, 1, H*dv)."""
        with torch.autocast(q.device.type, enabled=False):
            s = torch.matmul((q * self.d_k ** -0.5).float(),
                             k8.float().transpose(-1, -2))
            s = s * k_scale.transpose(-1, -2)[:, :, :1]
            if mask is not None:
                s = s.masked_fill(mask == 0, NEG_INF)
            p = torch.softmax(s, dim=-1)
            aw = (p * v_scale.transpose(-1, -2)[:, :, :1]).to(q.dtype)
            out = torch.matmul(aw.float(), v8.float()).to(q.dtype)
        N, H, Tq, d = out.shape
        return out.transpose(1, 2).reshape(N, Tq, H * d)

    def _decode_step_q8(self, token, t: int, carry, static):
        """decode_step over the int8 caches and encoder K/V (JAX
        ``_decode_step_q8``): this step's K/V are quantized per slot before
        the attention reads them."""
        enc_kvs, src_mask = static
        x = self._embed(token[:, None], offset=t)
        T = self.max_seq_len + 1
        pos_mask = (torch.arange(T, device=x.device) <= t).float()
        for layer, (ck, cks, cv, cvs), (ek8, eks, ev8, evs) in zip(
                self.layer_stack, carry, enc_kvs):
            sa, ca = layer.self_attn, layer.enc_attn
            y = layer.norm1(x)
            q = sa.split(sa.linear_q(y), self.d_k)
            k8, ks = self._quantize(sa.split(sa.linear_k(y), self.d_k), (3,))
            v8, vs = self._quantize(sa.split(sa.linear_v(y), self.d_v), (3,))
            ck[:, :, t:t + 1], cks[:, :, t:t + 1] = k8, ks
            cv[:, :, t:t + 1], cvs[:, :, t:t + 1] = v8, vs
            x = x + sa.fc(self._attend_q8(q, ck, cks, cv, cvs, pos_mask))
            q2 = ca.split(ca.linear_q(layer.norm2(x)), self.d_k)
            x = x + ca.fc(self._attend_q8(q2, ek8, eks, ev8, evs, src_mask))
            x = x + layer.mlp(layer.norm3(x))
        return self._head(x[:, 0]), carry

    # ---- fused step ------------------------------------------------------
    def _stacked_weights(self) -> Dict[str, torch.Tensor]:
        """Per-layer weights stacked over the layers, matmuls in (in, out)
        layout, as the JAX kernels take them: ln{1,2,3}_{s,b} (L, D), wqkv
        (L, D, 3HD) (q|k|v), wfc1 (L, HD, D), wq2/wk2/wv2 (L, D, HD), wfc2
        (L, HD, D), w1 (L, D, DI), b1 (L, DI), w2 (L, DI, D), b2 (L, D)."""
        def lin(m):
            return m.weight.t()
        names = ('ln1_s', 'ln1_b', 'ln2_s', 'ln2_b', 'ln3_s', 'ln3_b',
                 'wqkv', 'wfc1', 'wq2', 'wk2', 'wv2', 'wfc2', 'w1', 'b1',
                 'w2', 'b2')
        raw = {k: [] for k in names}
        for layer in self.layer_stack:
            sa, ca = layer.self_attn, layer.enc_attn
            vals = (layer.norm1.weight, layer.norm1.bias, layer.norm2.weight,
                    layer.norm2.bias, layer.norm3.weight, layer.norm3.bias,
                    torch.cat([lin(sa.linear_q), lin(sa.linear_k),
                               lin(sa.linear_v)], dim=1),
                    lin(sa.fc), lin(ca.linear_q), lin(ca.linear_k),
                    lin(ca.linear_v), lin(ca.fc), lin(layer.mlp.w_1),
                    layer.mlp.w_1.bias, lin(layer.mlp.w_2),
                    layer.mlp.w_2.bias)
            for k, v in zip(names, vals):
                raw[k].append(v.detach())
        return {k: torch.stack(v) for k, v in raw.items()}

    def _cached(self, key, make):
        """``make()``, computed once per key and weights stamp."""
        stamp = weights_stamp(self)
        if self._packed.get(key, (None,))[0] != stamp:
            self._packed[key] = (stamp, make())
        return self._packed[key][1]

    def step_weights(self) -> Dict[str, torch.Tensor]:
        """The fused step's weights: the stacked matmul weights in bf16 (the
        JAX kernels cast them so), LayerNorm affines and biases in float32,
        all contiguous; once per (device, weights stamp)."""
        def make():
            f32 = ('ln1_s', 'ln1_b', 'ln2_s', 'ln2_b', 'ln3_s', 'ln3_b',
                   'b1', 'b2')
            return {k: v.to(torch.float32 if k in f32 else torch.bfloat16)
                    .contiguous()
                    for k, v in self._stacked_weights().items()
                    if k not in ('wk2', 'wv2')}
        return self._cached((self.classifier.weight.device, 'step'), make)

    def _step_layer_args(self):
        """Per layer, the weight arguments of ``self_attn_step`` and of
        ``cross_ffn_step``: views of :meth:`step_weights`, made once per
        (device, weights stamp) and not at every step."""
        def make():
            w = self.step_weights()
            return [((w['wqkv'][l], w['wfc1'][l], w['ln1_s'][l],
                      w['ln1_b'][l]),
                     tuple(w[k][l] for k in (
                         'wq2', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1', 'w2',
                         'b2', 'ln3_s', 'ln3_b')))
                    for l in range(len(self.layer_stack))]
        return self._cached((self.classifier.weight.device, 'step_layers'),
                            make)

    def _fused_decode_step(self, token, t: int, carry, static, plain: bool):
        """decode_step through ``ops.decode_step``: per layer
        ``self_attn_step`` (LN1, QKV, cache append, attention, projection,
        residual) then ``cross_ffn_step`` (LN2, cross-attention, projection,
        residual, LN3, GELU FFN, residual)."""
        enc_kvs, src_mask = static
        sa_fn = self_attn_step_plain if plain else self_attn_step
        cf_fn = cross_ffn_step_plain if plain else cross_ffn_step
        x = self._embed(token[:, None], offset=t)[:, 0].contiguous()
        for (sa_w, cf_w), (ck, cv), (ek, ev) in zip(self._step_layer_args(),
                                                    carry, enc_kvs):
            x, _, _ = sa_fn(x, ck, cv, t, *sa_w)
            x = cf_fn(x, ek, ev, src_mask, *cf_w)
        return self._head(x), carry

    # ---- fused path ----------------------------------------------------
    def packed_weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Stacked (in, out) weights for ``ops.full_decode``, folded and in
        ``dtype``; computed once per (device, dtype) and weights stamp."""
        def make():
            raw = self._stacked_weights()
            raw.update(
                lnf_s=self.layer_norm.weight, lnf_b=self.layer_norm.bias,
                embed=self.trg_word_emb.weight,
                wcls=self.classifier.weight.t(), bcls=self.classifier.bias,
                pe=self.position_enc.position_table[0, :self.max_seq_len])
            return fold_decoder_weights(raw, self.n_head, dtype)
        return self._cached((self.classifier.weight.device, dtype), make)

    def fused_full_decode(self, out_enc: torch.Tensor, valid_ratio=None,
                          end_idx: Optional[int] = None,
                          plain: bool = False,
                          enc_dtype: str = 'bfloat16') -> torch.Tensor:
        """All max_seq_len greedy steps; with ``end_idx`` the decode stops
        once every row has emitted it. ``enc_dtype``: the encoder K/V type,
        ``'bfloat16'`` or ``'int8'``. Returns (N, S, C-1) float32."""
        N, TE = out_enc.shape[:2]
        src_mask = sequence_mask(valid_ratio, TE)
        if src_mask is None:
            src_mask = out_enc.new_ones((N, TE), dtype=torch.float32)
        fn = full_decode_plain if plain else full_decode
        return fn(out_enc, src_mask, self.packed_weights(out_enc.dtype),
                  self.n_head, self.start_idx, end_idx, enc_dtype=enc_dtype)
