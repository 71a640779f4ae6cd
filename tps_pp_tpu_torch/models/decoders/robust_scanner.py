"""RobustScanner's decoders (counterpart of
``tps_pp_tpu/models/decoders/robust_scanner.py``; reference
``decoders/sequence_attention_decoder.py``,
``position_attention_decoder.py``, ``robust_scanner_decoder.py`` and the
layers ``DotProductAttentionLayer``, ``PositionAwareLayer``,
``RobustScannerFusionLayer``).

Two branches read the encoder's (N, h, w, c) map ``out_enc`` and the
backbone's ``feat``: the hybrid branch (``SequenceAttentionDecoder``), whose
query is an LSTM over the embedded tokens, and the position branch
(``PositionAttentionDecoder``), whose query is a learned position table and
whose key is the position-aware module's LSTM over the map's rows. A GLU
fusion of the two glimpses feeds the classifier. At inference the hybrid
branch's LSTM state is carried step to step (the reference re-runs it over
the prefix each step; an LSTM is causal), and the position branch, static
in its query, is computed once in ``decode_init``.

The recurrences are float32 islands (``layers.Float32LSTM``): the hybrid
query's, and the position-aware module's over the map's width with N * h
rows as its batch. The attention's logits and softmax run in float32 (or
wider), the product with the value in the value's dtype, summed in
float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...registry import DECODERS
from ..encoders.nrtr import sequence_mask
from ..layers import Float32LSTM, nchw_to_nhwc, nhwc_to_nchw
from ..transformer import NEG_INF


def dot_product_attention(query, key, value, mask=None, scale: float = 1.0):
    """query (N, T, D), key (N, L, D), value (N, L, Dv), mask (N, L) True
    where masked -> (N, T, Dv) in value's dtype (reference
    ``layers/dot_product_attention_layer.py``)."""
    with torch.autocast(query.device.type, enabled=False):
        wide = torch.promote_types(query.dtype, torch.float32)
        logits = torch.matmul(query.to(wide),
                              key.to(wide).transpose(1, 2)) * scale
        if mask is not None:
            logits = logits.masked_fill(mask[:, None, :], NEG_INF)
        weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(value.dtype), value)


def width_mask(valid_ratio, h: int, w: int):
    """(N, h * w) True where masked: the columns past ``min(w, ceil(w *
    valid_ratio))``, repeated over the h rows; None without ratios."""
    if valid_ratio is None:
        return None
    masked = sequence_mask(valid_ratio, w) == 0                 # (N, w)
    return masked[:, None, :].expand(-1, h, -1).reshape(-1, h * w)


class PositionAwareLayer(nn.Module):
    """A stacked LSTM ``rnn`` over each row of the map, then ``mixer``
    (3x3 conv, ReLU, 3x3 conv): (N, h, w, C) -> (N, h, w, dim_model),
    NHWC."""

    def __init__(self, dim_model: int, rnn_layers: int = 2):
        super().__init__()
        self.rnn = Float32LSTM(dim_model, dim_model, num_layers=rnn_layers,
                               batch_first=True)
        self.mixer = nn.Sequential(
            nn.Conv2d(dim_model, dim_model, 3, padding=1), nn.ReLU(),
            nn.Conv2d(dim_model, dim_model, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        y = self.rnn(x.reshape(n * h, w, c))[0].to(x.dtype)
        y = y.reshape(n, h, w, y.shape[-1])
        return nchw_to_nhwc(self.mixer(nhwc_to_nchw(y)))


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


@DECODERS.register_module()
class SequenceAttentionDecoder(nn.Module):
    """The hybrid branch: an embedding (its pad row zeroed at lookup, as
    ``nn.Embedding(padding_idx=...)`` keeps it in the reference), the
    stacked LSTM ``sequence_layer`` as the query, attention over
    ``out_enc`` (the value ``feat``, or ``out_enc`` with
    ``encode_value``)."""
    IS_AUTOREGRESSIVE = True
    READS_FEAT = True

    def __init__(self, num_classes: int = 37, rnn_layers: int = 2,
                 dim_input: int = 512, dim_model: int = 128,
                 max_seq_len: int = 40, start_idx: int = 0,
                 mask: bool = True, padding_idx: Optional[int] = None,
                 dropout: float = 0.0, return_feature: bool = False,
                 encode_value: bool = False):
        super().__init__()
        self.mask, self.padding_idx = mask, padding_idx
        self.max_seq_len, self.start_idx = max_seq_len, start_idx
        self.return_feature, self.encode_value = return_feature, encode_value
        self.rnn_layers = rnn_layers
        self.embedding = nn.Embedding(num_classes, dim_model)
        self.sequence_layer = Float32LSTM(dim_model, dim_model,
                                          num_layers=rnn_layers,
                                          batch_first=True)
        if not return_feature:
            self.prediction = nn.Linear(
                dim_model if encode_value else dim_input, num_classes - 1)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(tokens)
        if self.padding_idx is not None:
            emb = torch.where((tokens == self.padding_idx)[..., None],
                              torch.zeros_like(emb), emb)
        return emb

    def _attend(self, query, feat, out_enc, valid_ratio):
        n, h, w, _ = out_enc.shape
        key = _flat(out_enc)
        value = key if self.encode_value else _flat(feat)
        mask = width_mask(valid_ratio, h, w) if self.mask else None
        return dot_product_attention(query, key, value, mask)

    def forward(self, feat, out_enc, targets, valid_ratio=None, rng=None):
        """(N, T, C-1) logits (the glimpses (N, T, Dv) with
        ``return_feature``) of targets (N, T)."""
        query = self.sequence_layer(self._embed(targets))[0].to(
            out_enc.dtype)
        attn = self._attend(query, feat, out_enc, valid_ratio)
        return attn if self.return_feature else self.prediction(attn)

    def decode_init(self, out_enc, valid_ratio=None, feat=None):
        """carry: each layer's (h, c), zeros; static: (feat, out_enc,
        valid_ratio)."""
        z = out_enc.new_zeros((out_enc.shape[0],
                               self.sequence_layer.hidden_size))
        return tuple((z, z) for _ in range(self.rnn_layers)), (
            feat, out_enc, valid_ratio)

    def decode_step(self, token, t: int, carry, static, plain: bool = False):
        """token (N,) -> (probs (N, C-1) float32, or the glimpse (N, Dv)
        with ``return_feature``; carry)."""
        feat, out_enc, valid_ratio = static
        x = self._embed(token)
        new = []
        for k, (h, c) in enumerate(carry):
            h, c = self.sequence_layer.cell_step(k, x, h, c)
            new.append((h, c))
            x = h
        attn = self._attend(x[:, None].to(out_enc.dtype), feat, out_enc,
                            valid_ratio)[:, 0]
        if self.return_feature:
            return attn, tuple(new)
        return torch.softmax(self.prediction(attn).float(), dim=-1), \
            tuple(new)


@DECODERS.register_module()
class PositionAttentionDecoder(nn.Module):
    """The position branch: a position table ``embedding`` of
    ``max_seq_len + 1`` rows as the query, the position-aware module's
    output as the key. Its query does not depend on the tokens."""
    IS_AUTOREGRESSIVE = False
    READS_FEAT = True

    def __init__(self, num_classes: int = 37, rnn_layers: int = 2,
                 dim_input: int = 512, dim_model: int = 128,
                 max_seq_len: int = 40, mask: bool = True,
                 return_feature: bool = False, encode_value: bool = False):
        super().__init__()
        self.mask, self.max_seq_len = mask, max_seq_len
        self.return_feature, self.encode_value = return_feature, encode_value
        self.embedding = nn.Embedding(max_seq_len + 1, dim_model)
        self.position_aware_module = PositionAwareLayer(dim_model,
                                                        rnn_layers)
        if not return_feature:
            self.prediction = nn.Linear(
                dim_model if encode_value else dim_input, num_classes - 1)

    def forward(self, feat, out_enc, targets=None, valid_ratio=None,
                rng=None):
        """(N, T, C-1) logits (glimpses with ``return_feature``); T is the
        targets' length, ``max_seq_len`` without them."""
        n, h, w, _ = out_enc.shape
        T = targets.shape[1] if targets is not None else self.max_seq_len
        query = self.embedding(torch.arange(T, device=out_enc.device))
        query = query[None].expand(n, -1, -1)
        key = _flat(self.position_aware_module(out_enc))
        value = _flat(out_enc) if self.encode_value else _flat(feat)
        mask = width_mask(valid_ratio, h, w) if self.mask else None
        attn = dot_product_attention(query, key, value, mask)
        return attn if self.return_feature else self.prediction(attn)


class RobustScannerFusionLayer(nn.Module):
    """cat -> ``linear_layer`` -> GLU."""

    def __init__(self, dim_model: int):
        super().__init__()
        self.linear_layer = nn.Linear(2 * dim_model, 2 * dim_model)

    def forward(self, x0, x1):
        a, b = self.linear_layer(torch.cat([x0, x1], dim=-1)).chunk(2, -1)
        return a * torch.sigmoid(b)


@DECODERS.register_module()
class RobustScannerDecoder(nn.Module):
    IS_AUTOREGRESSIVE = True
    READS_FEAT = True

    def __init__(self, num_classes: int = 37, dim_input: int = 512,
                 dim_model: int = 128, max_seq_len: int = 40,
                 start_idx: int = 0, mask: bool = True,
                 padding_idx: Optional[int] = None,
                 encode_value: bool = False,
                 hybrid_decoder: Optional[dict] = None,
                 position_decoder: Optional[dict] = None):
        super().__init__()
        self.max_seq_len, self.start_idx = max_seq_len, start_idx
        hd = dict(hybrid_decoder or {})
        hd.pop('type', None)
        self.hybrid_decoder = SequenceAttentionDecoder(
            num_classes=num_classes, dim_input=dim_input,
            dim_model=dim_model, max_seq_len=max_seq_len,
            start_idx=start_idx, mask=mask, padding_idx=padding_idx,
            encode_value=encode_value, return_feature=True, **hd)
        pd = dict(position_decoder or {})
        pd.pop('type', None)
        self.position_decoder = PositionAttentionDecoder(
            num_classes=num_classes, dim_input=dim_input,
            dim_model=dim_model, max_seq_len=max_seq_len, mask=mask,
            encode_value=encode_value, return_feature=True, **pd)
        fusion = dim_model if encode_value else dim_input
        self.fusion_module = RobustScannerFusionLayer(fusion)
        self.prediction = nn.Linear(fusion, num_classes - 1)

    def forward(self, feat, out_enc, targets, valid_ratio=None, rng=None):
        hybrid = self.hybrid_decoder(feat, out_enc, targets, valid_ratio)
        position = self.position_decoder(feat, out_enc, targets, valid_ratio)
        return self.prediction(self.fusion_module(hybrid, position))

    def decode_init(self, out_enc, valid_ratio=None, feat=None):
        """The hybrid branch's carry; static: its static and the position
        branch's glimpses of all ``max_seq_len`` steps, computed once."""
        carry, h_static = self.hybrid_decoder.decode_init(out_enc,
                                                          valid_ratio, feat)
        pos = self.position_decoder(feat, out_enc, None, valid_ratio)
        return carry, (h_static, pos)

    def decode_step(self, token, t: int, carry, static, plain: bool = False):
        h_static, pos = static
        hybrid, carry = self.hybrid_decoder.decode_step(token, t, carry,
                                                        h_static)
        out = self.prediction(self.fusion_module(hybrid, pos[:, t]))
        return torch.softmax(out.float(), dim=-1), carry
