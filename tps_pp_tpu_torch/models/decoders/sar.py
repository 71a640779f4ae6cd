"""SAR's decoders with 2-D attention (counterpart of
``tps_pp_tpu/models/decoders/sar.py``; reference
``decoders/sar_decoder.py``, ``sar_decoder_with_bs.py``).

Training: ``forward(feat, out_enc, targets, valid_ratio)`` is the
teacher-forced pass: the decoder's recurrence reads [holistic, embedded
targets] and each step's hidden state queries a tanh 2-D attention over the
backbone's feature map ``feat``. Inference: ``decode_init`` feeds the
holistic feature once and ``decode_step`` one embedded token, carrying the
two layers' states (h0, c0, h1, c1), which is the reference's
re-run-the-prefix loop made O(T) (an LSTM is causal). ``conv3x3_1(feat)``,
the attention's key, is computed once in ``decode_init``.

The recurrences are float32 islands (``layers.Float32LSTM`` and the cells,
see ``layers._Float32Island``): weights, carried state and gates in
float32, the hidden state cast to the model's dtype where it leaves. The
attention's scores are masked with -1e9 past ``min(w, ceil(w *
valid_ratio))`` columns and softmaxed in float32 (or wider); the glimpse is the
product of the weights, in the feature's dtype, with the feature, summed in
float32.

``ParallelSARDecoder`` keeps the decoder recurrence as one two-layer
``nn.LSTM`` ``rnn_decoder`` (``nn.GRU`` with ``dec_gru``) and the query
and score projections ``conv1x1_1`` / ``conv1x1_2`` as ``nn.Linear``;
``SequentialSARDecoder`` keeps the same math under the reference's other
containers, ``rnn_decoder_layer1/2`` cells and 1x1 ``Conv2d`` projections,
and its cell-state quirk (c := h after every step). As in the JAX package
the embedding's pad row is not pinned: a pad token is never fed at
inference (the classifier has no pad output), and in training it only
reaches positions the loss ignores.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import DECODERS
from ..encoders.nrtr import sequence_mask
from ..layers import (Float32GRU, Float32GRUCell, Float32LSTM,
                      Float32LSTMCell, nchw_to_nhwc, nhwc_to_nchw)
from ..transformer import NEG_INF, dropout


@DECODERS.register_module()
class ParallelSARDecoder(nn.Module):
    IS_AUTOREGRESSIVE = True
    # forward and decode_init read the backbone's feature map
    READS_FEAT = True

    def __init__(self, num_classes: int = 37, enc_bi_rnn: bool = False,
                 dec_bi_rnn: bool = False, dec_do_rnn: float = 0.0,
                 dec_gru: bool = False, d_model: int = 512,
                 d_enc: int = 512, d_k: int = 64, pred_dropout: float = 0.0,
                 max_seq_len: int = 40, mask: bool = True,
                 start_idx: int = 0, padding_idx: int = 92,
                 pred_concat: bool = False):
        super().__init__()
        # as in the JAX package, which builds the carried-state form only
        if dec_bi_rnn:
            raise NotImplementedError('dec_bi_rnn is not implemented')
        if dec_do_rnn:
            raise NotImplementedError('dec_do_rnn is not implemented')
        H = d_enc * (int(enc_bi_rnn) + 1)
        self.enc_size, self.dec_gru, self.mask = H, dec_gru, mask
        self.pred_dropout, self.pred_concat = pred_dropout, pred_concat
        self.max_seq_len = max_seq_len
        self.start_idx, self.padding_idx = start_idx, padding_idx
        self.conv3x3_1 = nn.Conv2d(d_model, d_k, 3, padding=1)
        self.embedding = nn.Embedding(num_classes, H)
        self.prediction = nn.Linear(2 * H + d_model if pred_concat
                                    else d_model, num_classes - 1)
        self._build_recurrence(H, d_k)

    def _build_recurrence(self, H: int, d_k: int):
        self.conv1x1_1 = nn.Linear(H, d_k)
        self.conv1x1_2 = nn.Linear(d_k, 1)
        rnn = Float32GRU if self.dec_gru else Float32LSTM
        self.rnn_decoder = rnn(H, H, num_layers=2, batch_first=True)

    def _query(self, y):
        return self.conv1x1_1(y)

    def _score(self, a):
        return self.conv1x1_2(a)

    def _cell(self, layer: int, x, h, c):
        return self.rnn_decoder.cell_step(layer, x, h, c)

    # ---- shared attention ----------------------------------------------
    def _key(self, feat: torch.Tensor) -> torch.Tensor:
        """conv3x3_1 of feat (N, h, w, C) -> (N, h, w, d_k), NHWC."""
        return nchw_to_nhwc(self.conv3x3_1(nhwc_to_nchw(feat)))

    def _attend(self, y, feat, valid_ratio, key=None):
        """y (N, T, H) hidden states, feat (N, h, w, C) -> glimpse (N, T, C)
        in feat's dtype; ``key`` is ``_key(feat)`` where it is computed
        already."""
        if key is None:
            key = self._key(feat)
        a = torch.tanh(key[:, None] + self._query(y)[:, :, None, None, :])
        a = self._score(a)[..., 0]                       # (N, T, h, w)
        N, T, h, w = a.shape
        with torch.autocast(a.device.type, enabled=False):
            a = a.to(torch.promote_types(a.dtype, torch.float32))
            if self.mask and valid_ratio is not None:
                keep = sequence_mask(valid_ratio, w)[:, None, None, :]
                a = a.masked_fill(keep == 0, NEG_INF)
            weights = torch.softmax(a.reshape(N, T, h * w), dim=-1)
        flat = feat.reshape(N, h * w, feat.shape[-1])
        return torch.matmul(weights.to(flat.dtype), flat)

    def _predict(self, y, glimpse, holistic, rng=None):
        if self.pred_concat:
            hf = holistic[:, None].expand(-1, y.shape[1], -1)
            out = self.prediction(torch.cat([y, glimpse, hf], dim=2))
        else:
            out = self.prediction(glimpse)
        return dropout(out, self.pred_dropout if self.training else 0.0, rng)

    # ---- teacher-forced pass (training) ---------------------------------
    def forward(self, feat: torch.Tensor, out_enc: torch.Tensor,
                targets: torch.Tensor, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat (N, h, w, C), out_enc (N, H) holistic, targets (N, T) ->
        (N, T, C-1) logits. ``rng`` draws the prediction dropout's masks in
        train mode."""
        emb = self.embedding(targets).to(out_enc.dtype)
        in_dec = torch.cat([out_enc[:, None], emb], dim=1)
        y = self.rnn_decoder(in_dec)[0].to(out_enc.dtype)
        glimpse = self._attend(y, feat, valid_ratio)
        return self._predict(y, glimpse, out_enc, rng)[:, 1:]

    # ---- the decode protocol ---------------------------------------------
    def decode_init(self, out_enc: torch.Tensor, valid_ratio=None,
                    feat: Optional[torch.Tensor] = None):
        """carry: the two layers' (h, c) after the holistic feature;
        static: (feat, out_enc, valid_ratio, conv3x3_1(feat))."""
        z = out_enc.new_zeros((out_enc.shape[0], self.enc_size))
        h0, c0 = self._cell(0, out_enc, z, z)
        h1, c1 = self._cell(1, h0, z, z)
        return (h0, c0, h1, c1), (feat, out_enc, valid_ratio,
                                  self._key(feat))

    def _step(self, token, carry, static):
        h0, c0, h1, c1 = carry
        feat, out_enc, valid_ratio, key = static
        x = self.embedding(token)
        h0, c0 = self._cell(0, x, h0, c0)
        h1, c1 = self._cell(1, h0, h1, c1)
        y = h1[:, None].to(out_enc.dtype)
        out = self._predict(y, self._attend(y, feat, valid_ratio, key),
                            out_enc)[:, 0]
        return torch.softmax(out.float(), dim=-1), (h0, c0, h1, c1)

    def decode_step(self, token, t: int, carry, static, plain: bool = False):
        """token (N,) -> (probs (N, C-1) float32, carry); ``plain`` is
        unused (no kernel on this path)."""
        return self._step(token, carry, static)


@DECODERS.register_module()
class SequentialSARDecoder(ParallelSARDecoder):
    """The reference's ``SequentialSARDecoder`` (sar_decoder.py:269-478):
    the parallel decoder's math on per-step cells, with the reference's
    quirk kept in both passes: ``_2d_attention`` returns ``(y, hx1, hx1,
    hx2, hx2)``, so every step's cell state is overwritten with its hidden
    state; only the holistic step keeps a true cell state (JAX
    ``decoders/sar.py:150-195``). Checkpoints of this class were trained
    under that recurrence."""

    def _build_recurrence(self, H: int, d_k: int):
        self.conv1x1_1 = nn.Conv2d(H, d_k, 1)
        self.conv1x1_2 = nn.Conv2d(d_k, 1, 1)
        cell = Float32GRUCell if self.dec_gru else Float32LSTMCell
        self.rnn_decoder_layer1 = cell(H, H)
        self.rnn_decoder_layer2 = cell(H, H)

    def _query(self, y):
        w = self.conv1x1_1
        return F.linear(y, w.weight[:, :, 0, 0], w.bias)

    def _score(self, a):
        w = self.conv1x1_2
        return F.linear(a, w.weight[:, :, 0, 0], w.bias)

    def _cell(self, layer: int, x, h, c):
        cell = (self.rnn_decoder_layer1, self.rnn_decoder_layer2)[layer]
        return cell.step(x, h, c)

    def forward(self, feat, out_enc, targets, valid_ratio=None, rng=None):
        emb = self.embedding(targets).to(out_enc.dtype)
        key = self._key(feat)
        z = out_enc.new_zeros((out_enc.shape[0], self.enc_size))
        h0, c0 = self._cell(0, out_enc, z, z)
        h1, c1 = self._cell(1, h0, z, z)
        outs = []
        for t in range(targets.shape[1]):
            h0, c0 = self._cell(0, emb[:, t], h0, c0)
            h1, c1 = self._cell(1, h0, h1, c1)
            y = h1[:, None].to(out_enc.dtype)
            glimpse = self._attend(y, feat, valid_ratio, key)
            outs.append(self._predict(y, glimpse, out_enc, rng)[:, 0])
            c0, c1 = h0, h1                          # the c := h quirk
        return torch.stack(outs, dim=1)

    def decode_step(self, token, t, carry, static, plain=False):
        probs, (h0, _, h1, _) = self._step(token, carry, static)
        return probs, (h0, h0, h1, h1)               # the c := h quirk


@DECODERS.register_module()
class ParallelSARDecoderWithBS(ParallelSARDecoder):
    """The reference's beam-search SAR decoder (``sar_decoder_with_bs.py``):
    the parallel decoder, decoded by ``base.beam_decode`` at
    ``beam_width`` (5), at any batch size."""

    def __init__(self, num_classes: int = 37, enc_bi_rnn: bool = False,
                 dec_bi_rnn: bool = False, dec_do_rnn: float = 0.0,
                 dec_gru: bool = False, d_model: int = 512,
                 d_enc: int = 512, d_k: int = 64, pred_dropout: float = 0.0,
                 max_seq_len: int = 40, mask: bool = True,
                 start_idx: int = 0, padding_idx: int = 92,
                 pred_concat: bool = False, beam_width: int = 5):
        super().__init__(num_classes, enc_bi_rnn, dec_bi_rnn, dec_do_rnn,
                         dec_gru, d_model, d_enc, d_k, pred_dropout,
                         max_seq_len, mask, start_idx, padding_idx,
                         pred_concat)
        self.beam_width = beam_width
