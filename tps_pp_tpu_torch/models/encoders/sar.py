"""SAR's holistic encoder (counterpart of
``tps_pp_tpu/models/encoders/sar.py``; reference
``encoders/sar_encoder.py:14-111``) and RobustScanner's
``ChannelReductionEncoder`` (JAX ``encoders/satrn.py:137-148``).

``SAREncoder``: the feature's max over its height, a two-layer LSTM (GRU
with ``enc_gru``, both directions with ``enc_bi_rnn``) over its width, the
hidden state at the last valid column ``min(T, ceil(T * valid_ratio)) - 1``,
then ``linear``. The recurrence is one torch ``nn.LSTM`` / ``nn.GRU``
``rnn_encoder`` of two layers, the reference's (JAX runs two scans from its
two layers' weights), kept in float32 (``layers.Float32LSTM``: a float32
island, where JAX scans in the model's dtype). ``enc_do_rnn`` is the dropout
between the two layers in training, its masks from the port's generator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...registry import ENCODERS
from ..layers import Float32GRU, Float32LSTM, nchw_to_nhwc, nhwc_to_nchw
from .nrtr import valid_steps


@ENCODERS.register_module()
class SAREncoder(nn.Module):

    def __init__(self, enc_bi_rnn: bool = False, enc_do_rnn: float = 0.0,
                 enc_gru: bool = False, d_model: int = 512,
                 d_enc: int = 512, mask: bool = True):
        super().__init__()
        self.enc_do_rnn, self.mask = float(enc_do_rnn), mask
        rnn = Float32GRU if enc_gru else Float32LSTM
        self.rnn_encoder = rnn(d_model, d_enc, num_layers=2,
                               batch_first=True, bidirectional=enc_bi_rnn)
        out = d_enc * (int(enc_bi_rnn) + 1)
        self.linear = nn.Linear(out, out)

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """feat (N, H, W, C) -> holistic feature (N, D * d_enc) in feat's
        dtype. ``rng`` draws the inter-layer dropout masks in train mode."""
        x = feat.amax(dim=1)
        rate = self.enc_do_rnn if self.training else 0.0
        h = self.rnn_encoder.run_layers(x, rate, rng)
        T = h.shape[1]
        if self.mask and valid_ratio is not None:
            rows = torch.arange(h.shape[0], device=h.device)
            holistic = h[rows, valid_steps(valid_ratio, T) - 1]
        else:
            holistic = h[:, -1]
        return self.linear(holistic.to(feat.dtype))


@ENCODERS.register_module()
class ChannelReductionEncoder(nn.Module):
    """A 1x1 convolution ``layer`` (reference
    ``encoders/channel_reduction_encoder.py``): (N, H, W, in) -> (N, H, W,
    out), NHWC."""

    def __init__(self, in_channels: int = 512, out_channels: int = 128):
        super().__init__()
        self.layer = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, feat: torch.Tensor, valid_ratio=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return nchw_to_nhwc(self.layer(nhwc_to_nchw(feat)))
