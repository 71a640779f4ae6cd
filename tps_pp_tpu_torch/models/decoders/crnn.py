"""``CRNNDecoder`` (counterpart of
``tps_pp_tpu/models/decoders/crnn.py:18-42``; reference
``decoders/crnn_decoder.py:13-74``).

A height-1 feature (N, 1, W, C), NHWC, read as W frames (H*W frames for
another height, row-major), gives (N, H*W, num_classes) logits in one
pass: with ``rnn_flag`` two :class:`BidirectionalLSTM` (C -> 256 -> 256,
256 -> 256 -> num_classes), the reference's ``decoder.{0,1}``; without it
the reference's 1x1 ``Conv2d`` ``decoder``. Non-autoregressive: the
training pass is the test pass.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...registry import DECODERS
from ..layers import BidirectionalLSTM, nchw_to_nhwc, nhwc_to_nchw


@DECODERS.register_module()
class CRNNDecoder(nn.Module):
    IS_AUTOREGRESSIVE = False
    READS_FEAT = True

    def __init__(self, in_channels: int = 512, num_classes: int = 37,
                 rnn_flag: bool = False):
        super().__init__()
        self.rnn_flag = rnn_flag
        if rnn_flag:
            self.decoder = nn.Sequential(
                BidirectionalLSTM(in_channels, 256, 256),
                BidirectionalLSTM(256, 256, num_classes))
        else:
            self.decoder = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, feat: torch.Tensor, out_enc=None, targets=None,
                valid_ratio=None, rng=None) -> torch.Tensor:
        """feat (N, H, W, C) (``out_enc`` in its place when it is a 4-d
        map, as in JAX) -> (N, H*W, num_classes) logits in feat's dtype;
        ``targets``, ``valid_ratio`` and ``rng`` are unused."""
        if out_enc is not None and out_enc.dim() == 4:
            feat = out_enc
        if not self.rnn_flag:
            feat = nchw_to_nhwc(self.decoder(nhwc_to_nchw(feat)))
        n, h, w, c = feat.shape
        x = feat.reshape(n, h * w, c)
        return self.decoder(x) if self.rnn_flag else x
