"""Encode-decode recognizer (counterpart of
``tps_pp_tpu/models/recognizers/encode_decode.py``).

backbone + optional TPS++ rectifier + encoder + decoder. The rectifier is a
mid-backbone stage: ``x, skips = backbone.stem_and_head(img)``,
``x = tpsnet(x, skips)['output']``, ``x = backbone.tail(x)``. Images and
features are NHWC at these boundaries. ``forward`` is the teacher-forced
training pass (JAX ``encode_decode.py:63-69``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class EncodeDecodeRecognizer(nn.Module):

    def __init__(self, backbone: nn.Module, encoder: nn.Module,
                 decoder: nn.Module, tpsnet: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.tpsnet = tpsnet
        self.encoder = encoder
        self.decoder = decoder

    def extract_feat(self, img: torch.Tensor, plain: bool = False):
        """img (N, H, W, C) -> backbone feature (N, h, w, c). ``plain``
        makes the rectifier use the sampler's plain version on any
        device."""
        x, skips = self.backbone.stem_and_head(img)
        if self.tpsnet is not None:
            x = self.tpsnet(x, skips, plain=plain)['output']
        return self.backbone.tail(x)

    def forward(self, img: torch.Tensor, targets: torch.Tensor,
                valid_ratio=None, rng: Optional[torch.Generator] = None,
                plain: bool = False) -> torch.Tensor:
        """Teacher-forced logits (N, T, C-1) of img (N, H, W, C) against
        targets (N, T); ``rng`` draws the dropout masks in train mode,
        ``plain`` makes the rectifier's warp take the plain versions."""
        feat = self.extract_feat(img, plain=plain)
        out_enc = self.encoder(feat, valid_ratio, rng=rng)
        return self.decoder(out_enc, targets, valid_ratio, rng=rng)

    def encode_full(self, img, valid_ratio=None):
        """(feat, out_enc) of the module path."""
        feat = self.extract_feat(img, plain=True)
        return feat, self.encoder(feat, valid_ratio)

    def decode_full_fused(self, img, valid_ratio=None,
                          end_idx: Optional[int] = None,
                          plain: bool = False) -> torch.Tensor:
        """The serving path: rectifier sampler, whole encoder and whole
        decode through the ops (kernels on CUDA tensors); ``plain`` runs
        the same functions through their plain PyTorch versions.
        Returns (N, S, C-1) float32 probabilities."""
        feat = self.extract_feat(img, plain=plain)
        out_enc = self.encoder(feat, valid_ratio, fused=True, plain=plain)
        return self.decoder.fused_full_decode(out_enc, valid_ratio,
                                              end_idx=end_idx, plain=plain)
