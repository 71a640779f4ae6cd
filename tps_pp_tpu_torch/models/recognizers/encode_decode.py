"""Encode-decode recognizer (counterpart of
``tps_pp_tpu/models/recognizers/encode_decode.py:25-76``).

optional image-space preprocessor (TPS-STN) + backbone + optional TPS++
rectifier + optional encoder + decoder. The rectifier is a mid-backbone
stage: ``x, skips = backbone.stem_and_head(img)``,
``x = tpsnet(x, skips)['output']``, ``x = backbone.tail(x)``; without one
the backbone runs whole. Images and features are NHWC at these
boundaries. ``forward`` is the training pass (JAX ``encode_decode.py:
63-69``): a decoder with ``READS_FEAT`` (CRNN, SAR, RobustScanner) takes
``(feat, out_enc, targets, ...)``, out_enc None without an encoder; NRTR's
takes ``(out_enc, targets, ...)``.
``forward_test_nar`` is the single pass of a non-autoregressive decoder.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class EncodeDecodeRecognizer(nn.Module):

    def __init__(self, backbone: nn.Module, encoder: Optional[nn.Module],
                 decoder: nn.Module, tpsnet: Optional[nn.Module] = None,
                 preprocessor: Optional[nn.Module] = None):
        super().__init__()
        self.preprocessor = preprocessor
        self.backbone = backbone
        self.tpsnet = tpsnet
        self.encoder = encoder
        self.decoder = decoder

    def extract_feat(self, img: torch.Tensor, plain: bool = False,
                     stem=None):
        """img (N, H, W, C) -> backbone feature (N, h, w, c). ``plain``
        makes the preprocessor's and the rectifier's warps use the plain
        versions on any device; ``stem``, a precomputed (x, skips)
        (``ops.stem.fused_stem_forward``), replaces
        ``backbone.stem_and_head``."""
        if self.preprocessor is not None:
            img = self.preprocessor(img, plain=plain)
        if self.tpsnet is None and stem is None:
            return self.backbone(img)
        x, skips = (stem if stem is not None else
                    self.backbone.stem_and_head(img))
        if self.tpsnet is not None:
            x = self.tpsnet(x, skips, plain=plain)['output']
        return self.backbone.tail(x)

    def forward(self, img: torch.Tensor, targets: torch.Tensor,
                valid_ratio=None, rng: Optional[torch.Generator] = None,
                plain: bool = False) -> torch.Tensor:
        """Training logits of img (N, H, W, C) against targets (N, T):
        teacher-forced (N, T, C-1) for the autoregressive decoders, the
        single pass's for CRNN.
        ``rng`` draws the dropout masks in train mode, ``plain`` makes the
        warps take the plain versions."""
        feat = self.extract_feat(img, plain=plain)
        out_enc = (None if self.encoder is None
                   else self.encoder(feat, valid_ratio, rng=rng))
        if getattr(self.decoder, 'READS_FEAT', False):
            return self.decoder(feat, out_enc, targets, valid_ratio, rng=rng)
        return self.decoder(out_enc, targets, valid_ratio, rng=rng)

    def encode_full(self, img, valid_ratio=None, plain: bool = False,
                    stem=None):
        """(feat, out_enc) of the module path, out_enc None without an
        encoder; ``plain`` and ``stem`` as in :meth:`extract_feat`."""
        feat = self.extract_feat(img, plain=plain, stem=stem)
        return feat, self.encode(feat, valid_ratio)

    def encode(self, feat, valid_ratio=None):
        """The encoder's output of feat, None without an encoder."""
        return None if self.encoder is None else self.encoder(feat,
                                                              valid_ratio)

    def forward_test_nar(self, img, valid_ratio=None,
                         plain: bool = False) -> torch.Tensor:
        """The single test pass of a non-autoregressive decoder (CRNN):
        its logits (N, T, C)."""
        feat, out_enc = self.encode_full(img, valid_ratio, plain=plain)
        return self.decoder(feat, out_enc, valid_ratio=valid_ratio)

    def decode_full_fused(self, img, valid_ratio=None,
                          end_idx: Optional[int] = None,
                          plain: bool = False,
                          enc_dtype: str = 'bfloat16',
                          stem=None, feat=None) -> torch.Tensor:
        """The serving path: rectifier sampler, whole encoder and whole
        decode through the ops (kernels on CUDA tensors); an encoder
        without ``SUPPORTS_FUSED_FORWARD`` (SATRN's) runs as a module before
        the whole decode, as in JAX (``tps_pp_tpu/apis/recognizer.py:
        233-243``); ``plain`` runs the same functions through their plain
        PyTorch versions;
        ``enc_dtype`` is the decode's encoder K/V type (``'bfloat16'`` or
        ``'int8'``); ``stem`` as in :meth:`extract_feat`; ``feat``, the
        output of :meth:`extract_feat` where it is computed already. Returns
        (N, S, C-1) float32 probabilities."""
        if feat is None:
            feat = self.extract_feat(img, plain=plain, stem=stem)
        if getattr(type(self.encoder), 'SUPPORTS_FUSED_FORWARD', False):
            out_enc = self.encoder(feat, valid_ratio, fused=True,
                                   plain=plain)
        else:
            out_enc = self.encode(feat, valid_ratio)
        return self.decoder.fused_full_decode(out_enc, valid_ratio,
                                              end_idx=end_idx, plain=plain,
                                              enc_dtype=enc_dtype)
