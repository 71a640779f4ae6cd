"""ABINet recognizer module (counterpart of
``tps_pp_tpu/models/recognizers/abinet.py``; reference
recognizer/abinet.py:18-206).

optional image-space preprocessor (MORAN, SPIN, the TPS-STN) + backbone +
optional TPS++ rectifier (``extract_feat``, shared with
``EncodeDecodeRecognizer``) + ``ABIVisionModel`` + ``iter_size`` rounds of
the language decoder and the fuser, each round on the last fuser's logits
(the first on the vision model's).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .encode_decode import EncodeDecodeRecognizer


class ABINetRecognizerModule(nn.Module):

    def __init__(self, backbone: nn.Module, encoder: nn.Module,
                 decoder: Optional[nn.Module] = None,
                 fuser: Optional[nn.Module] = None,
                 tpsnet: Optional[nn.Module] = None, iter_size: int = 1,
                 preprocessor: Optional[nn.Module] = None):
        super().__init__()
        self.preprocessor = preprocessor
        self.backbone = backbone
        self.tpsnet = tpsnet
        self.encoder = encoder
        self.decoder = decoder
        self.fuser = fuser
        self.iter_size = iter_size

    # the rectifier protocol is the encode-decode recognizer's, one copy
    extract_feat = EncodeDecodeRecognizer.extract_feat

    def forward(self, img: torch.Tensor, targets=None, valid_ratio=None,
                rng: Optional[torch.Generator] = None,
                plain: bool = False) -> Dict:
        """img (N, H, W, C) -> ``out_enc`` (the vision model's dict),
        ``out_decs`` and ``out_fusers`` (a dict a round), for ``ABILoss``.
        ``targets`` are unused, as in the reference; ``rng`` draws the
        dropout masks in train mode; ``plain`` makes the preprocessor's
        and the rectifier's warps take the kernels' plain versions."""
        feat = self.extract_feat(img, plain=plain)
        out_enc = self.encoder(feat, valid_ratio, rng=rng)
        text_logits = out_enc['logits']
        out_decs, out_fusers = [], []
        for _ in range(self.iter_size):
            if self.decoder is None:
                break
            out_dec = self.decoder(text_logits, rng=rng)
            out_decs.append(out_dec)
            if self.fuser is not None:
                # the vision feature in the l_feature slot, as the
                # reference calls it (abinet.py:138)
                out_fuser = self.fuser(out_enc['feature'],
                                       out_dec['feature'])
                text_logits = out_fuser['logits']
                out_fusers.append(out_fuser)
        return {'out_enc': out_enc, 'out_decs': out_decs,
                'out_fusers': out_fusers}

    def forward_test_nar(self, img: torch.Tensor, valid_ratio=None,
                         plain: bool = False) -> torch.Tensor:
        """The serving pass: the last fuser's logits (N, T, C), else the
        last language decoder's, else the vision model's."""
        out = self(img, valid_ratio=valid_ratio, plain=plain)
        last = (out['out_fusers'] or out['out_decs'] or [out['out_enc']])[-1]
        return last['logits']
