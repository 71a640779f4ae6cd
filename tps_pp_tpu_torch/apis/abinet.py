"""ABINetRecognizer: the ABINet family's recognizer (counterpart of
``tps_pp_tpu/apis/abinet.py``).

Builds the vision model, the language decoder, the fuser and ``ABILoss``
from the reference config's shape (``configs/_base_/recog_models/
abinet.py``), as the JAX package does: the label convertor's
``num_classes()`` fills in ``num_chars`` and the top-level
``max_seq_len`` where the vision decoder, the language decoder and the
fuser leave them out, the language decoder's ``pad_idx`` defaults to the
convertor's EOS, and the loss's ``num_classes`` to ``num_classes()``
(38 for DICT36, copied as JAX has it). An image-space ``preprocessor``
(MORAN, SPIN, the TPS-STN) runs before the backbone, as in JAX
(``tps_pp_tpu/models/recognizers/abinet.py:23-27``); its warps go through
kernels 8-10 (``ops.grid_sample``).

Everything else is ``TextRecognizer``'s: ``init_weights``,
``compute_loss`` (train mode, autocast; the convertor's
``target_lengths`` reach the loss), ``predict`` / ``simple_test`` (eval
mode, pow2 bucketing, the bf16 serving copy of f32 parameters, the
``plain`` switch). There is no decode loop: ``predict`` is one pass that
returns the last fuser's logits, (N, T, num_chars) in float32, and the
scores of ``simple_test`` are raw logits, as in JAX and the reference.
In eval mode the TPS++ rectifier warps through kernel 1
(``ops.tps_sampler``), in train mode through kernels 8 and 9
(``ops.grid_sample``). The fused stem never applies.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import fusers  # noqa: F401 (registration)
from ..models.recognizers.abinet import ABINetRecognizerModule
from ..registry import (BACKBONES, CONVERTORS, DECODERS, ENCODERS, FUSERS,
                        LOSSES, PREPROCESSORS, RECTIFIERS)
from .recognizer import TextRecognizer


class ABINetRecognizer(TextRecognizer):

    def __init__(self, cfg: Dict[str, Any], device=None,
                 param_dtype: Optional[str] = None):
        """``device`` and ``param_dtype`` as in ``TextRecognizer``."""
        cfg = self._setup(cfg, device, param_dtype)
        T = self.max_seq_len
        lc_cfg = dict(cfg['label_convertor'], max_seq_len=T)
        self.label_convertor = lc = CONVERTORS.build(lc_cfg)
        num_chars = lc.num_classes()

        enc_cfg = dict(cfg['encoder'])
        if 'decoder' in enc_cfg:
            enc_cfg['decoder'] = dict(enc_cfg['decoder'])
            enc_cfg['decoder'].setdefault('num_chars', num_chars)
            enc_cfg['decoder'].setdefault('max_seq_len', T)
        backbone = BACKBONES.build(cfg['backbone'])
        tpsnet = (RECTIFIERS.build(cfg['tpsnet'],
                                   in_channels=backbone.head_channels)
                  if cfg.get('tpsnet') else None)
        decoder = (DECODERS.build(cfg['decoder'], num_chars=num_chars,
                                  max_seq_len=T, pad_idx=lc.end_idx)
                   if cfg.get('decoder') else None)
        fuser = (FUSERS.build(cfg['fuser'], num_chars=num_chars,
                              max_seq_len=T)
                 if cfg.get('fuser') else None)
        preprocessor = (PREPROCESSORS.build(cfg['preprocessor'])
                        if cfg.get('preprocessor') else None)
        model = ABINetRecognizerModule(
            backbone, ENCODERS.build(enc_cfg), decoder, fuser, tpsnet,
            iter_size=int(cfg.get('iter_size', 1)),
            preprocessor=preprocessor)
        self.model = model.to(self.device, self.param_dtype).eval()
        loss_cfg = dict(cfg['loss'])
        loss_cfg.setdefault('num_classes', num_chars)
        self.loss_obj = LOSSES.build(loss_cfg)

    def resolved_decode_mode(self) -> str:
        """No decode loop: one pass (JAX ``apis/recognizer.py:146-152``)."""
        return 'single_pass'

    def resolved_stem_mode(self) -> str:
        """The module stem, always: the fused stem is the flagship's."""
        return 'xla'

    def _predict_impl(self, model, img, valid_ratio,
                      device_exit: bool = False) -> torch.Tensor:
        """One pass, no decode loop (``device_exit`` is not read)."""
        return model.forward_test_nar(img, valid_ratio,
                                      plain=self.plain).float()
