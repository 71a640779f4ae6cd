"""TextRecognizer: config -> model, convertor and the serving entry points
(counterpart of ``tps_pp_tpu/apis/recognizer.py``).

``predict`` pads the batch to the next power of two (replicating the last
row, so the all-rows-EOS exit is not held up) and slices the result back,
as the JAX package does. Decode modes:

* ``'fused40_bf16'``: the serving path. The TPS sampler, the whole encoder
  and the whole greedy decode run through the port's ops: the CUDA kernels
  on CUDA tensors, their plain versions on CPU tensors.
* ``'plain'``: the same path with every kernel replaced by its plain
  PyTorch version on any device, the reference the kernels are held to.
* ``'steps'``: the module path (per-layer modules, KV-cached
  ``greedy_decode``), the counterpart of the JAX package's ``steps``.
* ``'auto'`` (default): ``'fused40_bf16'`` for a bf16 model on CUDA whose
  decoder has ``d_k == d_v``, else ``'steps'``.

``early_exit`` (default on) stops decoding once every row has emitted EOS.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .. import convertors as _convertors  # noqa: F401 (registration)
from ..models import backbones, decoders, encoders, rectifiers  # noqa: F401
from ..models.decoders.base import greedy_decode
from ..models.recognizers.encode_decode import EncodeDecodeRecognizer
from ..registry import (BACKBONES, CONVERTORS, DECODERS, ENCODERS,
                        RECTIFIERS)
from ..utils.batching import next_pow2, pad_rows

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
DECODE_MODES = ('auto', 'fused40_bf16', 'plain', 'steps')


class TextRecognizer:
    """NRTR-style encode-decode recognizer with optional TPS++."""

    def __init__(self, cfg: Dict[str, Any], device=None):
        cfg = dict(cfg)
        self.cfg = cfg
        self.max_seq_len = int(cfg.get('max_seq_len', 40))
        self.dtype = _DTYPES[cfg.get('dtype', 'float32')]
        self.device = torch.device(device if device is not None else 'cpu')
        self.decode_mode = cfg.get('decode_mode', 'auto')
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(f'decode_mode {self.decode_mode!r} not in '
                             f'{DECODE_MODES}')
        self.early_exit = bool(cfg.get('early_exit', True))

        lc_cfg = dict(cfg['label_convertor'], max_seq_len=self.max_seq_len)
        self.label_convertor = lc = CONVERTORS.build(lc_cfg)
        backbone = BACKBONES.build(cfg['backbone'])
        tpsnet = (RECTIFIERS.build(cfg['tpsnet'],
                                   in_channels=backbone.head_channels)
                  if cfg.get('tpsnet') else None)
        decoder = DECODERS.build(
            cfg['decoder'], num_classes=lc.num_classes(),
            start_idx=lc.start_idx, padding_idx=lc.padding_idx,
            max_seq_len=self.max_seq_len)
        model = EncodeDecodeRecognizer(
            backbone, ENCODERS.build(cfg['encoder']), decoder, tpsnet)
        self.model = model.to(self.device, self.dtype).eval()

    def init_weights(self, seed: int = 0):
        """Random weights from a seeded ``torch.Generator``, drawn on the
        CPU so that every device gets the same values: conv and linear
        weights uniform with variance 1/fan_in, zero biases, unit normal
        embeddings (pad row zero), identity norms and BatchNorm statistics,
        and TPS++'s localization head at its reference init."""
        g = torch.Generator().manual_seed(seed)

        def fill(t, draw):
            t.copy_(draw(torch.empty(t.shape, dtype=torch.float32)))

        with torch.no_grad():
            for m in self.model.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    b = (3.0 / m.weight[0].numel()) ** 0.5
                    fill(m.weight, lambda x: x.uniform_(-b, b, generator=g))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.Embedding):
                    fill(m.weight, lambda x: x.normal_(generator=g))
                    if m.padding_idx is not None:
                        m.weight[m.padding_idx].zero_()
                elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                    m.reset_parameters()
            if self.model.tpsnet is not None:
                self.model.tpsnet.TPE.reset_localization()
        # the fused paths cache folded weights; drop them with a reload
        self.model.load_state_dict(self.model.state_dict())
        return self

    # -------------------------------------------------------- inference
    def resolved_decode_mode(self) -> str:
        if self.decode_mode != 'auto':
            return self.decode_mode
        dec = self.model.decoder
        if (self.device.type == 'cuda' and self.dtype == torch.bfloat16
                and dec.d_k == dec.d_v):
            return 'fused40_bf16'
        return 'steps'

    def _predict_impl(self, img, valid_ratio):
        mode = self.resolved_decode_mode()
        end_idx = self.label_convertor.end_idx if self.early_exit else None
        if mode in ('fused40_bf16', 'plain'):
            return self.model.decode_full_fused(img, valid_ratio,
                                                end_idx=end_idx,
                                                plain=mode == 'plain')
        _, out_enc = self.model.encode_full(img, valid_ratio)
        return greedy_decode(self.model.decoder, out_enc, valid_ratio,
                             max_seq_len=self.max_seq_len,
                             start_idx=self.label_convertor.start_idx,
                             end_idx=end_idx)

    def predict(self, img, valid_ratio=None,
                bucket_batch: bool = True) -> torch.Tensor:
        """img (N, H, W, C) array or tensor -> (N, S, C-1) float32
        per-step probabilities on the model's device."""
        img = torch.as_tensor(img).to(self.device, self.dtype)
        n = int(img.shape[0])
        if valid_ratio is None:
            vr = torch.ones((n,), dtype=torch.float32, device=self.device)
        else:
            vr = torch.as_tensor(valid_ratio, dtype=torch.float32).to(
                self.device)
        m = next_pow2(n) if bucket_batch else n
        img, vr = pad_rows((img, vr), n, m)
        with torch.inference_mode():
            out = self._predict_impl(img.contiguous(), vr.contiguous())
        return out[:n]

    def simple_test(self, img, valid_ratio=None, img_metas=None,
                    bucket_batch: bool = True):
        """Full test path with host-side decoding ->
        ``[{'text': str, 'score': [float, ...]}, ...]``."""
        out = self.predict(img, valid_ratio,
                           bucket_batch=bucket_batch).cpu().numpy()
        indexes, scores = self.label_convertor.tensor2idx(out, img_metas)
        strings = self.label_convertor.idx2str(indexes)
        return [dict(text=s, score=sc) for s, sc in zip(strings, scores)]


def build_recognizer(cfg: Dict[str, Any], device=None) -> TextRecognizer:
    """The NRTR family (``type`` NRTR / EncodeDecodeRecognizer) is the one
    the port serves so far."""
    type_name = cfg.get('type', 'EncodeDecodeRecognizer')
    if type_name not in ('NRTR', 'EncodeDecodeRecognizer'):
        raise NotImplementedError(
            f'recognizer type {type_name!r} is not ported yet')
    return TextRecognizer(cfg, device)
