"""TextRecognizer: config -> model, convertor, loss and the entry points for
serving and training (counterpart of ``tps_pp_tpu/apis/recognizer.py``).

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
``predict`` runs the model in eval mode for the call, whatever mode
training left it in.

Dtypes: ``cfg['dtype']`` is the compute dtype, ``param_dtype`` (default:
the compute dtype) that of the parameters. Training keeps float32
parameters and Adam state with bf16 compute, as the JAX package does with
flax's ``dtype``: build with ``param_dtype='float32'``, and
``compute_loss`` runs the model under ``torch.autocast`` to the compute
dtype. What autocast does differently from flax: it rounds the inputs of
matmuls and convolutions to bf16 as flax does, but runs LayerNorm and
softmax in float32 and leaves their outputs there, and the decoder's
embedding lookup is not cast, so the decoder's residual stream stays
float32 where flax keeps bf16 activations throughout. The attention scores,
the TPS grid and the warp run outside autocast, as JAX keeps them in
float32. ``predict`` on such a recognizer serves a copy of the model cast
to the compute dtype, made again after the weights change. ``'float64'``
is for parity tests: the model runs in float64 apart from the float32
islands the JAX package keeps too (attention and TPE scores, the sampler's
coordinates, the loss).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .. import convertors as _convertors  # noqa: F401 (registration)
from .. import losses as _losses  # noqa: F401 (registration)
from ..models import backbones, decoders, encoders, rectifiers  # noqa: F401
from ..models.decoders.base import greedy_decode
from ..models.layers import weights_stamp
from ..models.recognizers.encode_decode import EncodeDecodeRecognizer
from ..registry import (BACKBONES, CONVERTORS, DECODERS, ENCODERS, LOSSES,
                        RECTIFIERS)
from ..utils.batching import next_pow2, pad_rows

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float64': torch.float64}
DECODE_MODES = ('auto', 'fused40_bf16', 'plain', 'steps')


class TextRecognizer:
    """NRTR-style encode-decode recognizer with optional TPS++."""

    def __init__(self, cfg: Dict[str, Any], device=None,
                 param_dtype: Optional[str] = None):
        cfg = dict(cfg)
        self.cfg = cfg
        self.max_seq_len = int(cfg.get('max_seq_len', 40))
        self.dtype = _DTYPES[cfg.get('dtype', 'float32')]
        self.param_dtype = (_DTYPES[param_dtype] if param_dtype is not None
                            else self.dtype)
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
        self.model = model.to(self.device, self.param_dtype).eval()
        loss_cfg = dict(cfg.get('loss') or dict(type='TFLoss'))
        loss_cfg.setdefault('ignore_index', lc.padding_idx)
        self.loss_obj = LOSSES.build(loss_cfg)
        self._serving = None     # (weights stamp, model in self.dtype)

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
        return self

    # ------------------------------------------------------------- train
    def compute_loss(self, batch: Dict[str, Any],
                     generator: Optional[torch.Generator] = None,
                     train: bool = True, plain: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {name: loss}) of one batch of ``img`` (N, H, W, C),
        ``padded_targets`` (N, T) and optional ``valid_ratio`` (N,), through
        the teacher-forced pass in train mode (``train=False``: eval mode)
        for the call. Train mode updates the BatchNorm running statistics,
        as ``mutable=['batch_stats']`` does in JAX; ``generator`` (on the
        model's device) draws the dropout masks; ``plain`` makes the
        rectifier's warp take the kernels' plain versions."""
        img = torch.as_tensor(batch['img']).to(self.device, self.param_dtype)
        targets = torch.as_tensor(batch['padded_targets']).to(
            self.device, torch.long)
        vr = batch.get('valid_ratio')
        if vr is not None:
            vr = torch.as_tensor(vr, dtype=torch.float32).to(self.device)
        with self._mode(self.model, train), torch.autocast(
                self.device.type, dtype=self.dtype,
                enabled=self.param_dtype != self.dtype):
            logits = self.model(img.contiguous(), targets, vr,
                                rng=generator, plain=plain)
        losses = self.loss_obj(logits, {'padded_targets': targets},
                               valid_ratio=vr)
        return sum(losses.values()), losses

    @staticmethod
    @contextlib.contextmanager
    def _mode(model: nn.Module, train: bool):
        """``model`` in train or eval mode for the block, then back."""
        was = model.training
        model.train(train)
        try:
            yield model
        finally:
            model.train(was)

    # -------------------------------------------------------- inference
    def resolved_decode_mode(self) -> str:
        if self.decode_mode != 'auto':
            return self.decode_mode
        dec = self.model.decoder
        if (self.device.type == 'cuda' and self.dtype == torch.bfloat16
                and dec.d_k == dec.d_v):
            return 'fused40_bf16'
        return 'steps'

    def serving_model(self) -> nn.Module:
        """The model ``predict`` runs: ``self.model``, or, when the
        parameters are wider than the compute dtype, a copy cast to it,
        made again whenever a weight has changed."""
        if self.param_dtype == self.dtype:
            return self.model
        stamp = weights_stamp(self.model)
        if self._serving is None or self._serving[0] != stamp:
            self._serving = None
            model = copy.deepcopy(self.model)
            for p in model.parameters():
                p.grad = None
            self._serving = (stamp, model.to(self.dtype))
        return self._serving[1]

    def _predict_impl(self, model, img, valid_ratio):
        mode = self.resolved_decode_mode()
        end_idx = self.label_convertor.end_idx if self.early_exit else None
        if mode in ('fused40_bf16', 'plain'):
            return model.decode_full_fused(img, valid_ratio, end_idx=end_idx,
                                           plain=mode == 'plain')
        _, out_enc = model.encode_full(img, valid_ratio)
        return greedy_decode(model.decoder, out_enc, valid_ratio,
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
        model = self.serving_model()
        with self._mode(model, False), torch.inference_mode():
            out = self._predict_impl(model, img.contiguous(),
                                     vr.contiguous())
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


def build_recognizer(cfg: Dict[str, Any], device=None,
                     param_dtype: Optional[str] = None) -> TextRecognizer:
    """The NRTR family (``type`` NRTR / EncodeDecodeRecognizer) is the one
    the port serves and trains so far."""
    type_name = cfg.get('type', 'EncodeDecodeRecognizer')
    if type_name not in ('NRTR', 'EncodeDecodeRecognizer'):
        raise NotImplementedError(
            f'recognizer type {type_name!r} is not ported yet')
    return TextRecognizer(cfg, device, param_dtype)
