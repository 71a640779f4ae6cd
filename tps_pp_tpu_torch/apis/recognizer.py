"""TextRecognizer: config -> model, convertor, loss and the entry points for
serving and training (counterpart of ``tps_pp_tpu/apis/recognizer.py``).

The generic encode-decode recognizer of the JAX package
(``tps_pp_tpu/apis/recognizer.py:47-116``): the preprocessor, the TPS++
rectifier and the encoder are built only where the config has them, and
``autoregressive`` is the decoder's ``IS_AUTOREGRESSIVE``. A
non-autoregressive decoder (CRNN) has no decode loop:
``resolved_decode_mode()`` is ``'single_pass'`` and ``predict`` returns
its raw float32 logits (N, T, C), which the CTC convertor's
``tensor2idx`` softmaxes, as in JAX. What follows is the autoregressive
decoders' (NRTR; SAR's three and RobustScanner's, which run ``steps``
only: they have no whole-decode kernel, as in JAX, where they are plain
XLA). A decoder with ``READS_FEAT`` (SAR, RobustScanner) gets the
backbone's feature map in ``decode_init`` too.

``predict`` pads the batch to the next power of two (replicating the last
row, so the all-rows-EOS exit is not held up) and slices the result back,
as the JAX package does. With a ``mesh`` of local devices
(``parallel.create_mesh``) it then pads to a multiple of the data axis and
runs one equal shard a data row on that row's device, with one copy of
the serving model a card (copied again when the weights change), from
one host thread a card under ``torch.cuda.device`` (as
``torch.nn.parallel.parallel_apply`` does; a card listed twice runs its
shards in turn), and gathers the shards in order on the recognizer's
device: the JAX ``shard_map`` over ``'data'``
(``tps_pp_tpu/apis/recognizer.py:272-322``). Each shard's kernel launches
are kept in ``last_shard_launches``. Decode modes, the JAX package's
(``tps_pp_tpu/apis/recognizer.py:91-101``):

* ``'fused40_bf16'``: the serving path. The TPS sampler, the whole encoder
  and the whole greedy decode with bf16 encoder K/V run through the port's
  ops: the CUDA kernels on CUDA tensors, their plain versions on CPU
  tensors.
* ``'fused40'``: the same path with the encoder K/V quantized to int8 with
  one absmax scale per (layer, head) over the whole batch, so a row's
  output depends on the rest of its batch (argmax flips at quantization
  near-ties).
* ``'steps'``: the module path (per-layer modules, KV-cached
  ``greedy_decode``), the counterpart of the JAX package's ``steps``. A
  decoder with ``use_fused_step`` runs each layer's step as two kernels
  (``ops.decode_step``); one with ``kv_dtype='int8'`` keeps int8 caches.
* ``'auto'`` (default): ``'fused40_bf16'`` for a bf16 model on CUDA whose
  decoder, and encoder where it fuses, the kernels take
  (``kernel_accepts``: d_k == d_v, kernel 3's d_k 64 and d_model 512,
  kernel 4's d_k 32 or 64, and, once the trunk has run, at most 512
  tokens an image for both), else ``'steps'``. An encoder without a fused
  forward (SATRN's) runs as a module before the whole decode. A
  token count the kernels refuse is seen only after ``extract_feat``; the
  ``steps`` path then goes on from that feature, and the trunk runs once.
  An explicit ``'fused40*'`` on such a model raises the kernels'
  ``ValueError``; on a decoder without a whole decode (SAR, RobustScanner)
  it runs ``'steps'``, as in JAX.

Setting the attribute ``plain`` to True makes every mode run its kernels'
plain PyTorch versions on any device: the reference the kernels are held
to on the card.

Stem modes (``cfg['stem_mode']``), the JAX package's
(``tps_pp_tpu/apis/recognizer.py:179-213``): ``'xla'`` runs the module stem
(``backbone.stem_and_head``); ``'fused'`` runs the stem, layer1 and layer2
through ``ops.stem.fused_stem_forward`` (kernels 11-12 in the (C, P)
layout) when the trunk has the flagship's geometry (a rectifier,
``tps_stage == 2``, ``strides[:2] == (1, 2)``, stem width == base width),
and the module stem otherwise; ``'auto'`` (default) is ``'xla'``, as in
JAX. The fused stem folds the stem conv's bias, which the JAX one drops.

``early_exit`` (default on) stops decoding once every row has emitted EOS;
``fused_early_exit`` (default on) set to False turns that exit off in the
whole decodes (``fused40*``) only, as in JAX. ``beam_width`` above 1 (the
cfg key, else the decoder's attribute) runs ``beam_decode`` after
``encode_full`` in any mode, ranked with ``beam_length_norm``; it has no
early exit.
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
the TPS grids and the warps run outside autocast, as JAX keeps them in
float32; so do the recurrences (the CRNN decoder's LSTMs, SAR's and
RobustScanner's LSTMs and cells), which stay float32 in a bf16 model too
(``models/layers.py`` ``_Float32Island``), where JAX runs its scans in the
model's dtype. ``predict`` on such a recognizer serves a copy of
the model cast to the compute dtype, made again after the weights
change. ``'float64'``
is for parity tests: the model runs in float64 apart from the float32
islands the JAX package keeps too (attention and TPE scores, the sampler's
coordinates, the loss).
"""
from __future__ import annotations

import contextlib
import copy
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .. import convertors as _convertors  # noqa: F401 (registration)
from .. import losses as _losses  # noqa: F401 (registration)
from ..models import backbones, decoders, encoders, rectifiers  # noqa: F401
from ..models.decoders.base import beam_decode, greedy_decode
from ..models.layers import weights_stamp
from ..models.recognizers.encode_decode import EncodeDecodeRecognizer
from ..models.transformer import PackedMultiheadAttention
from ..ops import _lib
from ..ops.stem import fused_stem_forward
from ..registry import (BACKBONES, CONVERTORS, DECODERS, ENCODERS, LOSSES,
                        PREPROCESSORS, RECTIFIERS)
from ..utils.batching import next_pow2, pad_rows

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float64': torch.float64}
DECODE_MODES = ('auto', 'fused40_bf16', 'fused40', 'steps')
STEM_MODES = ('auto', 'xla', 'fused')


def _concrete(device) -> torch.device:
    """``device`` with the current card's index where it names none."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


class TextRecognizer:
    """Encode-decode recognizer (NRTR, SATRN, CRNN, SAR, RobustScanner)
    with an optional TPS++ rectifier or image-space preprocessor."""

    def __init__(self, cfg: Dict[str, Any], device=None,
                 param_dtype: Optional[str] = None):
        """``device``: where the model lives; the CUDA device when None,
        and a ``RuntimeError`` if there is none (pass ``'cpu'`` to build on
        the CPU)."""
        cfg = self._setup(cfg, device, param_dtype)
        self.decode_mode = cfg.get('decode_mode', 'auto')
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(f'decode_mode {self.decode_mode!r} not in '
                             f'{DECODE_MODES}')
        self.stem_mode = cfg.get('stem_mode', 'auto')
        if self.stem_mode not in STEM_MODES:
            raise ValueError(f'stem_mode {self.stem_mode!r} not in '
                             f'{STEM_MODES}')
        # stop the decode once every row has emitted EOS; fused_early_exit
        # turns the exit off in the whole decodes only
        # (tps_pp_tpu/apis/recognizer.py:78-86)
        self.early_exit = bool(cfg.get('early_exit', True))
        self.fused_early_exit = bool(cfg.get('fused_early_exit', True))
        self.beam_length_norm = bool(cfg.get('beam_length_norm', False))

        lc_cfg = dict(cfg['label_convertor'], max_seq_len=self.max_seq_len)
        self.label_convertor = lc = CONVERTORS.build(lc_cfg)
        backbone = BACKBONES.build(cfg['backbone'])
        tpsnet = (RECTIFIERS.build(cfg['tpsnet'],
                                   in_channels=backbone.head_channels)
                  if cfg.get('tpsnet') else None)
        preprocessor = (PREPROCESSORS.build(cfg['preprocessor'])
                        if cfg.get('preprocessor') else None)
        encoder = (ENCODERS.build(cfg['encoder']) if cfg.get('encoder')
                   else None)
        decoder = DECODERS.build(
            cfg['decoder'], num_classes=lc.num_classes(),
            start_idx=lc.start_idx, padding_idx=lc.padding_idx,
            max_seq_len=self.max_seq_len)
        self.autoregressive = bool(getattr(type(decoder),
                                           'IS_AUTOREGRESSIVE', False))
        # beam search above 1: the cfg key, else the decoder's
        # (tps_pp_tpu/apis/recognizer.py:110-113)
        self.beam_width = int(cfg.get(
            'beam_width', getattr(decoder, 'beam_width', 1) or 1))
        model = EncodeDecodeRecognizer(backbone, encoder, decoder, tpsnet,
                                       preprocessor)
        self.model = model.to(self.device, self.param_dtype).eval()
        loss_cfg = dict(cfg.get('loss') or dict(type='TFLoss'))
        loss_cfg.setdefault('ignore_index', lc.padding_idx)
        self.loss_obj = LOSSES.build(loss_cfg)

    def _setup(self, cfg: Dict[str, Any], device,
               param_dtype: Optional[str]) -> Dict[str, Any]:
        """The attributes every recognizer has (config, lengths, dtypes,
        device, the ``plain`` switch, caches); returns the config as a
        dict."""
        cfg = dict(cfg)
        self.cfg = cfg
        self.max_seq_len = int(cfg.get('max_seq_len', 40))
        self.dtype = _DTYPES[cfg.get('dtype', 'float32')]
        self.param_dtype = (_DTYPES[param_dtype] if param_dtype is not None
                            else self.dtype)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f'{type(self).__name__}: no CUDA device; pass '
                    'device="cpu" to build on the CPU')
            device = 'cuda'
        self.device = torch.device(device)
        self.plain = False
        self._serving = None     # (weights stamp, model in self.dtype)
        # predict(mesh=): {device: (weights stamp, replica)}
        self._replicas: Dict[torch.device, Tuple] = {}
        self.last_shard_launches: List[Dict[str, int]] = []
        # the test pipeline of the config, set by apis.inference
        # init_recognizer for model_inference
        self.test_pipeline_cfg = None
        return cfg

    def init_weights(self, seed: int = 0):
        """Random weights from a seeded ``torch.Generator``, drawn on the
        CPU so that every device gets the same values: conv and linear
        weights uniform with variance 1/fan_in, zero biases, unit normal
        embeddings (pad row zero where the embedding has one), the weights
        and biases of LSTMs, GRUs and their cells U(-1/sqrt(H), 1/sqrt(H))
        as the JAX package's init, identity norms
        and BatchNorm statistics, and every module's localization head at
        its reference init (``reset_localization``: TPS++'s, the
        TPS-STN's, SPIN's ``fc2``)."""
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
                elif isinstance(m, PackedMultiheadAttention):
                    w = m.in_proj_weight
                    b = (3.0 / w.shape[1]) ** 0.5
                    fill(w, lambda x: x.uniform_(-b, b, generator=g))
                    m.in_proj_bias.zero_()
                elif isinstance(m, (nn.RNNBase, nn.RNNCellBase)):
                    b = 1.0 / m.hidden_size ** 0.5
                    for w in m.parameters():
                        fill(w, lambda x: x.uniform_(-b, b, generator=g))
                elif isinstance(m, (nn.LayerNorm,
                                    nn.modules.batchnorm._BatchNorm)):
                    m.reset_parameters()
            for m in self.model.modules():
                if hasattr(m, 'reset_localization'):
                    m.reset_localization()
        return self

    # ------------------------------------------------------------- train
    def compute_loss(self, batch: Dict[str, Any],
                     generator: Optional[torch.Generator] = None,
                     train: bool = True, plain: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {name: loss}) of one batch of ``img`` (N, H, W, C),
        ``padded_targets`` (N, T) and the optional ``valid_ratio`` (N,) and
        ``target_lengths`` (N,) (passed to the loss, as in JAX), through
        the model's training pass in train mode (``train=False``: eval mode)
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
        targets_dict = {'padded_targets': targets}
        if batch.get('target_lengths') is not None:
            targets_dict['target_lengths'] = torch.as_tensor(
                batch['target_lengths']).to(self.device, torch.long)
        losses = self.loss_obj(logits, targets_dict, valid_ratio=vr)
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
    def resolved_decode_mode(self, tokens: Optional[int] = None) -> str:
        """The decode ``predict`` runs: ``'single_pass'`` for a
        non-autoregressive decoder; ``'steps'`` for a beam search
        (``beam_width`` > 1) or a decoder without a whole decode
        (``fused_full_decode``), whatever the mode, as in JAX
        (``tps_pp_tpu/apis/recognizer.py:146-177``); ``'auto'`` resolved
        by :meth:`auto_decode_mode` on this recognizer's device, over
        ``tokens`` encoder tokens an image where they are known."""
        if not self.autoregressive:
            return 'single_pass'
        if self.decode_mode != 'auto':
            if self.decode_mode != 'steps' and not self._fused_capable():
                return 'steps'
            return self.decode_mode
        return self.auto_decode_mode(self.device.type, tokens)

    def _fused_capable(self) -> bool:
        return self.beam_width <= 1 and hasattr(type(self.model.decoder),
                                                'fused_full_decode')

    def auto_decode_mode(self, device_type: str,
                         tokens: Optional[int] = None) -> str:
        """``'auto'`` for a model on a device of ``device_type``:
        ``'fused40_bf16'`` for a bf16 model on CUDA whose decoder has a
        whole decode and whose decoder, and encoder where it fuses
        (``SUPPORTS_FUSED_FORWARD``), the kernels take (``kernel_accepts``,
        over ``tokens`` encoder tokens an image where they are known), else
        ``'steps'``. An encoder that does not fuse (SATRN's) runs as a
        module on that path, so only the decoder's predicate asks. It never
        picks a path whose kernels would refuse the model."""
        m = self.model
        enc_ok = (not getattr(type(m.encoder), 'SUPPORTS_FUSED_FORWARD',
                              False) or m.encoder.kernel_accepts(tokens))
        if (device_type == 'cuda' and self.dtype == torch.bfloat16
                and self._fused_capable() and enc_ok
                and m.decoder.kernel_accepts(tokens)):
            return 'fused40_bf16'
        return 'steps'

    def resolved_stem_mode(self) -> str:
        """``'fused'`` iff ``predict`` runs the fused stem: the mode is
        ``'fused'`` and the trunk has the flagship's geometry."""
        if self.stem_mode != 'fused':
            return 'xla'
        bb = self.model.backbone
        geometry_ok = (self.model.tpsnet is not None
                       and self.model.preprocessor is None
                       and bb.tps_stage == 2
                       and bb.strides[:2] == (1, 2)
                       and bb.stem_channels == bb.base_channels)
        return 'fused' if geometry_ok else 'xla'

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

    def _predict_impl(self, model, img, valid_ratio,
                      device_exit: bool = False):
        """The serving path on a prepared batch. ``device_exit`` keeps
        the greedy ``steps`` exit on the device (``greedy_decode``), as a
        trace or a CUDA-graph capture needs; eager ``predict`` reads it on
        the host."""
        if not self.autoregressive:
            return model.forward_test_nar(img, valid_ratio,
                                          plain=self.plain).float()
        mode = self.resolved_decode_mode()
        end_idx = self.label_convertor.end_idx if self.early_exit else None
        start_idx = self.label_convertor.start_idx
        stem = (fused_stem_forward(model.backbone, img, self.dtype,
                                   plain=self.plain)
                if self.resolved_stem_mode() == 'fused' else None)
        feat = model.extract_feat(img, plain=self.plain, stem=stem)
        if mode in ('fused40_bf16', 'fused40') and (
                self.decode_mode != 'auto' or self.resolved_decode_mode(
                    feat.shape[1] * feat.shape[2]) != 'steps'):
            return model.decode_full_fused(
                img, valid_ratio,
                end_idx=end_idx if self.fused_early_exit else None,
                plain=self.plain,
                enc_dtype='int8' if mode == 'fused40' else 'bfloat16',
                feat=feat)
        out_enc = model.encode(feat, valid_ratio)
        if not getattr(model.decoder, 'READS_FEAT', False):
            feat = None
        if self.beam_width > 1:
            return beam_decode(model.decoder, out_enc, valid_ratio,
                               max_seq_len=self.max_seq_len,
                               start_idx=start_idx,
                               beam_width=self.beam_width,
                               length_norm=self.beam_length_norm,
                               plain=self.plain, feat=feat)
        return greedy_decode(model.decoder, out_enc, valid_ratio,
                             max_seq_len=self.max_seq_len,
                             start_idx=start_idx, end_idx=end_idx,
                             plain=self.plain, feat=feat,
                             device_exit=device_exit)

    def predict(self, img, valid_ratio=None, bucket_batch: bool = True,
                mesh=None) -> torch.Tensor:
        """img (N, H, W, C) array or tensor -> (N, S, C-1) float32
        per-step probabilities (an autoregressive decoder's) or (N, T, C)
        float32 logits (a single pass's) on the model's device. ``mesh``:
        data-parallel serving over a mesh of local devices (see the
        module's docstring)."""
        img = torch.as_tensor(img)
        n = int(img.shape[0])
        if valid_ratio is None:
            vr = torch.ones((n,), dtype=torch.float32)
        else:
            vr = torch.as_tensor(valid_ratio, dtype=torch.float32)
        nd = mesh.shape['data'] if mesh is not None else 1
        m = next_pow2(n) if bucket_batch else n
        m = -(-m // nd) * nd                       # divisible per shard
        if mesh is not None:
            img, vr = pad_rows((img, vr.to(img.device)), n, m)
            return self._predict_mesh(mesh, img, vr)[:n]
        img, vr = pad_rows((img.to(self.device, self.dtype),
                            vr.to(self.device)), n, m)
        model = self.serving_model()
        with self._mode(model, False), torch.inference_mode():
            out = self._predict_impl(model, img.contiguous(),
                                     vr.contiguous())
        return out[:n]

    def _shard_replicas(self, devices) -> List[nn.Module]:
        """The serving model for each shard's device: the model itself on
        its own device, one copy on each other device (the shards that
        share a card run in turn on one thread), made again when the
        serving model's weights change. Copies on devices that ``devices``
        does not list are dropped."""
        model = self.serving_model()
        stamp = weights_stamp(model)
        devices = [_concrete(d) for d in devices]
        home = _concrete(self.device)
        wanted = set(devices) - {home}
        self._replicas = {d: c for d, c in self._replicas.items()
                          if d in wanted and c[0] == stamp}
        for d in wanted - set(self._replicas):
            self._replicas[d] = (stamp, copy.deepcopy(model).to(d))
        return [model if d == home else self._replicas[d][1]
                for d in devices]

    def _predict_mesh(self, mesh, img, vr) -> torch.Tensor:
        devices = [_concrete(d) for d in mesh.data_devices()]
        replicas = self._shard_replicas(devices)
        s = img.shape[0] // len(devices)
        outs: List[Optional[torch.Tensor]] = [None] * len(devices)
        errors: List[Optional[BaseException]] = [None] * len(devices)
        counts: List[Dict[str, int]] = [{} for _ in devices]

        def run(shards):
            for i in shards:
                dev = devices[i]
                ctx = (torch.cuda.device(dev) if dev.type == 'cuda'
                       else contextlib.nullcontext())
                try:
                    with ctx, _lib.launch_scope() as counts[i], \
                            torch.inference_mode(), \
                            self._mode(replicas[i], False):
                        outs[i] = self._predict_impl(
                            replicas[i],
                            img[i * s:(i + 1) * s].to(dev, self.dtype)
                            .contiguous(),
                            vr[i * s:(i + 1) * s].to(dev).contiguous())
                except BaseException as e:      # re-raised by the caller
                    errors[i] = e

        # one host thread a card, running its shards in turn: two threads
        # on one card contend in the CUDA driver (PERF.md, section 6)
        by_card: Dict[str, List[int]] = {}
        for i, d in enumerate(devices):
            by_card.setdefault(str(d), []).append(i)
        groups = list(by_card.values())
        threads = [threading.Thread(target=run, args=(g,))
                   for g in groups[1:]]
        for t in threads:
            t.start()
        run(groups[0])
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        self.last_shard_launches = counts
        return torch.cat([o.to(self.device) for o in outs])

    def simple_test(self, img, valid_ratio=None, img_metas=None,
                    bucket_batch: bool = True, mesh=None):
        """Full test path with host-side decoding ->
        ``[{'text': str, 'score': [float, ...]}, ...]``. Without
        ``img_metas`` each row's meta holds its ``valid_ratio`` (1.0 when
        none is given), which clips a CTC decode, as in JAX."""
        out = self.predict(img, valid_ratio, bucket_batch=bucket_batch,
                           mesh=mesh).cpu().numpy()
        if img_metas is None:
            vr = (torch.as_tensor(valid_ratio).tolist()
                  if valid_ratio is not None else [1.0] * out.shape[0])
            img_metas = [{'valid_ratio': r} for r in vr]
        indexes, scores = self.label_convertor.tensor2idx(out, img_metas)
        strings = self.label_convertor.idx2str(indexes)
        return [dict(text=s, score=sc) for s, sc in zip(strings, scores)]


def build_recognizer(cfg: Dict[str, Any], device=None,
                     param_dtype: Optional[str] = None) -> TextRecognizer:
    """The recognizer of a model config: ``type`` ABINet builds an
    ``ABINetRecognizer`` and SegRecognizer a ``SegRecognizer`` (JAX
    ``apis/recognizer.py:337-348``); NRTR, CRNNNet, SARNet, SATRN,
    RobustScanner and EncodeDecodeRecognizer a ``TextRecognizer`` (JAX
    ``models/recognizers/encode_decode.py:110-111``); any other type raises
    ``NotImplementedError``.
    ``device`` defaults to the CUDA device (see :class:`TextRecognizer`)."""
    type_name = cfg.get('type', 'EncodeDecodeRecognizer')
    if type_name == 'ABINet':
        from .abinet import ABINetRecognizer
        return ABINetRecognizer(cfg, device, param_dtype)
    if type_name == 'SegRecognizer':
        from .seg import SegRecognizer
        return SegRecognizer(cfg, device, param_dtype)
    if type_name not in ('NRTR', 'CRNNNet', 'SARNet', 'SATRN',
                         'RobustScanner', 'EncodeDecodeRecognizer'):
        raise NotImplementedError(
            f'recognizer type {type_name!r} is not ported yet')
    return TextRecognizer(cfg, device, param_dtype)
