"""SegRecognizer: the segmentation-based recognizer (counterpart of
``tps_pp_tpu/apis/seg.py:28-90``; reference
``recognizer/seg_recognizer.py``).

Backbone (``ResNet31OCR`` with ``out_indices``), ``FPNOCR`` neck,
``SegHead``, ``SegLoss`` and ``SegConvertor``, built from the config's
``backbone`` / ``neck`` / ``head`` / ``loss`` / ``label_convertor`` as the
JAX package builds them; the head's ``num_classes`` defaults to the
convertor's dictionary (``<BG>``, the characters, ``<UKN>``).

Everything else is ``TextRecognizer``'s: the CUDA device by default,
``param_dtype``, bf16 autocast in ``compute_loss``, the serving copy of
wider parameters, eval mode and pow2 row bucketing in ``predict``, the
``plain`` switch (which changes nothing here: no kernel is on the path, as
in JAX, where the family is plain XLA). There is no decode loop
(``resolved_decode_mode()`` is ``'single_pass'``): ``predict`` returns the
head's logits (N, H, W, C) in float32, and ``simple_test`` decodes their
connected components on the host (``SegConvertor.tensor2str``).
``compute_loss`` takes ``img`` and ``gt_seg`` (N, H, W) integer char
kernels (``OCRSegDataset``'s), resized to the head's size with the nearest
rule of ``jax.image.resize`` where the sizes differ. JAX trains the family
through ``compute_loss`` and ``make_train_step``, not through
``train_recognizer``, which reads text targets; so does the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.layers import resize_nearest
from ..models.recognizers.seg import SegRecognizerModule
from ..registry import BACKBONES, CONVERTORS, HEADS, LOSSES, NECKS
from .recognizer import TextRecognizer


class SegRecognizer(TextRecognizer):

    def __init__(self, cfg: Dict[str, Any], device=None,
                 param_dtype: Optional[str] = None):
        """``device`` and ``param_dtype`` as in ``TextRecognizer``."""
        cfg = self._setup(cfg, device, param_dtype)
        self.label_convertor = lc = CONVERTORS.build(cfg['label_convertor'])
        head_cfg = dict(cfg['head'])
        head_cfg.setdefault('num_classes', len(lc.idx2char))
        model = SegRecognizerModule(BACKBONES.build(cfg['backbone']),
                                    NECKS.build(cfg['neck']),
                                    HEADS.build(head_cfg))
        self.model = model.to(self.device, self.param_dtype).eval()
        self.loss_obj = LOSSES.build(dict(cfg.get('loss')
                                          or dict(type='SegLoss')))
        self.autoregressive = False

    def resolved_decode_mode(self, tokens: Optional[int] = None) -> str:
        return 'single_pass'

    def resolved_stem_mode(self) -> str:
        return 'xla'

    def compute_loss(self, batch: Dict[str, Any],
                     generator: Optional[torch.Generator] = None,
                     train: bool = True, plain: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, {'loss_seg': ...}) of ``img`` (N, H, W, C) against
        ``gt_seg`` (N, h, w), in train mode (``train=False``: eval mode)
        for the call, which updates the BatchNorm statistics as JAX's
        ``mutable=['batch_stats']``. ``generator`` and ``plain`` are taken
        for ``make_train_step``'s signature: the model has no dropout and
        no kernel."""
        img = torch.as_tensor(batch['img']).to(self.device, self.param_dtype)
        gt = torch.as_tensor(batch['gt_seg']).to(self.device, torch.long)
        with self._mode(self.model, train), torch.autocast(
                self.device.type, dtype=self.dtype,
                enabled=self.param_dtype != self.dtype):
            out = self.model(img.contiguous())
        if tuple(out.shape[1:3]) != tuple(gt.shape[1:3]):
            gt = resize_nearest(gt[:, None], tuple(out.shape[1:3]))[:, 0]
        losses = self.loss_obj(out, gt)
        return sum(losses.values()), losses

    def _predict_impl(self, model, img, valid_ratio,
                      device_exit: bool = False) -> torch.Tensor:
        """One pass, no decode loop (``device_exit`` is not read)."""
        return model.forward_test_nar(img, valid_ratio).float()

    def simple_test(self, img, valid_ratio=None, img_metas=None,
                    bucket_batch: bool = True, mesh=None):
        """``predict`` (over ``mesh`` where given, as the JAX
        ``SegRecognizer.predict`` takes one: ``tps_pp_tpu/apis/seg.py:
        68-78``), then the connected-component decode on the host ->
        ``[{'text': str, 'score': [float, ...]}, ...]``. Without
        ``img_metas`` each row's meta holds its ``valid_ratio`` (1.0 when
        none is given), which cuts the columns decoded."""
        out = self.predict(img, valid_ratio, bucket_batch=bucket_batch,
                           mesh=mesh).cpu().numpy()
        if img_metas is None:
            vr = (torch.as_tensor(valid_ratio).tolist()
                  if valid_ratio is not None else [1.0] * out.shape[0])
            img_metas = [{'valid_ratio': r} for r in vr]
        texts, scores = self.label_convertor.tensor2str(out, img_metas)
        return [dict(text=t, score=s) for t, s in zip(texts, scores)]
