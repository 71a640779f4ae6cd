"""Text detection: a detector from a config, then single or batched
inference (counterpart of ``tps_pp_tpu/apis/detector.py:25-223`` and of
``build_detector_module`` in ``tps_pp_tpu/apis/train_det.py:37-56``).

DBNet is the family the port has (``configs/textdet/dbnet/``: R18-FPNC and
R50-DCNv2-FPNC). ``TextDetector`` holds its model, in float32 and eval
mode, on the card unless given ``device='cpu'``, and its postprocessor.
``detect_batch`` resizes each image to the fixed input size on the host
(``cv_ops.resize_u8``, within one grey level of ``cv2.resize``), runs one
forward over the batch padded to the next power of two (the last row
repeated, ``utils/batching.py``), copies the probability maps to the host,
postprocesses each image there and scales its boundaries
``[x1, y1, ..., score]`` back to the image's size. The other six families
of the JAX package raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..config import ConfigDict, load_config
from ..datasets.pipelines.cv_ops import resize_u8
from ..models import textdet
from ..ops.deform_conv import ModulatedDeformConv
from ..registry import BACKBONES, HEADS, NECKS
from ..utils.batching import next_pow2, pad_rows
from ..utils.convert import load_pth

def build_detector_module(model_cfg: Dict) -> nn.Module:
    """backbone -> neck -> head of a DBNet config; any other detector type
    raises ``NotImplementedError``."""
    det_type = model_cfg.get('type', 'DBNet')
    if det_type != 'DBNet':
        raise NotImplementedError(
            f'detector type {det_type!r} is not ported yet (ROADMAP.md '
            'queue 1: PANet and PSENet, FCENet and TextSnake, DRRG, Mask '
            'R-CNN)')
    return textdet.DBNetModule(BACKBONES.build(model_cfg['backbone']),
                               NECKS.build(model_cfg['neck']),
                               HEADS.build(model_cfg['head']))


def init_detector_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded ``torch.Generator``, drawn on the CPU
    so that every device gets the same values: the weights of convolutions
    (transposed and deformable ones included, and the DCNv2 offset
    predictors, which the reference zero-initialises, so that the
    deformable sampling is exercised) uniform with variance 1/fan_in, zero
    biases, identity BatchNorm affines and statistics."""
    g = torch.Generator().manual_seed(seed)

    def uniform(t, fan_in):
        b = (3.0 / fan_in) ** 0.5
        t.copy_(torch.empty(t.shape).uniform_(-b, b, generator=g))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = (m.in_channels // m.groups) * m.weight[0, 0].numel()
                uniform(m.weight, fan_in)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, ModulatedDeformConv):
                uniform(m.weight, m.weight[0].numel())
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


class TextDetector:
    """A DBNet model, its postprocessor and a fixed input size."""

    def __init__(self, model_cfg: Dict, img_size: Tuple[int, int] = (640, 640),
                 device=None, seed: int = 0,
                 checkpoint: Optional[str] = None):
        """``device``: the CUDA device when None, and a ``RuntimeError`` if
        there is none (pass ``'cpu'`` to build on the CPU)."""
        model_cfg = dict(model_cfg)
        self.model_cfg = model_cfg
        self.det_type = model_cfg.get('type', 'DBNet')
        self.img_size = tuple(img_size)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError('TextDetector: no CUDA device; pass '
                                   'device="cpu" to build on the CPU')
            device = 'cuda'
        self.device = torch.device(device)
        self.model = init_detector_weights(build_detector_module(model_cfg),
                                           seed)
        if checkpoint:
            if not checkpoint.endswith(('.pth', '.pt')):
                raise ValueError(
                    f'{checkpoint}: the port loads torch checkpoints (.pth, '
                    '.pt) only')
            self.model.load_state_dict(load_pth(checkpoint), strict=True)
        self.model.to(self.device).eval()
        pp_cfg = dict(model_cfg.get('postprocessor') or {})
        pp_type = pp_cfg.pop('type', 'DBPostprocessor')
        if pp_type != 'DBPostprocessor':
            raise NotImplementedError(f'postprocessor {pp_type!r} is not '
                                      'ported yet')
        self.postprocessor = textdet.DBPostprocessor(**pp_cfg)

    def prep(self, img: np.ndarray) -> Tuple[np.ndarray, float, float]:
        """An image -> (the input (H, W, C) float32 in [0, 1], the x and y
        scales back to the image). A uint8 image of another size is resized
        with ``cv_ops.resize_u8``; a float image must be at the input
        size."""
        h0, w0 = img.shape[:2]
        H, W = self.img_size
        if (h0, w0) != (H, W):
            if img.dtype != np.uint8:
                raise ValueError(f'a {img.dtype} image of {h0}x{w0}: only '
                                 f'uint8 images are resized to {H}x{W}')
            img = resize_u8(img, W, H)
        return img.astype(np.float32) / 255.0, w0 / W, h0 / H

    @torch.inference_mode()
    def forward(self, batch: Union[np.ndarray, torch.Tensor]
                ) -> torch.Tensor:
        """(N, H, W, 3) inputs -> the model's (N, H, W, 3) maps [prob, thr,
        binary] on the device, one forward over the batch padded to the
        next power of two."""
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device)
        n = x.shape[0]
        (x,) = pad_rows((x,), n, next_pow2(n))
        return self.model(x)[:n]

    def postprocess(self, prob_maps: np.ndarray,
                    scales: Sequence[Tuple[float, float]]
                    ) -> List[List[np.ndarray]]:
        """(N, H, W) probability maps on the host -> each image's
        boundaries, scaled by its (sx, sy)."""
        out = []
        for prob, (sx, sy) in zip(prob_maps, scales):
            scaled = []
            for b in self.postprocessor(prob):
                b = np.asarray(b, np.float32).copy()
                b[:-1:2] *= sx
                b[1:-1:2] *= sy
                scaled.append(b)
            out.append(scaled)
        return out

    def detect_batch(self, imgs: List[np.ndarray]
                     ) -> List[List[np.ndarray]]:
        """Boundaries of each image, in its own coordinates."""
        preps = [self.prep(img) for img in imgs]
        maps = self.forward(np.stack([p[0] for p in preps]))
        prob = maps[..., 0].cpu().numpy()
        return self.postprocess(prob, [(p[1], p[2]) for p in preps])

    def detect(self, img: np.ndarray) -> List[np.ndarray]:
        """img: HWC BGR. Its boundaries [x1, y1, ..., score]."""
        return self.detect_batch([img])[0]


def init_detector(config: Union[str, Dict], checkpoint: Optional[str] = None,
                  img_size=(640, 640), device=None,
                  seed: int = 0) -> TextDetector:
    """The detector of ``config`` (a config file, or a dict holding
    ``model`` or being the model's config) with seeded weights, then a
    ``.pth`` / ``.pt`` checkpoint's weights when given (strict), on the
    CUDA device or ``device`` (the JAX ``apis/detector.py:209-223``)."""
    if isinstance(config, str):
        model_cfg = load_config(config)['model']
    else:
        cfg = ConfigDict._wrap(dict(config))
        model_cfg = cfg.get('model', cfg)
    return TextDetector(model_cfg, img_size=img_size, device=device,
                        seed=seed, checkpoint=checkpoint)
