"""Text detection: a detector from a config, then single or batched
inference (counterpart of ``tps_pp_tpu/apis/detector.py:25-223`` and of
``build_detector_module`` in ``tps_pp_tpu/apis/train_det.py:37-56``).

The port has the JAX package's seven families: DBNet
(``configs/textdet/dbnet/``: R18-FPNC, R50-DCNv2-FPNC), PANet
(``configs/textdet/panet/``: R18 and R50 on FPEM_FFM), PSENet
(``configs/textdet/psenet/``: R50 on FPNF), FCENet
(``configs/textdet/fcenet/``: R50 and R50-DCNv2 on FPNDet), TextSnake
(``configs/textdet/textsnake/``: R50 on FPN_UNet), DRRG
(``configs/textdet/drrg/``: R50 on FPN_UNet, ``DRRGHead`` with its GCN)
and OCRMaskRCNN (``configs/textdet/maskrcnn/``: R50 on FPNDet, the RPN and
the box and mask heads). ``TextDetector`` holds its model, in float32 and
eval mode, on the card unless given ``device='cpu'``, and its
postprocessor (the config's, or the family's). ``detect_batch`` resizes
each image to the fixed input size on the host (``cv_ops.resize_u8``,
within one grey level of ``cv2.resize``), runs one forward over the batch
padded to the next power of two (the last row repeated,
``utils/batching.py``), copies the maps to the host (DBNet's probability
channel; PAN's and PSE's logits, at 1/4 of the input size; each FCENet
level's (cls, reg) pair, which its postprocessor scales by the level's
stride; TextSnake's five maps at the input size; DRRG's features and six
maps, concatenated on the card, at the input size; Mask R-CNN's RPN maps
only, its FPN levels staying on the card), postprocesses each image there
(DRRG: the test graphs on the host, the GCN on the card, the clustering on
the host, ``drrg.DRRGDetector``; Mask R-CNN: the proposals and NMS on the
host, the RoI pooling and both heads on the card over the batch's RoIs at
once, the masks pasted on the host, ``maskrcnn.MaskRCNNDetector``) and
scales its boundaries ``[x1, y1, ..., score]`` back to the image's size,
through the head's 1/4 for PAN and PSE (``HEAD_SCALE``, JAX's
``_DOWNSAMPLE``).
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

# the family's postprocessor where the config names none
# (tps_pp_tpu/apis/detector.py:116-117), and the scale of its head's maps
# where it is not the input's
POSTPROCESSORS = {'DBNet': textdet.DBPostprocessor,
                  'PANet': textdet.PANPostprocessor,
                  'PSENet': textdet.PSEPostprocessor,
                  'FCENet': textdet.FCEPostprocessor,
                  'TextSnake': textdet.TextSnakePostprocessor,
                  'DRRG': textdet.DRRGPostprocessor}
# DRRG's maps, as DBNet's, FCENet's and TextSnake's, at the input's scale
HEAD_SCALE = {'PANet': 0.25, 'PSENet': 0.25}
# the detector types of the JAX package (its apis/train_det.py:23)
DET_TYPES = ('DBNet', 'PANet', 'PSENet', 'FCENet', 'TextSnake',
             'OCRMaskRCNN', 'DRRG')


def build_detector_module(model_cfg: Dict) -> nn.Module:
    """backbone -> neck -> head of a DBNet, PANet, PSENet, FCENet,
    TextSnake, DRRG or OCRMaskRCNN config (a PAN / PSE / TextSnake / DRRG
    head's ``in_channels`` defaults to its neck's output; DRRG's head is
    ``DRRGHead`` where the config names none, as JAX builds it; Mask
    R-CNN's ``rpn_head``, ``box_head`` and ``mask_head`` read their keys,
    ``fc_out`` 1024 and ``channels`` 256 where the config leaves them out,
    on the neck's channels); any other type raises a ``ValueError``."""
    det_type = model_cfg.get('type', 'DBNet')
    if det_type not in DET_TYPES:
        raise ValueError(f'{det_type!r} is not a detector type '
                         f'({", ".join(DET_TYPES)})')
    backbone = BACKBONES.build(model_cfg['backbone'])
    neck = NECKS.build(model_cfg['neck'])
    if det_type == 'OCRMaskRCNN':
        c = neck.out_channels

        def part(key, cls):
            cfg = dict(model_cfg.get(key) or {})
            cfg.pop('type', None)
            return cls(**{'in_channels': c, **cfg})
        rpn = HEADS.build(model_cfg.get('rpn_head') or dict(type='RPNHead'),
                          in_channels=c)
        return textdet.MaskRCNNModule(backbone, neck, rpn, textdet.RoIHead(
            part('box_head', textdet.BoxHead),
            part('mask_head', textdet.MaskHead)))
    if det_type in ('DBNet', 'FCENet'):
        module = (textdet.DBNetModule if det_type == 'DBNet'
                  else textdet.FCENetModule)
        return module(backbone, neck, HEADS.build(model_cfg['head']))
    if det_type == 'DRRG':
        head = HEADS.build(model_cfg.get('head') or dict(type='DRRGHead'),
                           in_channels=neck.out_channels)
        return textdet.DRRGModule(backbone, neck, head)
    head = HEADS.build(model_cfg['head'], in_channels=neck.out_channels)
    module = (textdet.TextSnakeModule if det_type == 'TextSnake'
              else textdet.PANetModule)
    return module(backbone, neck, head)


def init_detector_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded ``torch.Generator``, drawn on the CPU
    so that every device gets the same values: the weights of convolutions
    (transposed and deformable ones included, and the DCNv2 offset
    predictors, which the reference zero-initialises, so that the
    deformable sampling is exercised) and of linear layers uniform with
    variance 1/fan_in, DRRG's graph convolutions Xavier-uniform (the
    reference's), zero biases, PReLU slopes 0.25, identity BatchNorm
    affines and statistics."""
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
            elif isinstance(m, nn.Linear):
                uniform(m.weight, m.in_features)
                m.bias.zero_()
            elif isinstance(m, textdet.GraphConv):
                uniform(m.weight, sum(m.weight.shape) / 2)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


class TextDetector:
    """A detector's model, its postprocessor and a fixed input size."""

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
        self.downsample = HEAD_SCALE.get(self.det_type, 1.0)
        if self.det_type == 'OCRMaskRCNN':
            self.postprocessor = textdet.MaskRCNNDetector(
                self.model,
                text_repr_type=model_cfg.get('text_repr_type', 'quad'))
            return
        pp_cfg = dict(model_cfg.get('postprocessor') or {})
        pp_type = pp_cfg.pop('type',
                             POSTPROCESSORS[self.det_type].__name__)
        self.postprocessor = getattr(textdet, pp_type)(**pp_cfg)
        if self.det_type == 'DRRG':
            self.postprocessor = textdet.DRRGDetector(self.model.head.gcn,
                                                      self.postprocessor)

    def prep(self, img: np.ndarray) -> Tuple[np.ndarray, float, float]:
        """An image -> (the input (H, W, C) float32 in [0, 1], the x and y
        scales from the head's maps back to the image). A uint8 image of
        another size is resized with ``cv_ops.resize_u8``; a float image
        must be at the input size."""
        h0, w0 = img.shape[:2]
        H, W = self.img_size
        if (h0, w0) != (H, W):
            if img.dtype != np.uint8:
                raise ValueError(f'a {img.dtype} image of {h0}x{w0}: only '
                                 f'uint8 images are resized to {H}x{W}')
            img = resize_u8(img, W, H)
        ds = self.downsample
        return img.astype(np.float32) / 255.0, w0 / W / ds, h0 / H / ds

    @torch.inference_mode()
    def forward(self, batch: Union[np.ndarray, torch.Tensor]):
        """(N, H, W, 3) inputs -> the model's maps on the device, one
        forward over the batch padded to the next power of two: DBNet's (N,
        H, W, 3) [prob, thr, binary], PAN's and PSE's (N, H / 4, W / 4, C)
        raw logits, TextSnake's (N, H, W, 5), FCENet's (cls (N, h, w, 4),
        reg (N, h, w, 22)) pair a level (strides 8, 16, 32), DRRG's
        (features (N, H, W, C), maps (N, H, W, 6)), Mask R-CNN's (the five
        NCHW levels, the RPN's (cls (N, h, w, A), reg (N, h, w, 4A)) pair
        a level)."""
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device)
        n = x.shape[0]
        (x,) = pad_rows((x,), n, next_pow2(n))
        out = self.model(x)
        if self.det_type == 'FCENet':
            return tuple((c[:n], r[:n]) for c, r in out)
        if self.det_type == 'DRRG':
            return tuple(t[:n] for t in out)
        if self.det_type == 'OCRMaskRCNN':
            levels, rpn = out
            return (tuple(t[:n] for t in levels),
                    tuple((c[:n], r[:n]) for c, r in rpn))
        return out[:n]

    def postprocess(self, maps, scales: Sequence[Tuple[float, float]]
                    ) -> List[List[np.ndarray]]:
        """The postprocessor's maps on the host (``host_maps``) -> each
        image's boundaries, scaled by its (sx, sy)."""
        if self.det_type == 'OCRMaskRCNN':
            results = self.postprocessor(*maps, self.img_size)
        else:
            results = [self.postprocessor(m) for m in maps]
        out = []
        for boundaries, (sx, sy) in zip(results, scales):
            scaled = []
            for b in boundaries:
                b = np.asarray(b, np.float32).copy()
                b[:-1:2] *= sx
                b[1:-1:2] *= sy
                scaled.append(b)
            out.append(scaled)
        return out

    def host_maps(self, maps):
        """The part of ``forward``'s maps the postprocessor reads, copied
        to the host, one entry an image: DBNet's probability channel, PAN's,
        PSE's and TextSnake's whole maps (an array), FCENet's list of
        (cls, reg) a level (JAX's ``_post_single``), DRRG's features and
        maps concatenated (N, H, W, C + 6), the features first; for Mask
        R-CNN (the levels, left on the card, and each image's list of
        RPN (cls, reg) maps a level on the host)."""
        if self.det_type == 'OCRMaskRCNN':
            levels, rpn = maps
            return levels, textdet.MaskRCNNDetector.host_rpn(rpn)
        if self.det_type == 'FCENet':
            levels = [(c.cpu().numpy(), r.cpu().numpy()) for c, r in maps]
            return [[(c[b], r[b]) for c, r in levels]
                    for b in range(len(levels[0][0]))]
        if self.det_type == 'DRRG':
            return torch.cat(maps, dim=-1).cpu().numpy()
        if self.det_type == 'DBNet':
            maps = maps[..., 0]
        return maps.cpu().numpy()

    def detect_batch(self, imgs: List[np.ndarray]
                     ) -> List[List[np.ndarray]]:
        """Boundaries of each image, in its own coordinates."""
        preps = [self.prep(img) for img in imgs]
        maps = self.host_maps(self.forward(np.stack([p[0] for p in preps])))
        return self.postprocess(maps, [(p[1], p[2]) for p in preps])

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
