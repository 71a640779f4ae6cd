"""The end-user OCR API (counterpart of ``tps_pp_tpu/apis/ocr.py:58-259``;
the reference's ``mmocr/utils/ocr.py`` ``MMOCR`` and ``utils/recog.py``).

``MMOCR(det=..., recog=...)`` detects, crops each box (the axis-aligned
quad of its boundary, ``crop_img``), recognizes the crops as one batch
(``model_inference`` with ``batch_mode``), with ``kie='SDMGR'`` classes
each box from its text and its place among the page's boxes (``label``,
``label_score``), and, with ``merge``, stitches the words into lines.
Either stage may be left out: det only returns boundaries, recog only
reads whole images; KIE needs both. Models are on the card unless
``device='cpu'``. With ``img_out_dir`` each detected page is drawn
(``utils.visualize.det_recog_show_result``: the boxes beside their texts,
which needs cv2) to ``<img_out_dir>/out_<file name>`` (``img_<i>.jpg`` for
an array), as the JAX package does; a recognition-only call draws
nothing.

Usage::

    ocr = MMOCR(det='DBNet', recog='NRTR_TPS')
    ocr.readtext(img, merge=True)
    # -> [{'filename': ..., 'result': [{'box', 'box_score', 'text'}, ...],
    #      'merged': [...]}]
    MMOCR(det='DBNet', recog='NRTR_TPS', kie='SDMGR', kie_ckpt=pth)
    # each box also carries 'label' and 'label_score'
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..datasets.kie_dataset import KIE_CHARS, compute_relations, encode_texts
from ..datasets.pipelines.transforms import LoadImageFromFile
from ..utils.box_util import crop_img, stitch_boxes_into_lines
from ..utils.visualize import det_recog_show_result
from .detector import init_detector
from .inference import init_recognizer, model_inference
from .train_kie import _load, init_kie_weights, resolve_device

# model name -> config path (the reference's MMOCR.textdet_models /
# textrecog_models tables, ocr.py:214-311)
DET_CONFIGS = {
    'DBNet': 'configs/textdet/dbnet/dbnet_r18_fpnc_1200e_icdar2015.py',
    'PANet': 'configs/textdet/panet/panet_r18_fpem_ffm_600e_icdar2015.py',
    'PSENet': 'configs/textdet/psenet/psenet_r50_fpnf_600e_icdar2015.py',
}
RECOG_CONFIGS = {
    'CRNN': 'configs/textrecog/crnn/crnn_academic_dataset.py',
    'NRTR_TPS': 'configs/textrecog/nrtr/nrtr_tps++.py',
    'SAR': 'configs/textrecog/sar/sar_r31_parallel_decoder_academic.py',
    'ABINet': 'configs/textrecog/abinet/abinet_academic.py',
}


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _resolve(table: Dict[str, str], name_or_path: Optional[str]):
    if not name_or_path:
        return None
    path = table.get(name_or_path, name_or_path)
    if not os.path.isabs(path) and not os.path.exists(path):
        candidate = os.path.join(_repo_root(), path)
        if os.path.exists(candidate):
            path = candidate
    return path


class MMOCR:
    """Detection + recognition end to end (reference ocr.py:164-717)."""

    def __init__(self, det: Optional[str] = 'DBNet',
                 recog: Optional[str] = 'CRNN',
                 kie: Optional[str] = None,
                 det_config: Optional[str] = None,
                 det_ckpt: Optional[str] = None,
                 recog_config: Optional[str] = None,
                 recog_ckpt: Optional[str] = None,
                 kie_ckpt: Optional[str] = None,
                 det_img_size=(640, 640), seed: int = 0, device=None,
                 **kwargs):
        self.detector = None
        self.rec = None
        self.kie_model = None
        if det:
            self.detector = init_detector(
                det_config or _resolve(DET_CONFIGS, det), checkpoint=det_ckpt,
                img_size=det_img_size, device=device, seed=seed)
        if recog:
            self.rec = init_recognizer(
                recog_config or _resolve(RECOG_CONFIGS, recog), recog_ckpt,
                device=device, seed=seed)
        if kie:
            assert self.detector is not None and self.rec is not None, (
                'KIE requires both det and recog (reference ocr.py:349-352)')
            self._init_kie(kie_ckpt, seed, device)

    # -- KIE -------------------------------------------------------------
    def _init_kie(self, kie_ckpt: Optional[str], seed: int, device):
        """SDMGR over the detected and recognized boxes (reference MMOCR
        kie stage, ocr.py:499-585; JAX ``apis/ocr.py:87-131``): the
        62-character set (``num_chars`` 64: the pad and the unknown),
        texts cut to 32 characters, 26 classes, no visual modality;
        ``kie_ckpt`` a ``.pth`` of its ``head.*`` weights."""
        from ..models.kie import build_sdmgr
        self.kie_max_chars = 32
        self.kie_char2idx = {c: i + 1 for i, c in enumerate(KIE_CHARS)}
        cfg = dict(head=dict(type='SDMGRHead', num_chars=len(KIE_CHARS) + 2,
                             num_classes=26))
        self.kie_device = resolve_device(device, 'MMOCR')
        self.kie_model = _load(init_kie_weights(build_sdmgr(cfg, False),
                                                seed),
                               kie_ckpt).to(self.kie_device).eval()

    def kie_infer(self, box_results: List[Dict]) -> List[Dict]:
        """Each box's ``label`` (the argmax class) and ``label_score``
        (its softmax probability), from the boxes' xyxy extents (relations
        with norm 10) and their texts."""
        n = len(box_results)
        if n == 0:
            return box_results
        boxes = np.asarray([[min(r['box'][0::2]), min(r['box'][1::2]),
                             max(r['box'][0::2]), max(r['box'][1::2])]
                            for r in box_results], np.float32)
        texts = encode_texts([r['text'] for r in box_results],
                             self.kie_char2idx, self.kie_max_chars)
        rel = compute_relations(boxes, 10.0)
        dev = self.kie_device
        with torch.inference_mode():
            node_cls, _ = self.kie_model(
                torch.from_numpy(rel)[None].to(dev),
                torch.from_numpy(texts)[None].to(dev))
            probs = torch.softmax(node_cls[0], -1).cpu().numpy()
            logits = node_cls[0].cpu().numpy()
        for r, lab, conf in zip(box_results, logits.argmax(-1),
                                probs.max(-1)):
            r['label'] = int(lab)
            r['label_score'] = float(conf)
        return box_results

    # -- single stages ---------------------------------------------------
    def detect(self, img) -> List[np.ndarray]:
        return self.detector.detect(self._load(img))

    def recognize(self, imgs, batch_mode: bool = True):
        return model_inference(self.rec, imgs, batch_mode=batch_mode)

    def crops(self, arr: np.ndarray, boundaries) -> tuple:
        """The crops of an image's boundaries, with their quads and box
        scores; empty crops are left out."""
        crops, boxes = [], []
        for b in boundaries:
            box = self._to_quad(b[:-1])
            crop = crop_img(arr, box)
            if crop.size == 0:
                continue
            boxes.append((box, float(b[-1])))
            crops.append(crop)
        return crops, boxes

    # -- end to end ------------------------------------------------------
    def readtext(self, img, output: Optional[str] = None,
                 details: bool = False, merge: bool = False,
                 merge_xdist: float = 20.0, batch_mode: bool = True,
                 img_out_dir: Optional[str] = None,
                 **kwargs) -> List[Dict]:
        """img: a path, an ndarray or a list of them. One dict per image
        (reference det_recog_kie_inference, ocr.py:499-585); ``output``
        writes the returned value as JSON."""
        single = not isinstance(img, (list, tuple))
        out = []
        for item in ([img] if single else list(img)):
            arr = self._load(item)
            filename = item if isinstance(item, str) else ''
            if self.detector is None:
                rec = self.recognize(arr, batch_mode=False)
                out.append({'filename': filename, 'text': rec['text'],
                            'score': rec['score']})
                continue
            crops, boxes = self.crops(arr, self.detector.detect(arr))
            if self.rec is not None and crops:
                recs = self.recognize(crops, batch_mode=batch_mode)
                if isinstance(recs, dict):
                    recs = [recs]
            else:
                recs = [{'text': '', 'score': 0.0}] * len(crops)
            box_results = []
            for (box, bscore), rec in zip(boxes, recs):
                score = rec.get('score', 0.0)
                if isinstance(score, (list, tuple, np.ndarray)):
                    score = float(np.mean(score)) if len(score) else 0.0
                box_results.append({
                    'box': [float(v) for v in box],
                    'box_score': bscore,
                    'text': rec.get('text', ''),
                    'text_score': float(score),
                })
            if self.kie_model is not None:
                box_results = self.kie_infer(box_results)
            res = {'filename': filename, 'result': box_results}
            if img_out_dir:
                name = os.path.basename(filename) or f'img_{len(out)}.jpg'
                os.makedirs(img_out_dir, exist_ok=True)
                det_recog_show_result(
                    arr, res, out_file=os.path.join(img_out_dir,
                                                    f'out_{name}'))
            if merge:
                res['merged'] = stitch_boxes_into_lines(
                    [{'box': r['box'], 'text': r['text']}
                     for r in box_results], max_x_dist=merge_xdist)
            out.append(res)
        if not details:
            for r in out:
                for b in r.get('result', []):
                    b.pop('text_score', None)
        if output is not None:
            with open(output, 'w') as f:
                json.dump(out, f, indent=2)
        return out

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _load(img) -> np.ndarray:
        if isinstance(img, np.ndarray):
            return img
        return LoadImageFromFile()(dict(img_path=img))['img']

    @staticmethod
    def _to_quad(flat) -> List[float]:
        """A boundary polygon (2k floats) -> its axis-aligned quad."""
        pts = np.asarray(flat, np.float32).reshape(-1, 2)
        x0, y0 = pts.min(0)
        x1, y1 = pts.max(0)
        return [float(x0), float(y0), float(x1), float(y0),
                float(x1), float(y1), float(x0), float(y1)]


class TextRecInference(MMOCR):
    """The recognition-only API (reference utils/recog.py)."""

    def __init__(self, config: Union[str, Dict],
                 checkpoint: Optional[str] = None, batch_mode: bool = False,
                 seed: int = 0, device=None):
        self.detector = None
        self.kie_model = None
        self.rec = init_recognizer(config, checkpoint, device=device,
                                   seed=seed)
        self.batch_mode = batch_mode

    def readtext(self, img, output: Optional[str] = None, **kwargs):
        results = model_inference(self.rec, img, batch_mode=self.batch_mode)
        if output is not None:
            with open(output, 'w') as f:
                json.dump(results, f, indent=2)
        return results
