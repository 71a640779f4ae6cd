"""Activation probes of a ``.pth`` checkpoint in the port (counterpart of
``tools/compare_activations.py``, its self-consistency half):

    python -m tps_pp_tpu_torch.tools.compare_activations CONFIG CKPT.pth \\
        [--image demo/demo_text_recog.jpg] [--device cpu]

Loads the checkpoint (the port reads the reference's names directly),
prints ``model_inference``'s reading of the image, then the probes the JAX
CLI prints: ``backbone.stage2`` (the trunk's feature before the
rectifier), ``tps.control_point``, ``tps.pc_score``, ``tps.rectified``,
``encoder.out`` and ``decoder.probs`` (``predict``), each with its shape,
mean, standard deviation and whether it is finite, on one crop resized to
128 x 32 and normalised as the JAX CLI does. A PNG image decodes without
cv2 (``cv_ops.png_decode``); another format needs cv2. Runs on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

MEAN = np.array([0.485, 0.456, 0.406])
STD = np.array([0.229, 0.224, 0.225])


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Activation probes of a .pth')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--image', default='demo/demo_text_recog.jpg')
    p.add_argument('--device', default=None)
    return p.parse_args(argv)


def read_image(path: str) -> np.ndarray:
    """The BGR image of a file: PNG by ``cv_ops.png_decode``, else cv2."""
    from ..datasets.pipelines.cv_ops import PNG_SIGNATURE, png_decode
    with open(path, 'rb') as f:
        body = f.read()
    if body[:8] == PNG_SIGNATURE:
        return png_decode(body)
    import cv2
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f'{path}: not an image cv2 decodes')
    return img


def probe(name: str, t: torch.Tensor):
    out = t.detach().float().cpu().numpy()
    print(f'{name:28s} shape={out.shape} mean={out.mean():+.4f} '
          f'std={out.std():.4f} finite={np.isfinite(out).all()}')
    return out


def main(argv: Optional[List[str]] = None):
    from ..apis import init_recognizer, model_inference
    from ..datasets.pipelines.cv_ops import resize_u8

    args = parse_args(argv)
    rec = init_recognizer(args.config, args.checkpoint, device=args.device)
    img = read_image(args.image)
    print('fp32 prediction:', model_inference(rec, img))

    x = resize_u8(img, 128, 32).astype(np.float32) / 255.0
    x = torch.from_numpy(((x - MEAN) / STD)[None].astype(np.float32)).to(
        rec.device, rec.dtype)
    model = rec.model
    with torch.inference_mode(), rec._mode(model, False):
        feat, skips = model.backbone.stem_and_head(x)
        probe('backbone.stage2', feat)
        if model.tpsnet is not None:
            outs = model.tpsnet(feat, skips)
            probe('tps.control_point', outs['control_point'])
            probe('tps.pc_score', outs['pc_score'])
            probe('tps.rectified', outs['output'])
        probe('encoder.out', model.encode(model.extract_feat(x)))
    probe('decoder.probs', rec.predict(x))
    print('Save these tensors and diff them against the reference modules '
          'run on the same inputs.')


if __name__ == '__main__':
    main()
