"""Export a recognizer for serving, capture it, or run an export
(counterpart of ``tools/deployment/export_model.py:31-78``, the reference's
``pytorch2onnx.py`` / ``onnx2tensorrt.py`` / ``deploy_test.py``):

    python -m tps_pp_tpu_torch.tools.export_model export CONFIG out.pt2 \\
        [--batch 8] [--height 32 --width 128 --channels 3] \\
        [--checkpoint X.pth] [--cfg-options model.dtype=bfloat16] \\
        [--device cpu]
    python -m tps_pp_tpu_torch.tools.export_model aot CONFIG - [...]
    python -m tps_pp_tpu_torch.tools.export_model test CONFIG out.pt2 \\
        [--image crop.png] [...]

* ``export``: ``utils.export.export_serialized`` of the config's
  recognizer at ``--batch`` images of height x width x channels, written
  to the artifact (a ``torch.export`` ``.pt2``); prints its bytes and the
  seconds the export took.
* ``aot``: ``utils.export.aot_compile`` (a CUDA graph on the card); prints
  the capture's ms, the graph pool's bytes and the kernels' launches the
  graph holds. The artifact argument is not written.
* ``test``: loads the artifact and runs it on ``--image`` (resized to the
  input size, over 255, repeated ``--batch`` times) or on zeros; prints
  the output's shape and the first three texts. A PNG image is decoded
  without cv2 (``cv_ops.png_decode``), anything else with ``cv2.imread``.

The recognizer is built from CONFIG with ``init_recognizer`` (seed-0
weights, then ``--checkpoint``) on the card, or on the CPU with ``--device
cpu``; the images' dtype is the model's compute dtype (``model.dtype``).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Export a text recognizer')
    p.add_argument('mode', choices=['export', 'aot', 'test'])
    p.add_argument('config')
    p.add_argument('artifact', help='output (export) or input (test)')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--height', type=int, default=32)
    p.add_argument('--width', type=int, default=128)
    p.add_argument('--channels', type=int, default=3)
    p.add_argument('--image', default=None)
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help="'cpu' for the CPU; the card when left out")
    return p.parse_args(argv)


def read_image(path: str, color: bool = True) -> np.ndarray:
    """An image file as cv2.imread gives it (BGR, or grey (H, W, 1)): a PNG
    through ``cv_ops.png_decode``, anything else through cv2."""
    from ..datasets.pipelines.cv_ops import PNG_SIGNATURE, png_decode
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:8] == PNG_SIGNATURE:
        img = png_decode(buf, grayscale=not color)
    else:
        from ..datasets.pipelines.transforms import LoadImageFromFile
        img = LoadImageFromFile(
            color_type='color' if color else 'grayscale')(
                dict(img_path=path))['img']
    return img if img.ndim == 3 else img[:, :, None]


def main(argv: Optional[List[str]] = None) -> dict:
    import torch

    from ..apis.inference import init_recognizer
    from ..config import load_config, merge_cli_options
    from ..datasets.pipelines.cv_ops import resize_u8
    from ..utils.export import aot_compile, export_serialized, load_serialized
    from .test import parse_cfg_options

    args = parse_args(argv)
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    rec = init_recognizer(cfg, args.checkpoint, device=args.device)
    shape = (args.height, args.width, args.channels)
    if args.mode == 'export':
        t0 = time.perf_counter()
        blob = export_serialized(rec, args.batch, shape)
        seconds = time.perf_counter() - t0
        with open(args.artifact, 'wb') as f:
            f.write(blob)
        out = {'bytes': len(blob), 'export_s': seconds,
               'artifact': args.artifact}
    elif args.mode == 'aot':
        call = aot_compile(rec, args.batch, shape)
        out = {'device': str(rec.device), 'capture_ms': call.capture_ms,
               'pool_bytes': call.pool_bytes,
               'captured_launches': call.captured_launches}
    else:
        with open(args.artifact, 'rb') as f:
            ep = load_serialized(f.read())
        if args.image:
            img = read_image(args.image, color=args.channels == 3)
            img = resize_u8(img, args.width, args.height)
            img = img.reshape(args.height, args.width, args.channels)
            batch = np.repeat((img.astype(np.float32) / 255.0)[None],
                              args.batch, 0)
        else:
            batch = np.zeros((args.batch, *shape), np.float32)
        with torch.no_grad():
            probs = ep.module()(
                torch.from_numpy(batch).to(rec.device, rec.dtype),
                torch.ones((args.batch,), device=rec.device))
        probs = probs.float().cpu().numpy()
        metas = [{'valid_ratio': 1.0}] * args.batch
        idx, _ = rec.label_convertor.tensor2idx(probs, metas)
        out = {'shape': list(probs.shape),
               'texts': rec.label_convertor.idx2str(idx)[:3]}
    print(out, flush=True)
    return out


if __name__ == '__main__':
    main()
