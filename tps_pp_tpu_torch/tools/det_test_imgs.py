"""Detect text in a folder's listed images: each image's boundaries as a
text file and drawn (counterpart of ``tools/det_test_imgs.py``, the
reference's ``tools/det_test_imgs.py:50-120``):

    python -m tps_pp_tpu_torch.tools.det_test_imgs IMG_ROOT IMG_LIST \\
        CONFIG [CHECKPOINT] [--out-dir results] [--batch-size 8] \\
        [--score-thr 0.3] [--img-size H W] [--cfg-options k=v ...] \\
        [--device cpu]

The images (read with cv2) run through ``TextDetector.detect_batch`` in
batches of ``--batch-size`` at ``--img-size`` (the config's ``img_size``,
else 640 x 640). For each, the boundaries scoring above ``--score-thr``
go to ``out_txt_dir/<name>.txt`` (one a line, each value rounded) and
drawn to ``out_vis_dir/<name>.jpg`` (``utils.visualize.
imshow_pred_boundary``), ``<name>`` the path with ``/`` as ``_`` and no
extension. The detector is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Batch-test det on images')
    p.add_argument('img_root')
    p.add_argument('img_list')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-dir', default='./results')
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--img-size', type=int, nargs=2, default=None,
                   help='H W of the input (default: the config\'s img_size '
                        'or 640 640)')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help="'cpu' for the CPU; the card when left out")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    from ..apis.detector import TextDetector
    from ..config import load_config, merge_cli_options
    from ..utils.fileio import list_from_file, list_to_file
    from ..utils.visualize import _cv2, imshow_pred_boundary
    from .test import parse_cfg_options

    args = parse_args(argv)
    cv2 = _cv2()
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    img_size = tuple(args.img_size or cfg.get('img_size') or (640, 640))
    det = TextDetector(cfg['model'], img_size=img_size,
                       checkpoint=args.checkpoint, device=args.device)

    out_txt = osp.join(args.out_dir, 'out_txt_dir')
    out_vis = osp.join(args.out_dir, 'out_vis_dir')
    for d in (args.out_dir, out_txt, out_vis):
        os.makedirs(d, exist_ok=True)

    files = [ln.strip().split()[0] for ln in list_from_file(args.img_list)
             if ln.strip()]
    total = 0
    for i in range(0, len(files), args.batch_size):
        chunk = files[i:i + args.batch_size]
        imgs = []
        for f in chunk:
            img = cv2.imread(osp.join(args.img_root, f))
            if img is None:
                raise FileNotFoundError(osp.join(args.img_root, f))
            imgs.append(img)
        for f, img, boundaries in zip(chunk, imgs, det.detect_batch(imgs)):
            keep = [b for b in boundaries
                    if float(np.asarray(b)[-1]) > args.score_thr]
            name = osp.splitext('_'.join(f.split('/')))[0]
            list_to_file(
                osp.join(out_txt, name + '.txt'),
                [','.join(str(round(float(x))) for x in b) for b in keep])
            imshow_pred_boundary(img, keep,
                                 out_file=osp.join(out_vis, name + '.jpg'))
            total += len(keep)
    logging.info('%d boundaries over %d images -> %s', total, len(files),
                 args.out_dir)
    return total


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main()
