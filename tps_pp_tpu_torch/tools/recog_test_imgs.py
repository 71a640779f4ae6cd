"""Recognize a folder's listed images, draw each with its text and sort
the drawings into correct and wrong (counterpart of
``tools/recog_test_imgs.py``, the reference's ``tools/recog_test_imgs.py
:40-123``):

    python -m tps_pp_tpu_torch.tools.recog_test_imgs IMG_ROOT IMG_LIST \\
        CONFIG [CHECKPOINT] [--out-dir results] [--batch-size 32] \\
        [--cfg-options k=v ...] [--device cpu]

``IMG_LIST`` lines are ``<relative path> [<gt label>]``. The images run
through ``model_inference`` in batches of ``--batch-size`` (the config's
test pipeline; images are read with cv2). Writes, as the JAX CLI does,
``out_vis_dir/<path with / as _>`` (``utils.visualize.imshow_text_label``,
which needs cv2), copies of the drawings of labelled images under
``correct/`` or ``wrong/``, ``results.txt`` (``<path> <pred> <gt>`` a
line), ``correct.txt`` and ``wrong.txt``; when every line has a label it
prints the OCR metrics (``eval_ocr_metric``) as the last line. The
recognizer is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import shutil
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Batch-test recog on images')
    p.add_argument('img_root_path')
    p.add_argument('img_list')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-dir', default='./results')
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help="'cpu' for the CPU; the card when left out")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    from ..apis.inference import init_recognizer, model_inference
    from ..config import load_config, merge_cli_options
    from ..evaluation.ocr_metric import eval_ocr_metric
    from ..utils.fileio import list_from_file, list_to_file
    from ..utils.visualize import _cv2, imshow_text_label
    from .test import parse_cfg_options

    args = parse_args(argv)
    cv2 = _cv2()
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    rec = init_recognizer(cfg, args.checkpoint, device=args.device)

    out_vis = osp.join(args.out_dir, 'out_vis_dir')
    correct_vis = osp.join(args.out_dir, 'correct')
    wrong_vis = osp.join(args.out_dir, 'wrong')
    for d in (args.out_dir, out_vis, correct_vis, wrong_vis):
        os.makedirs(d, exist_ok=True)

    img_files, gt_labels = [], []
    for line in list_from_file(args.img_list):
        items = line.strip().split()
        if not items:
            continue
        img_files.append(items[0])
        gt_labels.append(items[1] if len(items) >= 2 else '')

    pred_labels = []
    for i in range(0, len(img_files), args.batch_size):
        paths = [osp.join(args.img_root_path, f)
                 for f in img_files[i:i + args.batch_size]]
        for pth in paths:
            if not osp.exists(pth):
                raise FileNotFoundError(pth)
        pred_labels.extend(r['text'] for r in model_inference(
            rec, paths, batch_mode=True))

    for img_file, pred, gt in zip(img_files, pred_labels, gt_labels):
        out_name = '_'.join(img_file.split('/'))
        out_file = osp.join(out_vis, out_name)
        img = cv2.imread(osp.join(args.img_root_path, img_file))
        imshow_text_label(img, pred, gt, out_file=out_file)
        if gt:
            dst = correct_vis if gt == pred else wrong_vis
            shutil.copy(out_file, osp.join(dst, out_name))

    lines = [f'{osp.join(args.img_root_path, f)} {pr} {gt}'
             for f, pr, gt in zip(img_files, pred_labels, gt_labels)]
    list_to_file(osp.join(args.out_dir, 'results.txt'), lines)
    list_to_file(osp.join(args.out_dir, 'correct.txt'),
                 [ln for ln, pr, gt in zip(lines, pred_labels, gt_labels)
                  if gt and pr == gt])
    list_to_file(osp.join(args.out_dir, 'wrong.txt'),
                 [ln for ln, pr, gt in zip(lines, pred_labels, gt_labels)
                  if gt and pr != gt])
    metrics = None
    if gt_labels and all(gt_labels):
        metrics = eval_ocr_metric(pred_labels, gt_labels)
        logging.info('eval on %d images: %s', len(gt_labels), metrics)
        print(metrics)
    return pred_labels, metrics


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main()
