"""Run SDMGR over a KIE config's test set and save each image's
predictions and drawing (counterpart of ``tools/kie_test_imgs.py``, the
reference's ``tools/kie_test_imgs.py:20-49``):

    python -m tps_pp_tpu_torch.tools.kie_test_imgs CONFIG [CHECKPOINT] \\
        [--out-dir results] [--cfg-options k=v ...] [--device cpu]

Each item of ``data.test`` goes through the model one at a time
(``build_sdmgr_apply``). ``<name>.json`` holds each box's ``{text, box,
pred, conf}`` (the argmax node class and its softmax probability) and
``<name>.jpg`` the drawing (``utils.visualize.imshow_edge``: boxes
coloured by class, the key -> value pairs whose softmaxed link passes 0.5
beside them), ``<name>`` the file name without its extension
(``sample_<i>`` without one). Texts and boxes come from the annotation
lines; where the image file is absent the drawing is on a white canvas
of the line's size (or the boxes' extent + 16). The model is on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Visualize KIE predictions')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--out-dir', default='./results')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help="'cpu' for the CPU; the card when left out")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from ..apis.train_kie import build_sdmgr_apply, build_task_dataset
    from ..config import load_config, merge_cli_options
    from ..utils.visualize import _cv2, imshow_edge
    from .test import parse_cfg_options

    args = parse_args(argv)
    cv2 = _cv2()
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    ds = build_task_dataset(cfg, 'test')
    apply, model, _ = build_sdmgr_apply(cfg, args.checkpoint, ds[0],
                                        args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    for i in range(len(ds)):
        item = ds[i]
        node_cls, edge_cls = apply(model, item)
        line = ds.lines[i]
        anns = line['annotations'][:node_cls.shape[0]]
        n = len(anns)
        N = node_cls.shape[0]
        nodes = torch.softmax(node_cls.float(), -1).cpu().numpy()[:n]
        edges = torch.softmax(edge_cls.float(), -1).cpu().numpy().reshape(
            N, N, -1)[:n, :n, -1]
        texts = [str(a.get('text', '')) for a in anns]
        boxes = [np.asarray(a['box'], np.float32).reshape(-1) for a in anns]
        name = osp.splitext(osp.basename(
            str(line.get('file_name') or f'sample_{i}')))[0]
        json_result = [{
            'text': t,
            'box': [float(x) for x in b],
            'pred': int(nd.argmax(-1)),
            'conf': float(nd.max(-1)),
        } for t, b, nd in zip(texts, boxes, nodes)]
        with open(osp.join(args.out_dir, name + '.json'), 'w') as f:
            json.dump(json_result, f, ensure_ascii=False)

        img = None
        if line.get('file_name'):
            img = cv2.imread(osp.join(
                getattr(ds, 'img_prefix', '') or '', line['file_name']))
        if img is None:   # annotation-only: a white canvas
            pts = (np.concatenate(boxes).reshape(-1, 2) if boxes
                   else np.zeros((1, 2)))
            h = int(line.get('height') or pts[:, 1].max() + 16 or 256)
            w = int(line.get('width') or pts[:, 0].max() + 16 or 256)
            img = np.full((max(h, 32), max(w, 32), 3), 255, np.uint8)
        imshow_edge(img, boxes, texts, nodes, edges,
                    out_file=osp.join(args.out_dir, name + '.jpg'))
    logging.info('saved %d predictions -> %s', len(ds), args.out_dir)
    return len(ds)


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main()
