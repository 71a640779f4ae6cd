"""Detection dataset converters into the JSON lines that
``TextDetDataset`` reads, ``{'file_name', 'annotations': [{'polygon':
[...], 'text'?, 'ignore'?}]}`` (counterpart of
``tools/data/textdet_converter.py``; the reference's
``tools/data/textdet/{icdar,ctw1500,totaltext}_converter.py`` and
``coco_to_line_dict.py``):

    python -m tps_pp_tpu_torch.tools.data.textdet_converter KIND \\
        ANNOTATION IMG_DIR OUT_JSONL

* ``icdar``: ICDAR-2015/2017 ``gt_*.txt`` (8 coordinates and the
  transcription a line; ``'###'`` is ignored);
* ``ctw1500``: CTW1500's 28-point polygons;
* ``totaltext``: Total-Text's ``poly_gt_*.txt``;
* ``coco``: a COCO instances json with segmentation polygons;
* ``synthtext``: SynthText's gt.mat word quads;
* ``textocr``: TextOCR's json points (``'.'`` is ignored).

No image is read.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import List, Optional

from .textrecog_converter import load_synthtext_gt


def convert_icdar(gt_dir, img_dir, suffixes=('.jpg', '.png', '.JPG')):
    records = []
    for img_file in sorted(sum((glob.glob(os.path.join(img_dir, f'*{s}'))
                                for s in suffixes), [])):
        stem = os.path.splitext(os.path.basename(img_file))[0]
        gt_file = os.path.join(gt_dir, f'gt_{stem}.txt')
        if not os.path.exists(gt_file):
            continue
        anns = []
        raw = open(gt_file, 'rb').read().decode('utf-8-sig',
                                                errors='replace')
        for line in raw.splitlines():
            parts = line.strip().split(',')
            if len(parts) < 9:
                continue
            text = ','.join(parts[8:]).strip()
            ann = {'polygon': [float(v) for v in parts[:8]], 'text': text}
            if text == '###':
                ann['ignore'] = True
            anns.append(ann)
        records.append({'file_name': os.path.basename(img_file),
                        'annotations': anns})
    return records


def convert_ctw1500(gt_dir, img_dir):
    records = []
    for gt_file in sorted(glob.glob(os.path.join(gt_dir, '*.txt'))):
        stem = os.path.splitext(os.path.basename(gt_file))[0]
        anns = []
        for line in open(gt_file, encoding='utf-8'):
            parts = line.strip().split(',')
            nums = []
            for v in parts:
                try:
                    nums.append(float(v))
                except ValueError:
                    break
            if len(nums) < 8:
                continue
            if len(nums) >= 32:     # xmin, ymin, xmax, ymax, 28 offsets
                x0, y0 = nums[0], nums[1]
                offsets = nums[4:32]
                poly = []
                for i in range(0, len(offsets), 2):
                    poly += [x0 + offsets[i], y0 + offsets[i + 1]]
            else:
                poly = nums[:len(nums) // 2 * 2]
            text = ','.join(parts[len(nums):]).strip().strip('"#')
            ann = {'polygon': poly, 'text': text}
            if text in ('###', ''):
                ann['ignore'] = text == '###'
            anns.append(ann)
        records.append({'file_name': f'{stem}.jpg', 'annotations': anns})
    return records


def convert_totaltext(gt_dir, img_dir):
    records = []
    for gt_file in sorted(glob.glob(os.path.join(gt_dir, 'poly_gt_*.txt'))):
        img_name = os.path.basename(gt_file).replace(
            'poly_gt_', '').replace('.txt', '.jpg')
        anns = []
        for line in open(gt_file, encoding='utf-8'):
            xs = re.findall(r'x: \[\[([\d\s]+)\]\]', line)
            ys = re.findall(r'y: \[\[([\d\s]+)\]\]', line)
            ts = re.findall(r"transcriptions: \[u?'(.*?)'\]", line)
            if not xs or not ys:
                continue
            x = [float(v) for v in xs[0].split()]
            y = [float(v) for v in ys[0].split()]
            text = ts[0] if ts else ''
            ann = {'polygon': [c for xy in zip(x, y) for c in xy],
                   'text': text}
            if text == '#':
                ann['ignore'] = True
            anns.append(ann)
        records.append({'file_name': img_name, 'annotations': anns})
    return records


def convert_coco(json_path, img_dir):
    """A COCO instances json (reference coco_to_line_dict.py)."""
    with open(json_path, encoding='utf-8') as f:
        coco = json.load(f)
    imgs = {i['id']: i for i in coco['images']}
    per_img = {}
    for ann in coco['annotations']:
        seg = ann.get('segmentation')
        if not seg:
            continue
        poly = seg[0] if isinstance(seg, list) else None
        if poly is None or len(poly) < 8:
            continue
        entry = {'polygon': poly}
        if ann.get('iscrowd'):
            entry['ignore'] = True
        per_img.setdefault(ann['image_id'], []).append(entry)
    return [{'file_name': imgs[i]['file_name'], 'annotations': anns}
            for i, anns in per_img.items() if i in imgs]


def convert_synthtext(mat_path, img_dir):
    """SynthText's gt.mat word quads (reference
    textdet/synthtext_converter.py)."""
    records = []
    for img_path, words, quads, _ in load_synthtext_gt(mat_path):
        anns = [{'polygon': q.reshape(-1).tolist(), 'text': w}
                for w, q in zip(words, quads)]
        records.append({'file_name': img_path, 'annotations': anns})
    return records


def convert_textocr_det(json_path, img_dir):
    """TextOCR's json points (reference textdet/textocr_converter.py)."""
    with open(json_path, encoding='utf-8') as f:
        data = json.load(f)
    per_img = {}
    for ann in (data['anns'].values() if isinstance(data['anns'], dict)
                else data['anns']):
        text = ann.get('utf8_string', '')
        poly = ann.get('points') or []
        if len(poly) < 8:
            x, y, w, h = ann['bbox']
            poly = [x, y, x + w, y, x + w, y + h, x, y + h]
        entry = {'polygon': [float(v) for v in poly], 'text': text}
        if text == '.':
            entry['ignore'] = True
        per_img.setdefault(ann['image_id'], []).append(entry)
    imgs = data['imgs']
    return [{'file_name': imgs[str(i)]['file_name']
             if str(i) in imgs else imgs[i]['file_name'],
             'annotations': anns} for i, anns in per_img.items()]


CONVERTERS = {'icdar': convert_icdar, 'ctw1500': convert_ctw1500,
              'totaltext': convert_totaltext, 'coco': convert_coco,
              'synthtext': convert_synthtext,
              'textocr': convert_textocr_det}


def main(argv: Optional[List[str]] = None) -> list:
    p = argparse.ArgumentParser(description='Detection data converters')
    p.add_argument('kind', choices=list(CONVERTERS))
    p.add_argument('annotation', help='gt dir (or coco json)')
    p.add_argument('img_dir')
    p.add_argument('out_jsonl')
    args = p.parse_args(argv)
    records = CONVERTERS[args.kind](args.annotation, args.img_dir)
    with open(args.out_jsonl, 'w', encoding='utf-8') as f:
        for r in records:
            f.write(json.dumps(r) + '\n')
    print(f'wrote {len(records)} images -> {args.out_jsonl}')
    return records


if __name__ == '__main__':
    main()
