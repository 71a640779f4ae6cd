"""Recognition dataset converters (counterpart of
``tools/data/textrecog_converter.py``; the reference's
``tools/data/textrecog/{svt,totaltext,textocr,openvino,synthtext}_converter
.py``):

    python -m tps_pp_tpu_torch.tools.data.textrecog_converter KIND \\
        ANNOTATION IMG_ROOT OUT_DIR [--pack]

They write the port's ``label.txt`` (``<relpath> <text>`` lines, which
``HardDiskLoader`` reads) into OUT_DIR, and with ``--pack`` the same lines
as a TPSPACK1 ``label.pack`` (``PackedLoader``), from:

* ``svt``: SVT's test.xml (image-level rectangles and tags), each word box
  cropped into OUT_DIR;
* ``totaltext``: Total-Text's txt polygon annotations per image;
* ``jsonl``: ``{'filename': ..., 'text': ...}`` JSON lines;
* ``synthtext``: SynthText's gt.mat (scipy's ``loadmat``), word boxes
  cropped;
* ``textocr``: TextOCR's json (``utf8_string`` boxes cropped, boxes
  labelled ``'.'`` skipped);
* ``openvino``: Open Images v5 annotation json (``transcription`` boxes,
  legible English only);
* ``seg_synthtext``: SynthText's character boxes as the JSON lines of
  ``OCRSegDataset`` (``seg_label.jsonl``).

A crop is the box's rows and columns of the image, clipped to it, written
as ``img_<i>.jpg``. A PNG image is decoded without cv2
(``cv_ops.png_decode``); other images are decoded, and the JPEG crops
encoded, with cv2, imported in the call that needs it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from ...utils.packed import write_packed


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError('textrecog_converter decodes JPEG and other '
                          'non-PNG images and writes its JPEG crops with '
                          'cv2, which is not installed') from e
    return cv2


def imread(path: str) -> Optional[np.ndarray]:
    """The BGR image at ``path``, as ``cv2.imread`` gives it; None where
    there is no such file or cv2 cannot decode it."""
    from ...datasets.pipelines.cv_ops import PNG_SIGNATURE, png_decode
    if not os.path.isfile(path):
        return None
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:8] == PNG_SIGNATURE:
        return png_decode(buf)
    return _cv2().imread(path)


def _write_crop(out_dir: str, idx: int, crop: np.ndarray) -> str:
    fn = f'img_{idx}.jpg'
    _cv2().imwrite(os.path.join(out_dir, fn), crop)
    return fn


def convert_svt(xml_path, img_root, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for image in ET.parse(xml_path).getroot().iter('image'):
        img = imread(os.path.join(img_root, image.find('imageName').text))
        if img is None:
            continue
        for rect in image.iter('taggedRectangle'):
            tag = rect.find('tag').text
            x, y = int(rect.get('x')), int(rect.get('y'))
            w, h = int(rect.get('width')), int(rect.get('height'))
            crop = img[max(y, 0):y + h, max(x, 0):x + w]
            if crop.size == 0:
                continue
            lines.append(f'{_write_crop(out_dir, len(lines), crop)} {tag}')
    return lines


def convert_totaltext(ann_dir, img_root, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for ann in sorted(os.listdir(ann_dir)):
        if not ann.endswith('.txt'):
            continue
        img_name = ann.replace('poly_gt_', '').replace('.txt', '.jpg')
        img = imread(os.path.join(img_root, img_name))
        if img is None:
            continue
        for line in open(os.path.join(ann_dir, ann), encoding='utf-8'):
            xs = re.findall(r"x: \[\[([\d\s]+)\]\]", line)
            ys = re.findall(r"y: \[\[([\d\s]+)\]\]", line)
            ts = re.findall(r"transcriptions: \[u?'(.+?)'\]", line)
            if not xs or not ys or not ts or ts[0] == '#':
                continue
            x = [int(v) for v in xs[0].split()]
            y = [int(v) for v in ys[0].split()]
            crop = img[max(min(y), 0):max(y), max(min(x), 0):max(x)]
            if crop.size == 0:
                continue
            lines.append(f'{_write_crop(out_dir, len(lines), crop)} {ts[0]}')
    return lines


def _crop_box_lines(entries, img_root, out_dir):
    """entries: (image path under img_root, [(x0, y0, x1, y1, text), ...])
    pairs."""
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for rel, boxes in entries:
        img = imread(os.path.join(img_root, rel))
        if img is None:
            continue
        H, W = img.shape[:2]
        for x0, y0, x1, y1, text in boxes:
            x0, y0 = max(int(x0), 0), max(int(y0), 0)
            x1, y1 = min(int(x1), W), min(int(y1), H)
            crop = img[y0:y1, x0:x1]
            if crop.size == 0 or not text:
                continue
            lines.append(f'{_write_crop(out_dir, len(lines), crop)} {text}')
    return lines


def _unwrap(v) -> str:
    while isinstance(v, np.ndarray):
        v = v.reshape(-1)[0]
    return str(v)


def load_synthtext_gt(mat_path):
    """gt.mat -> (image path, words, word quads (n, 4, 2), character boxes)
    tuples (reference synthtext_converter.py:28-76)."""
    from scipy.io import loadmat
    gt = loadmat(mat_path, simplify_cells=False)
    for i in range(gt['imnames'].shape[1]):
        img_path = _unwrap(gt['imnames'][0, i])
        txt = gt['txt'][0, i]
        word_bb = gt['wordBB'][0, i]
        char_bb = gt['charBB'][0, i]
        words = []
        if isinstance(txt, str):
            words = txt.split()
        else:
            for line in np.asarray(txt, dtype=object).reshape(-1):
                words += _unwrap(line).split()
        if word_bb.ndim == 2:
            word_bb = word_bb[:, :, None]
        quads = word_bb.transpose(2, 1, 0)
        if len(words) != len(quads):
            continue
        yield img_path, words, quads, char_bb


def convert_synthtext(mat_path, img_root, out_dir):
    entries = []
    for img_path, words, quads, _ in load_synthtext_gt(mat_path):
        boxes = [(q[:, 0].min(), q[:, 1].min(), q[:, 0].max(),
                  q[:, 1].max(), word) for word, q in zip(words, quads)]
        entries.append((img_path, boxes))
    return _crop_box_lines(entries, img_root, out_dir)


def convert_seg_synthtext(mat_path, img_root, out_dir):
    """SynthText's character boxes -> ``seg_label.jsonl`` in out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(os.path.join(out_dir, 'seg_label.jsonl'), 'w',
              encoding='utf-8') as f:
        for img_path, words, quads, char_bb in load_synthtext_gt(mat_path):
            if char_bb.ndim == 2:
                char_bb = char_bb[:, :, None]
            chars = ''.join(words)
            cquads = char_bb.transpose(2, 1, 0)
            if len(chars) != len(cquads):
                continue
            anns = [{'char_box': q.reshape(-1).tolist(), 'char_text': c}
                    for c, q in zip(chars, cquads)]
            f.write(json.dumps({'file_name': img_path, 'text': chars,
                                'annotations': anns}) + '\n')
            n += 1
    return [f'# wrote {n} records to seg_label.jsonl (use OCRSegDataset)']


def convert_textocr(json_path, img_root, out_dir):
    """Reference textocr_converter.py:25-47."""
    with open(json_path, encoding='utf-8') as f:
        data = json.load(f)
    entries = []
    for img_id, info in data['imgs'].items():
        boxes = []
        for ann_id in data['imgToAnns'].get(img_id, []):
            ann = data['anns'][str(ann_id)] if isinstance(
                data['anns'], dict) else data['anns'][ann_id]
            text = ann.get('utf8_string', '')
            if text == '.':
                continue
            x, y, w, h = ann['bbox']
            boxes.append((x, y, x + w, y + h, text))
        entries.append((info['file_name'], boxes))
    return _crop_box_lines(entries, img_root, out_dir)


def convert_openvino(json_path, img_root, out_dir):
    """Open Images v5 (reference openvino_converter.py:36-60): legible
    English transcriptions only."""
    with open(json_path, encoding='utf-8') as f:
        data = json.load(f)
    imgs = {i['id']: i for i in data['images']}
    per_img = {}
    for ann in data['annotations']:
        attrs = ann.get('attributes', {})
        if not attrs.get('legible', True) or \
                attrs.get('language', 'english') != 'english':
            continue
        x, y, w, h = ann['bbox']
        per_img.setdefault(ann['image_id'], []).append(
            (x, y, x + w, y + h, attrs.get('transcription', '')))
    entries = [(imgs[i]['file_name'], boxes)
               for i, boxes in per_img.items() if i in imgs]
    return _crop_box_lines(entries, img_root, out_dir)


def convert_jsonl(jsonl_path, img_root, out_dir):
    lines = []
    for line in open(jsonl_path, encoding='utf-8'):
        if line.strip():
            obj = json.loads(line)
            lines.append(f"{obj['filename']} {obj['text']}")
    return lines


CONVERTERS = {'svt': convert_svt, 'totaltext': convert_totaltext,
              'jsonl': convert_jsonl, 'synthtext': convert_synthtext,
              'textocr': convert_textocr, 'openvino': convert_openvino,
              'seg_synthtext': convert_seg_synthtext}


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description='Recognition data converters')
    p.add_argument('kind', choices=list(CONVERTERS))
    p.add_argument('annotation')
    p.add_argument('img_root')
    p.add_argument('out_dir')
    p.add_argument('--pack', action='store_true',
                   help='also write label.pack (TPSPACK1)')
    args = p.parse_args(argv)
    lines = CONVERTERS[args.kind](args.annotation, args.img_root,
                                  args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    label = os.path.join(args.out_dir, 'label.txt')
    with open(label, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines) + '\n')
    print(f'wrote {len(lines)} samples -> {label}')
    if args.pack:
        write_packed(os.path.join(args.out_dir, 'label.pack'),
                     [ln.encode('utf-8') for ln in lines])
        print('wrote label.pack')
    return lines


if __name__ == '__main__':
    main()
