"""KIE and NER datasets (counterpart of
``tps_pp_tpu/datasets/kie_dataset.py``; the reference's ``KIEDataset``,
``OpensetKIEDataset`` and ``NerDataset``). numpy on the host.

* ``KIEDataset``: wildreceipt-style JSON lines, one receipt a line
  (``{'file_name', 'height', 'width', 'annotations': [{'box': 8 floats,
  'text', 'label'}]}``), into SDMGR's inputs: the texts as character
  indices padded to (max_nodes, max_chars) (0 pads; an unknown character
  is ``len(char2idx) + 1``), the (max_nodes, max_nodes, 5) box relations
  (``compute_relations``), the node labels (-100 on padded nodes) and the
  edge labels (1 where two nodes share a label, -1 on padded rows). With
  ``with_visual`` also the receipt image at ``img_size``, normalised, and
  the node boxes in its coordinates. The image is read as
  ``LoadImageFromFile`` reads one, ``cv2`` imported inside the call, or
  taken from ``images`` (file name -> uint8 BGR array), which needs no
  cv2; a missing file gives a black image of the line's size, as the JAX
  package's ``cv2.imread`` returning None does. The resize is
  ``cv_ops.resize_u8``, cv2's uint8 ``INTER_LINEAR`` bit for bit.
* ``OpensetKIEDataset``: the nodes classed bg / key / value / other, an
  edge where a key and a value share an ``edge`` id; predicted key-value
  pairs decoded from the edge matrix in each ``link_type`` and scored with
  the openset F1s.
* ``NerDataset``: cluener-style JSON lines (``{'text', 'label': {type:
  {entity: [[s, e], ...]}}}``) into character ids (the vocabulary's, or
  ``ord(ch) % 20000 + 100`` without one), the attention mask and BIO tag
  ids.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .pipelines.cv_ops import resize_u8

KIE_CHARS = '0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ'
# the reference's img_norm_cfg (mean and std of RGB, to_rgb)
IMG_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def compute_relations(boxes: np.ndarray, norm: float = 10.0) -> np.ndarray:
    """(N, 4) xyxy boxes -> (N, N, 5) relations ``[dx / h_i, dy / h_i,
    w_i / h_i, h_j / h_i, w_j / h_i]``, dx and dy scaled by ``10 / norm``
    (the reference's ``KIEDataset.compute_relation``)."""
    x1, y1 = boxes[:, 0], boxes[:, 1]
    w = np.maximum(boxes[:, 2] - boxes[:, 0], 1.0)
    h = np.maximum(boxes[:, 3] - boxes[:, 1], 1.0)
    dx = (x1[None, :] - x1[:, None]) / (h[:, None] * norm / 10.0)
    dy = (y1[None, :] - y1[:, None]) / (h[:, None] * norm / 10.0)
    N = len(boxes)
    rel = np.stack([
        dx, dy,
        np.broadcast_to((w / h)[:, None], (N, N)),
        h[None, :] / h[:, None],
        w[None, :] / h[:, None],
    ], axis=-1)
    return rel.astype(np.float32)


def encode_texts(texts: Sequence[str], char2idx: Dict[str, int],
                 max_chars: int) -> np.ndarray:
    """Node texts -> (len(texts), max_chars) int32 character indices, cut
    to ``max_chars``, 0 padding, ``len(char2idx) + 1`` for a character
    outside ``char2idx``."""
    out = np.zeros((len(texts), max_chars), np.int32)
    unknown = len(char2idx) + 1
    for i, text in enumerate(texts):
        for j, ch in enumerate(str(text)[:max_chars]):
            out[i, j] = char2idx.get(ch, unknown)
    return out


@DATASETS.register_module()
class KIEDataset:
    def __init__(self, ann_file: str, dict_file: Optional[str] = None,
                 dict_list: Optional[Sequence[str]] = None,
                 max_nodes: int = 64, max_chars: int = 32,
                 norm: float = 10.0, test_mode: bool = False,
                 img_prefix: str = '', with_visual: bool = False,
                 img_size=(512, 512),
                 images: Optional[Mapping[str, np.ndarray]] = None,
                 **kwargs):
        self.img_prefix = img_prefix
        self.with_visual = bool(with_visual)
        self.img_size = tuple(img_size)
        self.images = images or {}
        with open(ann_file, encoding='utf-8') as f:
            self.lines = [json.loads(line) for line in f if line.strip()]
        if dict_file:
            with open(dict_file, encoding='utf-8') as f:
                chars = [line.rstrip('\n') for line in f if line.strip()]
        else:
            chars = list(dict_list or KIE_CHARS)
        # index 0 pads (the reference embeds with padding_idx=0)
        self.char2idx = {c: i + 1 for i, c in enumerate(chars)}
        self.max_nodes = max_nodes
        self.max_chars = max_chars
        self.norm = norm
        self.test_mode = test_mode

    def __len__(self):
        return len(self.lines)

    def compute_relations(self, boxes: np.ndarray) -> np.ndarray:
        return compute_relations(boxes, self.norm)

    def __getitem__(self, index: int) -> Dict:
        line = self.lines[index]
        anns = line['annotations'][:self.max_nodes]
        N = self.max_nodes
        texts = np.zeros((N, self.max_chars), np.int32)
        texts[:len(anns)] = encode_texts([a.get('text', '') for a in anns],
                                         self.char2idx, self.max_chars)
        labels = np.full((N,), -100, np.int32)
        boxes = np.zeros((max(len(anns), 1), 4), np.float32)
        for i, ann in enumerate(anns):
            labels[i] = int(ann.get('label', 0))
            box = np.asarray(ann['box'], np.float32).reshape(-1, 2)
            boxes[i] = [box[:, 0].min(), box[:, 1].min(),
                        box[:, 0].max(), box[:, 1].max()]
        rel = np.zeros((N, N, 5), np.float32)
        n = len(anns)
        if n:
            rel[:n, :n] = self.compute_relations(boxes[:n])
        edges = np.full((N, N), -1, np.int32)
        if n:
            lab = labels[:n]
            edges[:n, :n] = (lab[:, None] == lab[None, :]).astype(np.int32)
        out = {
            'texts': texts,
            'relations': rel,
            'labels': labels,
            'edge_labels': edges,
            'filename': line.get('file_name'),
        }
        if self.with_visual:
            H, W = self.img_size
            img = self.load_image(line)
            h0, w0 = img.shape[:2]
            img = resize_u8(img, W, H).astype(np.float32)
            img = (img[..., ::-1] - IMG_MEAN) / IMG_STD
            sx, sy = W / max(w0, 1), H / max(h0, 1)
            scaled = boxes.copy()
            scaled[:, 0::2] *= sx
            scaled[:, 1::2] *= sy
            padded_boxes = np.zeros((N, 4), np.float32)
            padded_boxes[:len(scaled)] = scaled[:N]
            out['img'] = img
            out['boxes'] = padded_boxes
        return out

    def load_image(self, line: Dict) -> np.ndarray:
        """The receipt's uint8 BGR image: from ``images``, else decoded
        from ``img_prefix/file_name`` with ``cv2.imread``; black at the
        line's size (the image size where it has none) when the file is
        missing or does not decode."""
        name = line['file_name']
        if name in self.images:
            return np.asarray(self.images[name], np.uint8)
        H, W = self.img_size
        blank = np.zeros((line.get('height', H), line.get('width', W), 3),
                         np.uint8)
        path = os.path.join(self.img_prefix, name)
        if not os.path.isfile(path):
            return blank
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                'KIEDataset decodes receipt images with cv2.imread, and cv2 '
                'is not installed; pass decoded BGR arrays as images={file '
                'name: array}') from e
        img = cv2.imread(path)
        return blank if img is None else img

    def evaluate(self, results: List[np.ndarray], metric='macro_f1',
                 ignores=(0, 2, 4, 6, 8, 10, 12, 25), num_classes=26,
                 **kwargs) -> Dict:
        """results: each receipt's predicted node classes. The macro F1
        over ``num_classes`` classes, ``ignores`` left out."""
        from ..evaluation import compute_f1_score
        preds, gts = [], []
        for i, pred in enumerate(results):
            gt = self[i]['labels']
            valid = gt != -100
            preds.append(np.asarray(pred)[valid])
            gts.append(gt[valid])
        f1 = compute_f1_score(np.concatenate(preds), np.concatenate(gts),
                              ignores=ignores, num_classes=num_classes)
        return {'macro_f1': round(float(f1.mean()), 4)}


@DATASETS.register_module()
class NerDataset:
    """cluener-style NER lines -> (character ids, attention mask, BIO tag
    ids), ``max_len`` long. ``vocab_file`` is the reference's BERT
    vocabulary, one token a line."""

    def __init__(self, ann_file: str, categories: Sequence[str],
                 vocab_file: Optional[str] = None, max_len: int = 128,
                 test_mode: bool = False, **kwargs):
        with open(ann_file, encoding='utf-8') as f:
            self.lines = [json.loads(line) for line in f if line.strip()]
        self.categories = list(categories)
        self.tag2id = {'O': 0}
        for c in self.categories:
            self.tag2id[f'B-{c}'] = len(self.tag2id)
            self.tag2id[f'I-{c}'] = len(self.tag2id)
        self.id2tag = {v: k for k, v in self.tag2id.items()}
        self.max_len = max_len
        self.vocab = {}
        if vocab_file:
            with open(vocab_file, encoding='utf-8') as f:
                for i, tok in enumerate(f):
                    self.vocab[tok.rstrip('\n')] = i

    def __len__(self):
        return len(self.lines)

    def _char_id(self, ch: str) -> int:
        if self.vocab:
            return self.vocab.get(ch, self.vocab.get('[UNK]', 1))
        return (ord(ch) % 20000) + 100

    def __getitem__(self, index: int) -> Dict:
        line = self.lines[index]
        text = line['text'][:self.max_len]
        ids = np.zeros((self.max_len,), np.int32)
        mask = np.zeros((self.max_len,), np.int32)
        tags = np.zeros((self.max_len,), np.int32)
        for i, ch in enumerate(text):
            ids[i] = self._char_id(ch)
            mask[i] = 1
        for cat, entities in line.get('label', {}).items():
            for _, spans in entities.items():
                for s, e in spans:
                    if s >= self.max_len:
                        continue
                    tags[s] = self.tag2id[f'B-{cat}']
                    for k in range(s + 1, min(e + 1, self.max_len)):
                        tags[k] = self.tag2id[f'I-{cat}']
        return {'input_ids': ids, 'attention_mask': mask, 'labels': tags,
                'text': text}

    def evaluate(self, results: List[np.ndarray], **kwargs) -> Dict:
        """results: each line's predicted tag ids; scored over its
        unmasked positions."""
        from ..evaluation import eval_ner_f1
        pred_tags, gt_tags = [], []
        for i, pred in enumerate(results):
            item = self[i]
            n = int(item['attention_mask'].sum())
            pred_tags.append([self.id2tag[int(t)] for t in
                              np.asarray(pred)[:n]])
            gt_tags.append([self.id2tag[int(t)] for t in
                            item['labels'][:n]])
        return eval_ner_f1(pred_tags, gt_tags)


@DATASETS.register_module()
class OpensetKIEDataset(KIEDataset):
    """Openset KIE (reference ``datasets/openset_kie_dataset.py:11-308``):
    nodes classed bg / key / value / other, key-value pairs decoded from
    the predicted edges and scored with the openset micro and macro F1.
    A key and a value whose annotations share an ``edge`` id are a pair."""

    def __init__(self, ann_file, link_type='one-to-one', edge_thr=0.5,
                 key_node_idx=1, value_node_idx=2, node_classes=4, **kwargs):
        super().__init__(ann_file, **kwargs)
        assert link_type in ('one-to-one', 'one-to-many', 'many-to-one',
                             'many-to-many', 'none')
        self.link_type = link_type
        self.edge_thr = edge_thr
        self.key_node_idx = key_node_idx
        self.value_node_idx = value_node_idx
        self.node_classes = node_classes
        self.data_dict = {ln['file_name']: ln for ln in self.lines}

    def __getitem__(self, index: int) -> Dict:
        out = super().__getitem__(index)
        anns = self.lines[index]['annotations'][:self.max_nodes]
        # an edge where the ids match and it runs between a key and a value
        n = len(anns)
        edges = np.full((self.max_nodes, self.max_nodes), -1, np.int32)
        if n:
            eid = np.asarray([a.get('edge', -1) for a in anns])
            lab = np.asarray([a.get('label', 0) for a in anns])
            same = (eid[:, None] == eid[None, :]) & (eid[:, None] >= 0)
            kv = (lab[:, None] == self.key_node_idx) & \
                 (lab[None, :] == self.value_node_idx)
            edges[:n, :n] = (same & (kv | kv.T)).astype(np.int32)
        out['edge_labels'] = edges
        return out

    def _decode_pairs_gt(self, labels, edge_ids):
        """(reference openset_kie_dataset.py:98-112)"""
        gt_pairs = []
        for i, label in enumerate(labels):
            if label == self.key_node_idx:
                for j, edge_id in enumerate(edge_ids):
                    if edge_id == edge_ids[i] and \
                            labels[j] == self.value_node_idx:
                        gt_pairs.append((i, j))
        return gt_pairs

    def _decode_pairs_pred(self, nodes, labels, edges):
        """(reference openset_kie_dataset.py:114-153)"""
        edges = np.maximum(edges, edges.T)
        if self.link_type in ('none', 'many-to-many'):
            n1s, n2s = np.nonzero(edges > self.edge_thr)
            pred_pairs = [(int(a), int(b)) if nodes[a, 1] > nodes[a, 2]
                          else (int(b), int(a))
                          for a, b in zip(n1s, n2s) if a < b]
            pred_pairs = [(i, j) for i, j in pred_pairs
                          if labels[i] == self.key_node_idx and
                          labels[j] == self.value_node_idx]
        else:
            links = edges.copy()
            links[links <= self.edge_thr] = -1
            links[labels != self.key_node_idx, :] = -1
            links[:, labels != self.value_node_idx] = -1
            pred_pairs = []
            while (links > -1).any():
                i, j = np.unravel_index(np.argmax(links), links.shape)
                pred_pairs.append((int(i), int(j)))
                if self.link_type == 'one-to-one':
                    links[i, :] = -1
                    links[:, j] = -1
                elif self.link_type == 'one-to-many':
                    links[:, j] = -1
                elif self.link_type == 'many-to-one':
                    links[i, :] = -1
        conf = [float(edges[i, j]) for i, j in pred_pairs]
        return pred_pairs, conf

    def decode_pred(self, result: Dict) -> Dict:
        """result: ``{'filename', 'nodes' (n, C) softmax, 'edges' (n, n)
        link probability}``."""
        filename = result['filename']
        nodes = np.asarray(result['nodes'], np.float32)
        edges = np.asarray(result['edges'], np.float32)
        labels = nodes.argmax(-1)
        pairs, pairs_conf = self._decode_pairs_pred(nodes, labels, edges)
        return {'filename': filename, 'labels': labels.tolist(),
                'pairs': pairs, 'pairs_conf': pairs_conf}

    def decode_gt(self, filename: str) -> Dict:
        annos = self.data_dict[filename]['annotations'][:self.max_nodes]
        labels = [int(a.get('label', 0)) for a in annos]
        edge_ids = [a.get('edge', -1) for a in annos]
        pairs = self._decode_pairs_gt(labels, edge_ids)
        return {'filename': filename, 'labels': labels, 'pairs': pairs,
                'pairs_conf': [1.0] * len(pairs)}

    def evaluate(self, results, metric='openset_f1', **kwargs) -> Dict:
        preds = [self.decode_pred(r) for r in results]
        gts = [self.decode_gt(p['filename']) for p in preds]
        return self.compute_openset_f1(preds, gts)

    def compute_openset_f1(self, preds, gts) -> Dict:
        """(reference openset_kie_dataset.py:212-308)"""
        tot_edge_hit = tot_edge_gt = tot_edge_pred = 0
        hit = {i: 0 for i in range(self.node_classes)}
        gt_n = {i: 0 for i in range(self.node_classes)}
        pred_n = {i: 0 for i in range(self.node_classes)}
        for pred, gt in zip(preds, gts):
            tot_edge_hit += sum(1 for p in gt['pairs'] if p in pred['pairs'])
            tot_edge_gt += len(gt['pairs'])
            tot_edge_pred += len(pred['pairs'])
            for i, g in enumerate(gt['labels']):
                g = int(g)
                gt_n[g] += 1
                if int(pred['labels'][i]) == g:
                    hit[g] += 1
            for p in pred['labels']:
                pred_n[int(p)] += 1
        er = tot_edge_hit / max(1, tot_edge_gt)
        ep = tot_edge_hit / max(1, tot_edge_pred)
        stats = {'edge_openset_f1': 2 * er * ep / max(1, er + ep)}
        cared = [self.key_node_idx, self.value_node_idx]
        ch = sum(hit[i] for i in cared)
        cg = sum(gt_n[i] for i in cared)
        cp = sum(pred_n[i] for i in cared)
        macro = []
        for i in cared:
            r = hit[i] / max(1, gt_n[i])
            p = hit[i] / max(1, pred_n[i])
            macro.append(2 * r * p / max(1, r + p))
        mr, mp = ch / max(1, cg), ch / max(1, cp)
        stats['node_openset_micro_f1'] = 2 * mr * mp / max(1, mr + mp)
        stats['node_openset_macro_f1'] = float(np.mean(macro))
        return stats
