"""Recognition datasets in test mode and their batcher (counterpart of
``tps_pp_tpu/datasets/ocr_dataset.py:34-298``).

* ``OCRDataset``: a loader, a parser and a pipeline; the ground-truth
  ``text`` goes into the pipeline's results; ``evaluate`` is
  ``eval_ocr_metric`` against the annotations (reference
  ``datasets/base_dataset.py``, ``ocr_dataset.py:8-36``). Outside test mode
  a sample that fails to load is skipped for the next one, as in JAX.
* ``UniformConcatDataset``: per-dataset metrics and their ``mean_``
  (reference ``uniform_concat_dataset.py:92-151``).
* ``DataLoader``: batches in order, as the JAX one yields them in test
  mode: ``img`` (N, H, W, C) float32, ``valid_ratio`` (N,), ``img_metas``,
  ``texts`` and ``n_real``; with ``pad_to_batch`` the last batch repeats
  its last sample up to ``batch_size``. Shuffling, seeded augmentation and
  worker processes (the training side) are not ported yet.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..evaluation import eval_ocr_metric
from ..registry import DATASETS, LOADERS
from .pipelines.transforms import Compose

logger = logging.getLogger(__name__)


@DATASETS.register_module()
class OCRDataset:
    def __init__(self, ann_file: str = '', loader: Dict = None,
                 pipeline: Sequence = (), img_prefix: str = '',
                 test_mode: bool = False, dataset_info=None, **kwargs):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        loader = dict(loader or {})
        loader.setdefault('ann_file', ann_file)
        self.data_infos = LOADERS.build(loader)
        self.pipeline = Compose(pipeline)

    def __len__(self):
        return len(self.data_infos)

    def pre_pipeline(self, results: Dict):
        results['img_prefix'] = self.img_prefix
        results['text'] = results['img_info'].get('text', '')

    def prepare_data(self, index: int) -> Optional[Dict]:
        results = dict(img_info=self.data_infos[index])
        self.pre_pipeline(results)
        return self.pipeline(results)

    def __getitem__(self, index: int) -> Dict:
        # in test mode a result must stay at its annotation's position
        if self.test_mode:
            data = self.prepare_data(index)
            if data is None:
                raise RuntimeError(f'test sample {index} was filtered by '
                                   'the pipeline')
            return data
        for _ in range(len(self)):
            try:
                data = self.prepare_data(index)
                if data is not None:
                    return data
            except Exception as e:  # a corrupt image or annotation
                logger.warning('skipping sample %d: %s', index, e)
            index = (index + 1) % len(self)
        raise RuntimeError('all samples failed to load')

    def evaluate(self, results: List[Dict], metric='acc', **kwargs) -> Dict:
        gt_texts = [self.data_infos[i]['text'] for i in range(len(self))]
        pred_texts = [results[i]['text'] for i in range(len(self))]
        return eval_ocr_metric(pred_texts, gt_texts)


@DATASETS.register_module()
class UniformConcatDataset:
    """Datasets in a row, each given ``pipeline`` unless it has its own."""

    def __init__(self, datasets: Sequence, pipeline: Sequence = (),
                 test_mode: bool = False, **kwargs):
        self.datasets: List[OCRDataset] = []
        for ds in datasets:
            ds = dict(ds)
            if pipeline and 'pipeline' not in ds:
                ds['pipeline'] = pipeline
            ds.setdefault('test_mode', test_mode)
            self.datasets.append(DATASETS.build(ds))
        self.cumsizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumsizes[-1] if self.cumsizes else 0

    def __getitem__(self, index: int) -> Dict:
        for di, cum in enumerate(self.cumsizes):
            if index < cum:
                prev = self.cumsizes[di - 1] if di else 0
                return self.datasets[di][index - prev]
        raise IndexError(index)

    def evaluate(self, results: List[Dict], metric='acc', **kwargs) -> Dict:
        """``{len}_{ann_file}_{metric}`` per dataset and ``mean_{metric}``
        over them, rounded to 4 decimals."""
        if len(results) != len(self):
            raise ValueError(f'{len(results)} results for {len(self)} '
                             'samples')
        out: Dict[str, float] = {}
        start = 0
        all_metrics: Dict[str, List[float]] = {}
        for ds in self.datasets:
            end = start + len(ds)
            res = ds.evaluate(results[start:end], metric=metric, **kwargs)
            name = getattr(ds.data_infos, 'ann_file', '') or 'dataset'
            for k, v in res.items():
                out[f'{len(ds)}_{name}_{k}'] = v
                all_metrics.setdefault(k, []).append(v)
            start = end
        for k, vals in all_metrics.items():
            out[f'mean_{k}'] = float(f'{np.mean(vals):.4f}')
        return out


def collate(samples: List[Dict], batch_size: int, pad_to_batch: bool) -> Dict:
    """One batch of pipeline outputs (the JAX ``_collate``)."""
    n_real = len(samples)
    if pad_to_batch and n_real < batch_size:
        samples = samples + [samples[-1]] * (batch_size - n_real)
    imgs = np.stack([s['img'] for s in samples]).astype(np.float32,
                                                        copy=False)
    metas = [s['img_metas'] for s in samples]
    vr = np.asarray([m.get('valid_ratio', 1.0) or 1.0 for m in metas],
                    np.float32)
    return {
        'img': imgs,
        'valid_ratio': vr,
        'img_metas': metas,
        'texts': [s.get('text', '') for s in samples],
        'n_real': n_real,
    }


class DataLoader:
    """The dataset in order, ``batch_size`` samples a batch."""

    def __init__(self, dataset, batch_size: int, pad_to_batch: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to_batch = pad_to_batch

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        for i in range(0, n, self.batch_size):
            yield collate([self.dataset[j] for j in
                           range(i, min(i + self.batch_size, n))],
                          self.batch_size, self.pad_to_batch)


def build_dataset(cfg: Dict, default_args: Optional[Dict] = None):
    cfg = dict(cfg)
    for k, v in (default_args or {}).items():
        cfg.setdefault(k, v)
    return DATASETS.build(cfg)
