"""Recognition datasets and their batcher (counterpart of
``tps_pp_tpu/datasets/ocr_dataset.py:34-298``).

* ``OCRDataset``: a loader, a parser and a pipeline; the ground-truth
  ``text`` goes into the pipeline's results; ``evaluate`` is
  ``eval_ocr_metric`` against the annotations (reference
  ``datasets/base_dataset.py``, ``ocr_dataset.py:8-36``). Outside test mode
  a sample that fails to load is skipped for the next one, as in JAX.
  ``sample(index, key)`` runs the pipeline with the sample's generators
  (``seeded_rngs(key)``), which the augmentations draw from.
* ``UniformConcatDataset``: per-dataset metrics and their ``mean_``
  (reference ``uniform_concat_dataset.py:92-151``).
* ``DataLoader``: the JAX loader's batches: ``img`` (N, H, W, C) float32,
  ``valid_ratio`` (N,), ``img_metas``, ``texts`` and ``n_real``; with
  ``pad_to_batch`` the last batch repeats its last sample up to
  ``batch_size``. With ``shuffle`` the order of an epoch is
  ``random.Random(seed * 100003 + epoch).shuffle``, and every sample is
  drawn with the key ``(seed * 1000003 + epoch) * 1000003 + index``, so a
  sample's augmentation depends on neither the worker count nor the rank.
  Worker processes (``spawn``) run the pipeline and collate whole batches
  through ``torch.utils.data.DataLoader``, reading the dataset from a
  pickle file the loader writes once; ``pin_memory`` hands over
  ``img`` and ``valid_ratio`` as pinned tensors. Under data parallelism
  (``rank``, ``world_size``) every rank walks the same global order and
  takes its contiguous share of each global batch of ``batch_size``.
"""
from __future__ import annotations

import logging
import os
import pickle
import random
import tempfile
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluation import eval_ocr_metric
from ..registry import DATASETS, LOADERS
from .pipelines.transforms import Compose

logger = logging.getLogger(__name__)


@DATASETS.register_module()
class OCRDataset:
    def __init__(self, ann_file: str = '', loader: Dict = None,
                 pipeline: Sequence = (), img_prefix: str = '',
                 test_mode: bool = False, dataset_info=None, **kwargs):
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        loader = dict(loader or {})
        loader.setdefault('ann_file', ann_file)
        self.data_infos = LOADERS.build(loader)
        self.ann_file = self.data_infos.ann_file
        self.pipeline = Compose(pipeline)

    def __len__(self):
        return len(self.data_infos)

    def pre_pipeline(self, results: Dict):
        results['img_prefix'] = self.img_prefix
        results['text'] = results['img_info'].get('text', '')

    def prepare_data(self, index: int, rngs: Optional[Dict] = None
                     ) -> Optional[Dict]:
        results = dict(img_info=self.data_infos[index], **(rngs or {}))
        self.pre_pipeline(results)
        return self.pipeline(results)

    def __getitem__(self, index: int) -> Dict:
        return self.sample(index)

    def sample(self, index: int, key: Optional[int] = None) -> Dict:
        """The pipeline's output for ``index``; with ``key`` its
        augmentations draw from ``seeded_rngs(key)``, which a skipped
        sample's successor goes on drawing from."""
        rngs = seeded_rngs(key) if key is not None else None
        # in test mode a result must stay at its annotation's position
        if self.test_mode:
            data = self.prepare_data(index, rngs)
            if data is None:
                raise RuntimeError(f'test sample {index} was filtered by '
                                   'the pipeline')
            return data
        for _ in range(len(self)):
            try:
                data = self.prepare_data(index, rngs)
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
        return self.sample(index)

    def sample(self, index: int, key: Optional[int] = None) -> Dict:
        for di, cum in enumerate(self.cumsizes):
            if index < cum:
                prev = self.cumsizes[di - 1] if di else 0
                return self.datasets[di].sample(index - prev, key)
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
            name = ds.ann_file or 'dataset'
            for k, v in res.items():
                out[f'{len(ds)}_{name}_{k}'] = v
                all_metrics.setdefault(k, []).append(v)
            start = end
        for k, vals in all_metrics.items():
            out[f'mean_{k}'] = float(f'{np.mean(vals):.4f}')
        return out


class _LazyRandomState:
    """``np.random.RandomState(seed)``, made on its first use (making one
    takes ~0.3 ms, and most samples draw nothing from it)."""

    def __init__(self, seed: int):
        self._seed, self._state = seed, None

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        if self._state is None:
            self._state = np.random.RandomState(self._seed)
        return getattr(self._state, name)


def seeded_rngs(key: int) -> Dict:
    """The generators of the sample of ``key``, seeded as the JAX loader
    seeds ``random`` and ``np.random`` (``tps_pp_tpu/datasets/
    ocr_dataset.py:175-177``)."""
    return {'rng': random.Random(key),
            'np_rng': _LazyRandomState(key % (2 ** 32))}


def sample_key(seed: int, epoch: int, index: int) -> int:
    """The JAX loader's per-sample key."""
    return (seed * 1000003 + epoch) * 1000003 + int(index)


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


# (indices with their keys, rows of the batch, real rows, tensors wanted)
BatchSpec = Tuple[Tuple[Tuple[int, Optional[int]], ...], int, int, bool]


class _BatchFetcher(torch.utils.data.Dataset):
    """Runs the pipeline over one batch's samples and collates them. In a
    worker process it reads the dataset from the pickle file ``path`` on
    its first batch: a worker gets only the path when it starts, so the
    workers start at once and load the dataset side by side (a dataset in
    the start payload makes each start wait for the worker to import
    torch before the payload drains, one worker after another)."""

    def __init__(self, dataset=None, path: Optional[str] = None):
        self._dataset, self.path = dataset, path

    def __getstate__(self):
        return {'_dataset': None, 'path': self.path}

    @property
    def dataset(self):
        if self._dataset is None:
            with open(self.path, 'rb') as f:
                self._dataset = pickle.load(f)
        return self._dataset

    def __getitem__(self, spec: BatchSpec) -> Dict:
        items, rows, n_real, as_tensors = spec
        get = getattr(self.dataset, 'sample', None)
        samples = [get(i, key) if get is not None else self.dataset[i]
                   for i, key in items]
        batch = collate(samples, rows, pad_to_batch=True)
        batch['n_real'] = n_real
        if as_tensors:
            batch['img'] = torch.from_numpy(batch['img'])
            batch['valid_ratio'] = torch.from_numpy(batch['valid_ratio'])
        return batch


def _keep(batch):
    return batch


class _Specs(torch.utils.data.Sampler):
    """The batch specs of the loader's current epoch."""

    def __init__(self, loader: 'DataLoader'):
        self.loader = loader

    def __iter__(self):
        return self.loader.batch_specs()

    def __len__(self):
        return len(self.loader)


class DataLoader:
    """Batches of ``dataset`` (see the module docstring). ``num_workers``
    processes, each ``prefetch`` batches ahead, started on the first
    epoch and kept until ``close``; ``seed`` None is 0."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: Optional[int] = None,
                 pad_to_batch: bool = True, num_workers: int = 0,
                 prefetch: int = 2, pin_memory: bool = False, rank: int = 0,
                 world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f'rank {rank} of {world_size}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed or 0
        self.pad_to_batch = pad_to_batch
        self.pin_memory = pin_memory
        self.rank, self.world_size = rank, world_size
        self._epoch = 0
        workers = int(num_workers)
        fetcher = _BatchFetcher(dataset)
        if workers:
            fd, fetcher.path = tempfile.mkstemp(suffix='.pkl')
            with os.fdopen(fd, 'wb') as f:
                pickle.dump(dataset, f, protocol=pickle.HIGHEST_PROTOCOL)
            self._cleanup = weakref.finalize(self, os.remove, fetcher.path)
        self._loader = torch.utils.data.DataLoader(
            fetcher, batch_size=None, sampler=_Specs(self),
            collate_fn=_keep, num_workers=workers, pin_memory=pin_memory,
            multiprocessing_context='spawn' if workers else None,
            prefetch_factor=max(1, int(prefetch)) if workers else None,
            persistent_workers=workers > 0)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batch_specs(self) -> Iterator[BatchSpec]:
        """This rank's share of each global batch of the epoch: its
        samples with their keys (a share of padding only takes the
        batch's last sample), its number of rows and of real rows."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed * 100003 + self._epoch).shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                break
            rows = self.batch_size if self.pad_to_batch else len(idxs)
            lo = rows * self.rank // self.world_size
            hi = rows * (self.rank + 1) // self.world_size
            mine = idxs[lo:hi] or idxs[-1:]
            n_real = max(0, min(hi, len(idxs)) - lo)
            yield (tuple((i, sample_key(self.seed, self._epoch, i))
                         for i in mine), hi - lo, n_real, self.pin_memory)

    def __iter__(self) -> Iterator[Dict]:
        return iter(self._loader)

    def close(self):
        """Stop the worker processes and remove the dataset's file."""
        it = self._loader._iterator
        self._loader._iterator = None
        if it is not None and hasattr(it, '_shutdown_workers'):
            it._shutdown_workers()
        if hasattr(self, '_cleanup'):
            self._cleanup()


def build_dataset(cfg: Dict, default_args: Optional[Dict] = None):
    cfg = dict(cfg)
    for k, v in (default_args or {}).items():
        cfg.setdefault(k, v)
    return DATASETS.build(cfg)
