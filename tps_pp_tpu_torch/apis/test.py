"""The evaluation loop (counterpart of ``tps_pp_tpu/apis/test.py:23-123``,
the reference's ``apis/test.py`` single_gpu_test).

Fixed-shape batches from the test-mode ``DataLoader`` go through
``predict`` without bucketing; the first ``n_real`` rows of each are
decoded on the host; the metric is the dataset's ``evaluate``. A
``mesh`` of local devices splits each batch over its data axis
(``predict(mesh=)``, which pads a batch to a multiple of it); the TTA
branch runs unsharded, as in JAX (``tps_pp_tpu/apis/test.py:42``). Several
processes shard the dataset instead (``tools/test.py``).
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List

import numpy as np

from ..datasets.ocr_dataset import DataLoader
from ..datasets.pipelines.test_time_aug import merge_aug_results

logger = logging.getLogger('tps_pp_tpu_torch')


def _decode(rec, out, metas) -> List[Dict]:
    idxs, scores = rec.label_convertor.tensor2idx(out, metas)
    return [dict(text=s, score=sc)
            for s, sc in zip(rec.label_convertor.idx2str(idxs), scores)]


def eval_recognizer(rec, dataset, batch_size: int = 64, metric: str = 'acc',
                    return_results: bool = False, mesh=None):
    """The dataset's metrics over ``rec``'s reading of every sample (and
    the results, with ``return_results``). Logs ms per image, the time of
    ``predict`` and its copy to the host.

    Test-time augmentation: with ``MultiRotateAugOCR`` in the pipeline and
    ``batch_size`` 1, each image's variants run as one batch and
    ``merge_aug_results`` keeps the best reading; at larger batches the
    variants are ignored (reference apis/utils.py:61-98). ``mesh``: see
    the module's docstring."""
    if batch_size == 1 and len(dataset):
        probe = dataset[0]
        if 'aug_imgs' in probe:
            return _eval_recognizer_tta(rec, dataset, probe, metric,
                                        return_results)
    results: List[Dict] = []
    total_time, n_images = 0.0, 0
    for batch in DataLoader(dataset, batch_size, pad_to_batch=True):
        t0 = time.perf_counter()
        out = rec.predict(batch['img'], batch['valid_ratio'],
                          bucket_batch=False, mesh=mesh).cpu().numpy()
        total_time += time.perf_counter() - t0
        n_real = batch['n_real']
        results.extend(_decode(rec, out[:n_real],
                               batch['img_metas'][:n_real]))
        n_images += n_real
    if n_images:
        logger.info('%.2f ms per image (%d images)',
                    1000.0 * total_time / n_images, n_images)
    metrics = dataset.evaluate(results, metric=metric)
    return (metrics, results) if return_results else metrics


def _eval_recognizer_tta(rec, dataset, probe, metric: str,
                         return_results: bool):
    """Batch 1 with rotation variants: each image's variants, padded to the
    variant count, run as one batch; the best reading wins."""
    n_var = int(probe.get('aug_total', 1))
    results: List[Dict] = []
    total_time = 0.0
    for i in range(len(dataset)):
        item = dataset[i]
        imgs = list(item.get('aug_imgs') or [item['img']])
        metas = list(item.get('aug_metas') or
                     [item.get('img_metas', {})] * len(imgs))
        n_real = len(imgs)
        while len(imgs) < n_var:
            imgs.append(imgs[0])
            metas.append(metas[0])
        vr = np.asarray([m.get('valid_ratio', 1.0) or 1.0 for m in metas],
                        np.float32)
        t0 = time.perf_counter()
        out = rec.predict(np.stack(imgs).astype(np.float32), vr,
                          bucket_batch=False).cpu().numpy()
        total_time += time.perf_counter() - t0
        results.append(merge_aug_results(
            _decode(rec, out[:n_real], metas[:n_real])))
    if len(dataset):
        logger.info('%.2f ms per image (%d images, TTA x%d)',
                    1000.0 * total_time / len(dataset), len(dataset), n_var)
    metrics = dataset.evaluate(results, metric=metric)
    return (metrics, results) if return_results else metrics
