"""KIE (SDMGR) and NER (BERT-softmax) training, and the models the
evaluation builds (counterpart of ``tps_pp_tpu/apis/train_kie.py``; the
reference trains both through ``tools/train.py``: SDMGR by
``kie/extractors/sdmgr.py:16``, NER by
``ner/classifiers/ner_classifier.py:8``).

Both loops are JAX's ``_epoch_loop``: per epoch the seeded
``np.random.default_rng(seed).permutation`` of the dataset in batches of
``batch_size``, a short tail padded by repeating indices (so that a
dataset smaller than the batch still trains), one forward and backward in
train mode and one step of the config's optimizer (``_make_optimizer`` of
``train_det.py``: Adam 1e-3 where the config names none). The optimizer's
epoch is JAX's: ``len(train_ds)`` steps for KIE, ``len(train_ds) //
batch_size`` (at least 1) for NER, while either loop runs
``ceil(n / batch_size)`` steps an epoch; a KIE step policy at epochs
[40, 50] therefore drops the lr ``batch_size`` times later than the config
says (ROADMAP.md queue 3 keeps this, for parity with the JAX loop). Each
epoch writes ``epoch_{n}.pth`` (``utils/checkpoint.py``) with the
permutations' ``Generator`` state; ``resume_from`` goes on from one,
``load_from`` takes its weights only.

SDMGR trains with the UNet where the config has ``visual_modality`` and
the dataset gives images (``KIEDataset(with_visual=True)``), its
BatchNorm in train mode with flax's statistics; NER's dropout masks come
from a ``torch.Generator`` seeded from (seed, step)
(``parallel.train.step_generator``). Everything runs on the card unless
``device='cpu'``. No path launches a hand-written kernel.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models import common  # noqa: F401 (registers the UNet)
from ..models.kie.sdmgr import SDMGR, build_sdmgr, roi_visual_pool
from ..models.ner.bert import NerClassifier
from ..parallel import OptimizerChain
from ..parallel.train import step_generator
from ..registry import LOSSES
from ..utils import checkpoint
from ..utils.convert import load_pth
from .train_det import _backward_and_step, _make_optimizer

logger = logging.getLogger('tps_pp_tpu_torch')

KIE_TYPES = ('SDMGR',)
NER_TYPES = ('NerClassifier',)
# the item keys a training batch stacks
KIE_KEYS = ('relations', 'texts', 'labels', 'edge_labels')
NER_KEYS = ('input_ids', 'attention_mask', 'labels')

__all__ = ['KIE_TYPES', 'NER_TYPES', 'train_kie', 'train_ner',
           'make_kie_step', 'make_ner_step', 'build_sdmgr_apply',
           'build_ner_model', 'build_task_dataset', 'init_kie_weights',
           'roi_visual_pool']


def resolve_device(device, what: str) -> torch.device:
    """``device``, or the CUDA device when None, and a ``RuntimeError``
    if there is none (``device='cpu'`` asks for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f'{what}: no CUDA device; pass device="cpu" '
                               'to run on the CPU')
        device = 'cuda'
    return torch.device(device)


def init_kie_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded ``torch.Generator`` on the CPU (the
    same values on every device): convolutions and linear layers uniform
    with variance 1/fan_in and zero biases, embeddings normal with
    variance 1/width, the LSTM uniform in +-1/sqrt(hidden) (torch's and
    the JAX package's), BatchNorm and LayerNorm as torch resets them."""
    g = torch.Generator().manual_seed(seed)

    def uniform(t, b):
        t.copy_(torch.empty(t.shape).uniform_(-b, b, generator=g))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                uniform(m.weight, (3.0 / m.weight[0].numel()) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / m.embedding_dim ** 0.5)
            elif isinstance(m, nn.LSTM):
                for p in m.parameters():
                    uniform(p, m.hidden_size ** -0.5)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
    return model


def _load(model: nn.Module, path: Optional[str]) -> nn.Module:
    if path:
        model.load_state_dict(load_pth(checkpoint.resolve(path)),
                              strict=True)
    return model


def _epoch_loop(n: int, batch_size: int, epochs: int,
                rng: np.random.Generator, make_batch: Callable,
                run_step: Callable, save: Callable, optimizer,
                schedule, log_interval: int, start: int = 0) -> List[Dict]:
    """JAX's ``_epoch_loop`` from epoch ``start``: one dict an epoch with
    the metrics of its last step (``loss``, the named losses,
    ``grad_norm``), its ``lr``, ``steps`` and ``seconds``."""
    if not n:
        raise ValueError('the dataset is empty')
    history = []
    for epoch in range(start, epochs):
        order = rng.permutation(n)
        t0 = time.perf_counter()
        metrics, lr = {'loss': float('nan')}, schedule(optimizer.count)
        for it in range(0, n, batch_size):
            idx = order[it:it + batch_size]
            if len(idx) < batch_size:
                reps = -(-batch_size // max(n, 1))   # n may be < batch_size
                idx = np.concatenate([idx] + [order] * reps)[:batch_size]
            lr = schedule(optimizer.count)
            metrics = run_step(make_batch(idx))
            if (it // batch_size) % log_interval == 0:
                logger.info('epoch %d iter %d loss %.4f lr %.3e', epoch,
                            it // batch_size, float(metrics['loss']), lr)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(dict(epoch=epoch, lr=lr, steps=optimizer.count,
                            seconds=time.perf_counter() - t0, **metrics))
        logger.info('epoch %d done in %.2f s loss %.4f', epoch,
                    history[-1]['seconds'], history[-1]['loss'])
        save(epoch)
    return history


def _run(cfg: Dict, model: nn.Module, train_ds, steps_per_epoch: int,
         epochs: int, batch_size: int, seed: int, work_dir, resume_from,
         load_from, log_interval: int, make_batch, make_step
         ) -> Tuple[nn.Module, OptimizerChain, List[Dict]]:
    """The optimizer, ``load_from`` / ``resume_from``, the epochs and the
    checkpoints, shared by both loops."""
    optimizer, schedule = _make_optimizer(
        cfg, model.named_parameters(), steps_per_epoch, epochs)
    rng = np.random.default_rng(seed)
    _load(model, load_from)
    start = 0
    if resume_from:
        meta = checkpoint.restore(model, optimizer, resume_from)
        rng.bit_generator.state = meta['rng']
        start = min(int(meta['epoch']), epochs)
        logger.info('resumed from %s: epoch %s, step %d', resume_from,
                    meta['epoch'], optimizer.count)
    ckpt = checkpoint.CheckpointManager(work_dir) if work_dir else None

    def save(epoch):
        if ckpt is not None:
            ckpt.save(epoch + 1, model, optimizer, meta=dict(
                seed=seed, config=checkpoint.config_text(cfg),
                rng=rng.bit_generator.state))

    model.train()
    history = _epoch_loop(len(train_ds), batch_size, epochs, rng,
                          make_batch, make_step(optimizer), save, optimizer,
                          schedule, log_interval, start)
    model.eval()
    return model, optimizer, history


def _batch(train_ds, indices, keys, device) -> List[torch.Tensor]:
    items = [train_ds[int(i)] for i in indices]
    return [torch.from_numpy(np.stack([it[k] for it in items])).to(device)
            for k in keys]


def train_kie(cfg: Dict, train_ds, work_dir: Optional[str] = None,
              total_epochs: Optional[int] = None, batch_size: int = 4,
              log_interval: int = 10, seed: int = 0, device=None,
              model: Optional[SDMGR] = None,
              resume_from: Optional[str] = None,
              load_from: Optional[str] = None
              ) -> Tuple[SDMGR, OptimizerChain, List[Dict]]:
    """Train SDMGR (reference ``sdmgr.py`` forward_train +
    ``sdmgr_loss.py``) on ``train_ds`` (``KIEDataset`` items): ``model``
    if given, else the config's with ``init_kie_weights(seed)``, visual
    where the config has ``visual_modality`` and the items carry ``img``.
    Returns (the model, the optimizer chain, the history)."""
    device = resolve_device(device, 'train_kie')
    model_cfg = cfg['model']
    loss_fn = LOSSES.build(dict(model_cfg.get('loss') or
                                {'type': 'SDMGRLoss'}))
    visual = bool(model_cfg.get('visual_modality')) and 'img' in train_ds[0]
    if model is None:
        model = init_kie_weights(build_sdmgr(model_cfg, visual), seed)
    model = model.to(device)
    keys = KIE_KEYS + (('img', 'boxes') if model.visual else ())
    epochs = int(total_epochs or cfg.get('total_epochs') or 1)
    return _run(cfg, model, train_ds, max(1, len(train_ds)), epochs,
                batch_size, seed, work_dir, resume_from, load_from,
                log_interval, lambda idx: _batch(train_ds, idx, keys, device),
                lambda opt: make_kie_step(model, loss_fn, opt))


def make_kie_step(model: SDMGR, loss_fn, optimizer: OptimizerChain):
    """``step(batch) -> metrics``: SDMGR's forward and backward on
    ``batch`` (the tensors of ``KIE_KEYS``, then ``img`` and ``boxes``
    where the model is visual) through ``loss_fn``, in the mode the model
    is in, and one optimizer step; the metrics of
    ``train_det.make_det_train_step``."""
    C = model.head.num_classes

    def step(batch):
        relations, texts, labels, edge_labels, *vis = batch
        optimizer.zero_grad()
        node_cls, edge_cls = model(relations, texts, *vis)
        return _backward_and_step(loss_fn(
            node_cls.reshape(-1, C), edge_cls.reshape(-1, 2),
            labels.reshape(-1), edge_labels.reshape(-1)), optimizer)
    return step


def make_ner_step(model: NerClassifier, loss_fn, optimizer: OptimizerChain,
                  seed: int = 0):
    """``step(batch) -> metrics``: the classifier's forward and backward
    on ``batch`` (the tensors of ``NER_KEYS``), its dropout masks from
    ``step_generator(seed, step)``, and one optimizer step."""

    def step(batch):
        ids, mask, labels = batch
        gen = step_generator(seed, optimizer.count, ids.device)
        optimizer.zero_grad()
        return _backward_and_step(
            loss_fn(model(ids, mask, rng=gen), labels, mask), optimizer)
    return step


def train_ner(cfg: Dict, train_ds, work_dir: Optional[str] = None,
              total_epochs: Optional[int] = None, batch_size: int = 8,
              log_interval: int = 10, seed: int = 0, device=None,
              model: Optional[NerClassifier] = None,
              resume_from: Optional[str] = None,
              load_from: Optional[str] = None
              ) -> Tuple[NerClassifier, OptimizerChain, List[Dict]]:
    """Train the BERT-softmax classifier (reference
    ``ner_classifier.py`` forward_train) on ``train_ds`` (``NerDataset``
    items), as ``train_kie``; dropout from ``step_generator(seed,
    step)``."""
    device = resolve_device(device, 'train_ner')
    model_cfg = cfg['model']
    loss_fn = LOSSES.build(dict(model_cfg.get('loss') or
                                {'type': 'MaskedCrossEntropyLoss'}))
    if model is None:
        model = init_kie_weights(NerClassifier(model_cfg), seed)
    model = model.to(device)
    epochs = int(total_epochs or cfg.get('total_epochs') or 1)
    return _run(cfg, model, train_ds, max(1, len(train_ds) // batch_size),
                epochs, batch_size, seed, work_dir, resume_from, load_from,
                log_interval,
                lambda idx: _batch(train_ds, idx, NER_KEYS, device),
                lambda opt: make_ner_step(model, loss_fn, opt, seed))


def build_sdmgr_apply(cfg: Dict, checkpoint_path: Optional[str],
                      sample: Dict, device=None, seed: int = 0):
    """SDMGR inference for the evaluation: ``(apply, model, visual)``
    where ``apply(model, item) -> (node logits (N, C), edge logits
    (N * N, 2))`` on one dataset item, under ``torch.inference_mode``;
    visual as ``train_kie`` decides it from ``sample``; the ``.pth``'s
    weights (strict) where given, else ``init_kie_weights(seed)``."""
    device = resolve_device(device, 'build_sdmgr_apply')
    model_cfg = cfg['model']
    visual = bool(model_cfg.get('visual_modality')) and 'img' in sample
    model = _load(init_kie_weights(build_sdmgr(model_cfg, visual), seed),
                  checkpoint_path).to(device).eval()

    def apply(m, item):
        keys = ['relations', 'texts'] + (['img', 'boxes'] if visual else [])
        with torch.inference_mode():
            node_cls, edge_cls = m(*(torch.from_numpy(
                np.asarray(item[k]))[None].to(device) for k in keys))
        return node_cls[0], edge_cls[0]

    return apply, model, visual


def build_ner_model(cfg: Dict, checkpoint_path: Optional[str] = None,
                    device=None, seed: int = 0) -> NerClassifier:
    """The config's NerClassifier in eval mode on ``device`` (the card
    unless ``'cpu'``): the ``.pth``'s weights where given, else
    ``init_kie_weights(seed)``."""
    device = resolve_device(device, 'build_ner_model')
    model = init_kie_weights(NerClassifier(cfg['model']), seed)
    return _load(model, checkpoint_path).to(device).eval()


def build_task_dataset(cfg: Dict, split: str = 'train', **overrides):
    """The KIE or NER dataset of the config's ``data[split]``, built from
    ``DATASETS`` by its ``type``; ``overrides`` (e.g. ``images``) go to its
    constructor."""
    from ..datasets import build_dataset
    return build_dataset(dict(cfg['data'][split], **overrides))
