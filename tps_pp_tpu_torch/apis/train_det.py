"""``train_detector``: the detection training loop (counterpart of
``tps_pp_tpu/apis/train_det.py:23-188``, the det half of the reference's
``apis/train.py``).

One process, as the JAX loop: per epoch the seeded
``np.random.default_rng(seed).permutation`` of the dataset, cut into
batches of ``batch_size`` (the last one short); per batch, each item's
targets made on the host where the dataset did not make them
(``build_det_targets``; ``TextDetDataset`` items carry DBNet's), PAN's and
PSE's rescaled to the head's 1/4 (``cv_ops.resize_inter_nearest``;
FCENet's are made at each level's size and TextSnake's at the image's,
neither rescaled, as in JAX), then
one forward and backward in train mode (BatchNorm with flax's statistics,
``models/layers.py``) and one step of the config's optimizer
(``build_optimizer_from_run_cfg``: ``schedule_sgd_1200e`` is SGD 0.007,
momentum 0.9, weight decay 1e-4, poly 0.9 to 1e-7; its ``by_epoch`` is
not read, so the lr decays a step at a time, as in JAX; a ``grad_clip``
where set). Each epoch writes ``epoch_{n}.pth`` (``utils/checkpoint.py``;
JAX writes ``.npz``) with the permutations' ``Generator`` state;
``resume_from`` restores weights, optimizer state, step and that
``Generator`` and goes on at the checkpoint's epoch, so that a resumed run
takes the batches and lrs of the uninterrupted one.

The PAN loss supervises the embeddings of at most ``max_instances`` (24)
instances an image, as JAX does; the first image with more logs a
warning.

DRRG keeps JAX's ``_train_drrg`` loop: one page a step whatever
``batch_size`` says (a log line says so), its targets made in the
permutation's order from ``DRRGTargets``' ``RandomState`` (seeded with
``seed``; JAX draws from numpy's global generator, which
``np.random.seed(seed)`` puts on the same stream), then a no-grad
eval-mode forward whose features and maps, copied to the host, give the
GCN's node features (so the GCN pushes no gradient into the trunk), the
local graphs padded as JAX pads them (nodes to ``1 + k0 (1 + k1)``,
graphs to the next power of two, at least 8; the padded rows enter the
GCN's batch statistics), and the train-mode step on the map losses plus
``loss_gcn``. Its checkpoints also hold the targets' generator state, so
that a resumed epoch draws what the whole run drew.

OCRMaskRCNN keeps JAX's ``_train_maskrcnn`` loop: one page a step whatever
``batch_size`` says, the pages in the order of a
``numpy.random.default_rng(seed)`` permutation an epoch, drawn from the
same ``Generator`` as the RoI samples, as JAX draws them. A page's gt
polygons become boxes and masks (``maskrcnn.poly_boxes_masks``), an
eval-mode forward without gradients gives its RPN maps (the only tensors
copied to the host), the host makes the anchor targets, the proposals, the
RoI sample and the mask targets (``MaskRCNNDetector.train_targets``; a
page with no candidate is skipped and takes no step; ``MaskRCNNBatches``),
then the train-mode step on the five losses (RPN objectness and deltas,
RoI class, deltas and mask). The optimizer's epoch is the dataset's length
in steps, as JAX's. Its epochs run with cuDNN's deterministic algorithms
(the settings before are restored after): a step's RoI sample follows the
proposals of the weights before it, so with cuDNN's default algorithms
(weight gradients summed in another order each run) a resumed run would
part from the whole one.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..datasets.pipelines.cv_ops import resize_inter_nearest
from ..models import textdet  # (also registers targets and losses)
from ..parallel import OptimizerChain, build_optimizer_from_run_cfg
from ..registry import LOSSES, PIPELINES
from ..utils import checkpoint
from .detector import (HEAD_SCALE, build_detector_module,
                       init_detector_weights)

logger = logging.getLogger('tps_pp_tpu_torch')

# the target keys each family's loss reads
_TARGET_KEYS = {
    'DBNet': ('gt_shrink', 'gt_shrink_mask', 'gt_thr', 'gt_thr_mask'),
    'PANet': ('gt_texts', 'gt_kernels', 'gt_mask'),
    'PSENet': ('gt_kernels', 'gt_mask'),
    'TextSnake': ('gt_text_mask', 'gt_center_region_mask', 'gt_mask',
                  'gt_radius_map', 'gt_sin_map', 'gt_cos_map'),
    'FCENet': ('p3_maps', 'p4_maps', 'p5_maps'),
    'DRRG': ('gt_comp_attribs', 'gt_text_mask', 'gt_center_region_mask',
             'gt_mask', 'gt_top_height_map', 'gt_bot_height_map',
             'gt_sin_map', 'gt_cos_map'),
}
# targets that stay on the host (DRRG's components build its graphs there;
# Mask R-CNN's RoI levels pick the level each RoI is pooled from)
_HOST_KEYS = ('gt_comp_attribs', 'lvl')


def build_det_targets(model_cfg: Dict):
    """The config's ``targets`` pipeline, or ``{type}Targets``."""
    cfg = dict(model_cfg.get('targets') or
               {'type': f"{model_cfg.get('type', 'DBNet')}Targets"})
    return PIPELINES.build(cfg)


def _make_optimizer(cfg: Dict, named_params, steps_per_epoch: int = 1,
                    total_epochs: int = 1
                    ) -> Tuple[OptimizerChain, callable]:
    """The run config's optimizer and schedule, Adam 1e-3 where it names
    none (as JAX's ``_make_optimizer``)."""
    run_cfg = dict(cfg)
    run_cfg.setdefault('optimizer', {'type': 'Adam', 'lr': 1e-3})
    return build_optimizer_from_run_cfg(run_cfg, named_params,
                                        steps_per_epoch, total_epochs)


def _rescale(arr: np.ndarray, ratio: float) -> np.ndarray:
    """A target map (H, W) or stack (K, H, W) at ``ratio`` of its size,
    nearest (``cv2.resize(..., INTER_NEAREST)`` in JAX)."""
    arr = np.asarray(arr)
    if ratio == 1.0:
        return arr
    w, h = int(arr.shape[-1] * ratio), int(arr.shape[-2] * ratio)
    if arr.ndim == 2:
        return resize_inter_nearest(arr, w, h)
    return np.stack([resize_inter_nearest(a, w, h) for a in arr])


class DetBatches:
    """Dataset indices -> (image batch, target batch) as numpy on the host,
    as JAX's ``make_batch``: each item's targets made where it has none,
    rescaled to the head's scale; ``seconds`` counts the time taken."""

    def __init__(self, model_cfg: Dict, dataset, loss_fn):
        self.det_type = model_cfg.get('type', 'DBNet')
        self.keys = _TARGET_KEYS[self.det_type]
        self.targets = build_det_targets(model_cfg)
        self.ratio = HEAD_SCALE.get(self.det_type, 1.0)
        self.dataset = dataset
        self.max_instances = getattr(loss_fn, 'max_instances', None)
        self.warned = False
        self.seconds = 0.0

    def __call__(self, indices) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        t0 = time.perf_counter()
        imgs, tgts = [], {k: [] for k in self.keys}
        for i in indices:
            item = self.dataset[int(i)]
            if self.keys[0] not in item:
                item = self.targets(item)
            n_inst = len(item.get('gt_polygons', ()))
            if (self.max_instances and not self.warned
                    and n_inst > self.max_instances):
                logger.warning(
                    'image has %d text instances but the loss supervises '
                    'embeddings for at most max_instances=%d; raise '
                    'model.loss.max_instances', n_inst, self.max_instances)
                self.warned = True
            imgs.append(item['img'])
            for k in self.keys:
                tgts[k].append(_rescale(item[k], self.ratio))
        out = (np.stack(imgs).astype(np.float32),
               {k: np.stack(v) for k, v in tgts.items()})
        self.seconds += time.perf_counter() - t0
        return out

    def state(self) -> Dict:
        """What a checkpoint keeps of the batches: DRRG's targets'
        ``RandomState``."""
        if self.det_type != 'DRRG':
            return {}
        return {'targets_rng': _rng_state(self.targets.rng)}

    def load_state(self, meta: Dict) -> None:
        if self.det_type == 'DRRG':
            _set_rng_state(self.targets.rng, meta['targets_rng'])


def make_det_train_step(model: torch.nn.Module, loss_fn,
                        optimizer: OptimizerChain):
    """``step(img, targets) -> metrics``: one forward and backward of
    ``model`` (in the mode it is in) through ``loss_fn`` and one optimizer
    step. The metrics (0-d tensors, not synchronised) are ``loss``, the
    sum JAX differentiates, each named loss and ``grad_norm``, the global
    norm of the gradients before clipping."""

    def step(img: torch.Tensor, targets: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        return _backward_and_step(loss_fn(model(img), targets), optimizer)

    return step


def _backward_and_step(losses: Dict[str, torch.Tensor],
                       optimizer: OptimizerChain) -> Dict[str, torch.Tensor]:
    """The backward of the losses' sum and one optimizer step: the step's
    metrics."""
    total = sum(losses.values())
    total.backward()
    return {'loss': total.detach(),
            **{k: v.detach() for k, v in losses.items()},
            'grad_norm': optimizer.step()}


def make_drrg_train_step(model: torch.nn.Module, loss_fn,
                         optimizer: OptimizerChain):
    """DRRG's ``step(img, targets) -> metrics`` on one page (JAX's
    ``_train_drrg``): the eval-mode forward without gradients, its features
    and maps on the host, the page's local graphs from its
    ``gt_comp_attribs`` (1, n, 7) numpy, padded as JAX pads them, then the
    train-mode forward, the GCN on the graphs' node features (host
    constants), ``loss_fn`` with ``loss_gcn``, the backward and one
    optimizer step; the metrics of ``make_det_train_step``."""
    graphs = textdet.LocalGraphs()

    def step(img: torch.Tensor, targets: Dict) -> Dict[str, torch.Tensor]:
        targets = dict(targets)
        attribs = np.asarray(targets.pop('gt_comp_attribs')[0])
        model.eval()
        with torch.no_grad():
            feat_cat = torch.cat(model(img), dim=-1)[0].cpu().numpy()
        model.train()
        feats, adjs, knns, links, _, _ = graphs.build(
            feat_cat, attribs, pad_nodes=graphs.pad_nodes,
            pad_graphs=max(8, 1 << (len(attribs) - 1).bit_length()))
        dev = img.device
        optimizer.zero_grad()
        _, maps = model(img)
        gcn_pred = model.head.gcn(torch.from_numpy(feats).to(dev),
                                  torch.from_numpy(adjs).to(dev),
                                  torch.from_numpy(knns).to(dev))
        return _backward_and_step(
            loss_fn(maps, targets, gcn_pred,
                    torch.from_numpy(links).to(dev)), optimizer)

    return step


def _rng_state(rng: np.random.RandomState) -> Dict:
    """A ``RandomState``'s state as tensors and numbers (what a
    ``weights_only`` load reads back)."""
    _, keys, pos, has_gauss, gauss = rng.get_state()
    return dict(keys=torch.from_numpy(keys.astype(np.int64)), pos=int(pos),
                has_gauss=int(has_gauss), gauss=float(gauss))


def _set_rng_state(rng: np.random.RandomState, state: Dict) -> None:
    rng.set_state(('MT19937', state['keys'].numpy().astype(np.uint32),
                   state['pos'], state['has_gauss'], state['gauss']))


def make_maskrcnn_train_step(det, optimizer: OptimizerChain):
    """Mask R-CNN's ``step(img, batch) -> metrics`` on one page:
    ``det.train_losses`` in the model's mode, the backward and one
    optimizer step; the metrics of ``make_det_train_step``."""

    def step(img: torch.Tensor, batch: Dict) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        return _backward_and_step(det.train_losses(img, batch), optimizer)

    return step


class MaskRCNNBatches:
    """A one-page index list -> (the page (1, H, W, 3) on ``device``,
    ``MaskRCNNDetector.train_targets``' arrays), or None where the page has
    no candidate RoI: its gt polygons as boxes and masks
    (``maskrcnn.poly_boxes_masks``), the RPN maps of an eval-mode forward
    (``eval_rpn``), then the host's targets, the RoIs drawn from ``rng``
    (the ``Generator`` that permutes the pages, as in JAX); ``seconds``
    counts the host's targets, not the forward."""

    def __init__(self, det, dataset, device, dtype, rng):
        self.det, self.dataset, self.rng = det, dataset, rng
        self.device, self.dtype = device, dtype
        self.seconds = 0.0

    def __call__(self, indices):
        (i,) = indices
        item = self.dataset[int(i)]
        img = torch.from_numpy(np.asarray(item['img'], np.float32)[None]
                               ).to(self.device, self.dtype)
        hw = tuple(img.shape[1:3])
        t0 = time.perf_counter()
        gt_boxes, gt_masks = textdet.maskrcnn.poly_boxes_masks(
            item.get('gt_polygons', []), *hw)
        self.seconds += time.perf_counter() - t0
        rpn_np = self.det.eval_rpn(img)
        t0 = time.perf_counter()
        batch = self.det.train_targets(rpn_np, hw, gt_boxes, gt_masks,
                                       self.rng)
        self.seconds += time.perf_counter() - t0
        return None if batch is None else (img, batch)

    def state(self) -> Dict:
        return {}

    def load_state(self, meta: Dict) -> None:
        pass


@contextlib.contextmanager
def _deterministic_cudnn(on: bool):
    """cuDNN's deterministic algorithms while the block runs, where ``on``
    (the settings before restored after)."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    if on:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def train_detector(cfg: Dict, train_ds, work_dir: Optional[str] = None,
                   total_epochs: Optional[int] = None, batch_size: int = 4,
                   log_interval: int = 10, seed: int = 0, device=None,
                   model: Optional[torch.nn.Module] = None,
                   resume_from: Optional[str] = None,
                   load_from: Optional[str] = None
                   ) -> Tuple[torch.nn.Module, OptimizerChain, List[Dict]]:
    """Train the detector of ``cfg['model']`` on ``train_ds`` (items with
    ``img`` (H, W, 3) float32 and ``gt_polygons``, or their targets):
    ``model`` if given, else the config's with ``init_detector_weights(seed)``;
    on the card unless ``device`` says otherwise. Returns (the model, the
    optimizer chain, the history: one dict an epoch with the metrics of
    its last step (``loss``, the total JAX's history holds, the named
    losses and ``grad_norm``), the ``lr`` it stepped with, ``steps``,
    ``seconds`` and ``batch_seconds``, the host's share of making
    batches; Mask R-CNN's: the host's targets, not its eval-mode
    forwards; a Mask R-CNN epoch without a step has a NaN ``loss``).
    DRRG and Mask R-CNN train one page a step (the module docstring)."""
    model_cfg = cfg['model']
    det_type = model_cfg.get('type', 'DBNet')
    if det_type in ('DRRG', 'OCRMaskRCNN') and batch_size != 1:
        logger.info('%s trains one page a step, as the JAX loop does; '
                    'batch_size %d is not read', det_type, batch_size)
        batch_size = 1
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('train_detector: no CUDA device; pass '
                               'device="cpu" to train on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if model is None:
        model = init_detector_weights(build_detector_module(model_cfg),
                                      seed)
    model = model.to(device)
    epochs = int(total_epochs or cfg.get('total_epochs') or 1)
    n = len(train_ds)
    if not n:
        raise ValueError('train_detector: the dataset is empty')
    optimizer, schedule = _make_optimizer(
        cfg, model.named_parameters(), max(1, n // batch_size), epochs)
    rng = np.random.default_rng(seed)
    dtype = next(model.parameters()).dtype   # float32, or a float64 model's
    maskrcnn = det_type == 'OCRMaskRCNN'
    if maskrcnn:
        det = textdet.MaskRCNNDetector(
            model, num_train_rois=model_cfg.get('num_train_rois', 64),
            text_repr_type=model_cfg.get('text_repr_type', 'quad'))
        batches = MaskRCNNBatches(det, train_ds, device, dtype, rng)
        step = make_maskrcnn_train_step(det, optimizer)
    else:
        loss_cfg = dict(model_cfg.get('loss') or {'type': f'{det_type}Loss'})
        loss_fn = LOSSES.build(loss_cfg)
        batches = DetBatches(model_cfg, train_ds, loss_fn)
        if det_type == 'DRRG':
            batches.targets.rng = np.random.RandomState(seed)
        step = (make_drrg_train_step if det_type == 'DRRG'
                else make_det_train_step)(model, loss_fn, optimizer)
    if load_from:
        checkpoint.load_weights(model, load_from)
    start = 0
    if resume_from:
        meta = checkpoint.restore(model, optimizer, resume_from)
        rng.bit_generator.state = meta['rng']
        batches.load_state(meta)
        start = min(int(meta['epoch']), epochs)
        logger.info('resumed from %s: epoch %s, step %d', resume_from,
                    meta['epoch'], optimizer.count)
    ckpt = checkpoint.CheckpointManager(work_dir) if work_dir else None
    model.train()
    history: List[Dict] = []
    # Mask R-CNN's epochs repeat themselves on the card (module docstring)
    with _deterministic_cudnn(maskrcnn):
        for epoch in range(start, epochs):
            order = rng.permutation(n)
            t0 = time.perf_counter()
            batches.seconds = 0.0
            losses, lr = {'loss': float('nan')}, schedule(optimizer.count)
            for it in range(0, n, batch_size):
                made = batches(order[it:it + batch_size])
                if made is None:         # a Mask R-CNN page with no RoI
                    continue
                img, tgt = made
                img = torch.as_tensor(img).to(device, dtype,
                                              non_blocking=True)
                tgt = {k: v if k in _HOST_KEYS else
                       torch.as_tensor(v).to(device, non_blocking=True)
                       for k, v in tgt.items()}
                lr = schedule(optimizer.count)
                losses = step(img, tgt)
                if (it // batch_size) % log_interval == 0:
                    logger.info('epoch %d iter %d loss %.4f lr %.3e', epoch,
                                it // batch_size, float(losses['loss']), lr)
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            history.append(dict(epoch=epoch, lr=lr, steps=optimizer.count,
                                seconds=seconds,
                                batch_seconds=batches.seconds,
                                **{k: float(v) for k, v in losses.items()}))
            logger.info('epoch %d done in %.2f s (%.2f s making batches) '
                        'loss %.4f', epoch, seconds, batches.seconds,
                        history[-1]['loss'])
            if ckpt is not None:
                ckpt.save(epoch + 1, model, optimizer, meta=dict(
                    seed=seed, config=checkpoint.config_text(cfg),
                    rng=rng.bit_generator.state, **batches.state()))
    model.eval()
    return model, optimizer, history
