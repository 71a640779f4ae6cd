"""Optimizer, schedule and train step (counterpart of
``tps_pp_tpu/parallel/train.py:46-234``), on one device or one device a
rank of a process group (``parallel.dist``).

The JAX package builds one optax chain: clip by global norm -> coupled L2
(``add_decayed_weights``, every optimizer but AdamW) -> the optimizer with
the schedule -> the paramwise lr multipliers. ``OptimizerChain`` is that
chain over ``torch.optim``:

* the gradients are clipped by their global norm, scaled by
  ``max_norm / norm`` when the norm exceeds ``max_norm`` (optax's
  ``clip_by_global_norm``, with no ``+1e-6`` as ``clip_grad_norm_`` has);
* torch's ``weight_decay`` of Adam, Adadelta and SGD is the coupled L2 of
  the chain; AdamW's is decoupled in both (optax's default 1e-4 is kept);
* a multiplier is a parameter group's lr factor, which scales the update
  as the chain's last stage does, the optimizers' updates being linear in
  the lr;
* the schedule is read at the count before the step, as optax does, and
  written into every group's lr.

``custom_keys`` of ``paramwise_cfg`` match as substrings of the torch
parameter names (mmcv's convention; the JAX package matches them against
flax paths), the longest key first.

Under a process group the step averages the gradients over the ranks
before the clip, in buckets flattened into one all-reduce each after the
backward (``dist.all_reduce_mean``), as the mesh's ``psum`` over the data
axis does in JAX; with equal shares of the batch and the loss's mean over
all positions that is the gradient of the global batch's loss. The
metrics are averaged too.

With a ``mesh`` (``parallel.mesh``) whose model axis is above 1, the model
is split over the model group (``parallel.tp``): the gradients and metrics
are averaged over the data group only, BatchNorm's statistics are the data
group's, and the global norm behind ``grad_norm`` and the clip sums each
split parameter's squares over the model group and counts the replicated
ones once (``OptimizerChain.set_model_parallel``).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from . import dist

Schedule = Callable[[int], float]


def make_lr_schedule(base_lr: float, *, policy: str = 'step',
                     warmup_steps: int = 0, warmup_ratio: float = 1e-3,
                     step_epochs=(), steps_per_epoch: int = 1,
                     gamma: float = 0.1, power: float = 0.9,
                     min_lr: float = 0.0, total_steps: int = 0) -> Schedule:
    """Linear warmup, then ``'step'`` (the TPS++ recipe, reference
    configs/_base_/schedules/schedule_adam_step_12e.py: times ``gamma`` at
    each of ``step_epochs``), ``'poly'`` ((lr - min) (1 - t/T)^power + min
    over ``total_steps``) or ``'fixed'``. A function of the step count."""
    boundaries = {int(e * steps_per_epoch): gamma for e in step_epochs}

    def schedule(count: int) -> float:
        lr = base_lr
        if warmup_steps > 0:
            frac = min(count / warmup_steps, 1.0)
            lr = base_lr * (warmup_ratio + (1 - warmup_ratio) * frac)
        if policy == 'poly' and total_steps > 0:
            frac = min(max(count / total_steps, 0.0), 1.0)
            return (lr - min_lr) * (1.0 - frac) ** power + min_lr
        factor = 1.0
        for b in sorted(boundaries):
            if count >= b:
                factor *= boundaries[b]
        return lr * factor

    return schedule


def paramwise_lr_mult(custom_keys: Dict[str, Dict], name: str) -> float:
    """The lr multiplier of the parameter ``name``: that of the longest
    custom key found in it, else 1."""
    for k in sorted(custom_keys, key=len, reverse=True):
        if k in name:
            return float(custom_keys[k].get('lr_mult', 1.0))
    return 1.0


class OptimizerChain:
    """clip by global norm -> ``optimizer`` (whose groups carry ``lr_mult``)
    at ``schedule(count)``. ``step()`` takes the gradients in the
    parameters' ``.grad``; a parameter without one steps with a zero
    gradient, as it does in optax."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule,
                 max_norm: Optional[float] = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0
        self.params: List[torch.Tensor] = [
            p for g in optimizer.param_groups for p in g['params']]
        self._model_group = None
        self._sharded = ()

    def set_model_parallel(self, group, sharded: Iterable[torch.Tensor]):
        """Take the global norm over a model group: the squares of the
        ``sharded`` parameters' gradients summed over ``group``, the other
        parameters' counted once."""
        ids = {id(p) for p in sharded}
        self._model_group = group
        self._sharded = [i for i, p in enumerate(self.params)
                         if id(p) in ids]

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch._foreach_norm(grads)
        if self._model_group is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        sq = torch.stack(norms) ** 2
        split = torch.zeros(len(sq), dtype=torch.bool, device=sq.device)
        split[self._sharded] = True
        sq_split = torch.where(split, sq, 0).sum()
        torch.distributed.all_reduce(sq_split, group=self._model_group)
        return torch.sqrt(torch.where(split, 0, sq).sum() + sq_split)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        """Every parameter's gradient, zeros where it has none."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self) -> torch.Tensor:
        """Clip, set the lr, step; returns the global norm of the gradients
        before clipping (a 0-d tensor, not synchronised)."""
        grads = self.grads()
        norm = self.global_norm(grads)
        if self.max_norm is not None:
            torch._foreach_mul_(grads, torch.clamp(self.max_norm / norm,
                                                   max=1.0))
        lr = float(self.schedule(self.count))
        for group in self.optimizer.param_groups:
            group['lr'] = lr * group['lr_mult']
        self.optimizer.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        """The optimizer's state and the step count the schedule reads."""
        return {'count': self.count, 'optimizer': self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict):
        self.count = int(state['count'])
        self.optimizer.load_state_dict(state['optimizer'])


def _torch_optimizer(opt_type: str, groups: List[Dict], base_lr: float,
                     cfg: Dict) -> torch.optim.Optimizer:
    """The ``torch.optim`` counterpart of optax's ``opt_type`` with the
    config's remaining keys, in torch's names (``betas`` or ``b1``/``b2``,
    ``eps``, ``rho``, ``momentum``, ``nesterov``, ``weight_decay``)."""
    kind = opt_type.lower()
    if kind in ('adam', 'adamw'):
        betas = cfg.pop('betas', None) or (cfg.pop('b1', 0.9),
                                           cfg.pop('b2', 0.999))
        cls = torch.optim.Adam if kind == 'adam' else torch.optim.AdamW
        if kind == 'adamw':
            cfg.setdefault('weight_decay', 1e-4)      # optax.adamw's default
        return cls(groups, lr=base_lr, betas=tuple(betas), **cfg)
    if kind == 'adadelta':
        return torch.optim.Adadelta(groups, lr=base_lr, **cfg)
    if kind == 'sgd':
        if cfg.get('momentum') is None:
            cfg['momentum'] = 0.0
        return torch.optim.SGD(groups, lr=base_lr, **cfg)
    raise ValueError(f'optimizer type {opt_type!r}')


def build_optimizer(cfg: Dict, named_params: Iterable[Tuple[str,
                                                            torch.Tensor]],
                    steps_per_epoch: int = 1
                    ) -> Tuple[OptimizerChain, Schedule]:
    """``(OptimizerChain, schedule)`` from a reference-style optimizer
    config (``type``, ``lr``, ``grad_clip``, ``lr_config``,
    ``paramwise_cfg``, the optimizer's own keys) over ``named_params``
    (``model.named_parameters()``)."""
    cfg = dict(cfg or {})
    opt_type = cfg.pop('type', 'Adam')
    base_lr = cfg.pop('lr', 1e-4)
    grad_clip = cfg.pop('grad_clip', None)
    sched_cfg = dict(cfg.pop('lr_config', None) or {})
    paramwise = cfg.pop('paramwise_cfg', None) or {}
    if sched_cfg.get('warmup') and 'warmup_iters' in sched_cfg:
        it = int(sched_cfg['warmup_iters'])
        sched_cfg.setdefault(
            'warmup_steps',
            it * steps_per_epoch if sched_cfg.get('warmup_by_epoch') else it)
    schedule = make_lr_schedule(
        base_lr,
        policy=sched_cfg.get('policy', 'step'),
        warmup_steps=int(sched_cfg.get('warmup_epochs', 0) * steps_per_epoch)
        or sched_cfg.get('warmup_steps', 0),
        warmup_ratio=sched_cfg.get('warmup_ratio', 1e-3),
        step_epochs=sched_cfg.get('step', ()),
        steps_per_epoch=steps_per_epoch,
        gamma=sched_cfg.get('gamma', 0.1),
        power=sched_cfg.get('power', 0.9),
        min_lr=sched_cfg.get('min_lr', 0.0),
        total_steps=int(sched_cfg.get('total_epochs', 0) * steps_per_epoch))
    custom = paramwise.get('custom_keys') or {}
    by_mult: Dict[float, List[torch.Tensor]] = {}
    for name, p in named_params:
        by_mult.setdefault(paramwise_lr_mult(custom, name), []).append(p)
    groups = [dict(params=ps, lr_mult=m) for m, ps in by_mult.items()]
    optimizer = _torch_optimizer(opt_type, groups, base_lr, cfg)
    max_norm = (float(grad_clip.get('max_norm', 1.0)) if grad_clip
                else None)
    return OptimizerChain(optimizer, schedule, max_norm), schedule


def build_optimizer_from_run_cfg(cfg: Dict, named_params, steps_per_epoch: int,
                                 total_epochs: int
                                 ) -> Tuple[OptimizerChain, Schedule]:
    """The optimizer from a whole run config's reference-layout keys:
    ``optimizer``, ``lr_config`` and ``optimizer_config.grad_clip`` (mmcv
    keeps clipping in its OptimizerHook config); poly decay spans the run."""
    opt_cfg = dict(cfg.get('optimizer') or dict(type='Adam', lr=1e-4))
    opt_cfg['lr_config'] = dict(cfg.get('lr_config', {}) or {})
    opt_cfg['lr_config'].setdefault('total_epochs', total_epochs)
    oc = cfg.get('optimizer_config') or {}
    if oc.get('grad_clip') and 'grad_clip' not in opt_cfg:
        opt_cfg['grad_clip'] = dict(oc['grad_clip'])
    return build_optimizer(opt_cfg, named_params,
                           steps_per_epoch=steps_per_epoch)


def step_generator(seed: int, step: int, device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The dropout generator of ``step``: seeded from ``(seed, step)`` and
    the rank (``rank``, default the process's; a mesh's data index, so
    that the ranks of a model group draw alike), as JAX folds the step
    into its key (``tps_pp_tpu/parallel/train.py:196``), so that a resumed
    run draws the masks the uninterrupted run drew."""
    rank = dist.rank() if rank is None else rank
    key = ((seed * 1000003 + step) * 1000003 + rank) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(key)


def make_train_step(recognizer, optimizer: OptimizerChain,
                    mesh=None) -> Callable:
    """``train_step(batch, generator=None, plain=False) -> metrics``: one
    forward and backward through ``recognizer.compute_loss`` in train mode
    and one optimizer step. The metrics (0-d tensors, not synchronised)
    are ``loss``, each named loss (``loss_ce``) and ``grad_norm``, the
    global norm of the gradients before clipping; under a process group,
    means over the ranks (over the data group of ``mesh`` where its model
    axis is above 1: the model is then split with ``parallel.tp``, and the
    optimizer's norm set with ``set_model_parallel``)."""
    group = (mesh.group('data') if mesh is not None and mesh.distributed
             and mesh.shape['model'] > 1 else None)

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   plain: bool = False) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        with dist.use_data_group(group):
            total, losses = recognizer.compute_loss(batch, generator,
                                                    plain=plain)
            total.backward()
        metrics = {'loss': total.detach(),
                   **{k: v.detach() for k, v in losses.items()}}
        if dist.is_active():
            dist.all_reduce_mean(optimizer.grads(), group=group)
            values = torch.stack(list(metrics.values()))
            dist.all_reduce_mean([values], group=group)
            metrics = dict(zip(metrics, values))
        metrics['grad_norm'] = optimizer.step()
        return metrics

    return train_step
