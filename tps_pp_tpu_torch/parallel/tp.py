"""Tensor parallelism over a mesh's model group (the port's counterpart of
the JAX package's ``'model'`` axis: ``tps_pp_tpu/parallel/train.py:182-262``
with the placements of ``parallel/mesh.py``).

``shard_model`` keeps, on each rank of a model group, its slice of every
parameter that ``mesh.param_sharding`` splits (and of a split BatchNorm's
running statistics), and hooks the modules so that each Megatron pair ends
in one all-reduce over the model group:

* a column-parallel layer (q/k/v, ``w_1``, a block's ``conv1``) takes the
  replicated activation through ``copy_to_model``: the identity forward,
  an all-reduce of the input's gradient backward (each rank holds the
  part of that gradient its own heads or channels give). An attention
  applies it once to each of its distinct inputs and runs on its own
  heads (``n_head`` divided by the model size);
* a row-parallel layer (the attention's ``fc``, ``w_2``, a block's
  ``conv2``, the classifier) contracts its split input axis and sums the
  parts through ``reduce_from_model``: an all-reduce forward, the identity
  backward; its bias, replicated, is added once after the sum. The
  classifier's input is replicated, so it first takes its own slice
  (``scatter_to_model``, whose backward gathers the slices' gradients);
* an embedding split on its features gathers them after the lookup
  (``gather_from_model``, whose backward keeps the rank's slice).

``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient in
its backward too, which is right where every rank's loss is a different
term; here every rank of a model group computes the same loss, so the
pairs take these functions, whose backward is the other half of the pair.
DTensor's ``ColwiseParallel`` / ``RowwiseParallel`` cover ``nn.Linear``
and ``nn.Embedding`` only, not the convolution pairs.

Dropout draws the same masks on every rank of a model group (their
generators are seeded from the data index): the replicated activations
stay equal, and the attention weights of a rank's heads get a mask of
their own shape.
"""
from __future__ import annotations

import types
from typing import Dict, Optional

import torch
import torch.distributed as tdist
import torch.nn as nn
import torch.nn.functional as F

from ..models.transformer import MultiHeadAttention


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x, dim, group):
    parts = [torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x, dim, group):
    n = tdist.get_world_size(group)
    return x.chunk(n, dim)[tdist.get_rank(group)].contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x, dim, group):
    return _GatherFromModel.apply(x, dim, group)


def scatter_to_model(x, dim, group):
    return _ScatterToModel.apply(x, dim, group)


def _row_forward(self, x):
    """A Linear or Conv2d whose weight holds a slice of its input axis:
    this rank's part of the product, summed over the model group, then the
    bias once."""
    group = self._tp_group
    conv = isinstance(self, nn.Conv2d)
    dim = 1 if conv else -1
    if x.shape[dim] != self.weight.shape[1]:        # a replicated input
        x = scatter_to_model(x, dim, group)
    y = (self._conv_forward(x, self.weight, None) if conv
         else F.linear(x, self.weight))
    y = reduce_from_model(y, group)
    if self.bias is not None:
        y = y + (self.bias[:, None, None] if conv else self.bias)
    return y


def _attn_pre_hook(module, args):
    group = module._tp_group
    seen = {}
    out = []
    for a in args[:3]:
        if id(a) not in seen:
            seen[id(a)] = copy_to_model(a, group)
        out.append(seen[id(a)])
    return tuple(out) + tuple(args[3:])


def _copy_pre_hook(module, args):
    return (copy_to_model(args[0], module._tp_group),) + tuple(args[1:])


def _gather_hook(module, args, out):
    return gather_from_model(out, -1, module._tp_group)


def shard_model(model: nn.Module, mesh, sharding: Dict[str, Optional[int]]):
    """Slice ``model``'s parameters in place to this rank's part of each
    split one (``sharding`` from ``mesh.param_sharding``) and hook its
    modules (see the module's docstring). The parameters stay the same
    ``nn.Parameter`` objects, so an optimizer built before keeps them; its
    state must be sliced too (``shard_optimizer_state``). Call it before
    any backward through the model: autograd keeps a parameter's shape
    from its first backward. Raises
    ``NotImplementedError`` for a split parameter of a module it cannot
    pair."""
    m = mesh.shape['model']
    split = {k: d for k, d in sharding.items() if d is not None}
    model._tp = dict(sharding=split, group=None, size=m)
    if m == 1 or not split:
        return model
    group = mesh.group('model')
    model._tp['group'] = group
    idx = mesh.model_index
    params = dict(model.named_parameters())
    for name, dim in split.items():
        p = params[name]
        p.data = p.data.chunk(m, dim)[idx].clone()
        p.grad = None
    handled = set()
    for mname, mod in model.named_modules():
        pre = f'{mname}.' if mname else ''
        w = split.get(pre + 'weight')
        if isinstance(mod, MultiHeadAttention) and \
                pre + 'linear_q.weight' in split:
            mod.n_head //= m
            mod._tp_group = group
            mod.register_forward_pre_hook(_attn_pre_hook)
            handled.update(pre + f'{n}.weight' for n in
                           ('linear_q', 'linear_k', 'linear_v'))
            handled.update(pre + f'{n}.bias' for n in
                           ('linear_q', 'linear_k', 'linear_v'))
        elif isinstance(mod, (nn.Linear, nn.Conv2d)) and w == 0:
            if pre + 'weight' not in handled:
                mod._tp_group = group
                mod.register_forward_pre_hook(_copy_pre_hook)
            handled.update((pre + 'weight', pre + 'bias'))
        elif isinstance(mod, (nn.Linear, nn.Conv2d)) and w == 1:
            if isinstance(mod, nn.Conv2d) and mod.groups != 1:
                raise NotImplementedError(f'{mname}: a grouped conv')
            mod._tp_group = group
            mod.forward = types.MethodType(_row_forward, mod)
            handled.add(pre + 'weight')
        elif isinstance(mod, nn.Embedding) and w == 1:
            mod._tp_group = group
            mod.register_forward_hook(_gather_hook)
            handled.add(pre + 'weight')
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm) and w == 0:
            for b in (mod.running_mean, mod.running_var):
                b.data = b.data.chunk(m, 0)[idx].clone()
            mod.num_features //= m
            handled.update((pre + 'weight', pre + 'bias'))
    missing = sorted(set(split) - handled)
    if missing:
        raise NotImplementedError(f'tensor parallelism cannot pair the '
                                  f'split parameters {missing}')
    return model


def _split_buffers(model: nn.Module) -> Dict[str, int]:
    """The running statistics of the BatchNorms whose channels are split:
    {state_dict key: 0}."""
    split = model._tp['sharding']
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm) and \
                split.get(f'{mname}.weight') == 0:
            out[f'{mname}.running_mean'] = 0
            out[f'{mname}.running_var'] = 0
    return out


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, '_tp', {}).get('group') is not None


def sharded_parameters(model: nn.Module):
    """The parameters that hold a slice on this rank."""
    split = model._tp['sharding'] if is_sharded(model) else {}
    return [p for n, p in model.named_parameters() if n in split]


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` (every rank of the model group must call):
    each split tensor gathered from its slices."""
    sd = model.state_dict()
    if not is_sharded(model):
        return sd
    group = model._tp['group']
    dims = dict(model._tp['sharding'], **_split_buffers(model))
    return {k: (_gather(v, dims[k], group) if k in dims else v)
            for k, v in sd.items()}


def _optimizer_dims(chain, model: nn.Module) -> Dict[int, int]:
    """{index in the optimizer's state: split dim} of the split
    parameters."""
    dims = {id(p): model._tp['sharding'][n]
            for n, p in model.named_parameters()
            if n in model._tp['sharding']}
    return {i: dims[id(p)] for i, p in enumerate(chain.params)
            if id(p) in dims}


def gather_optimizer_state(chain, model: nn.Module) -> Dict:
    """``chain.state_dict()`` with each split parameter's state tensors
    (those of its shape) gathered (every rank of the model group must
    call)."""
    state = chain.state_dict()
    if not is_sharded(model):
        return state
    group = model._tp['group']
    dims = _optimizer_dims(chain, model)
    inner = state['optimizer']
    out = {}
    for i, st in inner['state'].items():
        p = chain.params[i]
        out[i] = {k: (_gather(v, dims[i], group)
                      if i in dims and torch.is_tensor(v)
                      and v.shape == p.shape else v)
                  for k, v in st.items()}
    return dict(state, optimizer=dict(inner, state=out))


def shard_optimizer_state(chain, model: nn.Module):
    """Slice the state of each split parameter that a resume restored
    whole, after ``shard_model``."""
    if not is_sharded(model):
        return
    group = model._tp['group']
    m = model._tp['size']
    for i, dim in _optimizer_dims(chain, model).items():
        p = chain.params[i]
        st = chain.optimizer.state.get(p, {})
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() == p.dim() and \
                    v.shape[dim] == p.shape[dim] * m:
                st[k] = v.chunk(m, dim)[tdist.get_rank(group)].clone()
