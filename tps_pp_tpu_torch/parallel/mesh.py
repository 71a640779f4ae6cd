"""The ('data', 'model') device mesh and its placement rules (counterpart of
``tps_pp_tpu/parallel/mesh.py:30-131``).

A mesh is a grid of devices, ``data`` rows by ``model`` columns. It comes in
two forms:

* in one process, its devices are local ``torch.device``s, and a device may
  be listed more than once (a one-card machine then drives the split with
  two shards on its card; the CPU tests build eight CPU "devices").
  ``TextRecognizer.predict(mesh=)`` runs one shard of the batch a data row,
  each on its own replica of the model, from one host thread a card;
* under a process group, its devices are the ranks, one card each, and the
  mesh carries a process group for each axis: ``group('data')`` joins the
  ranks that hold the same shard of the model (the gradient mean and
  BatchNorm's statistics reduce over it), ``group('model')`` the ranks
  that split one model (tensor parallelism, ``parallel.tp``).

``param_sharding`` applies the JAX package's name-pattern rules
(``_TP_RULES``, the Megatron pairing: q/k/v and FFN-in split their outputs,
the attention's output projection and FFN-out their inputs; each residual
block's ``conv1`` its output channels with ``bn1``, ``conv2`` its input
channels; embeddings their features; the classifier its input) to the
port's parameter names. The rules are written against flax paths, so each
torch name is first taken to its flax leaf through the conversion tables
of ``utils.convert`` (the reference's torch name beside the flax path), and
the spec's axis moves with the transpose between the two layouts: a flax
Dense kernel is (in, out), a torch Linear weight (out, in); a flax Conv
kernel (kh, kw, in, out), a torch one (out, in, kh, kw). A parameter whose
conversion kind has no one-to-one layout (packed attention, recurrences)
stays replicated.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import dist


class Mesh:
    """``data`` x ``model`` devices; see the module's docstring."""

    def __init__(self, grid: Sequence[Sequence], groups=None, coords=(0, 0)):
        self.grid = [list(row) for row in grid]
        self.shape = {'data': len(self.grid), 'model': len(self.grid[0])}
        self.groups = groups          # {'data': group, 'model': group}
        self.coords = tuple(coords)   # this rank's (data, model) index

    @property
    def devices(self) -> List:
        return [d for row in self.grid for d in row]

    @property
    def distributed(self) -> bool:
        """True when the devices are the ranks of a process group."""
        return self.groups is not None

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    def group(self, axis: str):
        if not self.distributed:
            raise ValueError('a mesh of local devices has no process groups')
        return self.groups[axis]

    def data_devices(self) -> List[torch.device]:
        """The device of each data row (its first column): where
        ``predict(mesh=)`` runs that row's shard."""
        if self.distributed:
            raise ValueError('predict(mesh=) takes a mesh of local devices; '
                             'under a process group each rank predicts its '
                             'own shard')
        return [row[0] for row in self.grid]

    def __repr__(self):
        return f'Mesh({self.shape}, devices={[str(d) for d in self.devices]})'


def _local_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device('cuda', i) for i in range(n)]
            or [torch.device('cpu')])


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices=None) -> Mesh:
    """('data', 'model') mesh. Defaults to all devices on the data axis: the
    ranks of the process group when one is active (every rank must call
    this, in the same order, since it makes the axes' groups), else the
    local CUDA devices (the CPU when there is none). ``devices`` may list a
    local device more than once."""
    if devices is None:
        devices = (list(range(dist.world_size())) if dist.is_active()
                   else _local_devices())
    devices = list(devices)
    n = len(devices)
    if data is None:
        assert n % model == 0
        data = n // model
    assert data * model == n, f'{data}x{model} != {n} devices'
    grid = [devices[i * model:(i + 1) * model] for i in range(data)]
    if not dist.is_active() or not all(isinstance(d, int) for d in devices):
        return Mesh([[torch.device(d) for d in row] for row in grid])
    if sorted(devices) != list(range(dist.world_size())):
        raise ValueError(f'a mesh under a process group lists every rank '
                         f'once, got {devices}')
    me = dist.rank()
    groups, coords = {}, None
    for i, row in enumerate(grid):                 # the model groups
        g = torch.distributed.new_group(row)
        if me in row:
            groups['model'], coords = g, (i, row.index(me))
    for j in range(model):                         # the data groups
        col = [row[j] for row in grid]
        g = torch.distributed.new_group(col)
        if me in col:
            groups['data'] = g
    return Mesh(grid, groups, coords)


# name-pattern -> spec over the flax leaf's dims (JAX ``mesh.py:45-74``)
_TP_RULES = [
    # attention: split heads on the output of q/k/v, input of the out-proj
    (re.compile(r'.*(linear_q|linear_k|linear_v)/kernel$'), (None, 'model')),
    (re.compile(r'.*(linear_q|linear_k|linear_v)/bias$'), ('model',)),
    (re.compile(r'.*(self_attn|enc_attn|attn)/fc/kernel$'), ('model', None)),
    # ffn: split d_inner
    (re.compile(r'.*(mlp/w_1|w_1)/kernel$'), (None, 'model')),
    (re.compile(r'.*(mlp/w_1|w_1)/bias$'), ('model',)),
    (re.compile(r'.*(mlp/w_2|w_2)/kernel$'), ('model', None)),
    # residual blocks: conv1 splits its output channels, bn1 follows,
    # conv2 contracts them
    (re.compile(r'.*block\d+/conv1/kernel$'), (None, None, None, 'model')),
    (re.compile(r'.*block\d+/bn1/(scale|bias)$'), ('model',)),
    (re.compile(r'.*block\d+/conv2/kernel$'), (None, None, 'model', None)),
    # embeddings: split the feature axis
    (re.compile(r'.*emb[^/]*/embedding$'), (None, 'model')),
    # classifier head: contract d_model
    (re.compile(r'.*classifier/kernel$'), ('model', None)),
]

# conversion kind -> {torch suffix: (flax leaf, flax dim of each torch dim)}
_LAYOUTS = {
    'conv': {'weight': ('kernel', (3, 2, 0, 1)), 'bias': ('bias', (0,))},
    'conv1x1_as_dense': {'weight': ('kernel', (1, 0, None, None)),
                         'bias': ('bias', (0,))},
    'linear': {'weight': ('kernel', (1, 0)), 'bias': ('bias', (0,))},
    'ln': {'weight': ('scale', (0,)), 'bias': ('bias', (0,))},
    'bn': {'weight': ('scale', (0,)), 'bias': ('bias', (0,))},
    'embed': {'weight': ('embedding', (0, 1))},
}
for _k in ('conv', 'conv1x1_as_dense', 'linear'):
    _LAYOUTS[_k + '_nobias'] = _LAYOUTS[_k]


def flax_leaf(name: str, rules: Iterable[Tuple[str, str, str]]
              ) -> Optional[Tuple[str, Tuple]]:
    """(flax path of the leaf, flax dim of each torch dim) of the torch
    parameter ``name`` under the conversion ``rules``, or None where its
    kind has no one-to-one layout."""
    prefix, _, suffix = name.rpartition('.')
    for tp, fp, kind in rules:
        if tp == prefix and suffix in _LAYOUTS.get(kind, {}):
            leaf, dims = _LAYOUTS[kind][suffix]
            return f'{fp}/{leaf}', dims
    return None


def _torch_dim(spec: Tuple, dims: Tuple, shape, mesh: Mesh) -> Optional[int]:
    """The torch dim that ``spec`` (over the flax dims) shards, or None
    where it replicates or does not fit (JAX ``_spec_fits``)."""
    flax_ndim = sum(d is not None for d in dims)
    flax_shape = [None] * flax_ndim
    for t, f in enumerate(dims):
        if f is not None:
            flax_shape[f] = shape[t]
    out = None
    for f, axis in enumerate(spec):
        if axis is None:
            continue
        if f >= flax_ndim or flax_shape[f] % mesh.shape[axis] != 0:
            return None
        out = dims.index(f)
    return out


def param_sharding(named_params, mesh: Mesh,
                   rules: Iterable[Tuple[str, str, str]]
                   ) -> Dict[str, Optional[int]]:
    """``{name: dim}`` for every parameter of ``named_params`` (a module or
    its ``named_parameters()``): the torch dim split over ``'model'``, or
    None for replicated. ``rules`` are the conversion rules of the model
    (``utils.convert.rules_for_config``), which pair each torch name with
    its flax path. With ``model`` 1 everything is replicated."""
    if isinstance(named_params, torch.nn.Module):
        named_params = named_params.named_parameters()
    rules = list(rules)
    out = {}
    for name, p in named_params:
        dim = None
        if mesh.shape['model'] > 1:
            leaf = flax_leaf(name, rules)
            if leaf is not None:
                path, dims = leaf
                for pat, spec in _TP_RULES:
                    if pat.match(path):
                        dim = _torch_dim(spec, dims, p.shape, mesh)
                        break
        out[name] = dim
    return out
