"""Shared conv building blocks (counterpart of
``tps_pp_tpu/models/layers.py``).

NCHW, as PyTorch's convolutions expect. The trunk's public functions take
and return NHWC (the JAX package's layout) through ``permute`` views, so the
tensors inside are NCHW-shaped with channels-last strides and no copy is
made at either boundary.

``BatchNorm2d`` keeps flax's train-mode statistics (see its docstring);
every BatchNorm of the port is one. Under a process group its statistics
are those of the global batch.
"""
from __future__ import annotations

import itertools
import warnings
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .transformer import dropout as _dropout


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def weights_stamp(module: nn.Module) -> tuple:
    """A value that changes whenever a parameter or buffer of ``module``
    changes: an in-place update (an optimizer step, ``load_state_dict``)
    bumps the tensor's version, a move or cast replaces its storage. Caches
    of values derived from the weights key on it."""
    return tuple((t.data_ptr(), t._version) for t in itertools.chain(
        module.parameters(), module.buffers()))


def cached_per_weights(cache: dict, key, module: nn.Module, make):
    """``make()``, computed once per ``key`` and :func:`weights_stamp` of
    ``module`` and kept in ``cache`` as (stamp, value). While
    ``torch.export`` traces, the parameters are fake tensors without
    storage: the value cached for ``key`` is returned as it is, so that the
    exported program holds it as constants and folds nothing at a call
    (``utils.export`` runs the model eagerly first, which fills the
    cache)."""
    if torch.compiler.is_exporting():
        if key not in cache:
            raise RuntimeError(
                f'{type(module).__name__}: nothing cached for {key} while '
                'torch.export traces; run the model once eagerly first')
        return cache[key][1]
    stamp = weights_stamp(module)
    if cache.get(key, (None,))[0] != stamp:
        cache[key] = (stamp, make())
    return cache[key][1]


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode statistics (``flax.linen
    .BatchNorm``, ``tps_pp_tpu/models/layers.py:56``): the running variance
    takes the *biased* batch variance (torch takes the unbiased one, larger
    by n/(n-1) for n values per channel), and the statistics are computed in
    float32 at least, whatever the input's dtype. ``momentum`` is torch's convention:
    0.1 here is flax's ``momentum=0.9``. Eval mode and the ``state_dict``
    keys are ``nn.BatchNorm2d``'s.

    Under a process group the train-mode statistics are the global batch's,
    as under JAX's mesh, where ``jit`` over the sharded batch reduces across
    it: the count, sum and sum of squares of every rank go through one
    all-reduce, and the backward all-reduces its two sums, so that it is
    the global batch's too (``_GlobalBatchNorm``; ``nn.SyncBatchNorm``
    keeps torch's unbiased running variance and does not run on gloo CPU
    tensors). Under a 2-D mesh the reductions run over the data group
    (``parallel.dist.data_group``); a BatchNorm whose channels tensor
    parallelism splits takes the statistics of this rank's channels."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if dist.is_available() and dist.is_initialized():
            return self._global_batch_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(
                x.to(torch.promote_types(x.dtype, torch.float32)),
                dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_batch_forward(self, x):
        from ..parallel.dist import data_group
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, data_group())
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm1d(BatchNorm2d):
    """:class:`BatchNorm2d`'s statistics over (N, C) features: the same
    module on an (N, C, 1, 1) view, so that the biased running variance,
    the float32 statistics and the global batch under a process group are
    its own; the ``state_dict`` keys are ``nn.BatchNorm1d``'s."""

    def forward(self, x):
        return super().forward(x[:, :, None, None])[:, :, 0, 0]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a process group:
    the forward all-reduces each channel's sum, sum of squares and count;
    the backward all-reduces the sums of the output gradient and of its
    product with the centred input, so that the input gradient is the
    global batch's. The weight and bias gradients stay this rank's, for
    the step's gradient all-reduce. Statistics in float32 at least. Both
    all-reduces run over ``group`` (None: the world).
    Returns (y, mean, biased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group=None):
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([xf.sum(dim=(0, 2, 3)),
                           (xf * xf).sum(dim=(0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0)
        invstd = torch.rsqrt(var + eps)
        scale = invstd * weight
        shift = bias - mean * scale
        y = torch.addcmul(shift.to(x.dtype)[:, None, None], x,
                          scale.to(x.dtype)[:, None, None])
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        g = gy.to(mean.dtype)
        xc = x.to(mean.dtype) - mean[:, None, None]
        sums = torch.cat([g.sum(dim=(0, 2, 3)), (g * xc).sum(dim=(0, 2, 3))])
        d_bias, d_weight = sums[:c].clone(), sums[c:] * invstd
        dist.all_reduce(sums, group=ctx.group)
        k = (weight * invstd)[:, None, None]
        gx = k * (g - (sums[:c] / n)[:, None, None]
                  - xc * (invstd * invstd * sums[c:] / n)[:, None, None])
        return gx.to(x.dtype), d_weight, d_bias, None, None


class ConvModule(nn.Module):
    """Conv2d + optional BatchNorm + ReLU, mmcv ConvModule semantics: the
    conv has a bias iff there is no norm. ``groups`` as ``nn.Conv2d``'s
    (the channel count for a depthwise conv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 use_norm: bool = False, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, _pair(kernel_size),
                              stride=_pair(stride), padding=_pair(padding),
                              groups=groups, bias=not use_norm)
        self.bn = BatchNorm2d(out_channels, eps=1e-5) if use_norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class BasicBlock(nn.Module):
    """ResNet basic block (JAX ``tps_pp_tpu/models/layers.py:67-105``). With
    ``use_conv1x1`` (the default here, the form the ABINet trunks use) it is
    conv1x1 -> conv3x3 with the stride on the 3x3 (reference
    conv_layer.py:31-33); without it, conv3x3 -> conv3x3 with the stride on
    the first, ResNet31's form. ``downsample`` is the reference's
    ``Sequential(conv1x1, bn)`` shortcut."""

    def __init__(self, inplanes: int, planes: int,
                 stride: Union[int, Tuple[int, int]] = 1,
                 use_downsample: bool = False, use_conv1x1: bool = True):
        super().__init__()
        if use_conv1x1:
            self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=_pair(stride),
                                   padding=1, bias=False)
        else:
            self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=_pair(stride),
                                   padding=1, bias=False)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride=_pair(stride), bias=False),
            BatchNorm2d(planes, eps=1e-5)) if use_downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def upsample_nearest(x: torch.Tensor, scale) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW tensor by integer factors."""
    sh, sw = _pair(scale)
    if sh > 1:
        x = x.repeat_interleave(sh, dim=2)
    if sw > 1:
        x = x.repeat_interleave(sw, dim=3)
    return x


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor to ``size`` (h, w) with
    ``jax.image.resize``'s index rule: output i reads input
    ``floor((i + 0.5) * m / n)``, in float32, for an axis of m -> n. For
    an integer ratio that is ``upsample_nearest``; torch's ``'nearest'``
    reads ``floor(i * m / n)`` and differs elsewhere."""
    for dim, n in zip((2, 3), size):
        m = x.shape[dim]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long()
            x = x.index_select(dim, idx.to(x.device))
    return x


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., 'bilinear')`` upsampling of an NCHW tensor:
    half-pixel centres, the edge taps renormalised, which is torch's
    ``align_corners=False`` with its source clamp (PANet's FFM and the
    UNet's up stages)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              out_size: Tuple[int, int],
              batch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RoIAlign of ``boxes`` (N, 4) xyxy in the level's coordinates from
    ``feat`` (B, C, H, W), RoI i from image ``batch[i]`` (0 where None):
    (N, C, out_h, out_w) bilinear samples at the bin centres (one sample a
    bin), the four taps clamped to the map, in one gather (JAX's
    ``roi_align_jax``); differentiable in ``feat``."""
    out_w, out_h = out_size
    B, C, H, W = feat.shape
    dt = feat.dtype
    boxes = boxes.to(dt)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0)
    h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1.0)
    # the bins' centres made on the host: on the card a division by a
    # Python number is a product with its reciprocal, an ulp from the CPU's
    # quotient, which moves a sample by up to an ulp times the box's width
    gys = ((torch.arange(out_h, dtype=dt) + 0.5) / out_h - 0.5).to(
        feat.device)
    gxs = ((torch.arange(out_w, dtype=dt) + 0.5) / out_w - 0.5).to(
        feat.device)
    gy, gx = torch.meshgrid(gys, gxs, indexing='ij')        # (oh, ow)
    px = cx[:, None, None] + gx[None] * w[:, None, None]    # (N, oh, ow)
    py = cy[:, None, None] + gy[None] * h[:, None, None]
    x0 = torch.clamp(torch.floor(px), 0, W - 1)
    y0 = torch.clamp(torch.floor(py), 0, H - 1)
    wx = torch.clamp(px - x0, 0, 1)[..., None]
    wy = torch.clamp(py - y0, 0, 1)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    base = (torch.zeros_like(x0) if batch is None
            else batch.to(feat.device).long()[:, None, None] * (H * W))
    idx = torch.stack([base + y0 * W + x0, base + y0 * W + x1,
                       base + y1 * W + x0, base + y1 * W + x1])
    rows = feat.permute(0, 2, 3, 1).reshape(B * H * W, C)
    # a backward that sums each row's gradients in a fixed order, so that
    # training repeats itself: on the card the indexing backward (a sort,
    # then a sum a segment; index_add_ adds atomically there), on the CPU
    # index_select's (index_add_ in index order; the indexing backward's
    # accumulate follows the threads there)
    flat = idx.flatten()
    taps = rows[flat] if rows.is_cuda else rows.index_select(0, flat)
    f00, f01, f10, f11 = taps.view(*idx.shape, C)    # each (N, oh, ow, C)
    out = ((f00 * (1 - wx) + f01 * wx) * (1 - wy) +
           (f10 * (1 - wx) + f11 * wx) * wy)
    return out.permute(0, 3, 1, 2)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW-shaped view (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window, stride, padding=0) -> torch.Tensor:
    """``nn.MaxPool2d`` over an NCHW tensor, the padding -inf as torch's
    (JAX ``tps_pp_tpu/models/layers.py:107-113``, flax's ``max_pool`` with
    the same pads)."""
    return F.max_pool2d(x, _pair(window), _pair(stride), _pair(padding))


class _Float32Island:
    """Keeps a recurrent module in float32 (or wider) whatever the model is
    cast to: a named float32 island, as the attention scores are one. A
    bf16 model's recurrence keeps float32 weights and state and runs on
    float32 inputs, outside autocast, so that it is the float32 one on every
    model (the JAX package runs its scans in the model's dtype). Why the
    port keeps it so: the CRNN decoder and SAR's / RobustScanner's
    recurrences are short (26-40 steps over at most 512 units), their
    arithmetic small beside the trunk's, while a bf16 state would round the
    carried cell state at every step of the decode. The ``state_dict`` keys
    and shapes are torch's."""

    def _apply(self, fn, recurse=True):
        def keep_wide(t):
            out = fn(t)
            if out.is_floating_point():
                out = out.to(torch.promote_types(out.dtype, torch.float32))
            return out
        return super()._apply(keep_wide, recurse)


class _Float32RNN(_Float32Island):
    """``forward`` and a layer-by-layer run for ``nn.LSTM`` / ``nn.GRU``."""

    def forward(self, x, hx=None):
        """x (N, T, In) in any float dtype -> (out (N, T, D * H), state) in
        the module's dtype."""
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.to(self.weight_ih_l0.dtype), hx)

    def run_layers(self, x: torch.Tensor, rate: float = 0.0,
                   rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """The stacked layers on x (N, T, In) from zero states, with
        ``dropout(rate, rng)`` on the output of every layer but the last,
        as torch's ``dropout=`` and the JAX package's scans apply it in
        training, its masks from ``rng`` (the port's explicit generator).
        Returns the last layer's outputs (N, T, D * H) in the module's
        dtype. At rate 0 it is ``forward``'s one call."""
        if rate == 0.0 or self.num_layers == 1:
            return self(x)[0]
        dirs = 2 if self.bidirectional else 1
        per_layer = len(self._flat_weights) // self.num_layers
        fn = torch.lstm if isinstance(self, nn.LSTM) else torch.gru
        with torch.autocast(x.device.type, enabled=False), \
                warnings.catch_warnings():
            # cuDNN copies one layer's four weights into a buffer of its own
            # at each call (a few MB) and warns that it does
            warnings.filterwarnings('ignore', 'RNN module weights are not')
            y = x.to(self.weight_ih_l0.dtype)
            for k in range(self.num_layers):
                if k:
                    y = _dropout(y, rate, rng)
                w = self._flat_weights[k * per_layer:(k + 1) * per_layer]
                h0 = y.new_zeros((dirs, y.shape[0], self.hidden_size))
                hx = (h0, h0) if isinstance(self, nn.LSTM) else h0
                y = fn(y, hx, w, True, 1, 0.0, self.training,
                       self.bidirectional, True)[0]
        return y

    def cell_step(self, layer: int, x: torch.Tensor, h: torch.Tensor,
                  c: torch.Tensor):
        """One step of layer ``layer`` (forward direction) on x (N, In):
        :func:`rnn_cell_step` with that layer's weights."""
        return rnn_cell_step(
            x, h, c, *(getattr(self, f'{n}_l{layer}') for n in (
                'weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')),
            gru=isinstance(self, nn.GRU))


class Float32LSTM(_Float32RNN, nn.LSTM):
    """``nn.LSTM`` as a float32 island (:class:`_Float32Island`)."""


class Float32GRU(_Float32RNN, nn.GRU):
    """``nn.GRU`` as a float32 island (:class:`_Float32Island`)."""


class _Float32Cell(_Float32Island):
    def step(self, x, h, c):
        """:func:`rnn_cell_step` with the cell's weights."""
        return rnn_cell_step(x, h, c, self.weight_ih, self.weight_hh,
                             self.bias_ih, self.bias_hh,
                             gru=isinstance(self, nn.GRUCell))


class Float32LSTMCell(_Float32Cell, nn.LSTMCell):
    """``nn.LSTMCell`` as a float32 island (:class:`_Float32Island`)."""


class Float32GRUCell(_Float32Cell, nn.GRUCell):
    """``nn.GRUCell`` as a float32 island; ``step`` returns (h, h)."""


def rnn_cell_step(x, h, c, w_ih, w_hh, b_ih, b_hh, gru: bool = False):
    """One step of a torch-gate LSTM cell (gate order i, f, g, o; both
    biases) or, with ``gru``, GRU cell (r, z, n; b_hn inside the reset
    product), in the weights' dtype (float32 or wider: the island), outside
    autocast; x (N, In) and the state (N, H) are cast to it. Returns the new
    (h, c); the GRU returns (h, h), so that the carried c slot stays inert,
    as the reference's ``hx = cx = GRUCell(...)`` (JAX
    ``tps_pp_tpu/models/decoders/robust_scanner.py:26-52``)."""
    dt = w_ih.dtype
    with torch.autocast(x.device.type, enabled=False):
        x, h = x.to(dt), h.to(dt)
        if gru:
            h = torch.gru_cell(x, h, w_ih, w_hh, b_ih, b_hh)
            return h, h
        return torch.lstm_cell(x, (h, c.to(dt)), w_ih, w_hh, b_ih, b_hh)


class BidirectionalLSTM(nn.Module):
    """CRNN's BiLSTM (JAX ``tps_pp_tpu/models/layers.py:230-244``,
    reference ``lstm_layer.py:5-21``): a bidirectional one-layer LSTM
    ``rnn`` (gate order i, f, g, o; both biases; the float32 island of
    :class:`Float32LSTM`) and a ``Linear`` ``embedding`` over the two
    directions' outputs, in the input's dtype. (N, T, in) -> (N, T, out)."""

    def __init__(self, in_channels: int, hidden_size: int, out_channels: int):
        super().__init__()
        self.rnn = Float32LSTM(in_channels, hidden_size, bidirectional=True,
                               batch_first=True)
        self.embedding = nn.Linear(2 * hidden_size, out_channels)

    def forward(self, x):
        h, _ = self.rnn(x)
        return self.embedding(h.to(x.dtype))
