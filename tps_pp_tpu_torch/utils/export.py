"""Export and ahead-of-time capture of a recognizer's serving path
(counterpart of ``tps_pp_tpu/utils/export.py``, the reference's
``tools/deployment`` chain of ONNX export, TensorRT engine and the
recognizer subclasses that serve them).

* ``export_serialized``: ``torch.export`` of ``TextRecognizer._predict_impl``
  on the serving model (``serving_model()``, the bf16 copy where the
  parameters are float32) at a fixed batch, saved to bytes with
  ``torch.export.save``; ``load_serialized`` loads it back. The kernels are
  the operators of ``torch.ops.tps_pp`` (``ops._lib.define_op``), one node
  each in the graph; on CUDA tensors they launch the kernels, on CPU
  tensors they run the plain versions.
* ``aot_compile``: a call with no first-call cost at a fixed shape, the
  counterpart of JAX's lower-and-compile. On CUDA, ``_predict_impl``
  captured once in a ``torch.cuda.CUDAGraph`` over static input buffers;
  a call copies into them and replays. On the CPU, the fixed-shape call
  itself.
* ``ExportedRecognizer``: JAX's ``simple_test`` surface over
  ``aot_compile``, padding a smaller batch to the compiled one.

Weights: the folded encoder and decoder weights and the TPS matrices are
computed by an eager call before the trace (``models.layers.
cached_per_weights``) and are constants of the exported program, so a call
folds nothing; the parameters themselves are its state. A captured graph
reads every weight through the pointer it was captured with.

Every decode mode traces. The whole decodes (``fused40_bf16``,
``fused40``) keep their early exit inside kernel 4. The greedy ``steps``
loop with its early exit takes its device form in a trace and a capture
(``_predict_impl(..., device_exit=True)``, ``models/decoders/base.py``):
all ``max_seq_len`` steps, each zeroed on the device where every row
ended before it, with the flag handed to the fused step's kernels, which
skip the step; eager ``predict`` reads the flag on the host instead.
``steps`` with ``early_exit`` off, beam search (which has no early exit)
and the single pass of a CTC decoder trace as fixed loops.
"""
from __future__ import annotations

import io
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops import gemm as _gemm  # noqa: F401 (its operators)
from ..ops.decode_step import cross_ffn_step, self_attn_step
from ..ops.encoder import encoder_forward
from ..ops.full_decode import full_decode
from ..ops.grid_sample import grid_sample_forward
from ..ops.stem import basic_block_cp
from ..ops.tps_sampler import tps_sampler

# the counters of the kernels a serving path may launch, by name
_COUNTERS = {
    'tps_sampler': (tps_sampler, 'launches'),
    'tps_sampler_twostage': (tps_sampler, 'launches_twostage'),
    'encoder': (encoder_forward, 'launches'),
    'full_decode': (full_decode, 'launches'),
    'full_decode_int8': (full_decode, 'launches_int8'),
    'self_attn_step': (self_attn_step, 'launches'),
    'cross_ffn_step': (cross_ffn_step, 'launches'),
    'grid_sample_forward': (grid_sample_forward, 'launches'),
    'basic_block_cp': (basic_block_cp, 'launches'),
}


def launch_counts() -> dict:
    """The launch counters of the serving kernels, by name."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _COUNTERS.items()}


class _Serving(nn.Module):
    """``rec._predict_impl`` on ``model`` as a module, for the trace."""

    def __init__(self, rec, model: nn.Module):
        super().__init__()
        self.model = model
        self.rec = rec

    def forward(self, img: torch.Tensor, valid_ratio: torch.Tensor):
        return self.rec._predict_impl(self.model, img, valid_ratio,
                                      device_exit=True)


def _inputs(rec, batch: int, input_shape: Tuple[int, int, int], dtype):
    h, w, c = input_shape
    img = torch.zeros((batch, h, w, c), dtype=dtype or rec.dtype,
                      device=rec.device)
    vr = torch.ones((batch,), dtype=torch.float32, device=rec.device)
    return img, vr


def export_program(rec, batch: int, input_shape: Tuple[int, int, int],
                   dtype: Optional[torch.dtype] = None):
    """The ``torch.export.ExportedProgram`` of ``rec``'s serving path on
    (batch, *input_shape) images of ``dtype`` (default: the recognizer's
    compute dtype) and (batch,) float32 valid ratios, traced on the
    recognizer's device in eval mode under ``torch.no_grad()`` after one
    eager call that fills the weight caches."""
    img, vr = _inputs(rec, batch, input_shape, dtype)
    model = rec.serving_model()
    with rec._mode(model, False), torch.no_grad():
        rec._predict_impl(model, img, vr)
        return torch.export.export(_Serving(rec, model), (img, vr))


def export_serialized(rec, batch: int, input_shape: Tuple[int, int, int],
                      dtype: Optional[torch.dtype] = None) -> bytes:
    """:func:`export_program` saved with ``torch.export.save``, as bytes."""
    buf = io.BytesIO()
    torch.export.save(export_program(rec, batch, input_shape, dtype), buf)
    return buf.getvalue()


def load_serialized(blob: bytes):
    """The ``ExportedProgram`` of :func:`export_serialized`'s bytes; the
    port's operators are registered first (this module imports ``ops``).
    Call it as ``ep.module()(img, valid_ratio)`` under ``torch.no_grad()``."""
    return torch.export.load(io.BytesIO(blob))


class AotCall:
    """``rec._predict_impl`` at one input shape, with no first-call cost.
    On CUDA a ``torch.cuda.CUDAGraph`` captured over static buffers: a call
    copies ``img`` and ``valid_ratio`` into them, replays the graph and
    returns the static output (overwritten by the next call; clone it to
    keep it). ``capture_ms`` is the capture's host time, ``pool_bytes`` the
    device memory the graph's pool reserved, ``captured_launches`` the
    kernels' launches recorded into the graph. On the CPU, the call
    itself."""

    def __init__(self, rec, batch: int, input_shape: Tuple[int, int, int],
                 dtype: Optional[torch.dtype] = None):
        self.rec, self.model = rec, rec.serving_model()
        self.img, self.vr = _inputs(rec, batch, input_shape, dtype)
        self.graph, self.out = None, None
        self.capture_ms, self.pool_bytes = 0.0, 0
        self.captured_launches = {}
        if rec.device.type == 'cuda':
            self._capture()

    def _run(self):
        with self.rec._mode(self.model, False), torch.no_grad():
            return self.rec._predict_impl(self.model, self.img, self.vr,
                                          device_exit=True)

    def _capture(self):
        """Two eager calls on a side stream (they build the kernels and
        fill the weight caches, whose host-to-device copies a capture
        forbids), then the capture."""
        dev = self.rec.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run()
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        # the capture empties the allocator's cache first: so does the
        # baseline of the pool's bytes
        torch.cuda.empty_cache()
        before, reserved = launch_counts(), torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self._run()
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.captured_launches = {k: n - before[k]
                                  for k, n in launch_counts().items()
                                  if n != before[k]}
        self.graph = graph

    def __call__(self, img: torch.Tensor, valid_ratio: torch.Tensor):
        if tuple(img.shape) != tuple(self.img.shape) or \
                tuple(valid_ratio.shape) != tuple(self.vr.shape):
            raise ValueError(f'aot_compile: compiled for images '
                             f'{tuple(self.img.shape)} and ratios '
                             f'{tuple(self.vr.shape)}, got '
                             f'{tuple(img.shape)} and '
                             f'{tuple(valid_ratio.shape)}')
        self.img.copy_(img)
        self.vr.copy_(valid_ratio)
        if self.graph is None:
            return self._run()
        self.graph.replay()
        return self.out


def aot_compile(rec, batch: int, input_shape: Tuple[int, int, int],
                dtype: Optional[torch.dtype] = None) -> AotCall:
    """``rec``'s serving path at (batch, *input_shape) images of ``dtype``
    (default: the compute dtype), as an :class:`AotCall`."""
    return AotCall(rec, batch, input_shape, dtype)


class ExportedRecognizer:
    """``simple_test`` over :func:`aot_compile` at a fixed batch (JAX
    ``ExportedRecognizer``): a smaller batch is padded with copies of its
    last image."""

    def __init__(self, rec, batch: int, input_shape: Tuple[int, int, int],
                 dtype: Optional[torch.dtype] = None):
        self.label_convertor = rec.label_convertor
        self.batch = batch
        self._call = aot_compile(rec, batch, input_shape, dtype)

    def simple_test(self, img, valid_ratio=None, img_metas=None):
        img = torch.as_tensor(img)
        n = img.shape[0]
        if n > self.batch:
            raise ValueError(f'batch {n} > compiled batch {self.batch}')
        if n < self.batch:
            img = torch.cat([img, img[-1:].expand(self.batch - n,
                                                  *img.shape[1:])])
        vr = np.ones((self.batch,), np.float32)
        if valid_ratio is not None:
            vr[:n] = np.asarray(valid_ratio, np.float32)
        call = self._call
        out = call(img.to(call.img.device, call.img.dtype),
                   torch.from_numpy(vr).to(call.vr.device))
        out = out[:n].float().cpu().numpy()
        metas = img_metas or [{'valid_ratio': float(r)} for r in vr[:n]]
        idxs, scores = self.label_convertor.tensor2idx(out, metas)
        strings = self.label_convertor.idx2str(idxs)
        return [dict(text=s, score=sc) for s, sc in zip(strings, scores)]
