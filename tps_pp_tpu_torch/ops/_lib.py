"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all at once,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, never at
import, into ``build/tps_pp_tpu_torch/`` beside the package; the library's
file name carries a hash of the sources and flags, so an edit rebuilds it.
``load()`` raises if there is no ``nvcc``.

``define_op`` makes a wrapper's kernel a PyTorch operator of the
``tps_pp`` namespace (``torch.ops.tps_pp.<name>``): its CUDA kernel is the
wrapper's ``ctypes`` launch, its CPU kernel the plain version, and its
fake kernel gives the output's shape and dtype without running anything,
so that ``torch.export`` records the operator as one node of its graph and
a CUDA graph captures the launch. The operators are registered through
``torch.library.Library(...).impl``: a Python kernel behind the C++
dispatcher, which costs a launch less on the host than
``torch.library.custom_op``'s Python dispatch (``PERF.md`` gives both).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR.parent / 'build' / 'tps_pp_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every extern "C" entry point
_SIGNATURES = {
    'tpk_tps_sampler': [_P] * 9 + [_I] * 10 + [_P],
    'tpk_encoder_forward': [_P] * 17 + [_I] * 7 + [_P],
    'tpk_encoder_attention': [_P] * 3 + [_I] * 4 + [_P],
    'tpk_gemm': [_P] * 8 + [_I] * 5 + [_P],
    'tpk_full_decode': [_P] * 35 + [_I] * 11 + [_P],
    'tpk_self_attn_step': [_P] * 10 + [_I] * 7 + [_P],
    'tpk_cross_ffn_step': [_P] * 17 + [_I] * 7 + [_P],
    'tpk_grid_sample_fwd': [_P] * 3 + [_I] * 6 + [_P],
    'tpk_grid_sample_grad': [_P] * 5 + [_I] * 6 + [_P, _P],
    'tpk_grid_sample_grad_img': [_P] * 3 + [_I] * 6 + [_P, _P],
    'tpk_grid_sample_plan': [_I] * 4 + [_P],
    'tpk_grid_sample_fwd_plan': [_I] * 6 + [_P],
    'tpk_conv3x3_cp': [_P] * 4 + [_I] * 7 + [_P],
    'tpk_basic_block_cp': [_P] * 6 + [_I] * 8 + [_P],
    'tpk_stem_plan': [_I] * 7 + [_P],
}

_lib = None
_OPS = None         # the torch.library.Library of the tps_pp namespace
# every operator defined: name -> (schema, CUDA kernel), for tools that time
# the dispatch (tools/torch_dispatch_cost.py)
OP_KERNELS = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of '
                       'tps_pp_tpu_torch need the CUDA toolkit to build')


def _sources():
    return sorted(SRC_DIR.glob('*.cu')) + sorted(SRC_DIR.glob('*.cuh'))


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'libtps_pp_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path. The compilers' output (``-Xptxas -v``: each
    kernel's registers, shared memory and spills) goes to ``<lib>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f'{out.stem}.tmp{os.getpid()}'
    jobs = []
    for src in sorted(SRC_DIR.glob('*.cu')):
        obj = BUILD_DIR / f'{tag}.{src.stem}.o'
        cmd = [nvcc] + NVCC_FLAGS + ['-c', '-o', str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(' '.join(cmd) + '\n' + text)
        if proc.returncode != 0:
            failed.append(f'{cmd[-1]} ({proc.returncode}):\n{text[-4000:]}')
    tmp = BUILD_DIR / f'{tag}.so'
    if not failed:
        cmd = [nvcc, '-shared', '-o', str(tmp)] + [str(o) for _, o, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f'link ({proc.returncode}):\n{proc.stderr[-4000:]}')
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix('.log').write_text('\n'.join(log))
    if failed:
        raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def define_op(name: str, schema: str, cuda, cpu, fake):
    """Define the operator ``tps_pp::<name>`` with the argument list and
    result of ``schema`` (``'(Tensor x, int n) -> Tensor'``) and its CUDA,
    CPU and fake kernels; return ``torch.ops.tps_pp.<name>``. Autograd
    falls through to the kernels, as it did when the wrappers called them
    directly: the plain version's operations record their graph on CPU
    tensors, a kernel's output carries none. Other devices have no kernel:
    the wrappers refuse them before they dispatch
    (:func:`require_kernel_device`)."""
    import torch
    global _OPS
    if _OPS is None:
        _OPS = torch.library.Library('tps_pp', 'DEF')
    _OPS.define(name + schema)
    _OPS.impl(name, cuda, 'CUDA')
    _OPS.impl(name, cpu, 'CPU')
    _OPS.impl(name, torch.library.fallthrough_kernel, 'Autograd')
    torch.library.register_fake(f'tps_pp::{name}', fake, lib=_OPS)
    OP_KERNELS[name] = (schema, cuda)
    return getattr(torch.ops.tps_pp, name)


_COUNT_LOCK = threading.Lock()
_SCOPE = threading.local()


def count_launch(wrapper, attr: str = 'launches'):
    """Add one to ``wrapper.<attr>``, a wrapper's launch count, under a
    lock (``predict(mesh=)`` launches from one host thread a card), and to
    the innermost ``launch_scope`` of this thread, keyed by
    ``'<wrapper name>.<attr>'``."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
    scope = getattr(_SCOPE, 'counts', None)
    if scope is not None:
        key = f'{wrapper.__name__}.{attr}'
        scope[key] = scope.get(key, 0) + 1


@contextlib.contextmanager
def launch_scope():
    """The launches this thread makes inside the block, as a dict
    ``{'<wrapper name>.<attr>': count}`` filled as they happen."""
    prev = getattr(_SCOPE, 'counts', None)
    _SCOPE.counts = counts = {}
    try:
        yield counts
    finally:
        _SCOPE.counts = prev


def require_kernel_device(device, name: str):
    """Raise unless ``device`` is the CPU (the plain version) or a CUDA
    device (the kernel): what a wrapper checks before it dispatches."""
    if device.type != 'cpu':
        require_cuda(device, name)


def require_cuda(device, name: str):
    """Raise unless ``device`` is a CUDA device: a kernel's wrapper takes
    the plain version for CPU tensors only and launches for CUDA ones."""
    if device.type != 'cuda':
        raise ValueError(f'{name}: tensors on {device}; the kernel takes '
                         f'CUDA tensors, the plain version CPU ones')


def check_args(name: str, device, expected):
    """Raise unless every tensor of ``expected`` ({arg: (tensor, shape,
    dtype)}, the shape a tuple) is contiguous, on ``device``, of that shape
    and dtype."""
    for arg, (t, shape, dt) in expected.items():
        if t.dtype != dt or t.shape != shape or t.device != device or \
                not t.is_contiguous():
            raise ValueError(
                f'{name}: {arg} must be a contiguous {dt} tensor of shape '
                f'{tuple(shape)} on {device}, got {t.dtype} '
                f'{tuple(t.shape)} on {t.device}')


_INVALID_VALUE = 1     # cudaErrorInvalidValue


def check(rc: int, name: str):
    """Raise on a non-zero cudaError_t returned by an entry point: a
    ``ValueError`` for cudaErrorInvalidValue, which an entry point returns
    for arguments outside the limits stated in its source; a
    ``RuntimeError`` otherwise."""
    if rc == _INVALID_VALUE:
        raise ValueError(f'{name}: arguments outside the kernel\'s limits, '
                         f'which its entry point in tps_pp_tpu_torch/csrc '
                         f'states (cudaErrorInvalidValue)')
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc} (cudaError_t)')


def stream_ptr(device) -> int:
    """The current stream of ``device``, as an int for ctypes. The kernels
    launch on the current CUDA device, so ``device`` must be it."""
    import torch
    if device.index is not None and \
            device.index != torch.cuda.current_device():
        raise ValueError(f'tensors on {device}, but the current CUDA device '
                         f'is {torch.cuda.current_device()}: launch under '
                         f'torch.cuda.device({device.index})')
    return torch.cuda.current_stream(device).cuda_stream
