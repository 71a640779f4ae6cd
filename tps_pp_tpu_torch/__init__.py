"""tps_pp_tpu_torch: the PyTorch + CUDA port of the NRTR + TPS++ serving path.

A second package beside ``tps_pp_tpu`` (the JAX reference). It imports
``torch`` and numpy, and nothing of JAX, flax or the JAX package. Module
names mirror the JAX package, so ``tps_pp_tpu/<path>.py`` has its
counterpart at ``tps_pp_tpu_torch/<path>.py``.

The three Pallas kernels of the serving path are hand-written CUDA C++ for
Hopper under ``csrc/``, built on first use with ``nvcc`` into
``build/tps_pp_tpu_torch/`` and bound with ``ctypes`` (``ops/_lib.py``).
"""
__version__ = '0.1.0'

from . import registry
