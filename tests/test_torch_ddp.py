"""Data parallelism of the port on the CPU: ``tools/torch_ddp_check.py``
runs ``train_recognizer`` in 2 and in 4 gloo processes against one
process, on the tiny flagship (dropout 0) and one global batch of 8
crops through the flagship's train augmentations, one SGD step with the
gradients clipped to norm 1.

The processes split the batch (each rank its contiguous share, each
sample with its own augmentation key), take BatchNorm's statistics over
the whole batch through an all-reduce in its forward and backward, and
average their gradients. So they must end where one process on the whole
batch ends:

* in float64 (the model's float32 islands kept: the loss, the attention
  scores, the TPS coordinates) the parameters, the BatchNorm running
  statistics and the gradient norm to 1e-12, the loss to 1e-6 (measured:
  2e-16, 1.3e-15, 3e-16 and 8.5e-8);
* in float32 the loss and the BatchNorm running statistics to 1e-5
  (measured 8.5e-8 and 6e-7), the parameters to 1e-3 and the gradient
  norm to 1e-2 relative (measured 6.8e-4 and 1.8e-3): the localization
  head's gradient reaches it through the warp's d_grid, a sum over every
  pixel and channel with heavy cancellation, whose float32 rounding over
  4 rows and over 8 parts by that much, as the float64 run shows it is
  rounding.

Only rank 0 writes the checkpoint. SGD, not Adam: Adam scales gradients
of rounding size (the stem conv's bias, which BatchNorm cancels) up to
the lr.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (loss, buffers, params, grad norm) bounds
BOUNDS = {'float64': (1e-6, 1e-12, 1e-12, 1e-12),
          'float32': (1e-5, 1e-5, 1e-3, 1e-2)}


@pytest.mark.parametrize('world,dtype', [(2, 'float64'), (4, 'float64'),
                                         (2, 'float32')])
def test_gloo_processes_equal_one_process(tmp_path, world, dtype):
    out = subprocess.run(
        [sys.executable, 'tools/torch_ddp_check.py', '--world', str(world),
         '--device', 'cpu', '--tiny', '--batch', '8', '--dtype', dtype,
         '--out', str(tmp_path / 'run')], cwd=REPO, capture_output=True,
        text=True, timeout=900, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    gaps = json.loads(out.stdout.strip().splitlines()[-1])
    assert gaps['worlds'] == [1] + [world] * world
    assert gaps['counts'] == [1] * (world + 1)
    assert gaps['launches'] == [[0, 0]] * (world + 1)   # plain on the CPU
    loss, buffers, params, grad_norm = BOUNDS[dtype]
    assert gaps['loss'] <= loss, gaps
    assert gaps['buffers'] <= buffers, gaps
    assert gaps['params'] <= params, gaps
    assert gaps['grad_norm'] <= grad_norm, gaps
    # only rank 0 wrote the checkpoint, once
    assert gaps['written'] == ['epoch_1.pth']
