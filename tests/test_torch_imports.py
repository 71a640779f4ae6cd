"""The port stands alone: importing it, serving and training on the CPU
loads neither JAX, flax, cv2 nor the JAX package, and launches no kernel
(CPU tensors go to the kernels' plain versions; nothing is built)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import tps_pp_tpu_torch
from tps_pp_tpu_torch import registry
from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.apis import flagship, recognizer, train
from tps_pp_tpu_torch.convertors import attn, base
from tps_pp_tpu_torch.losses import ce
from tps_pp_tpu_torch.models import layers, transformer
from tps_pp_tpu_torch.models.backbones import resnet_abi
from tps_pp_tpu_torch.models.decoders import base as dbase, nrtr as dnrtr
from tps_pp_tpu_torch.models.encoders import nrtr as enrtr
from tps_pp_tpu_torch.models.recognizers import encode_decode
from tps_pp_tpu_torch.models.rectifiers import tps_pp
from tps_pp_tpu_torch.ops import (_lib, encoder, full_decode, grid_sample,
                                  tps, tps_sampler)
from tps_pp_tpu_torch.parallel import train as ptrain
from tps_pp_tpu_torch.utils import batching, convert

wrappers = (tps_sampler.tps_sampler, encoder.encoder_forward,
            full_decode.full_decode, grid_sample.grid_sample_forward,
            grid_sample.grid_sample_grad, grid_sample.grid_sample_grad_img)
for mode in ('fused40_bf16', 'steps'):
    rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True, decode_mode=mode))
    rec.init_weights(0)
    res = rec.simple_test(np.zeros((3, 32, 64, 3), np.float32),
                          [1.0, 0.5, 0.8])
    assert len(res) == 3
_, history = train.train_recognizer(rec, [dict(
    img=np.zeros((2, 32, 64, 3), np.float32), valid_ratio=[1.0, 0.5],
    texts=['ab', 'c'])], dict(optimizer=dict(type='Adam', lr=1e-4)))
assert np.isfinite(history[0]['loss'])
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'launches': [w.launches for w in wrappers],
    'library': _lib._lib is not None}))
'''


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'launches': [0] * 6, 'library': False}
