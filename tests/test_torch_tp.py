"""Tensor parallelism of the port on the CPU (``parallel/tp.py``,
``make_train_step(mesh=)``, ``train_recognizer(mesh=)``), in gloo
processes, against one process:

* ``tools/torch_mesh_check.py --parts tp``: one float64 step of the tiny
  flagship (dropout 0, SGD, clip to norm 1) on a data 2 x model 2 mesh.
  The gradient norm within 1e-10 of one process's (relative; measured
  3e-16), the parameters after the step and the BatchNorm statistics
  within 1e-12 (measured 2e-16 and 1.3e-15). The loss equals the data
  parallel run's (data 2 x model 1) within 1e-10 (measured 0), and one
  process's within the data parallel bound of ``tests/test_torch_ddp.py``
  (1e-6, measured 8.5e-8): the loss is a float32 island of the float64
  model, averaged over two halves of the batch. After two steps every
  split parameter keeps its placement; the checkpoint rank 0 wrote (whole
  tensors) loads into one process with the gathered weights exactly.
* The ``ResNetDet`` trunk split over ``model`` 2 against the replicated
  trunk in float32, every pyramid level within 2e-5 (the JAX
  ``test_tp_conv_parity_vs_replicated``), and the input's gradient too.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))


def test_tp_step_equals_one_process(tmp_path):
    out = subprocess.run(
        [sys.executable, 'tools/torch_mesh_check.py', '--device', 'cpu',
         '--tiny', '--dtype', 'float64', '--parts', 'tp', '--out',
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    gaps = json.loads(out.stdout.strip().splitlines()[-1])
    assert gaps['worlds'] == [1, 4, 4, 4, 4]
    assert gaps['counts'] == [1] * 5
    assert gaps['split'] == 58
    assert gaps['grad_norm'] <= 1e-10, gaps
    assert gaps['params'] <= 1e-12, gaps
    assert gaps['buffers'] <= 1e-12, gaps
    assert gaps['loss_vs_data_parallel'] <= 1e-10, gaps
    assert gaps['grad_norm_vs_data_parallel'] <= 1e-10, gaps
    assert gaps['loss'] <= 1e-6, gaps
    assert gaps['placement_after_two_steps'] is True
    assert gaps['written'] == ['epoch_1.pth']
    assert gaps['checkpoint_max_abs'] == 0.0


TRUNK = r'''
import os, sys, torch, numpy as np
torch.set_num_threads(1)
from tps_pp_tpu_torch.models.textdet.dbnet import ResNetDet
from tps_pp_tpu_torch.parallel import (create_mesh, maybe_init_distributed,
                                       param_sharding, tp)
from tps_pp_tpu_torch.utils.convert import resnet_det_rules
maybe_init_distributed('cpu')
torch.manual_seed(0)
model = ResNetDet(stage_blocks=(1, 1, 1, 1), base_channels=8).eval()
g = torch.Generator().manual_seed(1)
with torch.no_grad():
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.2, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0, 0.2, generator=g)
import copy
whole = copy.deepcopy(model)
x = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (4, 32, 32, 3)).astype(np.float32)).requires_grad_()
ref = whole(x)
sum(o.square().sum() for o in ref).backward()
ref_grad = x.grad.clone()
x.grad = None
mesh = create_mesh(data=1, model=2)
rules = [(t[len('backbone.'):], f[len('backbone/'):], k)
         for t, f, k in resnet_det_rules((1, 1, 1, 1))]
tp.shard_model(model, mesh, param_sharding(model, mesh, rules))
split = sum(p.shape != q.shape for p, q in zip(
    model.state_dict().values(), tp.gather_state_dict(model).values()))
out = model(x)
sum(o.square().sum() for o in out).backward()
gap = max(float((a - b).abs().max()) for a, b in zip(out, ref))
ggap = float((x.grad - ref_grad).abs().max() / ref_grad.abs().max())
if int(os.environ['RANK']) == 0:
    print(gap, ggap, split, flush=True)
torch.distributed.destroy_process_group()
'''


def test_resnet_det_trunk_split_equals_replicated():
    from torch_ddp_check import free_port
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               WORLD_SIZE='2', MASTER_ADDR='localhost',
               MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, '-c', TRUNK], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    gap, grad_gap, split = outs[0][0].split()
    assert float(gap) <= 2e-5
    assert float(grad_gap) <= 2e-5
    # conv1, bn1 (weight, bias, mean, var), conv2 of each of 4 blocks
    assert int(split) == 4 * 6
