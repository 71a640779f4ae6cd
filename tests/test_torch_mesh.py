"""The port's device mesh on the CPU (``parallel/mesh.py``,
``predict(mesh=)``, ``eval_recognizer(mesh=)``, ``tools/test.py`` under
several processes) against the JAX package's mesh (``tests/test_parallel.py``
runs it on the same eight virtual CPU devices):

* ``create_mesh`` shapes and assertion as JAX's;
* ``param_sharding``: every parameter of the tiny flagship and of
  ``ResNetDet(stage_blocks=(1, 1, 1, 1), base_channels=8)`` placed as its
  JAX leaf on a ``data=4, model=2`` mesh, the axis moved with the transpose
  (torch (out, in[, kh, kw]) against flax (in, out) / (kh, kw, in, out));
* ``predict(mesh=)`` over eight CPU "devices" (one listed eight times)
  against the port's one-device ``predict`` and against JAX's
  ``predict(mesh=create_mesh(data=8))`` on the same weights, at B=8 and at
  B=6, which pads (atol 2e-5, rtol 1e-4, as ``tests/test_parallel.py``);
* ``eval_recognizer(mesh=)``: the metrics and results of the unsharded
  call;
* ``tools/test.py`` in two gloo processes (``torch.distributed.run``) on a
  recognizer, a detector and an SDMGR config: one process's metrics, and
  its results in dataset order.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tps_pp_tpu.parallel import create_mesh as jax_create_mesh
from tps_pp_tpu.parallel import param_sharding as jax_param_sharding

from tps_pp_tpu_torch.apis import eval_recognizer
from tps_pp_tpu_torch.datasets import build_dataset
from tps_pp_tpu_torch.models.textdet.dbnet import ResNetDet
from tps_pp_tpu_torch.ops import _lib
from tps_pp_tpu_torch.parallel import create_mesh, param_sharding
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.utils.convert import (resnet_det_rules,
                                            rules_for_config)
from torch_port_util import jax_flagship, jnp_tree, port_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ['cpu'] * 8


@pytest.fixture(scope='module')
def tiny():
    jrec, v, cfg = jax_flagship(tiny=True, seed=2)
    return jrec, v, cfg, port_from_jax(cfg, v)


def test_create_mesh_shapes():
    mesh = create_mesh(data=4, model=2, devices=CPU8)
    assert mesh.shape == {'data': 4, 'model': 2}
    assert not mesh.distributed
    assert create_mesh(devices=CPU8).shape == {'data': 8, 'model': 1}
    assert create_mesh(model=2, devices=CPU8).shape == {'data': 4,
                                                        'model': 2}
    with pytest.raises(AssertionError, match='3x2 != 8 devices'):
        create_mesh(data=3, model=2, devices=CPU8)
    assert create_mesh(devices=CPU8).data_devices() == \
        [torch.device('cpu')] * 8


def _jax_specs(params, mesh):
    flat = jax.tree_util.tree_flatten_with_path(
        jax_param_sharding(params, mesh))[0]
    return {'/'.join(getattr(p, 'key', str(p)) for p in path): s.spec
            for path, s in flat}


def _expected(named, jspecs, rules):
    """The torch dim of each parameter from its JAX leaf's spec, the axis
    moved with the transpose of its kind."""
    from tps_pp_tpu_torch.parallel.mesh import flax_leaf
    want = {}
    for name, p in named:
        leaf = flax_leaf(name, rules)
        dim = None
        if leaf is not None:
            path, dims = leaf
            spec = tuple(jspecs[path])
            for f, axis in enumerate(spec):
                if axis == 'model':
                    dim = dims.index(f)
        want[name] = dim
    return want


def test_param_sharding_matches_jax_flagship(tiny):
    jrec, v, cfg, rec = tiny
    jspecs = _jax_specs(v['params'], jax_create_mesh(data=4, model=2))
    mesh = create_mesh(data=4, model=2, devices=CPU8)
    rules = rules_for_config(cfg)
    got = param_sharding(rec.model, mesh, rules)
    assert got.keys() == dict(rec.model.named_parameters()).keys()
    assert got == _expected(rec.model.named_parameters(), jspecs, rules)
    # the JAX test's checks, in torch's layout
    assert sum(d is not None for d in got.values()) == sum(
        tuple(s) != () for s in jspecs.values()) == 58
    for name, d in got.items():
        if name.endswith(('linear_q.weight', 'w_1.weight', 'w_1.bias')) or \
                ('layer' in name and name.endswith(('.conv1.weight',
                                                    'bn1.weight'))) or \
                name.startswith('backbone.layer') and name.endswith(
                    'bn1.bias'):
            assert d == 0, name
        if name.endswith(('fc.weight', 'w_2.weight', 'classifier.weight',
                          'trg_word_emb.weight')) or \
                ('layer' in name and name.endswith('.conv2.weight')):
            assert d == 1, name
    assert got['backbone.conv1.weight'] is None      # the stem conv
    assert got['decoder.classifier.bias'] is None
    # model 1 replicates everything
    assert set(param_sharding(rec.model, create_mesh(devices=CPU8),
                              rules).values()) == {None}


def test_param_sharding_matches_jax_resnet_det():
    from tps_pp_tpu.models.textdet.dbnet import ResNetDet as JaxResNetDet
    jm = JaxResNetDet(stage_blocks=(1, 1, 1, 1), base_channels=8)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jspecs = _jax_specs(v['params'], jax_create_mesh(data=4, model=2))
    model = ResNetDet(stage_blocks=(1, 1, 1, 1), base_channels=8)
    rules = [(t[len('backbone.'):], f[len('backbone/'):], k)
             for t, f, k in resnet_det_rules((1, 1, 1, 1))]
    mesh = create_mesh(data=4, model=2, devices=CPU8)
    got = param_sharding(model, mesh, rules)
    assert got == _expected(model.named_parameters(), jspecs, rules)
    assert sum(d is not None for d in got.values()) == 4 * 4
    assert got['layer1.0.conv1.weight'] == 0
    assert got['layer1.0.conv2.weight'] == 1
    assert got['layer1.0.bn1.bias'] == 0
    assert got['conv1.weight'] is None


def test_predict_mesh_matches_one_device_and_jax(tiny):
    jrec, v, cfg, rec = tiny
    g = np.random.default_rng(0)
    img = g.standard_normal((8, 32, 64, 3)).astype(np.float32)
    vr = np.linspace(0.5, 1.0, 8).astype(np.float32)
    ref = rec.predict(img, vr, bucket_batch=False).numpy()
    mesh = create_mesh(data=8, devices=CPU8)
    jmesh = jax_create_mesh(data=8, model=1)
    jv = jnp_tree(v)
    for n in (8, 6):
        got = rec.predict(img[:n], vr[:n], bucket_batch=False,
                          mesh=mesh).numpy()
        assert got.shape == (n,) + ref.shape[1:]
        np.testing.assert_allclose(got, ref[:n], atol=2e-5, rtol=1e-4)
        want = np.asarray(jrec.predict(jv, jnp.asarray(img[:n]),
                                       jnp.asarray(vr[:n]),
                                       bucket_batch=False, mesh=jmesh))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
        assert len(rec.last_shard_launches) == 8
    # the model's own device listed eight times holds no copy
    assert rec._replicas == {}
    # simple_test takes the mesh too; a device other than the model's
    # ('cpu:0' is not 'cpu') gets one copy, made again after a weight
    # change and dropped once a mesh no longer lists it
    other = torch.device('cpu', 0)
    two = create_mesh(devices=['cpu', 'cpu:0'] * 4)
    texts = [r['text'] for r in rec.simple_test(img, vr, mesh=two)]
    assert texts == [r['text'] for r in rec.simple_test(img, vr)]
    assert list(rec._replicas) == [other]
    first = rec._replicas[other][1]
    with torch.no_grad():
        rec.model.decoder.classifier.bias.add_(1.0)
    try:
        np.testing.assert_allclose(
            rec.predict(img, vr, mesh=two).numpy(),
            rec.predict(img, vr).numpy(), atol=2e-5, rtol=1e-4)
        assert rec._replicas[other][1] is not first
    finally:
        with torch.no_grad():
            rec.model.decoder.classifier.bias.sub_(1.0)
    rec.predict(img, vr, mesh=mesh)
    assert rec._replicas == {}


def test_launch_scope_counts_per_thread():
    import threading

    def fake():
        pass
    fake.launches = 0
    seen = {}

    def count(name, n):
        with _lib.launch_scope() as c:
            for _ in range(n):
                _lib.count_launch(fake)
        seen[name] = c

    with _lib.launch_scope() as mine:
        _lib.count_launch(fake)
        threads = [threading.Thread(target=count, args=(k, n))
                   for k, n in (('a', 200), ('b', 300))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert seen == {'a': {'fake.launches': 200},
                    'b': {'fake.launches': 300}}
    assert mine == {'fake.launches': 1}
    assert fake.launches == 501


def test_eval_recognizer_mesh_matches_unsharded(tiny):
    from test_torch_eval import CONCAT
    _, _, _, rec = tiny
    want = eval_recognizer(rec, build_dataset(CONCAT, dict(test_mode=True)),
                           batch_size=4, return_results=True)
    mesh = create_mesh(data=8, devices=CPU8)
    got = eval_recognizer(rec, build_dataset(CONCAT, dict(test_mode=True)),
                          batch_size=4, return_results=True, mesh=mesh)
    assert got[0] == want[0]
    assert [r['text'] for r in got[1]] == [r['text'] for r in want[1]]
    np.testing.assert_allclose([s for r in got[1] for s in r['score']],
                               [s for r in want[1] for s in r['score']],
                               atol=2e-5)


def _run_test_tool(args, tmp_path, tag, world):
    """``tools/test.py`` in ``world`` gloo processes (1: no group)."""
    out = str(tmp_path / f'{tag}_{world}.json')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        env.pop(k, None)
    cmd = [sys.executable, '-m']
    if world > 1:
        sys.path.insert(0, os.path.join(REPO, 'tools'))
        from torch_ddp_check import free_port
        cmd += ['torch.distributed.run', '--nproc_per_node', str(world),
                '--master_port', str(free_port()), '-m']
    cmd += ['tps_pp_tpu_torch.tools.test'] + args + ['--out', out,
                                                      '--device', 'cpu']
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _recognizer_config(tmp_path):
    from test_torch_eval import CONCAT, PIPELINE
    from tps_pp_tpu_torch.apis import nrtr_tps_pp_cfg
    cfg = nrtr_tps_pp_cfg(tiny=True, decode_mode='steps')
    path = tmp_path / 'rec.py'
    path.write_text(f'model = {cfg!r}\ntest_pipeline = {PIPELINE!r}\n'
                    f'data = dict(samples_per_gpu=4, test={CONCAT!r})\n')
    return [str(path)]


def _detector_config(tmp_path):
    import cv2
    from test_torch_detector import SIZE, pages, write_config, write_dataset
    ann = write_dataset(str(tmp_path), [SIZE] * 5, seed=3)
    for i, img in enumerate(pages(5, seed=21)):
        cv2.imwrite(str(tmp_path / 'imgs' / f'img_{i}.png'), img)
    return [write_config(str(tmp_path), ann), '--eval', 'hmean-iou']


def _sdmgr_config(tmp_path):
    from test_torch_kie_ner import KIE_CONFIGS, write_receipts
    ann, _ = write_receipts(tmp_path, n=5)
    opts = []
    for split in ('train', 'test'):
        opts += [f'data.{split}.ann_file={ann}', f'data.{split}.dict_file=',
                 f'data.{split}.max_nodes=8', f'data.{split}.max_chars=8',
                 f'data.{split}.with_visual=False']
    opts += ['model.head.node_embed=16', 'model.head.edge_embed=16',
             'model.head.fusion_dim=32',
             'evaluation.metric_options.macro_f1.ignores=[]']
    return [os.path.join(REPO, KIE_CONFIGS['closed']), '--cfg-options'] + \
        opts


@pytest.mark.parametrize('kind', ['recognizer', 'detector', 'sdmgr'])
def test_test_tool_two_ranks_equal_one_process(tmp_path, kind):
    args = {'recognizer': _recognizer_config, 'detector': _detector_config,
            'sdmgr': _sdmgr_config}[kind](tmp_path)
    one = _run_test_tool(args, tmp_path, kind, 1)
    two = _run_test_tool(args, tmp_path, kind, 2)
    assert two['metrics'] == one['metrics']
    assert two['results'] == one['results']
    assert len(one['results']) == {'recognizer': 30, 'detector': 5,
                                   'sdmgr': 5}[kind]


def test_shard_view_and_interleave():
    ds = list(range(7))
    views = [test_tool._ShardView(ds, r, 3) for r in range(3)]
    assert [[v[i] for i in range(len(v))] for v in views] == \
        [[0, 3, 6], [1, 4], [2, 5]]
    assert views[1].sample(1) == 4
    per_rank = [[v[i] for i in range(len(v))] for v in views]
    assert test_tool._interleave(per_rank, 7) == ds
    assert views[0].evaluate([]) == {}
