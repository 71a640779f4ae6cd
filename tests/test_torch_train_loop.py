"""The port's training entry points against the JAX package's, on the CPU:

* the ``DataLoader`` on the toy set through the flagship's train pipeline
  (``configs/textrecog/nrtr/nrtr_tps++_toy.py``): the JAX loader's order
  and texts, images within the augmentations' tolerance; the same
  batches at 0 and 2 workers; a new epoch draws a new order and new
  augmentations; the ranks' shares of a global batch make up the batch;
* ``train_recognizer`` on the tiny flagship (dropout 0, log interval 1)
  from the weights JAX's ``train_recognizer`` initialises, carried across
  with ``state_dict_from_jax`` into a ``.pth`` given as ``load_from``: the
  per-iteration losses of the JAX loop;
* resume: two epochs against one epoch and ``resume_from`` its ``.pth``
  (dropout 0.1, so the masks keyed per step count): parameters, BatchNorm
  buffers and optimizer state bit-equal; a finished job replays nothing;
  ``load_from`` loads weights only; the newest 5 checkpoints are kept;
  the caches derived from the weights follow a restore;
* ``python -m tps_pp_tpu_torch.tools.train`` on the toy config narrowed
  through ``--cfg-options``, then ``tools/test.py`` on its checkpoint.

Tolerances: images within 1 grey level times ColorJitter's largest gain
(1.5 brightness x 1.5 contrast x 1.5 saturation), normalised by the
smallest std (the warps are within one grey level of cv2's,
``test_torch_augment.py``); losses within 5e-5 relative over the four
steps, float64 on both sides (see the test).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_recognizer

import tps_pp_tpu.apis.recognizer as jax_recognizer_module
from tps_pp_tpu.apis.train import train_recognizer as jax_train
from tps_pp_tpu.config import load_config as jax_load_config
from tps_pp_tpu.datasets import DataLoader as JaxDataLoader
from tps_pp_tpu.datasets import build_dataset as jax_build_dataset

from tps_pp_tpu_torch.apis import (build_recognizer, nrtr_tps_pp_cfg,
                                   train_recognizer)
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.datasets import DataLoader, build_dataset
from tps_pp_tpu_torch.parallel import build_optimizer
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import checkpoint
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_CFG = os.path.join(REPO, 'configs/textrecog/nrtr/nrtr_tps++_toy.py')
AUG_ATOL = 1.5 ** 3 / 255.0 / 0.224
LOSS_RTOL = 5e-5
OPT = dict(type='Adam', lr=1e-3, eps=1e-6)


def narrow(pipeline, width=64):
    """``pipeline`` resizing to 32 x ``width`` (the tiny flagship's)."""
    out = []
    for t in pipeline:
        t = dict(t)
        if t['type'] == 'ResizeOCR':
            t.update(min_width=width, max_width=width)
        out.append(t)
    return out


def toy_train(width=None, repeat=None):
    """The toy config's training set (its ``train_pipeline``), as a plain
    dict for both packages."""
    d = load_config(TOY_CFG)['data']['train']
    ds = dict(d['datasets'][0])
    if repeat is not None:
        ds['loader'] = dict(ds['loader'], repeat=repeat)
    pipeline = [dict(t) for t in d['pipeline']]
    return dict(type='UniformConcatDataset', datasets=[ds],
                pipeline=narrow(pipeline, width) if width else pipeline)


def same_batches(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a['texts'] == b['texts'] and a['n_real'] == b['n_real']
        np.testing.assert_allclose(a['img'], b['img'], rtol=0, atol=atol)
        np.testing.assert_array_equal(a['valid_ratio'], b['valid_ratio'])


def test_loader_matches_jax_and_ignores_workers():
    cfg = toy_train()
    got_ds, want_ds = build_dataset(cfg), jax_build_dataset(cfg)
    epochs = []
    for epoch in (0, 1):
        want = JaxDataLoader(want_ds, 8, shuffle=True, seed=3)
        want.set_epoch(epoch)
        want = list(want)
        runs = []
        for workers in (0, 2):
            loader = DataLoader(got_ds, 8, shuffle=True, seed=3,
                                num_workers=workers)
            try:
                loader.set_epoch(epoch)
                runs.append(list(loader))
            finally:
                loader.close()
        same_batches(runs[0], want, AUG_ATOL)
        same_batches(runs[1], runs[0], 0.0)
        assert runs[0][-1]['n_real'] == 100 - 8 * 12
        epochs.append(runs[0])
    a, b = epochs
    assert [x['texts'] for x in a] != [x['texts'] for x in b]
    assert not np.array_equal(a[0]['img'], b[0]['img'])


def test_rank_shares_make_up_the_global_batch():
    ds = build_dataset(toy_train(repeat=2))     # 20 samples: 8, 8, 4 + pad
    whole = list(DataLoader(ds, 8, shuffle=True, seed=1))
    shares = [list(DataLoader(ds, 8, shuffle=True, seed=1, rank=r,
                              world_size=2)) for r in (0, 1)]
    for i, batch in enumerate(whole):
        s0, s1 = shares[0][i], shares[1][i]
        np.testing.assert_array_equal(
            np.concatenate([s0['img'], s1['img']]), batch['img'])
        assert s0['texts'] + s1['texts'] == batch['texts']
        assert s0['n_real'] + s1['n_real'] == batch['n_real']
    assert [s['n_real'] for s in (shares[0][-1], shares[1][-1])] == [4, 0]


def tiny_cfg(dropout=0.0):
    cfg = nrtr_tps_pp_cfg(tiny=True)
    return dict(cfg, encoder=dict(cfg['encoder'], dropout=dropout),
                decoder=dict(cfg['decoder'], dropout=dropout))


def run_cfg(**kw):
    return dict(dict(samples_per_gpu=8, total_epochs=2, log_interval=1,
                     optimizer=OPT, input_shape=(32, 64, 3)), **kw)


def jax_train_f64(cfg, data, run, seed):
    """JAX ``train_recognizer`` with the model in float64 and its
    parameters cast to float64 as they are initialised (the JAX package's
    recognizer knows no 'float64', so it is named for the call). Returns
    the history and the initial variables."""
    jdt = jax_recognizer_module._DTYPES
    with jax.enable_x64(True):
        jdt['float64'] = jnp.float64
        try:
            jrec = jax_recognizer(dict(cfg, dtype='float64'))
        finally:
            del jdt['float64']
        init, first = jrec.init_variables, {}

        def init_f64(key, shape):
            v = jax.tree.map(lambda a: a.astype(jnp.float64)
                             if a.dtype == jnp.float32 else a,
                             init(key, shape))
            first['variables'] = jax.tree.map(np.asarray, v)
            return v

        jrec.init_variables = init_f64
        _, history = jax_train(jrec, jax_build_dataset(data), run, seed=seed)
    return history, first['variables']


def test_short_run_matches_jax(tmp_path):
    """Two epochs of two steps each (10 toy crops, batch 8, the last
    padded) with Adam, from JAX's initial weights. Both sides in float64
    apart from the float32 islands both keep (attention scores, the TPS
    coordinates, the loss), whose rounding Adam's steps and the TPS grid
    amplify: the losses part by 8.5e-8 relative at step 0 and 1.8e-5 at
    step 3 (measured), held to LOSS_RTOL. In float32 the two part by up
    to 5.6e-3 by step 3, as JAX's own loop does between a 1-device and
    an 8-device mesh (random weights make the step's effect on the TPS
    grid chaotic)."""
    cfg = tiny_cfg()
    one = dict(toy_train()['datasets'][0])
    data = dict(toy_train(width=64), datasets=[dict(
        one, loader=dict(one['loader'], repeat=1))])
    want, variables = jax_train_f64(cfg, data, run_cfg(), seed=4)
    pth = str(tmp_path / 'jax_init.pth')
    torch.save({'state_dict': state_dict_from_jax(variables, cfg)}, pth)
    rec = build_recognizer(dict(cfg, dtype='float64'), device='cpu')
    opt, got = train_recognizer(rec, build_dataset(data), run_cfg(),
                                load_from=pth, seed=4)
    want = [h['loss'] for h in want if 'loss' in h]
    got = [h['loss'] for h in got if 'loss' in h]
    assert len(got) == len(want) == 4 == opt.count
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def crops_dataset():
    return build_dataset(toy_train(width=64, repeat=2))   # 3 steps a epoch


def weights_and_state(rec, opt):
    return ({k: v.clone() for k, v in rec.model.state_dict().items()},
            opt.state_dict())


def assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def test_resume_is_bit_equal_and_a_finished_job_replays_nothing(tmp_path):
    cfg, ds = tiny_cfg(dropout=0.1), crops_dataset()
    rec = build_recognizer(cfg, device='cpu')
    opt, hist = train_recognizer(rec, ds, run_cfg(), seed=2,
                                 work_dir=str(tmp_path / 'a'))
    whole = weights_and_state(rec, opt)
    assert sorted(os.listdir(tmp_path / 'a')) == ['epoch_1.pth',
                                                  'epoch_2.pth']
    # one epoch, then the rest from its checkpoint
    rec1 = build_recognizer(cfg, device='cpu')
    train_recognizer(rec1, ds, run_cfg(total_epochs=1), seed=2,
                     work_dir=str(tmp_path / 'b'))
    rec2 = build_recognizer(cfg, device='cpu')
    opt2, hist2 = train_recognizer(
        rec2, ds, run_cfg(), seed=2, work_dir=str(tmp_path / 'c'),
        resume_from=str(tmp_path / 'b' / 'epoch_1.pth'))
    assert [h['epoch'] for h in hist2 if 'loss' in h] == [1, 1, 1]
    assert [h['loss'] for h in hist2 if 'loss' in h] == \
        [h['loss'] for h in hist if 'loss' in h and h['epoch'] == 1]
    assert_same(weights_and_state(rec2, opt2), whole)
    # a finished job (its work dir's newest checkpoint) has nothing left
    rec3 = build_recognizer(cfg, device='cpu')
    opt3, hist3 = train_recognizer(rec3, ds, run_cfg(), seed=2,
                                   resume_from=str(tmp_path / 'a'))
    assert opt3.count == opt.count == 6
    assert not [h for h in hist3 if 'loss' in h]
    assert_same(weights_and_state(rec3, opt3), whole)


def test_load_from_loads_weights_only(tmp_path):
    cfg, ds = tiny_cfg(), crops_dataset()
    rec = build_recognizer(cfg, device='cpu')
    train_recognizer(rec, ds, run_cfg(total_epochs=1), seed=0,
                     work_dir=str(tmp_path))
    trained = {k: v.clone() for k, v in rec.model.state_dict().items()}
    rec2 = build_recognizer(cfg, device='cpu')
    opt2, hist2 = train_recognizer(rec2, ds, run_cfg(total_epochs=0),
                                   seed=5, load_from=str(tmp_path))
    assert opt2.count == 0 and not opt2.optimizer.state and not hist2
    assert_same({k: v for k, v in rec2.model.state_dict().items()}, trained)
    # and the next run trains from them, from step 0 of the schedule
    opt3, hist3 = train_recognizer(rec2, ds, run_cfg(total_epochs=1), seed=5,
                                   load_from=str(tmp_path / 'epoch_1.pth'))
    assert [h['iter'] for h in hist3 if 'loss' in h] == [0, 1, 2]
    assert hist3[0]['lr'] == OPT['lr']


def test_the_newest_five_checkpoints_are_kept(tmp_path):
    rec = build_recognizer(tiny_cfg(), device='cpu')
    opt, _ = build_optimizer(OPT, rec.model.named_parameters())
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    for epoch in range(1, 8):
        opt.count = 10 * epoch
        mgr.save(epoch, rec.model, opt, meta=dict(seed=0))
    assert sorted(checkpoint.checkpoints(str(tmp_path))) == [3, 4, 5, 6, 7]
    assert checkpoint.resolve(str(tmp_path)).endswith('epoch_7.pth')
    meta = torch.load(tmp_path / 'epoch_7.pth', weights_only=True)['meta']
    assert meta == dict(seed=0, epoch=7, step=70)


def test_restore_refreshes_the_caches_of_the_weights(tmp_path):
    """A bf16-compute recognizer with f32 parameters serves a bf16 copy
    made per weights stamp: after a restore it serves the restored
    weights, as a fresh recognizer loaded from the same file does."""
    cfg = dict(tiny_cfg(), dtype='bfloat16', decode_mode='fused40_bf16')
    rec = build_recognizer(cfg, device='cpu', param_dtype='float32')
    rec.init_weights(0)
    opt, _ = build_optimizer(OPT, rec.model.named_parameters())
    img = np.random.default_rng(0).standard_normal(
        (4, 32, 64, 3)).astype(np.float32)
    before = rec.predict(img)
    other = build_recognizer(cfg, device='cpu', param_dtype='float32')
    other.init_weights(7)
    path = checkpoint.CheckpointManager(str(tmp_path)).save(
        1, other.model, opt)
    checkpoint.restore(rec.model, opt, path)
    after = rec.predict(img)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, other.predict(img), rtol=0, atol=0)


def test_train_cli_then_test_cli(tmp_path):
    """The toy config with the tiny flagship at width 64, two epochs: a
    checkpoint an epoch, then ``tools/test.py`` reads the last one."""
    base = load_config(TOY_CFG)['data']
    opts = [f'model={nrtr_tps_pp_cfg(tiny=True)!r}', 'total_epochs=2',
            'log_config.interval=5', 'data.samples_per_gpu=16'] + [
        f'data.{k}.pipeline={narrow(base[k]["pipeline"])!r}'
        for k in ('train', 'val', 'test')]
    wd = str(tmp_path / 'wd')
    opt, hist = train_tool.main([TOY_CFG, '--work-dir', wd, '--seed', '1',
                                 '--cfg-options'] + opts, device='cpu')
    assert opt.count == 2 * 7
    evals = [h['eval'] for h in hist if 'eval' in h]
    assert len(evals) == 2
    assert sorted(os.listdir(wd)) == ['epoch_1.pth', 'epoch_2.pth']
    metrics = test_tool.main([TOY_CFG, os.path.join(wd, 'epoch_2.pth'),
                              '--cfg-options'] + opts, device='cpu')
    assert metrics == evals[-1]
    # the shipped SDMGR UNet16 config trains through the KIE branch, on a
    # receipt annotation file given with --cfg-options (no images there:
    # the text and layout modality alone, as the JAX CLI's test runs it)
    import json
    ann = tmp_path / 'receipts.jsonl'
    ann.write_text('\n'.join(json.dumps({
        'file_name': f'{i}.png', 'height': 64, 'width': 64,
        'annotations': [{'box': [4, 8 * j, 40, 8 * j, 40, 8 * j + 6, 4,
                                 8 * j + 6], 'text': f'item{j}',
                         'label': j % 3} for j in range(3)]})
        for i in range(3)))
    kie_wd = str(tmp_path / 'kie')
    kie_cfg = 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py'
    _, kie_opt, kie_hist = train_tool.main([
        os.path.join(REPO, kie_cfg), '--work-dir', kie_wd, '--cfg-options',
        f'data.train.ann_file={ann}', 'data.train.dict_file=',
        'data.train.max_nodes=4', 'data.train.with_visual=False',
        'model.head.node_embed=16',
        'model.head.edge_embed=16', 'total_epochs=1'], device='cpu')
    assert kie_opt.count == 1 and np.isfinite(kie_hist[0]['loss'])
    assert os.listdir(kie_wd) == ['epoch_1.pth']


def test_jax_toy_config_loads_the_same_train_pipeline():
    assert jax_load_config(TOY_CFG)['data']['train']['pipeline'] == \
        load_config(TOY_CFG)['data']['train']['pipeline']
