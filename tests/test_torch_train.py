"""The port's training step against the JAX package on the CPU, on the tiny
flagship in float32 with dropout 0:

* ``TFLoss`` (and ``CELoss``) against the JAX losses;
* train-mode BatchNorm: outputs and running statistics of the trunk;
* teacher-forced logits in eval mode;
* the loss and every parameter's gradient against ``jax.value_and_grad``
  of JAX ``compute_loss`` (gradients named through ``state_dict_from_jax``,
  whose rules are transposes and reshapes), and the BatchNorm statistics
  the step leaves;
* one Adam + warmup + clip step against JAX ``make_train_step``;
* the schedules, the paramwise multipliers and each optimizer type against
  optax on a toy problem;
* dropout on its own (torch's generator cannot reproduce JAX's masks);
* the two repairs: weight caches that follow the weights, and ``predict``
  in eval mode whatever mode training left.

Tolerances: loss 1e-5 relative; gradients rtol 1e-4, atol 1e-6 x the
largest gradient (``tests/test_parallel.py``) with both sides in float64,
and in float32 within 3x the distance of JAX's own float32 gradients from
those (see the test); parameters after a step and BatchNorm statistics
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_util import jax_flagship, jnp_tree, port_from_jax

import tps_pp_tpu.apis.recognizer as jax_recognizer
from tps_pp_tpu.losses.ce import CELoss as JCELoss, TFLoss as JTFLoss
from tps_pp_tpu.parallel import TrainState
from tps_pp_tpu.parallel import build_optimizer as jbuild_optimizer
from tps_pp_tpu.parallel import make_lr_schedule as jmake_lr_schedule
from tps_pp_tpu.parallel import make_train_step as jmake_train_step
from tps_pp_tpu.parallel.train import _paramwise_lr_mults

from tps_pp_tpu_torch.apis import (build_recognizer, nrtr_tps_pp_cfg,
                                   train_recognizer)
from tps_pp_tpu_torch.losses import CELoss, TFLoss
from tps_pp_tpu_torch.models.layers import BatchNorm2d
from tps_pp_tpu_torch.models.transformer import dropout
from tps_pp_tpu_torch.parallel import (build_optimizer, make_lr_schedule,
                                       make_train_step, paramwise_lr_mult)
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
TEXTS = ['ab', 'hello', 'x1', 'q']
VR = np.array([1.0, 0.6, 0.85, 0.35], np.float32)
# warmup (first lr 1e-4) and a clip the gradients exceed; eps 1e-6 keeps
# Adam's first step (g / (|g| + eps)) from amplifying the sign of the
# near-zero gradients that two float32 implementations may round apart
OPT = dict(type='Adam', lr=1e-3, eps=1e-6, grad_clip=dict(max_norm=1.0),
           lr_config=dict(warmup='linear', warmup_iters=10,
                          warmup_ratio=0.1))


@pytest.fixture(scope='module')
def flagship():
    """JAX tiny flagship with dropout 0 and moving control points, one
    batch, and its loss, gradients, BatchNorm statistics and one train
    step, all as numpy."""
    jrec, v, cfg = jax_flagship(tiny=True, seed=5, dropout=0.0)
    rng = np.random.default_rng(5)
    k = v['params']['tpsnet']['TPE']['loc_fc2']['kernel']
    v['params']['tpsnet']['TPE']['loc_fc2']['kernel'] = (
        0.05 * rng.standard_normal(k.shape)).astype(np.float32)
    img = rng.standard_normal((4, 32, 64, 3)).astype(np.float32)
    targets = jrec.label_convertor.str2tensor(TEXTS)['padded_targets']
    batch = dict(img=img, valid_ratio=VR, padded_targets=targets)
    jbatch = jnp_tree(batch)
    jv = jnp_tree(v)

    def loss_fn(params):
        total, (_, new_state) = jrec.compute_loss(
            dict(jv, params=params), jbatch, jax.random.PRNGKey(1),
            train=True)
        return total, new_state['batch_stats']

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jv['params'])
    grads64 = _jax_grads_f64(cfg, v, batch)
    tx, _ = jbuild_optimizer(OPT)
    state, metrics = jmake_train_step(jrec, donate=False)(
        TrainState.create(jv, tx), jbatch, jax.random.PRNGKey(1))
    logits = jrec.module.apply(jv, jnp.asarray(img), jnp.asarray(targets),
                               jnp.asarray(VR), train=False)
    return dict(
        cfg=cfg, v=v, batch=batch, loss=float(loss),
        grads=state_dict_from_jax(jax.tree.map(np.asarray, dict(
            params=grads, batch_stats=new_bs)), cfg),
        grads64=grads64,
        step=state_dict_from_jax(jax.tree.map(np.asarray, dict(
            params=state.params, batch_stats=state.batch_stats)), cfg),
        metrics={k: float(m) for k, m in metrics.items()},
        logits=np.asarray(logits), jrec=jrec)


def _jax_grads_f64(cfg, v, batch):
    """The gradients of JAX ``compute_loss`` with the model in float64
    (its float32 islands stay float32), as a port state dict. The JAX
    package's recognizer knows no 'float64', so it is named for the call."""
    jdt = jax_recognizer._DTYPES
    with jax.enable_x64(True):
        jdt['float64'] = jnp.float64
        try:
            jrec = jax_recognizer.build_recognizer(dict(
                cfg, dtype='float64', decode_mode='steps',
                tpsnet=dict(cfg['tpsnet'], sample_mode='gather')))
        finally:
            del jdt['float64']
        jv = jnp_tree(jax.tree.map(
            lambda a: a.astype(np.float64) if a.dtype == np.float32 else a,
            v))
        jbatch = jnp_tree(dict(batch, img=batch['img'].astype(np.float64)))

        def loss_fn(params):
            total, (_, new_state) = jrec.compute_loss(
                dict(jv, params=params), jbatch, jax.random.PRNGKey(1),
                train=True)
            return total, new_state['batch_stats']

        (_, new_bs), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jv['params'])
        return state_dict_from_jax(jax.tree.map(np.asarray, dict(
            params=grads, batch_stats=new_bs)), cfg)


def _port(flagship, **overrides):
    return port_from_jax(flagship['cfg'], flagship['v'], **overrides)


def _bn_buffers(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(('running_mean', 'running_var'))}


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize('reduction', ['none', 'mean', 'sum'])
def test_tf_loss_matches_jax(reduction):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 8, 37)).astype(np.float32)
    targets = rng.integers(0, 37, (3, 8)).astype(np.int32)
    targets[:, 5:] = 38                                   # pads beyond C-1
    targets[1, 2] = 38
    tdict = {'padded_targets': targets}
    for port, ref in ((TFLoss(38, reduction), JTFLoss(38, reduction)),
                      (CELoss(38, reduction, ignore_first_char=True),
                       JCELoss(38, reduction, ignore_first_char=True))):
        got = port(torch.from_numpy(logits), {
            'padded_targets': torch.from_numpy(targets)})['loss_ce']
        want = ref(jnp.asarray(logits), jnp_tree(tdict))['loss_ce']
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------- modules, train mode

def test_train_mode_batchnorm_matches_flax(flagship):
    """The trunk's stem and first stages in train mode: the outputs (1e-4:
    flax takes the batch variance as E[x^2] - E[x]^2, torch in two passes,
    and the f32 difference grows through the stages) and the running
    statistics flax's mutable batch_stats receive (1e-5)."""
    jrec, v, img = flagship['jrec'], flagship['v'], flagship['batch']['img']
    (x, skips), new = jrec.module.apply(
        jnp_tree(v), jnp.asarray(img), train=True,
        method=lambda m, i, train: m.backbone.stem_and_head(i, train=train),
        mutable=['batch_stats'])
    want_bs = state_dict_from_jax(jax.tree.map(np.asarray, dict(
        params=v['params'], batch_stats=dict(
            v['batch_stats'], backbone=new['batch_stats']['backbone']))),
        flagship['cfg'])
    rec = _port(flagship)
    bb = rec.model.backbone.train()
    with torch.no_grad():
        got, got_skips = bb.stem_and_head(torch.from_numpy(img))
    for g, w in zip([got] + got_skips, [x] + list(skips)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    before = state_dict_from_jax(v, flagship['cfg'])
    moved = 0
    for n, b in _bn_buffers(rec.model).items():
        np.testing.assert_allclose(b.numpy(), want_bs[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
        moved += not np.allclose(b.numpy(), before[n].numpy())
    assert moved > 0


def test_batchnorm_running_var_is_biased():
    """flax's running variance: the biased batch variance (torch's own
    BatchNorm takes n/(n-1) times it); momentum 0.1 is flax's 0.9."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 2, 2)).astype(np.float32) * 3 + 1)
    bn = BatchNorm2d(3).train()
    ref = torch.nn.BatchNorm2d(3).train()
    out, want = bn(x), ref(x)
    torch.testing.assert_close(out, want)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(ref.running_var, 0.9 + 0.1 * var * 8 / 7)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    assert int(bn.num_batches_tracked) == 1


def test_teacher_forced_logits_match_jax(flagship):
    rec = _port(flagship)
    b = flagship['batch']
    with torch.no_grad():
        got = rec.model(torch.from_numpy(b['img']),
                        torch.from_numpy(b['padded_targets']).long(),
                        torch.from_numpy(VR))
    assert got.shape == flagship['logits'].shape == (4, 8, 38)
    np.testing.assert_allclose(got.numpy(), flagship['logits'], rtol=1e-4,
                               atol=1e-5)


def test_loss_and_every_gradient_match_jax(flagship):
    """float32: the loss to 1e-5 and the BatchNorm statistics to 1e-5 of
    JAX's. Gradients: in float64 on both sides (their float32 islands
    kept), every parameter's to rtol 1e-4 and atol 1e-6 x the largest
    gradient. In float32 the two frameworks' gradients part by more than
    that (up to ~8e-6 x the largest): 26 train-mode BatchNorms and the TPS
    grid amplify float32 rounding, which is why the JAX package's own
    trunk + TPS++ gradient test runs in float64 (test_grad_parity.py). So
    in float32 each of the port's gradients must be as close to the
    float64 ones as JAX's float32 gradient is, within a factor 3 (the port
    measured up to 2.1e-5 x the largest gradient from them, JAX up to
    5.6e-5)."""
    rec = _port(flagship)
    total, losses = rec.compute_loss(flagship['batch'])
    assert set(losses) == {'loss_ce'}
    assert abs(float(total.detach()) - flagship['loss']) <= 1e-5 * abs(
        flagship['loss'])
    total.backward()
    want, want64 = flagship['grads'], flagship['grads64']
    names = [n for n, _ in rec.model.named_parameters()]
    scale = max(float(want64[n].abs().max()) for n in names)
    for n, p in rec.model.named_parameters():
        err = float((p.grad.double() - want64[n]).abs().max())
        jax_err = float((want[n].double() - want64[n]).abs().max())
        assert err <= 3 * jax_err + 1e-6 * scale, (n, err, jax_err)
    # the grid reaches the loss through the warp's d_grid only
    assert float(rec.model.tpsnet.TPE.localization_fc2.weight.grad.abs()
                 .max()) > 1e-3 * scale
    for n, b in _bn_buffers(rec.model).items():
        np.testing.assert_allclose(b.numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    assert not rec.model.training                   # compute_loss restores

    rec64 = _port(flagship, dtype='float64')
    batch64 = dict(flagship['batch'],
                   img=flagship['batch']['img'].astype(np.float64))
    total64, _ = rec64.compute_loss(batch64)
    total64.backward()
    for n, p in rec64.model.named_parameters():
        assert p.grad.dtype == torch.float64
        np.testing.assert_allclose(p.grad.numpy(), want64[n].numpy(),
                                   rtol=1e-4, atol=1e-6 * scale, err_msg=n)
    for n, b in _bn_buffers(rec64.model).items():
        np.testing.assert_allclose(b.numpy(), want64[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_adam_step_matches_jax_train_step(flagship):
    rec = _port(flagship)
    optimizer, schedule = build_optimizer(OPT, rec.model.named_parameters())
    assert schedule(0) == pytest.approx(1e-4)
    metrics = make_train_step(rec, optimizer)(flagship['batch'])
    want = flagship['metrics']
    assert set(metrics) == set(want) == {'loss', 'loss_ce', 'grad_norm'}
    for k in want:
        assert float(metrics[k]) == pytest.approx(want[k], rel=1e-5), k
    assert want['grad_norm'] > OPT['grad_clip']['max_norm']   # clipped
    step = flagship['step']
    for n, t in rec.model.state_dict().items():
        if n in step and not n.endswith('num_batches_tracked'):
            np.testing.assert_allclose(t.numpy(), step[n].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)
    assert optimizer.count == 1


# ------------------------------------------------- schedules and optimizers

@pytest.mark.parametrize('kwargs', [
    dict(policy='step', warmup_steps=5, warmup_ratio=0.2,
         step_epochs=(2, 3), steps_per_epoch=4, gamma=0.5),
    dict(policy='poly', warmup_steps=3, total_steps=20, power=0.9,
         min_lr=1e-6),
    dict(policy='fixed'),
    dict(policy='step', step_epochs=(1,), steps_per_epoch=7),
])
def test_lr_schedule_matches_jax(kwargs):
    got, want = make_lr_schedule(1e-3, **kwargs), jmake_lr_schedule(
        1e-3, **kwargs)
    for count in range(0, 25):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)


def test_paramwise_multipliers_match_jax(flagship):
    """Keys that name the same modules as a substring of the torch name and
    of the flax path; the longest match wins in both."""
    custom = {'backbone': dict(lr_mult=0.0), 'trg_word_emb': dict(lr_mult=0.5),
              'classifier': dict(lr_mult=2.0), 'TPE': dict(lr_mult=0.25),
              'loc_fc2': dict(lr_mult=3.0),
              'localization_fc2': dict(lr_mult=3.0)}
    v = flagship['v']
    mults = jax.tree.map(np.asarray, _paramwise_lr_mults(custom, v['params']))
    want = state_dict_from_jax(dict(params=jax.tree.map(
        lambda m, p: np.full(np.shape(p), m, np.float32), mults,
        v['params']), batch_stats=v['batch_stats']), flagship['cfg'])
    rec = _port(flagship)
    seen = set()
    for n, p in rec.model.named_parameters():
        m = float(np.unique(want[n].numpy())[0])
        assert paramwise_lr_mult(custom, n) == m, n
        seen.add(m)
    assert seen == {0.0, 0.5, 1.0, 2.0, 0.25, 3.0}


@pytest.mark.parametrize('opt', [
    dict(type='Adam', lr=1e-2, weight_decay=1e-2),
    dict(type='AdamW', lr=1e-2, betas=(0.8, 0.99)),
    dict(type='AdamW', lr=1e-2, weight_decay=0.1),
    dict(type='Adadelta', lr=1.0, rho=0.95, eps=1e-6),
    dict(type='SGD', lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-3),
    dict(type='SGD', lr=0.1),
])
def test_optimizer_steps_match_optax(opt):
    """Three steps with fixed gradients through the whole chain: clip
    (triggered), coupled or decoupled decay, warmup, paramwise lr."""
    cfg = dict(opt, grad_clip=dict(max_norm=2.0),
               lr_config=dict(warmup='linear', warmup_iters=4,
                              warmup_ratio=0.25),
               paramwise_cfg=dict(custom_keys={'head': dict(lr_mult=0.5)}))
    rng = np.random.default_rng(0)
    init = {'body': {'w': rng.standard_normal((4, 3)).astype(np.float32)},
            'head': {'b': rng.standard_normal((5,)).astype(np.float32)}}
    grads = [{'body': {'w': rng.standard_normal((4, 3)).astype(np.float32)},
              'head': {'b': rng.standard_normal((5,)).astype(np.float32)}}
             for _ in range(3)]
    tx, _ = jbuild_optimizer(cfg)
    params = jnp_tree(init)
    state = tx.init(params)
    named = [('body.w', torch.nn.Parameter(torch.from_numpy(
        init['body']['w'].copy()))), ('head.b', torch.nn.Parameter(
            torch.from_numpy(init['head']['b'].copy())))]
    chain, _ = build_optimizer(cfg, named)
    for g in grads:
        updates, state = tx.update(jnp_tree(g), state, params)
        params = optax.apply_updates(params, updates)
        named[0][1].grad = torch.from_numpy(g['body']['w'].copy())
        named[1][1].grad = torch.from_numpy(g['head']['b'].copy())
        chain.step()
        np.testing.assert_allclose(named[0][1].detach().numpy(),
                                   np.asarray(params['body']['w']),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(named[1][1].detach().numpy(),
                                   np.asarray(params['head']['b']),
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- dropout

def test_dropout_rate_scale_and_generator():
    x = torch.ones((200, 500))
    a = dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.9))
    torch.testing.assert_close(dropout(x, 0.1, torch.Generator()
                                       .manual_seed(3)), a)
    assert not torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(4)),
                           a)
    assert dropout(x, 0.0, None) is x
    assert not bool(dropout(x, 1.0, None).any())


def test_dropout_applies_in_train_mode_only():
    """The flagship with dropout 0.1: eval-mode losses equal those of the
    same weights with dropout 0; train-mode losses depend on the
    generator and repeat with its seed."""
    cfg = nrtr_tps_pp_cfg(tiny=True)
    cfg0 = dict(cfg, encoder=dict(cfg['encoder'], dropout=0.0),
                decoder=dict(cfg['decoder'], dropout=0.0))
    rec = build_recognizer(cfg, device='cpu')
    rec0 = build_recognizer(cfg0, device='cpu')
    rec.init_weights(1)
    rec0.model.load_state_dict(rec.model.state_dict())
    rng = np.random.default_rng(1)
    batch = dict(img=rng.standard_normal((2, 32, 64, 3)).astype(np.float32),
                 padded_targets=rec.label_convertor.str2tensor(
                     ['abc', 'de'])['padded_targets'])
    with torch.no_grad():
        ev = float(rec.compute_loss(batch, train=False)[0])
        ev0 = float(rec0.compute_loss(batch, train=False)[0])
        tr0 = float(rec0.compute_loss(batch)[0])
        tr = [float(rec.compute_loss(
            batch, torch.Generator().manual_seed(s))[0]) for s in (7, 7, 8)]
    assert ev == ev0
    assert tr[0] == tr[1] != tr[2] and tr[0] != tr0


# ----------------------------------------------------------------- repairs

def _one_update(rec, how):
    """One in-place update of every weight: an Adam step on random
    gradients, or the port's own train step."""
    if how == 'optimizer':
        opt = torch.optim.Adam(rec.model.parameters(), lr=1e-2)
        g = torch.Generator().manual_seed(0)
        for p in rec.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    else:
        chain, _ = build_optimizer(dict(type='Adam', lr=1e-2),
                                   rec.model.named_parameters())
        td = rec.label_convertor.str2tensor(TEXTS)
        make_train_step(rec, chain)(dict(
            img=np.random.default_rng(2).standard_normal(
                (4, 32, 64, 3)).astype(np.float32),
            valid_ratio=VR, padded_targets=td['padded_targets']))


@pytest.mark.parametrize('how', ['optimizer', 'train_step'])
def test_weight_caches_follow_the_weights(how):
    """The fused paths' folded weights are cached; after the weights change
    in place, the ``fused40_bf16`` path (which reads the cache) must serve
    the new weights, as the ``steps`` path (which reads the modules) does."""
    rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True), device='cpu')
    rec.init_weights(0)
    img = np.random.default_rng(3).standard_normal(
        (4, 32, 64, 3)).astype(np.float32)
    rec.decode_mode, rec.plain = 'fused40_bf16', True
    before = rec.predict(img, VR)
    _one_update(rec, how)
    got = rec.predict(img, VR)
    rec.decode_mode = 'steps'
    want = rec.predict(img, VR)
    assert not torch.allclose(before, want, atol=1e-4)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('how', ['train_mode', 'train_step'])
def test_predict_runs_in_eval_mode(how):
    """After training left the model in train mode, ``predict`` equals
    ``predict`` of a fresh eval model with the same weights and BatchNorm
    statistics, and leaves the mode as it found it."""
    cfg = nrtr_tps_pp_cfg(tiny=True)
    rec = build_recognizer(cfg, device='cpu')
    rec.init_weights(0)
    if how == 'train_step':
        _one_update(rec, how)
    rec.model.train()
    img = np.random.default_rng(4).standard_normal(
        (4, 32, 64, 3)).astype(np.float32)
    fresh = build_recognizer(cfg, device='cpu')
    fresh.model.load_state_dict(rec.model.state_dict())
    rec.plain = fresh.plain = True
    for mode in ('fused40_bf16', 'steps'):
        rec.decode_mode = fresh.decode_mode = mode
        torch.testing.assert_close(rec.predict(img, VR),
                                   fresh.predict(img, VR), atol=0, rtol=0)
        assert rec.model.training


def test_bf16_compute_with_f32_parameters():
    """``param_dtype='float32'`` with a bf16 config: the loss runs under
    autocast, the parameters and their gradients stay f32, and ``predict``
    serves a bf16 copy that follows the weights."""
    rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True, dtype='bfloat16'),
                           device='cpu', param_dtype='float32')
    rec.init_weights(0)
    img = np.random.default_rng(5).standard_normal(
        (4, 32, 64, 3)).astype(np.float32)
    serving = rec.serving_model()
    assert next(serving.parameters()).dtype == torch.bfloat16
    assert rec.serving_model() is serving
    batches = [dict(img=img, valid_ratio=VR, texts=TEXTS)] * 2
    chain, history = train_recognizer(rec, batches, dict(
        optimizer=dict(type='Adam', lr=1e-3), log_interval=1))
    assert chain.count == 2 and len(history) == 2
    assert all(np.isfinite(h['loss']) and h['grad_norm'] > 0
               for h in history)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in rec.model.parameters())
    assert rec.serving_model() is not serving
    out = rec.predict(img, VR)
    assert out.shape == (4, 8, 38) and bool(torch.isfinite(out).all())
