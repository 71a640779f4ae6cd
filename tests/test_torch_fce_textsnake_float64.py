"""FCENet and TextSnake training in float64 against the JAX package on
the CPU, on the five pages where JAX's float32 FCENet gradients part from
the port's: JAX's ``train_detector`` loop run in float64 (its modules given
``dtype=float64``, its losses' ``jnp.float32`` read as ``jnp.float64``)
against the port's ``train_detector`` on a float64 model, and one batch's
train-mode gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_fce_textsnake import (CFGS, _two_threads,  # noqa: F401
                                      jax_initial, ts_pages)

from tps_pp_tpu.apis.train_det import _TARGET_KEYS as JAX_TARGET_KEYS
from tps_pp_tpu.apis.train_det import _make_optimizer as jax_make_optimizer
from tps_pp_tpu.apis.train_det import build_det_targets as jax_det_targets
from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.models.textdet import fce_textsnake as jfce
from tps_pp_tpu_torch.apis.train_det import DetBatches, train_detector
from tps_pp_tpu_torch.models.textdet import FCELoss
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax


class _Wide:
    """``jnp`` with ``float32`` read as ``float64``: JAX's losses cast to
    ``jnp.float32`` by name, and so run in float64 with this in place."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def float64_jax(name):
    """(JAX's module of ``name`` computing in float64, its loss), for use
    under ``jax.enable_x64`` with ``jfce.jnp`` set to ``_Wide()``."""
    cfg = CFGS[name]
    jm = jax_build(dict(cfg, **{k: dict(cfg[k], dtype=jnp.float64)
                                for k in ('backbone', 'neck', 'head')}))
    loss = dict(cfg['loss'])
    return jm, getattr(jfce, loss.pop('type'))(**loss)


def jax_loop64(name, ds, v, epochs=2, batch_size=2, seed=1):
    """JAX's ``train_detector`` loop (its optimizer, targets, batches and
    order of pages) in float64 from the variables ``v``: each epoch's last
    loss."""
    cfg = dict(model=CFGS[name], total_epochs=epochs)
    targets = jax_det_targets(CFGS[name])
    keys = JAX_TARGET_KEYS[CFGS[name]['type']]
    n = len(ds)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jfce, 'jnp', _Wide())
        jm, loss_fn = float64_jax(name)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        params, state = v['params'], {'batch_stats': v['batch_stats']}
        tx = jax_make_optimizer(cfg, max(1, n // batch_size), epochs)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, state, opt_state, img, tgt):
            def f(p):
                out, new_state = jm.apply({'params': p, **state}, img,
                                          train=True, mutable=['batch_stats'])
                return sum(loss_fn(out, tgt).values()), new_state
            (loss, new_state), grads = jax.value_and_grad(
                f, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), new_state,
                    opt_state, loss)

        rng = np.random.default_rng(seed)
        history = []
        for _ in range(epochs):
            order = rng.permutation(n)
            for it in range(0, n, batch_size):
                items = [targets(ds[int(i)]) for i in order[it:it +
                                                            batch_size]]
                img = jnp.asarray(np.stack([i['img'] for i in items]),
                                  jnp.float64)
                tgt = {k: jnp.asarray(np.stack([i[k] for i in items]))
                       for k in keys}
                params, state, opt_state, loss = step(params, state,
                                                      opt_state, img, tgt)
            history.append(float(loss))
    return history


@pytest.mark.parametrize('name', ['fce', 'textsnake'])
def test_train_detector_float64_matches_the_jax_loop(name):
    """Two epochs of five pages in batches of 2, both sides in float64
    from the same initial weights: each epoch's last loss within 1e-10 of
    JAX's loop. The port's float32 run stays within 1e-4 of it."""
    cfg = dict(model=CFGS[name], total_epochs=2)
    ds = ts_pages(5, 2)
    v, model = jax_initial(name)
    want = jax_loop64(name, ds, v)
    _, opt, hist = train_detector(cfg, ds, batch_size=2, seed=1,
                                  device='cpu', model=model.double())
    assert opt.count == 6
    assert next(model.parameters()).dtype == torch.float64
    np.testing.assert_allclose([h['loss'] for h in hist], want, rtol=1e-10)
    _, _, hist32 = train_detector(cfg, ds, batch_size=2, seed=1,
                                  device='cpu', model=jax_initial(name)[1])
    np.testing.assert_allclose([h['loss'] for h in hist32], want, rtol=1e-4)


def test_fce_float64_train_gradients_match_jax():
    """The batch of the five pages where JAX's float32 FCENet gradients
    part from the port's (pages 4 and 0), train mode: in float64 the loss
    within 1e-12 and every gradient within 1e-9 of the largest of JAX's;
    the port's float32 gradients within 1e-4 of that largest."""
    cfg = CFGS['fce']
    v, model = jax_initial('fce')
    img, tgt = DetBatches(cfg, ts_pages(5, 2), FCELoss())([4, 0])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jfce, 'jnp', _Wide())
        jm, loss_fn = float64_jax('fce')
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)

        def f(p):
            out, _ = jm.apply({'params': p, 'batch_stats':
                               v64['batch_stats']}, jnp.asarray(img,
                                                                jnp.float64),
                              train=True, mutable=['batch_stats'])
            return sum(loss_fn(out, {k: jnp.asarray(a)
                                     for k, a in tgt.items()}).values())
        loss, grads = jax.jit(jax.value_and_grad(f))(v64['params'])
        want = state_dict_from_jax(jax.tree.map(np.asarray, dict(
            params=grads, batch_stats=v64['batch_stats'])), cfg)
    top = max(float(t.abs().max()) for t in want.values())
    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        m = jax_initial('fce')[1].to(dtype).train()
        total = sum(FCELoss(**{k: a for k, a in cfg['loss'].items()
                               if k != 'type'})(
            m(torch.from_numpy(img).to(dtype)),
            {k: torch.from_numpy(a) for k, a in tgt.items()}).values())
        if dtype == torch.float64:
            assert abs(float(total.detach()) - float(loss)) <= 1e-12 * abs(
                float(loss))
        total.backward()
        for n, p in m.named_parameters():
            assert p.grad.dtype == dtype
            np.testing.assert_allclose(p.grad.double().numpy(),
                                       want[n].numpy(), rtol=0,
                                       atol=atol * top, err_msg=n)


def float32_gaps():
    """On the batch of ``test_fce_float64_train_gradients_match_jax``, the
    largest gap of each side's gradients from JAX's float64 ones, per
    parameter over its largest entry: {(side, dtype): (gap, parameter)},
    and the four losses."""
    import contextlib
    cfg = CFGS['fce']
    v, _ = jax_initial('fce')
    img, tgt = DetBatches(cfg, ts_pages(5, 2), FCELoss())([4, 0])
    kw = {k: a for k, a in cfg['loss'].items() if k != 'type'}
    grads, losses = {}, {}
    for dt in ('float64', 'float32'):
        wide = dt == 'float64'
        with pytest.MonkeyPatch.context() as mp, (
                jax.enable_x64(True) if wide else contextlib.nullcontext()):
            if wide:
                mp.setattr(jfce, 'jnp', _Wide())
                jm, loss_fn = float64_jax('fce')
            else:
                jm, loss_fn = jax_build(cfg), jfce.FCELoss(**kw)
            vv = jax.tree.map(lambda a: jnp.asarray(a.astype(dt)), v)

            def f(p):
                out, _ = jm.apply({'params': p, 'batch_stats':
                                   vv['batch_stats']},
                                  jnp.asarray(img.astype(dt)), train=True,
                                  mutable=['batch_stats'])
                return sum(loss_fn(out, {k: jnp.asarray(a)
                                         for k, a in tgt.items()}).values())
            loss, g = jax.jit(jax.value_and_grad(f))(vv['params'])
            losses['jax', dt] = float(loss)
            grads['jax', dt] = state_dict_from_jax(jax.tree.map(
                np.asarray, dict(params=g, batch_stats=vv['batch_stats'])),
                cfg)
        m = jax_initial('fce')[1].to(getattr(torch, dt)).train()
        total = sum(FCELoss(**kw)(m(torch.from_numpy(img.astype(dt))), {
            k: torch.from_numpy(a) for k, a in tgt.items()}).values())
        total.backward()
        losses['port', dt] = float(total.detach())
        grads['port', dt] = {n: p.grad for n, p in m.named_parameters()}
    ref, names = grads['jax', 'float64'], list(grads['port', 'float64'])
    gaps = {key: max((float((g[n].double() - ref[n].double()).abs().max()
                            / ref[n].double().abs().max()), n)
                     for n in names)
            for key, g in grads.items() if key != ('jax', 'float64')}
    return gaps, losses


if __name__ == '__main__':
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fce_textsnake_float64.py
    torch.set_num_threads(2)
    gaps, losses = float32_gaps()
    for key, (gap, name) in gaps.items():
        print(*key, f'{gap:.3g}', name)
    print('losses', losses)
