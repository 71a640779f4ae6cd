"""The training side's rest and the last tools of the port, against the JAX
package on the CPU:

* ``cv_ops.remap_linear`` against ``cv2.remap(INTER_LINEAR,
  BORDER_REPLICATE)`` (cv2 5.0) and ``cv_ops.pil_rotate_nearest`` against
  PIL's nearest-neighbour ``rotate(expand=False, center=...)``: bit for
  bit on uint8;
* ``Stretch`` / ``Distort`` / ``Curve`` and ``OnlineCropOCR``,
  ``FancyPCA``, ``RandomPaddingOCR``, ``OpencvToPil`` ->
  ``RandomRotateImageBox`` -> ``PilToOpencv`` against the JAX transforms,
  the port drawing from ``seeded_rngs(key)``, JAX from ``random`` /
  ``np.random`` seeded with the key: images equal, boxes within 1e-6;
* ``KD_Loss``: value and gradient to the student within 1e-6 of
  ``jax.value_and_grad``, no gradient to the teacher;
* ``MaskCTCConvertor`` / ``Mask_ABIConvertor``: equal arrays;
* ``TFCommonDecoder`` in a recognizer, on the JAX weights carried by
  ``state_dict_from_jax``: logits within 1e-5 in float32 (measured
  2.5e-6);
* ``render_dataset(16, seed=0)`` pixel-equal to JAX's, equal labels;
* ``tools/compare_activations.py`` on a ``.pth`` of seed-0 weights: each
  probe's shape and finite flag as the JAX CLI prints them on the CPU, its
  mean and std within 1e-4.
"""
import os
import random
import re
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tps_pp_tpu.convertors.mask  # noqa: F401 (registration)
import tps_pp_tpu.datasets.pipelines.extras  # noqa: F401 (registration)
import tps_pp_tpu.datasets.pipelines.tps_aug  # noqa: F401 (registration)
from tps_pp_tpu.registry import CONVERTORS as JAX_CONVERTORS
from tps_pp_tpu.registry import PIPELINES as JAX_PIPELINES

import tps_pp_tpu_torch.convertors  # noqa: F401 (registration)
from tps_pp_tpu_torch.datasets import seeded_rngs
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.registry import CONVERTORS, PIPELINES

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(32, 100, 3), (32, 128), (29, 77, 3), (17, 45, 1)]


def test_remap_linear_matches_cv2():
    for seed in range(24):
        g = np.random.default_rng(seed)
        h, w = int(g.integers(5, 60)), int(g.integers(5, 160))
        img = g.integers(0, 256, (h, w, 3) if seed % 3 else (h, w),
                         np.uint8)
        mx = g.uniform(-5, w + 5, (h + 3, w + 2)).astype(np.float32)
        my = g.uniform(-5, h + 5, (h + 3, w + 2)).astype(np.float32)
        if seed % 4 == 0:       # positions on the 1/64 grid: half-way ties
            mx = (np.round(mx * 64) / 64).astype(np.float32)
            my = (np.round(my * 64) / 64).astype(np.float32)
        np.testing.assert_array_equal(
            cv_ops.remap_linear(img, mx, my),
            cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REPLICATE))


def test_pil_rotate_nearest_matches_pil():
    for seed in range(40):
        g = np.random.default_rng(seed)
        h, w = int(g.integers(5, 60)), int(g.integers(5, 160))
        img = g.integers(0, 256, (h, w, 3) if seed % 2 else (h, w),
                         np.uint8)
        angle = float(g.uniform(-40, 40))
        center = (w / 2.0, h / 2.0) if seed % 5 else (float(g.uniform(0, w)),
                                                     float(g.uniform(0, h)))
        want = np.asarray(Image.fromarray(img).rotate(
            angle, resample=Image.NEAREST, expand=False, center=center))
        np.testing.assert_array_equal(
            cv_ops.pil_rotate_nearest(img, angle, center), want)


def _jax_run(cfg, results, key):
    random.seed(key)
    np.random.seed(key % (2 ** 32))
    return JAX_PIPELINES.build(dict(cfg))(results)


def _port_run(cfg, results, key):
    return PIPELINES.build(dict(cfg))(dict(results, **seeded_rngs(key)))


def _images():
    for seed in range(4):
        g = np.random.default_rng(seed)
        for shape in SHAPES:
            yield seed, g.integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize('name', ['Stretch', 'Distort', 'Curve'])
def test_tps_augmentations_match_jax(name):
    applied = 0
    for seed, img in _images():
        for mag in (-1, 0, 2):
            cfg = dict(type=name, mag=mag, prob=0.7)
            key = seed * 100 + mag + 7
            want = _jax_run(cfg, dict(img=img.copy()), key)['img']
            got = _port_run(cfg, dict(img=img.copy()), key)['img']
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            applied += not np.array_equal(want, img)
    assert applied > 10


def _quads(g, w, h, n=4):
    boxes = []
    for _ in range(n):
        x, y = g.uniform(0, w - 4), g.uniform(0, h - 4)
        bw, bh = g.uniform(2, 12), g.uniform(2, 10)
        boxes.append([x, y, x + bw, y, x + bw, y + bh, x, y + bh])
    return boxes


def test_extras_match_jax():
    crop_keys = ('x1', 'y1', 'x2', 'y2', 'x3', 'y3', 'x4', 'y4')
    for seed, img in _images():
        if img.ndim == 3 and img.shape[2] == 1:
            continue
        g = np.random.default_rng(seed + 50)
        h, w = img.shape[:2]
        key = 1000 + seed
        # OnlineCropOCR with and without the box keys
        box = dict(zip(crop_keys, np.asarray(_quads(g, w, h, 1)[0]) +
                       [2, 1] * 4))
        for info in (box, {}):
            cfg = dict(type='OnlineCropOCR', jitter_prob=0.6)
            want = _jax_run(cfg, dict(img=img, img_info=dict(info)), key)
            got = _port_run(cfg, dict(img=img, img_info=dict(info)), key)
            np.testing.assert_array_equal(got['img'], want['img'])
        if img.ndim == 3:
            cfg = dict(type='FancyPCA', alpha_std=0.3)
            np.testing.assert_array_equal(
                _port_run(cfg, dict(img=img.copy()), key)['img'],
                _jax_run(cfg, dict(img=img.copy()), key)['img'])
            f = img.astype(np.float32) / 255.0
            np.testing.assert_array_equal(
                _port_run(cfg, dict(img=f.copy()), key)['img'],
                _jax_run(cfg, dict(img=f.copy()), key)['img'])
        boxes = _quads(g, w, h)
        cfg = dict(type='RandomPaddingOCR', box_type='char_quads')
        want = _jax_run(cfg, dict(img=img, ann_info=dict(
            char_quads=[list(b) for b in boxes])), key)
        got = _port_run(cfg, dict(img=img, ann_info=dict(
            char_quads=[list(b) for b in boxes])), key)
        np.testing.assert_array_equal(got['img'], want['img'])
        np.testing.assert_allclose(got['ann_info']['char_quads'],
                                   want['ann_info']['char_quads'], atol=1e-6)
        # BGR -> "PIL" -> rotate with the boxes -> BGR
        chain = [dict(type='OpencvToPil'),
                 dict(type='RandomRotateImageBox', min_angle=-30,
                      max_angle=30),
                 dict(type='PilToOpencv')]
        ann = dict(chars=list('abcd'), char_quads=boxes)
        want = dict(img=img, ann_info={k: list(v) for k, v in ann.items()})
        random.seed(key)
        np.random.seed(key)
        for c in chain:
            want = JAX_PIPELINES.build(dict(c))(want)
        got = dict(img=img, ann_info={k: list(v) for k, v in ann.items()},
                   **seeded_rngs(key))
        for c in chain:
            got = PIPELINES.build(dict(c))(got)
        np.testing.assert_array_equal(got['img'], want['img'])
        assert got['ann_info']['chars'] == want['ann_info']['chars']
        np.testing.assert_allclose(np.asarray(got['ann_info']['char_quads'],
                                              float).reshape(-1),
                                   np.asarray(want['ann_info']['char_quads'],
                                              float).reshape(-1), atol=1e-6)


def test_kd_loss_matches_jax():
    from tps_pp_tpu.losses.kd import kd_loss as jax_kd
    from tps_pp_tpu_torch.losses import KD_Loss
    g = np.random.default_rng(0)
    t = g.standard_normal((3, 4, 8, 16)).astype(np.float32)
    s = g.standard_normal((3, 4, 8, 16)).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_kd, argnums=1)(jnp.asarray(t),
                                                         jnp.asarray(s))
    tt = torch.from_numpy(t).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    got = KD_Loss()(tt, st)['loss_kd']
    got.backward()
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)
    assert tt.grad is None


def test_mask_convertors_match_jax():
    strings = ['hello', 'ab', '', 'a1b2c3d4e5f6g7h8i9']
    mask_ids = [[0, 2, 9], [1], [0], [-1, 3, 30]]
    for name, extra in (('MaskCTCConvertor', {}),
                        ('Mask_ABIConvertor', dict(max_seq_len=10))):
        cfg = dict(type=name, dict_type='DICT36', with_unknown=True, **extra)
        want = JAX_CONVERTORS.build(dict(cfg)).str2tensor_mask(strings,
                                                               mask_ids)
        got = CONVERTORS.build(dict(cfg)).str2tensor_mask(strings, mask_ids)
        for k in ('masked_targets', 'other_targets', 'targets'):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(got['padded_targets'],
                                      np.asarray(want['padded_targets']))


def test_tf_common_decoder_matches_jax():
    from tps_pp_tpu.apis.flagship import nrtr_tps_pp_cfg
    from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
    from tps_pp_tpu_torch.apis import build_recognizer
    from tps_pp_tpu_torch.utils.convert import state_dict_from_jax
    cfg = nrtr_tps_pp_cfg(tiny=True)
    cfg['decoder'] = dict(type='TFCommonDecoder', n_layers=2, n_head=2,
                          d_k=8, d_v=8, d_model=64, d_inner=128, dropout=0.1)
    jrec = build_jax(cfg)
    v = jax.tree.map(np.asarray, jrec.init_variables(jax.random.PRNGKey(0),
                                                     (1, 32, 64, 3)))
    assert set(v['params']['decoder']) == {'cls', 'layer0', 'layer1'}
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    assert rec.resolved_decode_mode() == 'single_pass'
    img = np.random.default_rng(0).standard_normal((3, 32, 64, 3)).astype(
        np.float32)
    want = np.asarray(jrec.predict(v, img))
    got = rec.predict(img).numpy()
    assert got.shape == want.shape == (3, 8, 39)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the training pass: one logit a query position
    td = rec.label_convertor.str2tensor(['ab', 'c', 'xyz'])
    with torch.no_grad():
        total, _ = rec.compute_loss(dict(img=img, padded_targets=td[
            'padded_targets']), train=False)
    assert torch.isfinite(total)


def test_render_dataset_matches_jax():
    from tps_pp_tpu.utils.synth_text import render_dataset as jax_render
    from tps_pp_tpu_torch.utils.synth_text import render_dataset
    for kw in (dict(), dict(length_dist='real', max_len=25, lower=True)):
        want_i, want_t = jax_render(16, seed=0, **kw)
        got_i, got_t = render_dataset(16, seed=0, **kw)
        np.testing.assert_array_equal(got_i, want_i)
        assert got_t == want_t


_PROBE = re.compile(r'^(\S+)\s+shape=(\(.*?\)) mean=(\S+) std=(\S+) '
                    r'finite=(\S+)$')


def _probes(text):
    out = {}
    for line in text.splitlines():
        m = _PROBE.match(line.strip())
        if m:
            out[m.group(1)] = (m.group(2), float(m.group(3)),
                               float(m.group(4)), m.group(5))
    return out


def test_compare_activations_matches_jax_cli(tmp_path):
    from tps_pp_tpu.apis.flagship import nrtr_tps_pp_cfg
    from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
    from tps_pp_tpu_torch.tools import compare_activations
    from tps_pp_tpu_torch.utils.convert import state_dict_from_jax
    cfg = nrtr_tps_pp_cfg(tiny=True)
    # the JAX CLI inits at 32 x 128: the rectifier's geometry of that input
    cfg['tpsnet'] = dict(cfg['tpsnet'], img_size=(16, 64),
                         rectified_img_size=(16, 64), point_size=(2, 16))
    v = jax.tree.map(np.asarray, build_jax(cfg).init_variables(
        jax.random.PRNGKey(0), (1, 32, 128, 3)))
    pth = tmp_path / 'w.pth'
    torch.save(state_dict_from_jax(v, cfg), pth)
    cfg_file = tmp_path / 'tiny.py'
    cfg_file.write_text(f'model = {cfg!r}\n')
    image = os.path.join(REPO, 'demo/demo_text_recog.jpg')
    jax_out = subprocess.run(
        [sys.executable, 'tools/compare_activations.py', str(cfg_file),
         str(pth), '--image', image], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO))
    assert jax_out.returncode == 0, jax_out.stderr[-4000:]
    want = _probes(jax_out.stdout)
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        compare_activations.main([str(cfg_file), str(pth), '--image', image,
                                  '--device', 'cpu'])
    got = _probes(buf.getvalue())
    assert list(got) == list(want) == [
        'backbone.stage2', 'tps.control_point', 'tps.pc_score',
        'tps.rectified', 'encoder.out', 'decoder.probs']
    for k, (shape, mean, std, finite) in want.items():
        assert got[k][0] == shape and got[k][3] == finite == 'True', k
        assert abs(got[k][1] - mean) <= 1e-4, k
        assert abs(got[k][2] - std) <= 1e-4, k
