"""The port's drawing (``tps_pp_tpu_torch/utils/visualize.py``) and its
image-folder CLIs against the JAX package's on the CPU.

* Each of the six functions pixel for pixel against
  ``tps_pp_tpu/utils/visualize.py`` on the same inputs, the files they
  write byte for byte.
* ``recog_test_imgs``, ``det_test_imgs`` and ``kie_test_imgs`` against
  ``tools/recog_test_imgs.py``, ``det_test_imgs.py`` and
  ``kie_test_imgs.py`` on the same weights (a ``.pth`` for the port; the
  same ``.pth`` for JAX's recognizer, an ``.npz`` of the same variables for
  its detector and SDMGR): the same ``results.txt`` / ``correct.txt`` /
  ``wrong.txt``, the same files under ``out_vis_dir``, ``correct`` and
  ``wrong`` with the same pixels, the same metrics; the same boundary text
  files and drawings; the same KIE JSONs (``conf`` within 1e-5) and
  drawings.
"""
import ast
import importlib.util
import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
from torch_port_util import jax_flagship, perturb_batch_stats

from tps_pp_tpu.utils import visualize as jvis
from tps_pp_tpu.utils.checkpoint import save_variables

from tps_pp_tpu_torch.tools import det_test_imgs, kie_test_imgs
from tps_pp_tpu_torch.tools import recog_test_imgs
from tps_pp_tpu_torch.utils import visualize as vis
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _cases():
    g = np.random.default_rng(0)
    img = g.integers(0, 256, (40, 90, 3), np.uint8)
    quads = [[5.2, 4.9, 40.7, 6.1, 39.5, 20.3, 6.0, 18.8],
             [50, 22, 85, 22, 85, 36, 50, 36]]
    return {
        'imshow_text_label': [
            (img, 'pred', 'gt'), (img, 'pred', ''),
            (g.standard_normal((32, 64, 1)).astype(np.float32), 'x', 'y'),
            (g.integers(0, 256, (20, 30), np.uint8), 'grey', '')],
        'draw_feature_map': [
            (g.standard_normal((1, 8, 32, 16)).astype(np.float32),),
            (g.standard_normal((8, 32, 5)).astype(np.float32),)],
        'draw_point_map': [
            (img, g.uniform(0, 1, (32, 2))),
            (g.standard_normal((32, 64, 1)).astype(np.float32),
             g.uniform(0, 1, (2, 16, 2)))],
        'imshow_pred_boundary': [
            (img, [np.asarray(q + [0.87]) for q in quads]),
            (img, [np.asarray(quads[0] + [0.5])], None, False,
             (255, 0, 0))],
        'det_recog_show_result': [
            (img, {'result': [{'box': q, 'text': t}
                              for q, t in zip(quads, ('hello', 'w0rld'))]}),
            (img, {'result': []})],
        'imshow_edge': [
            (img, [q[:4] for q in quads] + [quads[1]], ['key', 'value', 'x'],
             g.uniform(0, 1, (3, 4)), g.uniform(0, 1, (3, 3))),
            (img, [quads[0]], ['solo'], g.uniform(0, 1, (1, 2)),
             np.ones((1, 1)))],
    }


@pytest.mark.parametrize('fn', ['imshow_text_label', 'draw_feature_map',
                                'draw_point_map', 'imshow_pred_boundary',
                                'det_recog_show_result', 'imshow_edge'])
def test_drawing_matches_jax(fn, tmp_path):
    for i, args in enumerate(_cases()[fn]):
        got = getattr(vis, fn)(*args)
        want = getattr(jvis, fn)(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        mine, theirs = (str(tmp_path / f'{who}_{i}.jpg')
                        for who in ('port', 'jax'))
        for f, path in ((vis, mine), (jvis, theirs)):
            if fn == 'imshow_pred_boundary':
                f.imshow_pred_boundary(args[0], args[1], path, *args[3:])
            else:
                getattr(f, fn)(*args, out_file=path)
        with open(mine, 'rb') as a, open(theirs, 'rb') as b:
            assert a.read() == b.read()


def test_drawing_without_cv2_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2 is not installed'):
        vis.imshow_text_label(np.zeros((4, 4, 3), np.uint8), 'a')


# ---------------------------------------------------------- the CLIs

def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    capsys.readouterr()
    jax_tool(name).main()
    return capsys.readouterr().out


def tree(root):
    """{relative path: file} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = \
                os.path.join(d, f)
    return out


def same_trees(a, b, text_suffixes=('.txt',)):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if k.endswith(text_suffixes):
            assert open(ta[k]).read() == open(tb[k]).read(), k
        elif k.endswith(('.png', '.jpg')):
            np.testing.assert_array_equal(cv2.imread(ta[k]),
                                          cv2.imread(tb[k]), err_msg=k)
    return ta


PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
                 std=[0.229, 0.224, 0.225]),
            dict(type='Collect', keys=['img'])]


def test_recog_test_imgs_matches_jax(tmp_path, monkeypatch, capsys):
    _, rv, rcfg = jax_flagship(tiny=True, seed=2)
    pth = str(tmp_path / 'tiny.pth')
    torch.save({'state_dict': state_dict_from_jax(rv, rcfg)}, pth)
    cfg = tmp_path / 'tiny_cfg.py'
    cfg.write_text(f'model = {rcfg!r}\ntest_pipeline = {PIPELINE!r}\n'
                   f'input_shape = (32, 64, 3)\n')
    root = tmp_path / 'imgs'
    (root / 'sub').mkdir(parents=True)
    g = np.random.default_rng(3)
    names = [f'sub/{i}.png' if i % 2 else f'{i}.png' for i in range(6)]
    for n in names:
        cv2.imwrite(str(root / n), g.integers(0, 256, (24 + 3 * len(n), 70,
                                                       3), np.uint8))
    # the first two labelled with the port's own reading, so that both
    # correct/ and wrong/ fill
    from tps_pp_tpu_torch.apis import init_recognizer, model_inference
    rec = init_recognizer(str(cfg), pth, device='cpu')
    read = [r['text'] for r in model_inference(
        rec, [str(root / n) for n in names[:2]], batch_mode=True)]
    labels = read + ['zz', 'word', 'a', 'b']
    lst = tmp_path / 'list.txt'
    lst.write_text('\n'.join(f'{n} {t}' for n, t in zip(names, labels)))
    args = [str(root), str(lst), str(cfg), pth, '--batch-size', '4']
    preds, metrics = recog_test_imgs.main(
        args + ['--out-dir', str(tmp_path / 'port'), '--device', 'cpu'])
    out = run_jax_tool('recog_test_imgs',
                       args + ['--out-dir', str(tmp_path / 'jax')],
                       monkeypatch, capsys)
    files = same_trees(tmp_path / 'port', tmp_path / 'jax')
    assert len([k for k in files if k.startswith('out_vis_dir')]) == 6
    assert any(k.startswith('correct') for k in files)
    assert any(k.startswith('wrong') for k in files)
    want = ast.literal_eval(out.strip().splitlines()[-1])
    assert set(metrics) == set(want)
    for k in want:
        assert abs(metrics[k] - want[k]) <= 1e-6


DET_CFG = dict(
    type='DBNet',
    backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                  base_channels=8),
    neck=dict(type='FPNC', in_channels=[8, 16, 32, 64], lateral_channels=16,
              out_channels=4),
    head=dict(type='DBHead', in_channels=16, k=50),
    postprocessor=dict(type='DBPostprocessor', text_repr_type='quad'))


def test_det_test_imgs_matches_jax(tmp_path, monkeypatch, capsys):
    from tps_pp_tpu.apis.detector import init_detector as jax_init_detector
    v = jax.tree.map(np.asarray, perturb_batch_stats(
        jax_init_detector(dict(model=DET_CFG),
                          img_size=(96, 128)).variables, 0))
    up2 = v['params']['head']['binarize']['up2']
    up2['kernel'] = up2['kernel'] * 6
    up2['bias'] = np.full((1,), -0.6, np.float32)
    npz, pth = str(tmp_path / 'det.npz'), str(tmp_path / 'det.pth')
    save_variables(npz, v)
    torch.save({'state_dict': state_dict_from_jax(v, DET_CFG)}, pth)
    cfg = tmp_path / 'det_cfg.py'
    cfg.write_text(f'model = {DET_CFG!r}\nimg_size = (96, 128)\n')
    root = tmp_path / 'pages'
    (root / 'a').mkdir(parents=True)
    g = np.random.default_rng(0)
    names = ['a/p0.png', 'p1.png', 'a/p2.png']
    for i, n in enumerate(names):
        cv2.imwrite(str(root / n), g.integers(0, 256, (96 + 20 * i, 128, 3),
                                              np.uint8))
    lst = tmp_path / 'list.txt'
    lst.write_text('\n'.join(names))
    args = [str(root), str(lst), str(cfg), '--batch-size', '2']
    total = det_test_imgs.main(args[:3] + [pth] + args[3:] + [
        '--out-dir', str(tmp_path / 'port'), '--device', 'cpu'])
    run_jax_tool('det_test_imgs', args[:3] + [npz] + args[3:] + [
        '--out-dir', str(tmp_path / 'jax')], monkeypatch, capsys)
    files = same_trees(tmp_path / 'port', tmp_path / 'jax')
    assert sorted(files) == sorted(
        [f'out_txt_dir/{n}.txt' for n in ('a_p0', 'p1', 'a_p2')] +
        [f'out_vis_dir/{n}.jpg' for n in ('a_p0', 'p1', 'a_p2')])
    assert total >= 5


def test_kie_test_imgs_matches_jax(tmp_path, monkeypatch, capsys):
    from test_torch_kie_ner import write_receipts

    from tps_pp_tpu.apis.train_kie import build_sdmgr_apply as jax_apply
    from tps_pp_tpu.apis.train_kie import build_task_dataset as jax_ds
    from tps_pp_tpu.config import load_config, merge_cli_options
    ann, lines = write_receipts(tmp_path, n=4)
    g = np.random.default_rng(1)
    for ln in lines[:2]:            # the other two are drawn on a canvas
        cv2.imwrite(str(tmp_path / ln['file_name']), g.integers(
            0, 256, (ln['height'], ln['width'], 3), np.uint8))
    cfg_path = os.path.join(
        REPO, 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py')
    opts = [f'data.test.ann_file={ann}', 'data.test.dict_file=',
            f'data.test.img_prefix={tmp_path}', 'data.test.max_nodes=8',
            'data.test.max_chars=8', 'data.test.with_visual=False',
            'model.head.node_embed=16', 'model.head.edge_embed=16',
            'model.head.fusion_dim=32']
    from tps_pp_tpu_torch.tools.test import parse_cfg_options
    cfg = merge_cli_options(load_config(cfg_path), parse_cfg_options(opts))
    ds = jax_ds(cfg, 'test')
    _, variables, visual = jax_apply(cfg, None, ds[0])
    assert not visual
    variables = jax.tree.map(lambda a: np.asarray(a) * 3, variables)
    npz, pth = str(tmp_path / 'kie.npz'), str(tmp_path / 'kie.pth')
    save_variables(npz, variables)
    torch.save({'state_dict': state_dict_from_jax(
        variables, dict(cfg['model'], visual_modality=False))}, pth)
    n = kie_test_imgs.main([cfg_path, pth, '--out-dir', str(tmp_path / 'p'),
                            '--device', 'cpu', '--cfg-options'] + opts)
    run_jax_tool('kie_test_imgs', [cfg_path, npz, '--out-dir',
                                   str(tmp_path / 'j'), '--cfg-options'] +
                 opts, monkeypatch, capsys)
    files = same_trees(tmp_path / 'p', tmp_path / 'j')
    assert n == 4 and len(files) == 8
    for k, path in files.items():
        if not k.endswith('.json'):
            continue
        got = json.load(open(path))
        want = json.load(open(os.path.join(tmp_path / 'j', k)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a['text'], a['box'], a['pred']) == \
                (b['text'], b['box'], b['pred'])
            assert abs(a['conf'] - b['conf']) <= 1e-5
