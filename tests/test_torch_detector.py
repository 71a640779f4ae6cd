"""The port's detection entry points against the JAX package's on the CPU:
``TextDetector.detect_batch`` at odd batch sizes on one narrow DBNet's
weights (its map scaled so that it crosses the mask threshold in tens of
blobs a page),
``init_detector`` from a ``.pth``, the refusal of the detector types
not ported, ``TextDetDataset`` in test mode and its ``evaluate``, and
``tools/test.py`` on a config shaped like the shipped one, whose
``data.test`` is a ``UniformConcatDataset`` of ``IcdarDataset``s (which
the JAX CLI cannot build)."""
import json
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
from torch_port_util import perturb_batch_stats

from tps_pp_tpu.apis.detector import TextDetector as JaxDetector
from tps_pp_tpu.datasets.textdet_dataset import TextDetDataset as JaxDataset

from tps_pp_tpu_torch.apis import TextDetector, init_detector
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.datasets import TextDetDataset, build_dataset
from tps_pp_tpu_torch.registry import DATASETS
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (96, 128)
CFG = dict(
    type='DBNet',
    backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                  base_channels=8),
    neck=dict(type='FPNC', in_channels=[8, 16, 32, 64], lateral_channels=16,
              out_channels=4),
    head=dict(type='DBHead', in_channels=16, k=50),
    postprocessor=dict(type='DBPostprocessor', text_repr_type='quad'))


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pages(n, seed=0, size=SIZE):
    """Seeded uint8 BGR noise (tens of boxes a page on these weights)."""
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (*size, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope='module')
def detectors(tmp_path_factory):
    """(JAX detector, the port's, the state dict, a .pth of it), on one
    set of weights whose probability map crosses 0.3 in blobs."""
    jdet = JaxDetector(CFG, img_size=SIZE)
    v = jax.tree.map(np.asarray, perturb_batch_stats(jdet.variables, 0))
    up2 = v['params']['head']['binarize']['up2']
    up2['kernel'] = up2['kernel'] * 3
    up2['bias'] = np.full((1,), -0.6, np.float32)
    jdet.variables = v
    sd = state_dict_from_jax(v, CFG)
    det = TextDetector(CFG, img_size=SIZE, device='cpu')
    det.model.load_state_dict(sd, strict=True)
    pth = str(tmp_path_factory.mktemp('det') / 'dbnet.pth')
    torch.save({'meta': {}, 'state_dict': sd}, pth)
    return jdet, det, sd, pth


def same_boundaries(got, want):
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for a, b in zip(g_img, w_img):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a[:-1], b[:-1], atol=1e-3, rtol=0)
            np.testing.assert_allclose(a[-1], b[-1], atol=1e-6, rtol=0)


@pytest.mark.parametrize('n', [1, 3, 5])
def test_detect_batch_matches_jax_at_odd_batch_sizes(detectors, n):
    jdet, det, _, _ = detectors
    imgs = pages(n, seed=n)
    got = det.detect_batch(imgs)
    same_boundaries(got, jdet.detect_batch(imgs))
    assert sum(len(b) for b in got) >= 10 * n
    assert det.detect(imgs[0]) is not None


def test_detect_scales_boundaries_back_to_the_image(detectors):
    """A page of another size goes through resize_u8 (within one grey
    level of cv2's resize); the boundaries come back in its coordinates:
    the same as the JAX detector on the port's resized input, scaled."""
    jdet, det, _, _ = detectors
    big = pages(1, seed=11, size=(150, 230))[0]
    got = det.detect(big)
    inner, sx, sy = det.prep(big)
    assert (sx, sy) == (230 / SIZE[1], 150 / SIZE[0])
    want = jdet.detect((inner * 255).round().astype(np.uint8))
    for b in want:
        b[:-1:2] *= sx
        b[1:-1:2] *= sy
    same_boundaries([got], [want])


def test_init_detector_from_a_pth(detectors):
    jdet, _, sd, pth = detectors
    det = init_detector(dict(model=CFG), pth, img_size=SIZE, device='cpu')
    assert det.device.type == 'cpu' and not det.model.training
    got = det.model.state_dict()
    assert got.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(got[k], t), k
    imgs = pages(2, seed=7)
    same_boundaries(det.detect_batch(imgs), jdet.detect_batch(imgs))
    with pytest.raises(ValueError):
        init_detector(dict(model=CFG), pth[:-4] + '.npz', device='cpu')


def test_other_detector_types_raise():
    """Every family of the JAX package builds, Mask R-CNN last (it raised
    before its port): the CTW1500 config at full width through
    ``init_detector`` (R50, FPN 256, RPN of 5 anchors, box FCs of 1024,
    mask convs of 256); a type that is not a detector raises."""
    det = init_detector(os.path.join(REPO, 'configs/textdet/maskrcnn/'
                                     'mask_rcnn_r50_fpn_160e_ctw1500.py'),
                        device='cpu')
    m = det.model
    assert det.det_type == 'OCRMaskRCNN' and not m.training
    assert m.rpn_head.rpn_cls.out_channels == 5
    assert m.roi_head.bbox_head.shared_fcs[0].in_features == 256 * 49
    assert m.roi_head.bbox_head.fc_cls.out_features == 2
    assert m.roi_head.mask_head.upsample.out_channels == 256
    with pytest.raises(ValueError, match='not a detector type'):
        init_detector(dict(model=dict(CFG, type='SDMGR')), device='cpu')


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TextDetector(CFG, img_size=SIZE)


# ----------------------------------------------------------- datasets --

def write_dataset(root, sizes, seed=0):
    """Images of ``sizes`` and a JSON-lines annotation file with cared and
    don't-care polygons; returns the annotation path."""
    g = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'imgs'), exist_ok=True)
    lines = []
    for i, (h, w) in enumerate(sizes):
        name = f'img_{i}.png'
        cv2.imwrite(os.path.join(root, 'imgs', name),
                    g.integers(0, 256, (h, w, 3), np.uint8))
        anns = []
        for j in range(int(g.integers(1, 5))):
            x, y = g.uniform(0, w - 20), g.uniform(0, h - 12)
            bw, bh = g.uniform(8, 20), g.uniform(5, 12)
            anns.append({'polygon': [x, y, x + bw, y, x + bw, y + bh, x,
                                     y + bh],
                         'text': 'ab', 'ignore': bool(j == 2)})
        lines.append(json.dumps({'file_name': name, 'annotations': anns}))
    ann = os.path.join(root, 'ann.jsonl')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


def test_textdet_dataset_items_and_evaluate_match_jax(tmp_path):
    ann = write_dataset(str(tmp_path), [(60, 90), (96, 128), (130, 70)])
    prefix = str(tmp_path / 'imgs')
    ds = TextDetDataset(ann, img_prefix=prefix, img_size=SIZE,
                        test_mode=True)
    jds = JaxDataset(ann, img_prefix=prefix, img_size=SIZE, test_mode=True)
    assert len(ds) == len(jds) == 3
    assert DATASETS.get('IcdarDataset') is TextDetDataset
    for i in range(3):
        got, want = ds[i], jds[i]
        assert got['img'].shape == (*SIZE, 3)
        # resize_u8 is within one grey level of cv2.resize
        assert np.abs(got['img'] - want['img']).max() <= 1 / 255 + 1e-6
        for key in ('gt_polygons', 'gt_polygons_ignore'):
            assert len(got[key]) == len(want[key])
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b)
        assert got['img_metas'] == want['img_metas']
        assert ds.sample(i)['img_metas'] == got['img_metas']
    g = np.random.default_rng(1)
    preds = [[np.append(p.reshape(-1) + g.uniform(-3, 3, 8),
                        0.9).astype(np.float32)
              for p in jds[i]['gt_polygons'] + jds[i]['gt_polygons_ignore']]
             for i in range(3)]
    preds[1] = preds[1][1:]
    for metric in ('hmean-iou', 'hmean-ic13'):
        fresh = TextDetDataset(ann, img_prefix=prefix, img_size=SIZE,
                               test_mode=True)
        assert fresh.evaluate(preds, metric=metric) == \
            jds.evaluate(preds, metric=metric)


def test_textdet_dataset_in_train_mode_raises(tmp_path):
    """Train mode builds now (its items carry DBNet's maps,
    ``tests/test_torch_det_train.py``); what raises is a ``target_cfg``
    that ``DBNetTargets`` does not take, as in JAX."""
    ann = write_dataset(str(tmp_path), [(40, 60)])
    ds = TextDetDataset(ann, img_prefix=str(tmp_path / 'imgs'),
                        img_size=SIZE)
    assert ds[0]['gt_shrink'].shape == SIZE
    for cls in (TextDetDataset, JaxDataset):
        with pytest.raises(TypeError, match='unexpected keyword'):
            cls(ann, img_prefix=str(tmp_path / 'imgs'),
                target_cfg=dict(shrink=0.4))


# ---------------------------------------------------------- tools/test --

def write_config(root, ann):
    """A config shaped like dbnet_r18_fpnc_1200e_icdar2015.py: data.test a
    UniformConcatDataset of IcdarDatasets with the test pipeline; the
    dataset's size is the detector's, so that no image is resized."""
    path = os.path.join(root, 'dbnet_toy.py')
    with open(path, 'w') as f:
        f.write(f'''model = {CFG!r}
det_img_size = {SIZE!r}
test = dict(type='IcdarDataset', ann_file={ann!r},
            img_prefix={os.path.join(root, 'imgs')!r}, pipeline=None,
            img_size=det_img_size)
test_pipeline = [dict(type='LoadImageFromFile',
                      color_type='color_ignore_orientation'),
                 dict(type='Collect', keys=['img'], img_scale=(1333, 736))]
data = dict(samples_per_gpu=2,
            test=dict(type='UniformConcatDataset', datasets=[test],
                      pipeline=test_pipeline))
evaluation = dict(interval=100, metric='hmean-iou')
''')
    return path


def test_tools_test_evaluates_a_uniform_concat_dbnet_config(
        detectors, tmp_path):
    """The port's CLI builds data.test through its registry, detects each
    image in batches of samples_per_gpu and prints hmean-iou; the numbers
    are those of the JAX detector and metric on the same images."""
    jdet, _, _, pth = detectors
    sizes = [SIZE] * 5
    ann = write_dataset(str(tmp_path), sizes, seed=3)
    for i, img in enumerate(pages(5, seed=21)):
        cv2.imwrite(str(tmp_path / 'imgs' / f'img_{i}.png'), img)
    cfg_path = write_config(str(tmp_path), ann)
    out = str(tmp_path / 'out.json')
    metrics = test_tool.main([cfg_path, pth, '--eval', 'hmean-iou',
                              '--out', out], device='cpu')
    jds = JaxDataset(ann, img_prefix=str(tmp_path / 'imgs'), img_size=SIZE,
                     test_mode=True)
    preds = jdet.detect_batch([(jds[i]['img'] * 255).astype(np.uint8)
                               for i in range(5)])
    want = jds.evaluate(preds, metric='hmean-iou')
    assert {k.split('_')[-1] for k in metrics} == set(want)
    for k, v in want.items():
        assert metrics[f'mean_{k}'] == v
    saved = json.load(open(out))
    assert saved['metrics'] == metrics
    assert len(saved['results']) == 5
    same_boundaries([[np.asarray(b, np.float32) for b in r]
                     for r in saved['results']], preds)
    ic13 = test_tool.main([cfg_path, pth, '--eval', 'hmean-ic13',
                           '--batch-size', '3'], device='cpu')
    assert ic13['mean_hmean'] == jds.evaluate(preds, 'hmean-ic13')['hmean']


def test_jax_cli_cannot_build_the_uniform_concat_test_set(tmp_path):
    """The JAX CLI passes cfg.data.test to TextDetDataset(**d), which a
    UniformConcatDataset entry (the shipped DBNet configs') cannot
    satisfy; the port builds it (the test above)."""
    ann = write_dataset(str(tmp_path), [SIZE], seed=4)
    cfg_path = write_config(str(tmp_path), ann)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, 'tools/test.py', cfg_path,
                          '--eval', 'hmean-iou'], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "missing 1 required positional argument: 'ann_file'" in \
        out.stderr
    ds = build_dataset(load_config(cfg_path)['data']['test'],
                       dict(test_mode=True))
    assert len(ds) == 1 and isinstance(ds.datasets[0], TextDetDataset)
