"""The port's ``MMOCR`` against the JAX package's on the CPU: ``readtext``
with a narrow DBNet and the tiny flagship recognizer on the same weights
gives the same boxes, texts and merged lines, for pages as arrays and as
files; recognition alone; ``output`` writes the returned value; ``kie=``
labels the boxes as JAX's does; ``img_out_dir`` draws JAX's page;
``TextRecInference``; and the box utilities against JAX's."""
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch
from torch_port_util import jax_flagship, perturb_batch_stats

from tps_pp_tpu.apis.ocr import MMOCR as JaxMMOCR
from tps_pp_tpu.apis.ocr import TextRecInference as JaxRecInference
from tps_pp_tpu.utils import box_util as jbox

from tps_pp_tpu_torch.apis import MMOCR, TextRecInference
from tps_pp_tpu_torch.utils import box_util
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

SIZE = (96, 128)
DET_CFG = dict(
    type='DBNet',
    backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                  base_channels=8),
    neck=dict(type='FPNC', in_channels=[8, 16, 32, 64], lateral_channels=16,
              out_channels=4),
    head=dict(type='DBHead', in_channels=16, k=50),
    postprocessor=dict(type='DBPostprocessor', text_repr_type='quad'))
PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
                 std=[0.229, 0.224, 0.225]),
            dict(type='Collect', keys=['img'])]


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def ocrs(tmp_path_factory):
    """(JAX MMOCR, the port's): the detector's weights carried across,
    the recognizer's through one .pth both load."""
    _, rv, rcfg = jax_flagship(tiny=True, seed=2)
    pth = str(tmp_path_factory.mktemp('rec') / 'tiny.pth')
    torch.save({'state_dict': state_dict_from_jax(rv, rcfg)}, pth)
    # input_shape: the JAX init's shape for the tiny model's variables
    recog = dict(model=rcfg, test_pipeline=PIPELINE, input_shape=(32, 64, 3))
    jocr = JaxMMOCR(det='DBNet', recog='NRTR_TPS', det_config=dict(
        model=DET_CFG), recog_config=recog, recog_ckpt=pth,
        det_img_size=SIZE)
    v = jax.tree.map(np.asarray,
                     perturb_batch_stats(jocr.detector.variables, 0))
    up2 = v['params']['head']['binarize']['up2']
    up2['kernel'] = up2['kernel'] * 3
    up2['bias'] = np.full((1,), -0.6, np.float32)
    jocr.detector.variables = v
    ocr = MMOCR(det='DBNet', recog='NRTR_TPS', det_config=dict(model=DET_CFG),
                recog_config=recog, recog_ckpt=pth, det_img_size=SIZE,
                device='cpu')
    ocr.detector.model.load_state_dict(state_dict_from_jax(v, DET_CFG),
                                       strict=True)
    return jocr, ocr, recog, pth


def pages(n, seed=0):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (*SIZE, 3), np.uint8) for _ in range(n)]


def same_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a['filename'] == b['filename']
        assert set(a) == set(b)
        assert len(a['result']) == len(b['result'])
        for r, s in zip(a['result'], b['result']):
            assert set(r) == set(s)
            np.testing.assert_allclose(r['box'], s['box'], atol=1e-3)
            assert abs(r['box_score'] - s['box_score']) <= 1e-6
            assert r['text'] == s['text']
            if 'text_score' in r:
                assert abs(r['text_score'] - s['text_score']) <= 1e-3
        for r, s in zip(a.get('merged', []), b.get('merged', [])):
            assert r['text'] == s['text']
            np.testing.assert_allclose(r['box'], s['box'], atol=1e-3)


@pytest.mark.parametrize('merge', [False, True])
def test_readtext_matches_jax(ocrs, merge):
    jocr, ocr, _, _ = ocrs
    imgs = pages(2)
    got = ocr.readtext(imgs, merge=merge, details=True)
    same_results(got, jocr.readtext(imgs, merge=merge, details=True))
    texts = [r['text'] for page in got for r in page['result']]
    assert len(texts) >= 20 and len(set(texts)) > 1
    if merge:
        assert all(len(p['merged']) >= 1 for p in got)


def test_readtext_of_files_writes_the_result(ocrs, tmp_path):
    jocr, ocr, _, _ = ocrs
    paths = []
    for i, img in enumerate(pages(2, seed=1)):
        paths.append(str(tmp_path / f'page_{i}.png'))
        cv2.imwrite(paths[-1], img)
    out = str(tmp_path / 'out.json')
    got = ocr.readtext(paths[0], output=out, merge=True)
    same_results(got, jocr.readtext(paths[0], merge=True))
    assert json.load(open(out)) == json.loads(json.dumps(got))
    assert 'text_score' not in got[0]['result'][0]
    det = ocr.detect(paths[1])
    want = jocr.detect(paths[1])
    assert len(det) == len(want)
    for a, b in zip(det, want):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_recognition_only_matches_jax(ocrs):
    jocr, _, recog, pth = ocrs
    ocr = MMOCR(det=None, recog='NRTR_TPS', recog_config=recog,
                recog_ckpt=pth, device='cpu')
    jrec = JaxMMOCR(det=None, recog='NRTR_TPS', recog_config=recog,
                    recog_ckpt=pth)
    crops = [p[10:40, 5:90] for p in pages(3, seed=2)]
    got, want = ocr.readtext(crops), jrec.readtext(crops)
    assert [r['text'] for r in got] == [r['text'] for r in want]
    single = ocr.readtext(crops[0])
    assert single[0]['text'] == got[0]['text']
    rec_inf = TextRecInference(recog, pth, batch_mode=True, device='cpu')
    jrec_inf = JaxRecInference(recog, pth, batch_mode=True)
    assert [r['text'] for r in rec_inf.readtext(crops)] == \
        [r['text'] for r in jrec_inf.readtext(crops)]


def test_kie_and_drawn_output_raise(ocrs, tmp_path):
    """``kie='SDMGR'`` (on the JAX MMOCR's KIE weights, through a
    ``kie_ckpt``) labels every box as JAX's does, each ``label_score``
    within 1e-5; KIE without a recognizer fails JAX's assertion; the
    drawn result (``img_out_dir``) is the file JAX draws."""
    jocr, ocr, recog, pth = ocrs
    jocr._init_kie('SDMGR', None, 3)
    try:
        kie_cfg = dict(type='SDMGR', head=dict(type='SDMGRHead',
                                               num_chars=64, num_classes=26))
        kie_pth = str(tmp_path / 'sdmgr.pth')
        torch.save({'state_dict': state_dict_from_jax(
            {'params': {'head': jocr.kie_variables['params']}}, kie_cfg)},
            kie_pth)
        kocr = MMOCR(det='DBNet', recog='NRTR_TPS',
                     det_config=dict(model=DET_CFG), recog_config=recog,
                     recog_ckpt=pth, det_img_size=SIZE, kie='SDMGR',
                     kie_ckpt=kie_pth, device='cpu')
        kocr.detector.model.load_state_dict(ocr.detector.model.state_dict())
        imgs = pages(2)
        got = kocr.readtext(imgs, details=True)
        want = jocr.readtext(imgs, details=True)
    finally:
        jocr.kie_head = None
    same_results(got, want)
    boxes = [(r, s) for a, b in zip(got, want)
             for r, s in zip(a['result'], b['result'])]
    assert len(boxes) >= 20
    for r, s in boxes:
        assert r['label'] == s['label']
        assert abs(r['label_score'] - s['label_score']) <= 1e-5
    assert len({r['label'] for r, _ in boxes}) > 1
    with pytest.raises(AssertionError, match='KIE requires'):
        MMOCR(det=None, recog='NRTR_TPS', recog_config=recog, recog_ckpt=pth,
              kie='SDMGR', device='cpu')
    # the drawn page (img_out_dir) is JAX's, byte for byte
    page = pages(1, seed=4)[0]
    mine, theirs = tmp_path / 'port_vis', tmp_path / 'jax_vis'
    theirs.mkdir()
    got = ocr.readtext(page, img_out_dir=str(mine))
    same_results(got, jocr.readtext(page, img_out_dir=str(theirs)))
    assert len(got[0]['result']) >= 5
    assert os.listdir(mine) == os.listdir(theirs) == ['out_img_0.jpg']
    assert (mine / 'out_img_0.jpg').read_bytes() == \
        (theirs / 'out_img_0.jpg').read_bytes()


def word_boxes(seed):
    g = np.random.default_rng(seed)
    out = []
    for i in range(int(g.integers(0, 12))):
        x, y = g.uniform(0, 300), float(g.integers(0, 4)) * 30 + \
            g.uniform(-4, 4)
        w, h = g.uniform(5, 60), g.uniform(10, 20)
        out.append({'box': [x, y, x + w, y, x + w, y + h, x, y + h],
                    'text': f'w{i}'})
    return out


@pytest.mark.parametrize('seed', range(6))
def test_box_util_matches_jax(seed):
    boxes = word_boxes(seed)
    for dist in (5, 20, 60):
        for ratio in (0.5, 0.8, None):
            assert box_util.stitch_boxes_into_lines(
                boxes, dist, ratio) == jbox.stitch_boxes_into_lines(
                boxes, dist, ratio)
    for a in boxes:
        for b in boxes:
            assert box_util.is_on_same_line(a['box'], b['box']) == \
                jbox.is_on_same_line(a['box'], b['box'])
    img = np.random.default_rng(seed).integers(0, 256, (120, 360, 3),
                                               np.uint8)
    for b in boxes:
        np.testing.assert_array_equal(box_util.crop_img(img, b['box']),
                                      jbox.crop_img(img, b['box']))
