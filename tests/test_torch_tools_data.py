"""The port's data and model CLIs (``tps_pp_tpu_torch/tools/data/*``,
``tools/misc/print_config.py``, ``publish_model``, ``convert_checkpoint``,
``benchmark_processing``) against the JAX CLIs under ``tools/`` on the
same small inputs made from a seed, on the CPU.

* Each converter writes output byte-equal to the JAX CLI's: label files,
  TPSPACK1 files, JSON lines; ``textrecog_converter``'s crops decode to
  the same pixels (a PNG source image is decoded without cv2 on the
  port's side). The LMDB branches raise an ``ImportError`` naming
  ``pack_converter`` where python-lmdb is absent.
* ``print_config`` prints what JAX's prints for shipped configs (the
  address of a function value aside).
* ``publish_model`` keeps the weights alone and names the file after its
  sha256; ``convert_checkpoint`` round-trips a ``.pth`` made by
  ``state_dict_from_jax`` and raises on a key its rules do not cover;
  ``benchmark_processing`` runs on a tiny config, with ``--profile``.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from tps_pp_tpu_torch.tools import (benchmark_processing, convert_checkpoint,
                                    publish_model)
from tps_pp_tpu_torch.tools.data import (closeset_to_openset, lmdb_converter,
                                         pack_converter, textdet_converter,
                                         textrecog_converter)
from tps_pp_tpu_torch.tools.misc import print_config
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_util import jax_flagship

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
try:
    import lmdb  # noqa: F401
    HAVE_LMDB = True
except ImportError:
    HAVE_LMDB = False


def jax_cli(rel):
    """The JAX CLI at ``tools/<rel>`` as a module."""
    name = 'jax_cli_' + rel.replace('/', '_')[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['cli'] + [str(a) for a in argv])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mod.main()
    return out.getvalue()


def label_text(g, n=6):
    words = ['hello', 'wörld', 'a,b', 'x', 'TPS++', '12']
    return [f'{w}{int(g.integers(0, 99))}' for w in words[:n]]


# ---------------------------------------------------------------- packing

def test_pack_converter_matches_jax(tmp_path, monkeypatch):
    g = np.random.default_rng(0)
    txt = tmp_path / 'label.txt'
    txt.write_text('\n'.join(f'img_{i}.jpg {t}' for i, t in
                             enumerate(label_text(g))) + '\n\n \n',
                   encoding='utf-8')
    assert pack_converter.main([str(txt), str(tmp_path / 'port.pack')]) == 6
    run_jax_main(jax_cli('data/pack_converter.py'),
                 [txt, tmp_path / 'jax.pack'], monkeypatch)
    assert (tmp_path / 'port.pack').read_bytes() == \
        (tmp_path / 'jax.pack').read_bytes()
    if not HAVE_LMDB:
        with pytest.raises(ImportError, match='pack_converter'):
            pack_converter.main([str(tmp_path / 'x.lmdb'),
                                 str(tmp_path / 'y.pack'), '--from-lmdb'])


@pytest.mark.parametrize('mode', ['txt2pack', 'pack2txt'])
def test_lmdb_converter_matches_jax(tmp_path, mode):
    g = np.random.default_rng(1)
    jax_conv = jax_cli('data/lmdb_converter.py')
    txt = tmp_path / 'label.txt'
    txt.write_text('\n'.join(label_text(g)) + '\n', encoding='utf-8')
    src = txt
    if mode == 'pack2txt':
        src = tmp_path / 'label.pack'
        jax_conv.txt2pack(str(txt), str(src))
    ours, theirs = tmp_path / 'port.out', tmp_path / 'jax.out'
    assert lmdb_converter.main([mode, str(src), str(ours)]) == 6
    getattr(jax_conv, mode)(str(src), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    if not HAVE_LMDB:
        for m in ('txt2lmdb', 'lmdb2txt'):
            with pytest.raises(ImportError, match='pack_converter'):
                lmdb_converter.main([m, str(txt), str(tmp_path / 'x')])


# ---------------------------------------------------- recognition crops

def _write_image(path, g, hw=(64, 96)):
    import cv2
    img = g.integers(0, 256, hw + (3,), np.uint8)
    cv2.imwrite(str(path), img)


def _recog_inputs(kind, root, g):
    """(annotation path, image root) of a small ``kind`` dataset."""
    import cv2
    from scipy.io import savemat
    im = root / 'im'
    im.mkdir()
    if kind == 'svt':
        _write_image(im / 'a.jpg', g)
        _write_image(im / 'b.png', g, (50, 70))
        xml = ('<tagset>'
               '<image><imageName>a.jpg</imageName><taggedRectangles>'
               '<taggedRectangle x="4" y="6" width="30" height="20">'
               '<tag>HELLO</tag></taggedRectangle>'
               '<taggedRectangle x="-5" y="40" width="40" height="40">'
               '<tag>EDGE</tag></taggedRectangle>'
               '<taggedRectangle x="200" y="2" width="5" height="5">'
               '<tag>OUT</tag></taggedRectangle>'
               '</taggedRectangles></image>'
               '<image><imageName>b.png</imageName><taggedRectangles>'
               '<taggedRectangle x="10" y="10" width="25" height="15">'
               '<tag>PNG</tag></taggedRectangle></taggedRectangles></image>'
               '<image><imageName>missing.jpg</imageName>'
               '<taggedRectangles/></image></tagset>')
        (root / 'test.xml').write_text(xml)
        return root / 'test.xml', im
    if kind == 'totaltext':
        ann = root / 'ann'
        ann.mkdir()
        _write_image(im / 'img1.jpg', g)
        (ann / 'poly_gt_img1.txt').write_text(
            "x: [[10 50 50 10]], y: [[10 10 30 30]], ornt: [u'h'], "
            "transcriptions: [u'word']\n"
            "x: [[1 9 9 1]], y: [[1 1 9 9]], ornt: [u'#'], "
            "transcriptions: [u'#']\n"
            "x: [[60 90 90 60]], y: [[40 40 60 60]], ornt: [u'c'], "
            "transcriptions: [u'two']\n")
        return ann, im
    if kind == 'jsonl':
        f = root / 'ann.jsonl'
        f.write_text('{"filename": "a.jpg", "text": "foo"}\n\n'
                     '{"filename": "b/c.jpg", "text": "b\\u00e4r"}\n')
        return f, im
    if kind in ('synthtext', 'seg_synthtext'):
        cv2.imwrite(str(im / 'a.jpg'), g.integers(0, 256, (64, 96, 3),
                                                  np.uint8))
        word_bb = np.zeros((2, 4, 2), np.float64)
        word_bb[:, :, 0] = [[4, 40, 40, 4], [4, 4, 20, 20]]
        word_bb[:, :, 1] = [[50, 80, 80, 50], [4, 4, 20, 20]]
        char_bb = np.zeros((2, 4, 3), np.float64)
        for i, x0 in enumerate((4, 22, 50)):
            char_bb[:, :, i] = [[x0, x0 + 14, x0 + 14, x0], [4, 4, 20, 20]]
        gt = {'imnames': np.array([[np.array(['a.jpg'])]], dtype=object),
              'txt': np.array([[np.array(['ab c'])]], dtype=object),
              'wordBB': np.empty((1, 1), object),
              'charBB': np.empty((1, 1), object)}
        gt['wordBB'][0, 0] = word_bb
        gt['charBB'][0, 0] = char_bb
        savemat(root / 'gt.mat', gt)
        return root / 'gt.mat', im
    if kind == 'textocr':
        _write_image(im / 'x.jpg', g)
        data = {'imgs': {'1': {'file_name': 'x.jpg'},
                         '2': {'file_name': 'gone.jpg'}},
                'imgToAnns': {'1': [0, 1, 2], '2': [0]},
                'anns': [{'bbox': [4, 4, 20, 12], 'utf8_string': 'abc'},
                         {'bbox': [30, 30, 10, 10], 'utf8_string': '.'},
                         {'bbox': [50, 20, 60, 30], 'utf8_string': 'wide'}]}
        (root / 'TextOCR.json').write_text(json.dumps(data))
        return root / 'TextOCR.json', im
    assert kind == 'openvino'
    _write_image(im / 'y.jpg', g)
    data = {'images': [{'id': 7, 'file_name': 'y.jpg'}],
            'annotations': [
                {'image_id': 7, 'bbox': [2, 2, 16, 10],
                 'attributes': {'transcription': 'ok', 'legible': True,
                                'language': 'english'}},
                {'image_id': 7, 'bbox': [2, 20, 16, 10],
                 'attributes': {'transcription': 'non', 'legible': True,
                                'language': 'french'}},
                {'image_id': 7, 'bbox': [20, 30, 30, 12],
                 'attributes': {'transcription': 'blur', 'legible': False}},
                {'image_id': 7, 'bbox': [40, 40, 20, 10],
                 'attributes': {'transcription': 'yes'}}]}
    (root / 'ov.json').write_text(json.dumps(data))
    return root / 'ov.json', im


RECOG_KINDS = ['svt', 'totaltext', 'jsonl', 'synthtext', 'seg_synthtext',
               'textocr', 'openvino']


@pytest.mark.parametrize('kind', RECOG_KINDS)
def test_textrecog_converter_matches_jax(tmp_path, monkeypatch, kind):
    import cv2
    g = np.random.default_rng(RECOG_KINDS.index(kind))
    ann, im = _recog_inputs(kind, tmp_path, g)
    ours, theirs = tmp_path / 'port', tmp_path / 'jax'
    lines = textrecog_converter.main([kind, str(ann), str(im), str(ours),
                                      '--pack'])
    run_jax_main(jax_cli('data/textrecog_converter.py'),
                 [kind, ann, im, theirs, '--pack'], monkeypatch)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in os.listdir(theirs):
        a, b = (ours / name).read_bytes(), (theirs / name).read_bytes()
        if name.endswith('.jpg'):
            np.testing.assert_array_equal(
                cv2.imread(str(ours / name)), cv2.imread(str(theirs / name)))
        else:
            assert a == b, name
    crops = [ln for ln in lines if not ln.startswith('#')]
    if kind not in ('jsonl', 'seg_synthtext'):
        assert crops and all((ours / ln.split()[0]).exists()
                             for ln in crops)


# ----------------------------------------------------- detection lines

def _det_inputs(kind, root, g):
    from scipy.io import savemat
    if kind == 'icdar':
        gt, img = root / 'gt', root / 'imgs'
        gt.mkdir()
        img.mkdir()
        for stem, ext in (('img_1', '.jpg'), ('img_2', '.png'),
                          ('img_3', '.JPG')):
            (img / f'{stem}{ext}').write_bytes(b'')
        (gt / 'gt_img_1.txt').write_bytes(
            '﻿10,10,50,10,50,30,10,30,hello\n5,5,9,5,9,9,5,9,###\n'
            '1,2,3\n'.encode())
        (gt / 'gt_img_2.txt').write_text('0,0,4,0,4,4,0,4,a,b\n')
        return gt, img
    if kind == 'ctw1500':
        (root / '0001.txt').write_text(
            ','.join(str(v) for v in [10, 20, 110, 80] +
                     list(range(28))) + ',####text\n'
            '1,2,3,4,5,6,7,8,"plain"\n1,2,3\n')
        return root, root
    if kind == 'totaltext':
        (root / 'poly_gt_img1.txt').write_text(
            "x: [[10 50 50 10]], y: [[10 10 30 30]], ornt: [u'h'], "
            "transcriptions: [u'word']\n"
            "x: [[1 9 9]], y: [[1 1 9]], ornt: [u'#'], "
            "transcriptions: [u'#']\n")
        return root, root
    if kind == 'coco':
        coco = {'images': [{'id': 1, 'file_name': 'a.jpg'},
                           {'id': 2, 'file_name': 'b.jpg'}],
                'annotations': [
                    {'image_id': 1, 'segmentation': [[0, 0, 10, 0, 10, 10,
                                                      0, 10]], 'iscrowd': 0},
                    {'image_id': 1, 'segmentation': [[1, 1, 2, 1, 2, 2, 1,
                                                      2]], 'iscrowd': 1},
                    {'image_id': 2, 'segmentation': [[1, 1, 2, 2]]},
                    {'image_id': 3, 'segmentation': [[0, 0, 1, 0, 1, 1, 0,
                                                      1]]}]}
        (root / 'coco.json').write_text(json.dumps(coco))
        return root / 'coco.json', root
    if kind == 'synthtext':
        return _recog_inputs('synthtext', root, g)
    assert kind == 'textocr'
    data = {'imgs': {'1': {'file_name': 'x.jpg'}},
            'anns': {'1_1': {'image_id': '1', 'bbox': [4, 4, 20, 12],
                             'utf8_string': 'abc'},
                     '1_2': {'image_id': '1', 'bbox': [1, 1, 2, 2],
                             'points': [1, 1, 3, 1, 3, 3, 1, 3],
                             'utf8_string': '.'}}}
    (root / 'TextOCR.json').write_text(json.dumps(data))
    return root / 'TextOCR.json', root


DET_KINDS = ['icdar', 'ctw1500', 'totaltext', 'coco', 'synthtext',
             'textocr']


@pytest.mark.parametrize('kind', DET_KINDS)
def test_textdet_converter_matches_jax(tmp_path, monkeypatch, kind):
    g = np.random.default_rng(10 + DET_KINDS.index(kind))
    ann, img = _det_inputs(kind, tmp_path, g)
    recs = textdet_converter.main([kind, str(ann), str(img),
                                   str(tmp_path / 'port.jsonl')])
    run_jax_main(jax_cli('data/textdet_converter.py'),
                 [kind, ann, img, tmp_path / 'jax.jsonl'], monkeypatch)
    assert recs
    assert (tmp_path / 'port.jsonl').read_bytes() == \
        (tmp_path / 'jax.jsonl').read_bytes()


@pytest.mark.parametrize('merge', [False, True])
def test_closeset_to_openset_matches_jax(tmp_path, monkeypatch, merge):
    g = np.random.default_rng(20)
    lines = []
    for i in range(4):
        anns = [{'box': [int(v) for v in g.integers(0, 100, 8)],
                 'text': f'té{j}', 'label': int(g.integers(0, 26))}
                for j in range(int(g.integers(3, 9)))]
        lines.append(json.dumps({'file_name': f'r{i}.jpg', 'height': 100,
                                 'width': 80, 'annotations': anns}))
    src = tmp_path / 'close.txt'
    src.write_text('\n'.join(lines) + '\n\n', encoding='utf-8')
    extra = ['--merge'] if merge else []
    assert closeset_to_openset.main(
        [str(src), str(tmp_path / 'port.txt')] + extra) == 4
    run_jax_main(jax_cli('data/closeset_to_openset.py'),
                 [src, tmp_path / 'jax.txt'] + extra, monkeypatch)
    assert (tmp_path / 'port.txt').read_bytes() == \
        (tmp_path / 'jax.txt').read_bytes()


# ------------------------------------------------------- model tools

@pytest.mark.parametrize('config', [
    'textrecog/nrtr/nrtr_tps++.py',
    'textrecog/sar/sar_r31_parallel_decoder_academic.py',
    'textrecog/abinet/abinet_tps++.py',
    'textdet/dbnet/dbnet_r18_fpnc_1200e_icdar2015.py',
    'kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py'])
def test_print_config_matches_jax(monkeypatch, config):
    path = os.path.join(ROOT, 'configs', config)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        text = print_config.main([path])
    assert out.getvalue() == text + '\n'
    want = run_jax_main(jax_cli('misc/print_config.py'), [path], monkeypatch)

    def addr(s):
        return re.sub(r' at 0x[0-9a-f]+>', '>', s)
    assert addr(out.getvalue()) == addr(want)


@pytest.fixture(scope='module')
def tiny_pth(tmp_path_factory):
    """(config path, a .pth of the tiny flagship's JAX weights converted by
    ``state_dict_from_jax``, the state dict)."""
    _, v, cfg = jax_flagship(tiny=True, seed=3)
    d = tmp_path_factory.mktemp('tiny')
    cfg_path = d / 'tiny_cfg.py'
    cfg_path.write_text(f'model = {cfg!r}\ninput_shape = (32, 64, 3)\n')
    sd = state_dict_from_jax(v, cfg)
    torch.save({'meta': {'epoch': 3}, 'state_dict': sd,
                'optimizer': {'state': {}, 'count': 7}}, d / 'epoch_3.pth')
    return str(cfg_path), d, sd


def test_publish_model_strips_and_hashes(tiny_pth, tmp_path):
    import hashlib
    cfg_path, work_dir, sd = tiny_pth
    out = publish_model.main([str(work_dir), str(tmp_path / 'tiny'),
                              '--config', cfg_path])
    data = open(out, 'rb').read()
    digest = hashlib.sha256(data).hexdigest()[:8]
    assert out == str(tmp_path / f'tiny-{digest}.pth')
    ckpt = torch.load(out, weights_only=True)
    assert list(ckpt) == ['state_dict']
    assert ckpt['state_dict'].keys() == sd.keys()
    assert all(torch.equal(ckpt['state_dict'][k], sd[k]) for k in sd)
    assert not os.path.exists(str(tmp_path / 'tiny') + '.pth.tmp')


def test_convert_checkpoint_round_trip_and_coverage(tiny_pth, tmp_path):
    cfg_path, work_dir, sd = tiny_pth
    out = tmp_path / 'weights.pth'
    got = convert_checkpoint.main([str(work_dir / 'epoch_3.pth'), str(out),
                                   '--config', cfg_path, '--device', 'cpu'])
    assert got['verified'] and got['tensors'] == len(sd)
    back = torch.load(out, weights_only=True)['state_dict']
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    stray = dict(sd, **{'decoder.extra_head.weight': torch.zeros(2)})
    torch.save(stray, tmp_path / 'stray.pth')
    with pytest.raises(ValueError, match='decoder.extra_head.weight'):
        convert_checkpoint.main([str(tmp_path / 'stray.pth'),
                                 str(tmp_path / 'x.pth'), '--config',
                                 cfg_path, '--device', 'cpu', '--no-verify'])
    short = {k: t for k, t in sd.items() if not k.startswith('decoder.')}
    torch.save(short, tmp_path / 'short.pth')
    with pytest.raises(ValueError, match='not in the checkpoint'):
        convert_checkpoint.main([str(tmp_path / 'short.pth'),
                                 str(tmp_path / 'y.pth'), '--config',
                                 cfg_path, '--device', 'cpu', '--no-verify'])


@pytest.mark.parametrize('profile', [False, True])
def test_benchmark_processing_runs(tmp_path, profile):
    from tps_pp_tpu_torch.datasets.pipelines.cv_ops import png_encode
    g = np.random.default_rng(30)
    lines = []
    for i in range(5):
        (tmp_path / f'c{i}.png').write_bytes(png_encode(g.integers(
            0, 256, (20, 40 + 7 * i, 3), np.uint8)))
        lines.append(f'c{i}.png w{i}')
    (tmp_path / 'label.txt').write_text('\n'.join(lines) + '\n')
    train = dict(type='OCRDataset', ann_file=str(tmp_path / 'label.txt'),
                 img_prefix=str(tmp_path),
                 loader=dict(type='HardDiskLoader',
                             parser=dict(type='LineStrParser')),
                 pipeline=[dict(type='LoadImageFromFile'),
                           dict(type='ResizeOCR', height=32, min_width=64,
                                max_width=64, keep_aspect_ratio=False),
                           dict(type='ToTensorOCR'),
                           dict(type='Collect', keys=['img'])])
    cfg = tmp_path / 'cfg.py'
    cfg.write_text(f'data = dict(samples_per_gpu=2, train={train!r})\n')
    argv = [str(cfg), '--n', '12'] + (['--profile'] if profile else [])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rates = benchmark_processing.main(argv)
    assert list(rates) == [0] and rates[0] > 0
    assert 'samples/sec' in out.getvalue()
    assert ('cumulative' in out.getvalue()) == profile
