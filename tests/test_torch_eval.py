"""The port's evaluation path against the JAX package's, on the CPU:

* ``eval_ocr_metric`` / ``count_matches`` / ``levenshtein`` on
  hypothesis-made strings (case, symbols, digits, CJK, empty): equal.
* ``LineStrParser`` / ``LineJsonParser`` / ``HardDiskLoader`` (repeat,
  separators): equal; ``LmdbLoader`` without python-lmdb raises in both.
* ``OCRDataset`` / ``UniformConcatDataset`` on the toy dataset: equal
  metas and texts, images within one grey level after normalisation;
  ``evaluate`` equal on the same results; the ``DataLoader``'s padded
  batches and ``n_real`` equal.
* ``eval_recognizer`` on the tiny flagship with the JAX weights carried
  across (``steps``, float32, the test pipeline at width 64): the same
  texts and metric dicts, and so for the batch-1 TTA branch with
  ``force_rotate``; ``python -m tps_pp_tpu_torch.tools.test`` on a config
  with a ``.pth`` of those weights gives the JAX metrics.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_port_util import jax_flagship, jnp_tree, port_from_jax

from tps_pp_tpu.apis.test import eval_recognizer as jax_eval
from tps_pp_tpu.datasets import DataLoader as JaxDataLoader
from tps_pp_tpu.datasets import build_dataset as jax_build_dataset
from tps_pp_tpu.datasets import loader as jloader
from tps_pp_tpu.evaluation import ocr_metric as jmetric

from tps_pp_tpu_torch.apis import eval_recognizer
from tps_pp_tpu_torch.datasets import DataLoader, build_dataset
from tps_pp_tpu_torch.datasets import loader as tloader
from tps_pp_tpu_torch.evaluation import ocr_metric as tmetric
from tps_pp_tpu_torch.tools import test as tool
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, 'tests/data/ocr_toy_dataset')
NORM = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
GREY = 1.0 / 255.0 / min(NORM['std']) + 1e-6
TAIL = [dict(type='ToTensorOCR'), dict(type='NormalizeOCR', **NORM),
        dict(type='Collect', keys=['img'],
             meta_keys=['filename', 'ori_shape', 'resize_shape',
                        'valid_ratio'])]
# the flagship's test pipeline at the tiny model's width
PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False)] + TAIL
TTA_PIPELINE = [dict(type='LoadImageFromFile'),
                dict(type='MultiRotateAugOCR', rotate_degrees=[0, 90, 270],
                     force_rotate=True, transforms=PIPELINE[1:])]
LOADER = dict(type='HardDiskLoader',
              parser=dict(type='LineStrParser', keys=['filename', 'text'],
                          keys_idx=[0, 1], separator=' '))

TEXT = st.text(alphabet=st.sampled_from(
    list('abcXYZ019 -_!?.,') + ['中', '文', '字', 'é']), max_size=8)


@settings(max_examples=150, deadline=None, database=None)
@given(pairs=st.lists(st.tuples(TEXT, TEXT), max_size=8))
def test_ocr_metric_matches_jax(pairs):
    preds = [p for p, _ in pairs]
    gts = [g for _, g in pairs]
    for full in (False, True):
        assert tmetric.eval_ocr_metric(preds, gts, full=full) == \
            jmetric.eval_ocr_metric(preds, gts, full=full)
    assert tmetric.count_matches(preds, gts) == \
        jmetric.count_matches(preds, gts)
    for p, g in pairs:
        assert tmetric.levenshtein(p, g) == jmetric._levenshtein_py(p, g)
        assert tmetric._levenshtein_py(p, g) == jmetric._levenshtein_py(p, g)


def test_ocr_metric_fixed_cases():
    preds = ['hello', 'World', 'he-llo', 'nope', '', '中文!']
    gts = ['hello', 'world', 'hello', 'yes!', '', '中文?']
    got = tmetric.eval_ocr_metric(preds, gts, full=True)
    assert got == jmetric.eval_ocr_metric(preds, gts, full=True)
    assert got['word_acc_ignore_case_symbol'] == round(5 / 6, 4)


@pytest.mark.parametrize('parser,lines', [
    (dict(type='LineStrParser', keys=['filename', 'text'], keys_idx=[0, 1],
          separator=' '),
     ['  a.jpg hello ', 'b.jpg world extra', '', 'c.jpg 7']),
    (dict(type='LineStrParser', keys=['filename', 'text'], keys_idx=[0, 1],
          separator=' ,\t'),
     ['a.jpg hello', 'b.jpg,world', '', 'c.jpg\tx,y']),
    (dict(type='LineStrParser', keys=['text', 'filename'], keys_idx=[1, 0],
          separator=',', strip_pos='right', strip_str='#'),
     ['a.jpg,hello##', ' b.jpg,wor ld', '', 'c.jpg,x#']),
    (dict(type='LineJsonParser', keys=['filename', 'text']),
     [json.dumps(dict(filename=f'f{i}.jpg', text=f't {i}', extra=i))
      for i in range(3)])])
@pytest.mark.parametrize('repeat', [1, 3])
def test_hard_disk_loader_matches_jax(tmp_path, parser, lines, repeat):
    ann = tmp_path / 'ann.txt'
    ann.write_text('\n'.join(lines) + '\n', encoding='utf-8')
    cfg = dict(ann_file=str(ann), parser=parser, repeat=repeat)
    got = tloader.HardDiskLoader(**cfg)
    want = jloader.HardDiskLoader(**cfg)
    assert len(got) == len(want) == 3 * repeat
    assert list(got) == list(want)
    assert [got[i] for i in range(len(got))] == \
        [want[i] for i in range(len(want))]


def test_parser_errors_match_jax():
    for mod in (tloader, jloader):
        with pytest.raises(ValueError, match='out of range'):
            mod.LineStrParser(keys_idx=(0, 2), keys=('a', 'b')).get_item(
                ['x y'], 0)
        with pytest.raises(ValueError, match='not in line json'):
            mod.LineJsonParser(keys=('a',)).get_item(['{"b": 1}'], 0)
    with pytest.raises(FileNotFoundError):
        tloader.HardDiskLoader('/nonexistent/ann.txt', LOADER['parser'])


def test_lmdb_loader_without_lmdb_raises_in_both(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, 'lmdb', None)
    for mod in (tloader, jloader):
        with pytest.raises(ImportError, match='python-lmdb'):
            mod.LmdbLoader(str(tmp_path), LOADER['parser'])


def toy(repeat=1, pipeline=PIPELINE):
    return dict(type='OCRDataset', img_prefix=TOY,
                ann_file=os.path.join(TOY, 'label.txt'),
                loader=dict(LOADER, repeat=repeat), pipeline=pipeline,
                test_mode=True)


def bare(cfg):
    return {k: v for k, v in cfg.items() if k != 'pipeline'}


# the toy set, then the toy set twice over, with the pipeline of the concat
CONCAT = dict(type='UniformConcatDataset', datasets=[bare(toy()),
                                                     bare(toy(2))],
              pipeline=PIPELINE)


def same_item(got, want):
    assert got.keys() == want.keys()
    assert got['img_metas'] == want['img_metas']
    assert got['text'] == want['text']
    np.testing.assert_allclose(got['img'], want['img'], rtol=0, atol=GREY)


@pytest.mark.parametrize('cfg', [toy(), CONCAT], ids=['ocr', 'concat'])
def test_datasets_match_jax(cfg):
    got = build_dataset(cfg, dict(test_mode=True))
    want = jax_build_dataset(cfg, dict(test_mode=True))
    assert len(got) == len(want)
    for i in range(len(got)):
        same_item(got[i], want[i])
    texts = [want[i]['text'] for i in range(len(want))]
    g = np.random.default_rng(0)
    results = [dict(text=t if g.uniform() < 0.5 else t.upper() + '!'
                    if g.uniform() < 0.5 else 'zz', score=[0.5])
               for t in texts]
    assert got.evaluate(results) == want.evaluate(results)


@pytest.mark.parametrize('batch_size', [4, 10, 16])
def test_data_loader_batches_match_jax(batch_size):
    got_ds = build_dataset(toy(), dict(test_mode=True))
    want_ds = jax_build_dataset(toy(), dict(test_mode=True))
    got = list(DataLoader(got_ds, batch_size, pad_to_batch=True))
    want = list(JaxDataLoader(want_ds, batch_size, shuffle=False,
                              pad_to_batch=True))
    assert len(got) == len(want) == len(DataLoader(got_ds, batch_size))
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert a['n_real'] == b['n_real']
        assert a['img'].shape == b['img'].shape == (batch_size, 32, 64, 3)
        np.testing.assert_allclose(a['img'], b['img'], rtol=0, atol=GREY)
        np.testing.assert_array_equal(a['valid_ratio'], b['valid_ratio'])
        assert a['img_metas'] == b['img_metas']
        assert a['texts'] == b['texts']
    assert got[-1]['n_real'] == 10 - batch_size * (len(got) - 1)


@pytest.fixture(scope='module')
def tiny():
    # seed 2: readings that differ from image to image
    jrec, v, cfg = jax_flagship(tiny=True, seed=2)
    return jrec, v, cfg, port_from_jax(cfg, v)


@pytest.mark.parametrize('batch_size', [4, 16])
def test_eval_recognizer_matches_jax(tiny, batch_size):
    jrec, v, cfg, rec = tiny
    want_m, want_r = jax_eval(jrec, jnp_tree(v), jax_build_dataset(
        CONCAT, dict(test_mode=True)), batch_size=batch_size,
        return_results=True)
    got_m, got_r = eval_recognizer(rec, build_dataset(
        CONCAT, dict(test_mode=True)), batch_size=batch_size,
        return_results=True)
    assert len(got_r) == len(want_r) == 30
    assert [r['text'] for r in got_r] == [r['text'] for r in want_r]
    for g, w in zip(got_r, want_r):
        np.testing.assert_allclose(g['score'], w['score'], atol=1e-4)
    assert got_m == want_m
    assert set(got_m) == {f'{n}_{os.path.join(TOY, "label.txt")}_'
                          'word_acc_ignore_case_symbol' for n in (10, 20)} | {
        'mean_word_acc_ignore_case_symbol'}
    assert eval_recognizer(rec, build_dataset(toy(), dict(test_mode=True)),
                           batch_size=batch_size) == \
        tool_metrics_of(got_r[:10])


def tool_metrics_of(results):
    from tps_pp_tpu_torch.evaluation import eval_ocr_metric
    gts = [line.split()[1] for line in
           open(os.path.join(TOY, 'label.txt')).read().splitlines()]
    return eval_ocr_metric([r['text'] for r in results], gts)


def test_eval_recognizer_tta_matches_jax(tiny):
    jrec, v, cfg, rec = tiny
    want_m, want_r = jax_eval(jrec, jnp_tree(v), jax_build_dataset(
        toy(pipeline=TTA_PIPELINE), dict(test_mode=True)), batch_size=1,
        return_results=True)
    ds = build_dataset(toy(pipeline=TTA_PIPELINE), dict(test_mode=True))
    assert len(ds[0]['aug_imgs']) == 3
    got_m, got_r = eval_recognizer(rec, ds, batch_size=1,
                                   return_results=True)
    assert [r['text'] for r in got_r] == [r['text'] for r in want_r]
    np.testing.assert_allclose([r['score'] for r in got_r],
                               [r['score'] for r in want_r], atol=1e-4)
    assert got_m == want_m


def test_test_tool_matches_jax(tiny, tmp_path, capsys):
    """The CLI on a config file naming the tiny model, the toy set and the
    width-64 pipeline, with a ``.pth`` of the JAX weights (mmcv's wrapper,
    DDP prefixes)."""
    jrec, v, cfg, rec = tiny
    pth = tmp_path / 'w.pth'
    torch.save({'meta': {}, 'state_dict': {
        f'module.{k}': t for k, t in state_dict_from_jax(v, cfg).items()}},
        pth)
    cfg_file = tmp_path / 'tiny_toy.py'
    cfg_file.write_text(
        f"model = {cfg!r}\ntest_pipeline = {PIPELINE!r}\n"
        f"data = dict(samples_per_gpu=4, test={CONCAT!r})\n")
    out = tmp_path / 'out.json'
    got = tool.main([str(cfg_file), str(pth), '--eval', 'acc', '--out',
                     str(out), '--cfg-options', 'data.samples_per_gpu=3',
                     'model.decode_mode=steps'], device='cpu')
    want = jax_eval(jrec, jnp_tree(v), jax_build_dataset(
        CONCAT, dict(test_mode=True)), batch_size=4)
    assert got == want
    assert json.loads(capsys.readouterr().out) == want
    saved = json.loads(out.read_text())
    assert saved['metrics'] == want and len(saved['results']) == 30


def test_test_tool_options_and_other_tasks(tmp_path, monkeypatch):
    assert tool.parse_cfg_options(['a.b=1', 'c=bfloat16', 'd=[1, 2]']) == \
        {'a.b': 1, 'c': 'bfloat16', 'd': [1, 2]}
    # every detector evaluates (tests/test_torch_detector.py,
    # tests/test_torch_panet.py, tests/test_torch_fce_textsnake.py,
    # tests/test_torch_drrg.py, tests/test_torch_maskrcnn.py): an
    # OCRMaskRCNN config goes to the det branch, SDMGR and NerClassifier
    # to the KIE / NER branch (tests/test_torch_kie_ner.py runs it)
    calls = []
    monkeypatch.setattr(tool, 'eval_detector', lambda cfg, args, device: (
        calls.append(cfg['model']['type']) or ({'hmean': 0.5}, [])))
    monkeypatch.setattr(tool, 'eval_kie_ner', lambda cfg, args, device: (
        calls.append(cfg['model']['type']) or ({'macro_f1': 0.5}, [])))
    for model_type in ('OCRMaskRCNN', 'SDMGR', 'NerClassifier'):
        cfg_file = tmp_path / f'{model_type}.py'
        cfg_file.write_text(f"model = dict(type='{model_type}')\n")
        assert tool.main([str(cfg_file)], device='cpu') == (
            {'hmean': 0.5} if model_type == 'OCRMaskRCNN'
            else {'macro_f1': 0.5})
    assert calls == ['OCRMaskRCNN', 'SDMGR', 'NerClassifier']
