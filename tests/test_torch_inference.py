"""The port's ``init_recognizer`` / ``model_inference`` against the JAX
package's, on the CPU: one ``.pth`` written from the JAX tiny flagship's
weights (mmcv's ``{'meta', 'state_dict'}`` wrapper, DDP ``module.``
prefixes) loads into both; ``model_inference`` on the ten toy images, as
files and as ndarrays, one by one and as a batch, gives the same texts
(scores within 1e-4). ``batch_mode=True`` sorts by ``valid_ratio`` and
restores the input order (a ``keep_aspect_ratio=True`` pipeline, where the
ratios differ); a single image gives a dict; the orbax and ``.npz`` routes
raise."""
import os

import cv2
import numpy as np
import pytest
import torch
from torch_port_util import jax_flagship

from tps_pp_tpu.apis.inference import init_recognizer as jax_init
from tps_pp_tpu.apis.inference import model_inference as jax_infer

from tps_pp_tpu_torch.apis import (init_recognizer, model_inference,
                                   nrtr_tps_pp_cfg)
from tps_pp_tpu_torch.apis.inference import DEFAULT_TEST_PIPELINE
from tps_pp_tpu_torch.utils.convert import load_pth, state_dict_from_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, 'tests/data/ocr_toy_dataset')
FILES = [os.path.join(TOY, f'img_{i}.jpg') for i in range(10)]
NORM = dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
            std=[0.229, 0.224, 0.225])
PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'), NORM,
            dict(type='Collect', keys=['img'],
                 meta_keys=['filename', 'ori_shape', 'resize_shape',
                            'valid_ratio'])]
# widths follow the crops, padded to 64: valid ratios differ
RATIO_PIPELINE = [dict(type='ResizeOCR', height=32, min_width=16,
                       max_width=64), dict(type='ToTensorOCR'), NORM,
                  dict(type='Collect', keys=['img'])]


@pytest.fixture(scope='module')
def recognizers(tmp_path_factory):
    """(JAX recognizer, its variables, the port's), both from one .pth."""
    _, v, cfg = jax_flagship(tiny=True, seed=2)
    sd = state_dict_from_jax(v, cfg)
    pth = str(tmp_path_factory.mktemp('ckpt') / 'tiny.pth')
    torch.save({'meta': {'epoch': 3}, 'state_dict': {
        f'module.{k}': t for k, t in sd.items()}}, pth)
    config = dict(model=cfg, test_pipeline=PIPELINE)
    jrec, jv = jax_init(config, pth, input_shape=(1, 32, 64, 3))
    rec = init_recognizer(config, pth, device='cpu')
    return jrec, jv, rec, sd, pth


def texts_and_scores(results):
    return [r['text'] for r in results], [r['score'] for r in results]


def same_results(got, want):
    gt, gs = texts_and_scores(got)
    wt, ws = texts_and_scores(want)
    assert gt == wt
    for a, b in zip(gs, ws):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_checkpoint_loads_the_written_weights(recognizers):
    _, _, rec, sd, pth = recognizers
    assert rec.device.type == 'cpu'
    assert rec.test_pipeline_cfg == PIPELINE
    got = rec.model.state_dict()
    assert got.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(got[k], t.to(got[k].dtype)), k
    assert load_pth(pth).keys() == sd.keys()


@pytest.mark.parametrize('as_arrays', [False, True], ids=['files', 'arrays'])
@pytest.mark.parametrize('batch_mode', [False, True])
def test_model_inference_matches_jax(recognizers, as_arrays, batch_mode):
    jrec, jv, rec, _, _ = recognizers
    imgs = [cv2.imread(f) for f in FILES] if as_arrays else list(FILES)
    want = jax_infer(jrec, jv, imgs, batch_mode=batch_mode)
    got = model_inference(rec, imgs, batch_mode=batch_mode)
    assert isinstance(got, list) and len(got) == 10
    same_results(got, want)
    assert len(set(r['text'] for r in got)) > 1


def test_batch_mode_restores_the_input_order(recognizers):
    jrec, jv, rec, _, _ = recognizers
    # float32 crops in [0, 1]: both resizes agree within float rounding,
    # where on uint8 noise one grey level would move the scores by ~1e-4
    g = np.random.default_rng(3)
    imgs = [g.random((int(g.integers(16, 48)), int(g.integers(16, 160)), 3),
                     np.float32) for _ in range(7)]
    ratios = [rec_ratio(img) for img in imgs]
    assert len(set(ratios)) > 3 and ratios != sorted(ratios)
    batched = model_inference(rec, imgs, RATIO_PIPELINE, batch_mode=True)
    alone = model_inference(rec, imgs, RATIO_PIPELINE, batch_mode=False)
    same_results(batched, alone)
    same_results(batched, jax_infer(jrec, jv, imgs, RATIO_PIPELINE,
                                    batch_mode=True))


def rec_ratio(img):
    from tps_pp_tpu_torch.datasets.pipelines.transforms import ResizeOCR
    return ResizeOCR(**{k: v for k, v in RATIO_PIPELINE[0].items()
                        if k != 'type'})(dict(img=img))['valid_ratio']


def test_single_image_gives_a_dict(recognizers):
    jrec, jv, rec, _, _ = recognizers
    img = cv2.imread(FILES[4])
    got = model_inference(rec, img)
    assert isinstance(got, dict) and set(got) == {'text', 'score'}
    same_results([got], [jax_infer(jrec, jv, img)])
    assert model_inference(rec, FILES[4])['text'] == got['text']
    assert isinstance(model_inference(rec, (img,)), list)


def test_other_checkpoint_formats_raise(tmp_path):
    cfg = nrtr_tps_pp_cfg(tiny=True)
    for path in (str(tmp_path / 'weights.npz'), str(tmp_path / 'orbax_dir')):
        with pytest.raises(ValueError, match='need jax'):
            init_recognizer(cfg, path, device='cpu')


def test_init_recognizer_seeds_and_defaults(tmp_path):
    """A model config alone: seeded weights, no pipeline of its own (the
    default, the JAX package's, is used); a bare state_dict loads too."""
    cfg = nrtr_tps_pp_cfg(tiny=True)
    a = init_recognizer(cfg, device='cpu', seed=5)
    b = init_recognizer(dict(model=cfg), device='cpu', seed=5)
    assert a.test_pipeline_cfg is None
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    pth = tmp_path / 'bare.pt'
    torch.save(a.model.state_dict(), pth)
    c = init_recognizer(cfg, str(pth), device='cpu', seed=6)
    assert all(torch.equal(x, y) for x, y in zip(
        a.model.state_dict().values(), c.model.state_dict().values()))
    assert DEFAULT_TEST_PIPELINE[0]['max_width'] == 128
