"""``init_recognizer`` / ``model_inference``: image in, text out
(counterpart of ``tps_pp_tpu/apis/inference.py:21-128``, the reference's
``apis/inference.py``).

``init_recognizer`` builds the model of a config (a path or a dict) on the
card, seeds its weights and loads a torch checkpoint, whose keys are the
reference's; ``model_inference`` pushes images (BGR ndarrays, or paths,
which need cv2) through the config's test pipeline and ``simple_test``.

The flagship's config (``configs/textrecog/nrtr/nrtr_tps++.py``) sets no
``dtype``, so its model is float32 and ``'auto'`` decodes ``steps``; set
``model.dtype`` to ``bfloat16`` (``merge_cli_options``, the
``--cfg-options`` route) to serve ``fused40_bf16`` on kernels 1, 3 and 4.
Its rectifier leaves ``sample_mode`` at its default, under which the JAX
package warps through its gather sampler; the port warps through kernel 1
(``'dense'``), which computes the same function.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..config import ConfigDict, load_config
from ..datasets.pipelines.transforms import Compose
from ..utils.convert import load_pth
from .recognizer import TextRecognizer, build_recognizer

# the pipeline of a recognizer whose config names none
# (tps_pp_tpu/apis/inference.py:75-83)
DEFAULT_TEST_PIPELINE = [
    dict(type='ResizeOCR', height=32, min_width=128, max_width=128,
         keep_aspect_ratio=False),
    dict(type='ToTensorOCR'),
    dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
         std=[0.229, 0.224, 0.225]),
    dict(type='Collect', keys=['img']),
]


def init_recognizer(config: Union[str, Dict],
                    checkpoint: Optional[str] = None, device=None,
                    seed: int = 0) -> TextRecognizer:
    """The recognizer of ``config`` (a config file, or a dict holding
    ``model`` or being the model's config) with ``init_weights(seed)``,
    then a ``.pth`` / ``.pt`` checkpoint's weights when given (strict), on
    the CUDA device or ``device``; the config's ``test_pipeline`` is kept
    for ``model_inference``."""
    if isinstance(config, str):
        cfg = load_config(config)
        model_cfg = cfg['model']
    else:
        cfg = ConfigDict._wrap(dict(config))
        model_cfg = cfg.get('model', cfg)
    rec = build_recognizer(model_cfg, device).init_weights(seed)
    if checkpoint:
        if not checkpoint.endswith(('.pth', '.pt')):
            raise ValueError(
                f'{checkpoint}: the port loads torch checkpoints (.pth, .pt) '
                'only; orbax directories and .npz files of the JAX package '
                'need jax to read')
        rec.model.load_state_dict(load_pth(checkpoint), strict=True)
    rec.test_pipeline_cfg = cfg.get('test_pipeline')
    return rec


def model_inference(rec: TextRecognizer, imgs,
                    test_pipeline: Optional[Sequence] = None,
                    batch_mode: bool = False,
                    mesh=None) -> Union[Dict, List[Dict]]:
    """``{'text', 'score'}`` of an image, or a list of them for a list of
    images (paths or ndarrays). ``batch_mode=False`` runs each image alone;
    ``batch_mode=True`` runs them as one batch sorted by ``valid_ratio``
    and returns the results in input order. ``mesh`` reaches
    ``simple_test`` (``predict(mesh=)``)."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    pipeline_cfg = (test_pipeline or rec.test_pipeline_cfg
                    or DEFAULT_TEST_PIPELINE)
    # the loader stage follows the input (reference apis/inference.py:107)
    steps = [dict(s) for s in pipeline_cfg]
    is_nd = isinstance(imgs[0], np.ndarray)
    if steps and steps[0].get('type', '').startswith('LoadImage'):
        if is_nd:
            steps[0]['type'] = 'LoadImageFromNdarray'
    elif is_nd:
        steps.insert(0, dict(type='LoadImageFromNdarray'))
    else:
        steps.insert(0, dict(type='LoadImageFromFile'))
    pipeline = Compose(steps)

    datas = []
    for img in imgs:
        if is_nd:
            results = dict(img=img, img_info=dict(filename=None))
        else:
            results = dict(img_path=img, img_info=dict(filename=img))
        datas.append(pipeline(results))

    def run(subset):
        batch = np.stack([d['img'] for d in subset]).astype(np.float32)
        vr = np.asarray([d['img_metas'].get('valid_ratio', 1.0) or 1.0
                         for d in subset], np.float32)
        metas = [d['img_metas'] for d in subset]
        return rec.simple_test(batch, vr, img_metas=metas, mesh=mesh)

    if batch_mode:
        # sorted by valid_ratio, so that crops of like width share the
        # decode's row blocks; restored to input order
        order = sorted(range(len(datas)), key=lambda i: float(
            datas[i]['img_metas'].get('valid_ratio', 1.0) or 1.0))
        sorted_results = run([datas[i] for i in order])
        results = [None] * len(datas)
        for r, i in zip(sorted_results, order):
            results[i] = r
    else:
        # one image a batch: with keep_aspect_ratio the widths may differ
        results = [run([d])[0] for d in datas]
    return results[0] if single else results
