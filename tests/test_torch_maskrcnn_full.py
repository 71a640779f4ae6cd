"""OCRMaskRCNN at the shipped configs' full width on the CPU, at a small
page size: the three configs build through ``init_detector`` and detect;
the ICDAR 2015 config's levels, RPN maps and both heads' outputs on JAX's
weights within 1e-5 of the JAX package's (relative to their largest
magnitude), and its detections box by box as JAX's ``detect`` gives them
but at stated near-ties (``chip_smoke.compare_maskrcnn``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import compare_maskrcnn, maskrcnn_decisions
from test_torch_maskrcnn import jax_per_box
from torch_port_util import perturb_batch_stats

from tps_pp_tpu.apis.detector import TextDetector as JaxDetector

from tps_pp_tpu_torch.apis import init_detector
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [f'configs/textdet/maskrcnn/mask_rcnn_r50_fpn_160e_{d}.py'
           for d in ('ctw1500', 'icdar2015', 'icdar2017')]
SIZE = (128, 128)


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run (ROADMAP queue 3:
    torch's oneDNN corrupts the heap at 3 or more in a channels-last
    conv)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rel_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize('path', CONFIGS)
def test_shipped_configs_build_and_detect(path):
    """Each shipped config at full width (ResNetDet50 [3, 4, 6, 3], FPN
    256, an RPN of 5 anchors, box FCs of 1024, mask convs of 256: the
    43,973,728 parameters of the JAX package's) on seed-0 weights detects
    two 150 x 170 pages at 128 x 128 (CTW1500's boundaries polygons, the
    others' quads): finite boundaries of an odd length."""
    det = init_detector(os.path.join(REPO, path), img_size=SIZE,
                        device='cpu')
    m = det.model
    assert sum(p.numel() for p in m.parameters()) == 43_973_728
    assert m.rpn_head.rpn_reg.out_channels == 20
    assert m.roi_head.bbox_head.shared_fcs[1].out_features == 1024
    assert det.postprocessor.text_repr_type == (
        'poly' if 'ctw1500' in path else 'quad')
    g = np.random.default_rng(0)
    out = det.detect_batch([g.integers(0, 256, (150, 170, 3), np.uint8)
                            for _ in range(2)])
    assert len(out) == 2
    for b in sum(out, []):
        assert b.dtype == np.float32 and b.size % 2 == 1
        assert np.isfinite(b).all()


def test_full_width_matches_jax():
    """The ICDAR 2015 config on JAX's seed-0 weights (BatchNorm statistics
    perturbed): two pages' levels and RPN maps, the box head on JAX's 7x7
    RoIs and the mask head on its 14x14 RoIs within 1e-5 of their largest
    magnitude; the detections box by box as JAX's (points within 1e-3 px)
    but at near-ties, at least 10 compared equal."""
    cfg = dict(load_config(os.path.join(REPO, CONFIGS[1]))['model'])
    jdet = JaxDetector(cfg, img_size=SIZE, rng_seed=0)
    v = jax.tree.map(np.asarray, jdet.variables)
    v['main'] = perturb_batch_stats(v['main'], 0)
    det = init_detector(dict(model=cfg), img_size=SIZE, device='cpu')
    det.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    x = np.random.default_rng(1).random((2, *SIZE, 3)).astype(np.float32)
    d = jdet._det
    levels, rpn = d.module.apply(v['main'], jnp.asarray(x))
    with torch.no_grad():
        got_levels, got_rpn = det.model(torch.from_numpy(x))
    for a, b in zip(got_levels, levels):
        rel_close(a.permute(0, 2, 3, 1), b, 1e-5)
    for (a, b), (c, e) in zip(got_rpn, rpn):
        rel_close(a, c, 1e-5)
        rel_close(b, e, 1e-5)
    g = np.random.default_rng(2)
    levels_np = [np.asarray(t)[:1] for t in levels]
    boxes = np.concatenate([g.uniform(0, 64, (12, 2)),
                            g.uniform(64, 128, (12, 2))], 1).astype(
                                np.float32)
    r7, r14 = d._pool(levels_np, boxes, (7, 7)), d._pool(levels_np, boxes,
                                                         (14, 14))
    heads = det.model.roi_head
    with torch.no_grad():
        cls, deltas = heads.bbox_head(
            torch.from_numpy(r7).permute(0, 3, 1, 2))
        masks = heads.mask_head(torch.from_numpy(r14).permute(0, 3, 1, 2))
    want_cls, want_deltas = d.module.box_head.apply(v['box'],
                                                    jnp.asarray(r7))
    rel_close(cls, want_cls, 1e-5)
    rel_close(deltas, want_deltas, 1e-5)
    rel_close(masks, np.asarray(d.module.mask_head.apply(
        v['mask'], jnp.asarray(r14)))[..., 0], 1e-5)
    jdet.variables = jax.tree.map(jnp.asarray, v)
    p = det.postprocessor
    _, got = maskrcnn_decisions(p, lambda: p(got_levels, p.host_rpn(got_rpn),
                                            SIZE))
    want = [jax_per_box(jdet, v, x[i:i + 1])[0] for i in range(2)]
    compared, box_ties, mask_ties = compare_maskrcnn(got, want, atol=1e-3)
    assert compared >= 10, (compared, box_ties, mask_ties)
