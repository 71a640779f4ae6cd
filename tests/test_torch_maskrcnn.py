"""OCRMaskRCNN in the port against the JAX package on the CPU, on the narrow
config of JAX's own test (``tests/test_textdet.py:508-540``: ResNetDet
[1, 1, 1, 1] base 8, FPN 16, box FCs of 64, mask convs of 16): the host
box geometry, proposals, RoI sampling and mask targets bit for bit,
``cv_ops.resize_f32`` against ``cv2.resize`` (1e-6, the 0.5 decisions
equal), the RPN, box and mask heads and the module on carried weights
(1e-5), ``roi_align`` and its gradient against ``roi_align_jax`` /
``jax.grad`` (1e-5), detection with ``score_thr=0`` (boundaries equal but
at stated near-ties), the training losses and gradients of one sampled
batch (1e-5 / 1e-4), ``train_detector`` against JAX's ``_train_maskrcnn``
(pages without a candidate skipped alike) and its resume, and the entry
points: ``init_detector`` from a ``.pth``, ``tools/test.py``,
``tools/train.py`` and ``MMOCR.readtext`` with a config path. Inputs are
made from seeds with numpy; the shipped configs at full width are
``test_torch_maskrcnn_full.py``."""
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import compare_maskrcnn, maskrcnn_decisions
from test_torch_det_train import Pages, word_polygons
from test_torch_textdet import close
from torch_port_util import load_sub, perturb_batch_stats

from tps_pp_tpu.apis import train_det as jax_train_det
from tps_pp_tpu.apis.detector import TextDetector as JaxDetector
from tps_pp_tpu.datasets.textdet_dataset import TextDetDataset as JaxDataset
from tps_pp_tpu.models.textdet import maskrcnn as jm
from tps_pp_tpu.models.textdet.postprocess import \
    points2boundary as jax_points2boundary

from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.models.textdet import maskrcnn
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

BB = dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1], base_channels=8)
CFG = dict(type='OCRMaskRCNN', backbone=BB,
           neck=dict(type='FPNDet', in_channels=[8, 16, 32, 64],
                     out_channels=16),
           rpn_head=dict(type='RPNHead', feat_channels=16),
           box_head=dict(fc_out=64), mask_head=dict(channels=16),
           num_train_rois=16)
C = 16                              # the neck's channels
SIZE = (64, 64)
# the shipped schedule (schedule_sgd_160e): SGD 0.08 after a linear warmup
# of 500 steps from 0.001 of it, steps at epochs 80 and 128
SCHEDULE = dict(optimizer=dict(type='SGD', lr=0.08, momentum=0.9,
                               weight_decay=0.0001),
                optimizer_config=dict(grad_clip=None),
                lr_config=dict(policy='step', warmup='linear',
                               warmup_iters=500, warmup_ratio=0.001,
                               step=[80, 128]))


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run (ROADMAP queue 3:
    torch's oneDNN corrupts the heap at 3 or more in a channels-last
    conv)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_boxes(g, n, hw=SIZE, lo=-8.0):
    """``n`` xyxy boxes of 0.5 px up to the page, some past its edges,
    float32."""
    h, w = hw
    xy = g.uniform(lo, [w, h], (n, 2))
    wh = g.uniform(0.5, [w, h], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ------------------------------------------------------ host geometry --

@pytest.mark.parametrize('seed', range(3))
def test_box_geometry_matches_jax(seed):
    """Anchors of several level shapes and strides, both box coders (deltas
    past the clip at 4, degenerate boxes, the detection stds), the IoU
    matrix, NMS (ties, thresholds, ``max_out``) and the RoI levels, bit for
    bit."""
    g = np.random.default_rng(seed)
    shapes = [(int(g.integers(1, 20)), int(g.integers(1, 20)))
              for _ in range(5)]
    for a, b in zip(maskrcnn.generate_anchors(shapes),
                    jm.generate_anchors(shapes)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(maskrcnn.generate_anchors(shapes[:2], (8, 16), (2, 3),
                                              (0.5, 1.0, 2.0)),
                    jm.generate_anchors(shapes[:2], (8, 16), (2, 3),
                                        (0.5, 1.0, 2.0))):
        np.testing.assert_array_equal(a, b)
    anc = random_boxes(g, 200)
    anc[:5, 2:] = anc[:5, :2]                       # zero-size boxes
    deltas = g.normal(0, 3, (200, 4)).astype(np.float32)
    for stds in ((1., 1., 1., 1.), maskrcnn.BOX_STDS):
        np.testing.assert_array_equal(maskrcnn.delta2bbox(anc, deltas, stds),
                                      jm.delta2bbox(anc, deltas, stds))
        gts = random_boxes(g, 200)
        np.testing.assert_array_equal(maskrcnn.bbox2delta(anc, gts, stds),
                                      jm.bbox2delta(anc, gts, stds))
    b = random_boxes(g, 60)
    np.testing.assert_array_equal(maskrcnn.bbox_iou_matrix(anc, b),
                                  jm.bbox_iou_matrix(anc, b))
    scores = np.round(g.random(200), 1).astype(np.float32)   # many ties
    for thr, max_out in ((0.7, 100), (0.5, 10), (0.0, 1000), (1.0, 3)):
        np.testing.assert_array_equal(
            maskrcnn.nms_xyxy(anc, scores, thr, max_out),
            jm.nms_xyxy(anc, scores, thr, max_out))
    xy = g.uniform(0, 1600, (300, 2))           # sides of 1-1600 px
    big = np.concatenate([xy, xy + np.exp(g.uniform(0, np.log(1600),
                                                    (300, 2)))], 1)
    lvl = maskrcnn.roi_levels(big, 5)
    areas = np.prod(np.maximum(big[:, 2:] - big[:, :2], 1), -1)
    np.testing.assert_array_equal(lvl, np.clip(np.floor(np.log2(
        np.sqrt(areas) / 56 + 1e-6)) + 2, 0, 3).astype(int))
    assert set(lvl) == {0, 1, 2, 3}


def rpn_maps(g, hw, scale=3.0):
    """Random RPN maps a level (cls (h, w, 5), reg (h, w, 20)) of an
    ``hw`` input, and zero levels of their shapes (JAX reads the shapes
    from its levels)."""
    shapes, h, w = [], *hw
    for _ in range(5):
        h, w = -(-h // 2) if shapes else h // 4, -(-w // 2) if shapes else \
            w // 4
        shapes.append((h, w))
    maps = [(g.normal(0, scale, (h, w, 5)).astype(np.float32),
             g.normal(0, 0.5, (h, w, 20)).astype(np.float32))
            for h, w in shapes]
    return maps, [np.zeros((1, h, w, 1), np.float32) for h, w in shapes]


@pytest.mark.parametrize('hw', [(64, 64), (128, 96), (640, 640)])
def test_proposals_and_pooling_match_jax(hw):
    """``proposals`` (the top-k cut of each level at 640 x 640, clipping,
    ``wh > 2``, NMS) bit for bit on the same RPN maps; ``pool`` on the CPU
    (each RoI on its level, two pages at once) within 1e-5 of JAX's host
    ``_pool`` (``roi_align_np``) of each page."""
    g = np.random.default_rng(hw[0])
    jdet = jm.MaskRCNNDetector(None)
    det = maskrcnn.MaskRCNNDetector(None)
    maps, dummies = rpn_maps(g, hw)
    got, want = det.proposals(maps, hw), jdet._proposals(dummies, maps, hw)
    assert len(want[0]) == 100
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if hw[0] == 640:
        return
    levels = [g.standard_normal((2, C, h.shape[1], h.shape[2])).astype(
        np.float32) for h in dummies]
    boxes = [random_boxes(g, 30, hw), want[0]]
    pooled = det.pool([torch.from_numpy(t) for t in levels], boxes, (7, 5))
    assert pooled.shape == (130, C, 5, 7)
    for i, b in enumerate(boxes):
        ref = jdet._pool([t[i:i + 1].transpose(0, 2, 3, 1) for t in levels],
                         b, (7, 5))
        part = pooled[:30] if i == 0 else pooled[30:]
        close(part.permute(0, 2, 3, 1), ref, 1e-5)


def test_resize_f32_matches_cv2():
    """``cv_ops.resize_f32`` against ``cv2.resize`` (``INTER_LINEAR``) of
    float32 sigmoid maps, 28 x 28 (the mask head's) and other sizes, to
    every width and height of 1-70 in steps (28 -> 14 the area path):
    within 1e-6, and the 0.5 decisions equal but where cv2's value lies
    within 1e-6 of 0.5 (counted: 2 pixels on these maps). ``resize_inter_
    nearest`` of float32 crops against ``INTER_NEAREST``, bit for bit."""
    g = np.random.default_rng(0)
    ties = worst = 0
    for h, w in ((28, 28), (28, 28), (7, 9), (30, 17)):
        m = 1 / (1 + np.exp(-g.normal(0, 2, (h, w)))).astype(np.float32)
        for dw in list(range(1, 71, 3)) + [14, w // 2]:
            for dh in list(range(1, 71, 5)) + [14, h // 2]:
                want = cv2.resize(m, (dw, dh))
                got = cv_ops.resize_f32(m, dw, dh)
                assert got.dtype == np.float32 and got.shape == want.shape
                worst = max(worst, float(np.abs(got - want).max()))
                near = np.abs(want - 0.5) <= 1e-6
                ties += int(near.sum())
                np.testing.assert_array_equal((got > 0.5)[~near],
                                              (want > 0.5)[~near])
                crop = (g.random((h, w)) > 0.5).astype(np.float32)
                np.testing.assert_array_equal(
                    cv_ops.resize_inter_nearest(crop, dw, dh),
                    cv2.resize(crop, (dw, dh),
                               interpolation=cv2.INTER_NEAREST))
    assert worst <= 1e-6 and ties <= 4


@pytest.mark.parametrize('seed', range(3))
def test_training_targets_match_jax(seed):
    """``poly_boxes_masks`` (polygons past the page's edges, a
    two-point one), ``rpn_targets``, ``sample_rois`` (few and no
    negatives, no gt) and ``make_mask_targets`` bit for bit from the same
    ``Generator`` draws."""
    g = np.random.default_rng(seed)
    polys = word_polygons(g, 6, 96, 80) + [np.zeros((2, 2), np.float32)]
    boxes, masks = maskrcnn.poly_boxes_masks(polys, 96, 80)
    jboxes, jmasks = jax_train_det._poly_boxes_masks(polys, 96, 80)
    np.testing.assert_array_equal(boxes, jboxes)
    assert len(masks) == len(jmasks) == 6
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)
    det = maskrcnn.MaskRCNNDetector(None)
    jdet = jm.MaskRCNNDetector(None)
    shapes = [(24, 20), (12, 10), (6, 5), (3, 3), (2, 2)]
    for gt in (boxes, boxes[:0]):
        for a, b in zip(det.rpn_targets(shapes, gt, (96, 80)),
                        jdet.rpn_targets(shapes, gt, (96, 80))):
            np.testing.assert_array_equal(a, b)
    props = random_boxes(g, 40, (96, 80))
    for p, gt, num in ((props, boxes, 64), (props[:3], boxes, 16),
                       (boxes + 0.5, boxes, 16), (props, boxes[:0], 16),
                       (props[:0], boxes[:0], 16)):
        got = maskrcnn.sample_rois(p, gt, num,
                                   rng=np.random.default_rng(seed))
        want = jm._sample_rois(p, gt, num, rng=np.random.default_rng(seed))
        if want is None:
            assert got is None
            continue
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        rois, labels, _, midx = got
        idx = np.where(labels == 1, midx, -1)
        np.testing.assert_array_equal(
            maskrcnn.make_mask_targets(rois, masks, idx),
            jm.make_mask_targets(rois, jmasks, idx))


# ------------------------------------------------------------ modules --

@functools.lru_cache(maxsize=None)
def jax_detector(seed=0, hw=SIZE):
    """The JAX ``TextDetector`` of ``CFG`` at ``hw`` on seed ``seed`` and
    its variables as numpy, the main part's BatchNorm statistics and
    affines perturbed in both (a fresh init is the identity)."""
    jdet = JaxDetector(CFG, img_size=hw, rng_seed=seed)
    v = jax.tree.map(np.asarray, jdet.variables)
    v['main'] = perturb_batch_stats(v['main'], seed)
    jdet.variables = jax.tree.map(jnp.asarray, v)
    return jdet, v


def port_model(v):
    model = build_detector_module(CFG)
    model.load_state_dict(state_dict_from_jax(v, CFG), strict=True)
    return model.eval()


def test_head_configs_with_unknown_keys_raise():
    """A misspelled ``rpn_head`` / ``box_head`` / ``mask_head`` key raises
    ``TypeError`` in the port, as in JAX's dataclass heads."""
    for key, bad in (('rpn_head', dict(type='RPNHead', feat_chanels=16)),
                     ('box_head', dict(fc_outs=64)),
                     ('mask_head', dict(chanels=16))):
        cfg = dict(CFG, **{key: bad})
        with pytest.raises(TypeError):
            build_detector_module(cfg)
        with pytest.raises(TypeError):
            JaxDetector(cfg, img_size=SIZE)


def test_heads_match_flax():
    """``RPNHead`` on five levels, ``BoxHead`` on 7x7 RoIs and ``MaskHead``
    on 14x14 RoIs, flax's weights carried by ``maskrcnn_rules``: within
    1e-5."""
    g = np.random.default_rng(1)
    _, v = jax_detector()
    rules = convert.maskrcnn_rules(CFG)
    rpn = load_sub(maskrcnn.RPNHead(C, 16),
                   {'params': v['main']['params']['rpn_head']}, rules,
                   'rpn_head', 'rpn_head')
    feats = [g.standard_normal((2, s, s + 1, C)).astype(np.float32)
             for s in (16, 8, 4, 2, 1)]
    want = jm.RPNHead(feat_channels=16).apply(
        {'params': v['main']['params']['rpn_head']},
        [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = rpn([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for (a, b), (c, d) in zip(got, want):
        assert a.shape == (2, *c.shape[1:3], 5) and b.shape[-1] == 20
        close(a, c, 1e-5)
        close(b, d, 1e-5)
    box = load_sub(maskrcnn.BoxHead(C, 64), {'params': v['box']['params']},
                   rules, 'box', 'roi_head.bbox_head')
    mask = load_sub(maskrcnn.MaskHead(C, 16), {'params': v['mask']['params']},
                    rules, 'mask', 'roi_head.mask_head')
    r7 = g.standard_normal((9, 7, 7, C)).astype(np.float32)
    r14 = g.standard_normal((9, 14, 14, C)).astype(np.float32)
    with torch.no_grad():
        cls, deltas = box(torch.from_numpy(r7).permute(0, 3, 1, 2))
        logits = mask(torch.from_numpy(r14).permute(0, 3, 1, 2))
    want_cls, want_deltas = jm.BoxHead(fc_out=64).apply(v['box'],
                                                        jnp.asarray(r7))
    close(cls, want_cls, 1e-5)
    close(deltas, want_deltas, 1e-5)
    want = jm.MaskHead(channels=16).apply(v['mask'], jnp.asarray(r14))
    assert logits.shape == (9, 28, 28)
    close(logits, np.asarray(want)[..., 0], 1e-5)


@pytest.mark.parametrize('hw', [(64, 64), (128, 128)])
def test_module_matches_flax(hw):
    """``MaskRCNNModule``'s five levels (the stride-64 one a stride-2
    pick of P5) and RPN maps, eval-mode BatchNorm on perturbed statistics,
    within 1e-5 of flax's."""
    jdet, v = jax_detector()
    model = port_model(v)
    x = np.random.default_rng(hw[0]).random((2, *hw, 3)).astype(np.float32)
    levels, rpn = jdet.module.apply(v['main'], jnp.asarray(x))
    with torch.no_grad():
        got_levels, got_rpn = model(torch.from_numpy(x))
    assert [t.shape[2] for t in got_levels] == [hw[0] // s
                                                for s in (4, 8, 16, 32, 64)]
    for a, b in zip(got_levels, levels):
        close(a.permute(0, 2, 3, 1), b, 1e-5)
    for (a, b), (c, d) in zip(got_rpn, rpn):
        close(a, c, 1e-5)
        close(b, d, 1e-5)


def test_roi_align_and_its_gradient_match_jax():
    """``roi_align`` on two pages (RoIs past the edges, thinner than a
    pixel) within 1e-5 of ``roi_align_jax`` and of the host
    ``roi_align_np``; its gradient in the map, for a random cotangent,
    within 1e-5 of ``jax.vjp``'s."""
    g = np.random.default_rng(2)
    feat = g.standard_normal((2, 5, 16, 20)).astype(np.float32)
    boxes = [random_boxes(g, 12, (16, 20), lo=-4.0),
             np.array([[2.0, 3.0, 10.0, 9.0], [0.0, 0.0, 19.0, 15.0],
                       [5.5, 4.5, 8.0, 12.0], [3.0, 3.0, 3.2, 3.1]],
                      np.float32)]
    rois = np.concatenate(boxes)
    image = np.repeat([0, 1], [12, 4])
    cot = g.standard_normal((16, 5, 5, 7)).astype(np.float32)
    t = torch.from_numpy(feat).requires_grad_()
    got = maskrcnn.roi_align(t, torch.from_numpy(rois), (7, 5),
                             torch.from_numpy(image))
    (got * torch.from_numpy(cot)).sum().backward()
    grad = np.zeros_like(feat)
    for i, b in enumerate(boxes):
        sel = image == i
        fi = jnp.asarray(feat[i].transpose(1, 2, 0))
        out, vjp = jax.vjp(lambda f: jm.roi_align_jax(f, jnp.asarray(b),
                                                      (7, 5)), fi)
        close(got[sel].detach().permute(0, 2, 3, 1), out, 1e-5)
        close(got[sel].detach().permute(0, 2, 3, 1),
              jm.roi_align_np(feat[i].transpose(1, 2, 0), b, (7, 5)), 1e-5)
        grad[i] = np.asarray(vjp(jnp.asarray(
            cot[sel].transpose(0, 2, 3, 1)))[0]).transpose(2, 0, 1)
    close(t.grad, grad, 1e-5)


# ---------------------------------------------------------- detection --

def jax_per_box(jdet, v, img):
    """JAX's ``MaskRCNNDetector.detect`` of one page (1, H, W, 3), its
    boundaries a final box (JAX's own code, stage by stage), and the
    whole ``detect``'s list."""
    d = jdet._det
    levels, rpn = d.module.apply(v['main'], jnp.asarray(img))
    levels_np = [np.asarray(t) for t in levels]
    rpn_np = [(np.asarray(c)[0], np.asarray(r)[0]) for c, r in rpn]
    H, W = img.shape[1:3]
    props, _ = d._proposals(levels_np, rpn_np, (H, W))
    out = dict(boxes=np.zeros((0, 4), np.float32), box_margin=np.inf,
               boundaries=[], mask_margins=[], px_margins=[])
    if len(props):
        cls, deltas = d.module.box_head.apply(
            v['box'], jnp.asarray(d._pool(levels_np, props, (7, 7))))
        cls, deltas = np.asarray(jax.nn.softmax(cls, -1)), np.asarray(deltas)
        keep = cls[:, 1] > d.score_thr
        if keep.any():
            boxes = jm.delta2bbox(props[keep], deltas[keep],
                                  stds=(0.1, 0.1, 0.2, 0.2))
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
            scores = cls[keep, 1]
            k2 = jm.nms_xyxy(boxes, scores, 0.5, d.post_nms_top_n)
            boxes, scores = boxes[k2], scores[k2]
            logits = np.asarray(d.module.mask_head.apply(
                v['mask'], jnp.asarray(d._pool(levels_np, boxes,
                                               (14, 14)))))[..., 0]
            out['boxes'] = boxes
            for box, score, mlog in zip(boxes, scores, logits):
                x0, y0, x1, y1 = box.astype(int)
                bw, bh = max(x1 - x0, 1), max(y1 - y0, 1)
                m = cv2.resize(1 / (1 + np.exp(-mlog)), (bw, bh))
                seg = np.zeros((H, W), np.uint8)
                seg[y0:y0 + bh, x0:x0 + bw] = m > d.mask_thr
                pts = np.argwhere(seg)[:, ::-1]
                b = (jax_points2boundary(pts, d.text_repr_type, float(score))
                     if len(pts) else None)
                out['boundaries'].append([] if b is None else [b])
                out['mask_margins'].append(np.inf)
                out['px_margins'].append(np.inf)
    return out, d.detect(v, jnp.asarray(img))


@pytest.mark.parametrize('hw', [(64, 64), (128, 128)])
def test_detection_with_score_thr_0_matches_jax(hw):
    """The port's serving stages (one forward of three pages, the pooling
    and heads over their RoIs at once) with ``score_thr`` 0 against JAX's
    ``detect`` of each page, box by box: the same boundaries (points
    within 1e-3 px: cv2's and ``cv_ops``' min-area rectangles part by an
    ulp) but where a decision of the port's lies within 1e-4 of its
    threshold or a box corner within 1e-3 px of an integer
    (``chip_smoke.compare_maskrcnn``); at least 20 compared equal."""
    jdet, v = jax_detector(1, hw)
    jdet._det.score_thr = 0.0
    det = maskrcnn.MaskRCNNDetector(port_model(v), score_thr=0.0)
    x = np.random.default_rng(3).random((3, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        levels, rpn = det.model(torch.from_numpy(x))
    _, got = maskrcnn_decisions(det, lambda: det(levels, det.host_rpn(rpn),
                                                 hw))
    want = []
    for i in range(3):
        per_box, whole = jax_per_box(jdet, v, x[i:i + 1])
        flat = sum(per_box['boundaries'], [])
        assert len(flat) == len(whole) and all(
            np.array_equal(a, b) for a, b in zip(flat, whole))
        want.append(per_box)
    compared, box_ties, mask_ties = compare_maskrcnn(got, want, atol=1e-3)
    assert compared >= 20, (compared, box_ties, mask_ties)


# ----------------------------------------------------------- training --

def test_training_losses_and_gradients_match_jax():
    """One page: the port's ``train_targets`` on JAX's RPN maps give JAX's
    ``sample_train_batch`` bit for bit (the same ``Generator`` draws), and
    ``train_losses`` in train mode (BatchNorm over the page) gives each of
    the five losses within 1e-5 and every parameter's gradient within 1e-4
    (relative, of its largest magnitude) of ``jax.grad`` of JAX's
    ``train_losses``."""
    jdet, v = jax_detector(2)
    d = jdet._det
    d.num_train_rois = 16
    page = Pages(1, seed=5, hw=SIZE, words=(3, 4))[0]
    img = page['img'][None]
    boxes, masks = maskrcnn.poly_boxes_masks(page['gt_polygons'], *SIZE)
    want = d.sample_train_batch(v, img, boxes, masks,
                                rng=np.random.default_rng(7))
    rpn = [(np.asarray(c)[0], np.asarray(r)[0])
           for c, r in d.module.apply(v['main'], jnp.asarray(img))[1]]
    det = maskrcnn.MaskRCNNDetector(port_model(v), num_train_rois=16)
    got = det.train_targets(rpn, SIZE, boxes, masks, np.random.default_rng(7))
    assert set(got) - {'lvl'} == set(want) - {'lvl_onehot'}
    for k in set(want) - {'lvl_onehot'}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.eye(4)[got['lvl']], want['lvl_onehot'])
    assert 0 < int(got['labels'].sum()) < 16

    params = {k: v[k]['params'] for k in ('main', 'box', 'mask')}
    bs = v['main']['batch_stats']

    def f(p):
        losses, _ = d.train_losses(
            {'main': {'params': p['main'], 'batch_stats': bs},
             'box': {'params': p['box']}, 'mask': {'params': p['mask']}},
            jnp.asarray(img), {k: jnp.asarray(t) for k, t in want.items()})
        return sum(losses.values()), losses
    (_, losses), grads = jax.value_and_grad(f, has_aux=True)(params)
    model = det.model.train()
    out = det.train_losses(torch.from_numpy(img), got)
    sum(out.values()).backward()
    assert set(out) == set(losses)
    for k in losses:
        np.testing.assert_allclose(float(out[k].detach()), float(losses[k]),
                                   rtol=1e-5)
    want_g = state_dict_from_jax(
        {'main': {'params': grads['main'], 'batch_stats': bs},
         'box': {'params': grads['box']}, 'mask': {'params': grads['mask']}},
        CFG)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        scale = float(want_g[name].abs().max())
        assert float((p.grad - want_g[name]).abs().max()) <= 1e-4 * scale, \
            name


def jax_loop(cfg, ds, seed, monkeypatch, v=None):
    """JAX's ``train_detector`` (``_train_maskrcnn``) from the variables
    ``v`` where given, else its own initial ones: each epoch's last
    loss."""
    if v is not None:
        monkeypatch.setattr(jm.MaskRCNNDetector, 'init_variables',
                            lambda self, rng, shape: jax.tree.map(
                                jnp.asarray, v))
    return jax_train_det.train_detector(cfg, ds, seed=seed)[1]


def jax_initial(seed):
    """The JAX loop's initial variables on ``seed`` (its own init)."""
    d = jm.MaskRCNNDetector(JaxDetector(CFG, img_size=SIZE,
                                        rng_seed=seed).module)
    return jax.tree.map(np.array, d.init_variables(
        jax.random.PRNGKey(seed), (1, *SIZE, 3)))


def test_train_detector_matches_the_jax_loop(monkeypatch):
    """Two epochs of four pages, one a step, Adam 1e-3 (JAX's default):
    each epoch's last loss within 1e-4 of JAX's ``_train_maskrcnn`` on the
    same initial weights, pages and ``Generator`` draws."""
    cfg = dict(model=CFG, total_epochs=2)
    ds = Pages(4, seed=2, hw=SIZE, words=(1, 4))
    v = jax_initial(1)
    want = jax_loop(cfg, ds, 1, monkeypatch)
    _, opt, hist = train_detector(cfg, ds, batch_size=4, seed=1,
                                  device='cpu', model=port_model(v))
    np.testing.assert_allclose([h['loss'] for h in hist], want, rtol=1e-4)
    assert opt.count == 8 and [h['steps'] for h in hist] == [4, 8]
    assert set(hist[0]) >= {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                            'loss_bbox', 'loss_mask', 'grad_norm'}


def test_pages_without_a_candidate_are_skipped(monkeypatch):
    """The RPN's x deltas pushed past the page (every proposal clipped to
    zero width) on both sides: the page without a polygon has no
    candidate and takes no step in either loop; the rest give JAX's
    losses (1e-4)."""
    cfg = dict(model=CFG, total_epochs=2)
    ds = Pages(3, seed=4, hw=SIZE, words=(1, 3))
    ds.items[1]['gt_polygons'] = []
    v = jax_initial(2)
    v['main']['params']['rpn_head']['rpn_reg']['bias'][0::4] += 100.0
    want = jax_loop(cfg, ds, 2, monkeypatch, v)
    _, opt, hist = train_detector(cfg, ds, seed=2, device='cpu',
                                  model=port_model(v))
    np.testing.assert_allclose([h['loss'] for h in hist], want, rtol=1e-4)
    assert opt.count == 4 and [h['steps'] for h in hist] == [2, 4]


def test_train_detector_resume_repeats_the_run(tmp_path):
    """A run resumed from its epoch-1 ``.pth`` (weights, optimizer, the
    ``Generator``'s state) takes the uninterrupted run's pages, RoI draws
    and lrs (the shipped SGD warmup schedule) and reaches its metrics
    exactly; resuming a finished run takes no step."""
    cfg = dict(model=CFG, total_epochs=2, **SCHEDULE)
    ds = Pages(3, seed=3, hw=SIZE, words=(1, 4))
    _, opt, hist = train_detector(cfg, ds, work_dir=str(tmp_path), seed=2,
                                  device='cpu')
    assert os.path.exists(tmp_path / 'epoch_2.pth')
    _, opt2, again = train_detector(
        cfg, ds, seed=2, device='cpu',
        resume_from=str(tmp_path / 'epoch_1.pth'))
    assert [h['epoch'] for h in again] == [1]
    assert opt2.count == opt.count == 6
    assert again[-1]['lr'] == hist[-1]['lr']
    for k in ('loss', 'loss_mask', 'loss_rpn_cls', 'grad_norm'):
        assert again[-1][k] == hist[-1][k], k
    _, _, none = train_detector(cfg, ds, seed=2, device='cpu',
                                resume_from=str(tmp_path))
    assert none == []


def test_train_detector_steps_with_deterministic_cudnn(monkeypatch):
    """Mask R-CNN's steps and eval-mode forwards run with cuDNN's
    deterministic algorithms (benchmarking off), and the settings before
    the run are restored after it, also where a step raises."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, 'deterministic', False)
    monkeypatch.setattr(cudnn, 'benchmark', True)
    seen = []
    losses, rpn = (maskrcnn.MaskRCNNDetector.train_losses,
                   maskrcnn.MaskRCNNDetector.eval_rpn)

    def record(fn):
        def call(*a, **k):
            seen.append((cudnn.deterministic, cudnn.benchmark))
            return fn(*a, **k)
        return call
    monkeypatch.setattr(maskrcnn.MaskRCNNDetector, 'train_losses',
                        record(losses))
    monkeypatch.setattr(maskrcnn.MaskRCNNDetector, 'eval_rpn', record(rpn))
    ds = Pages(2, seed=3, hw=SIZE, words=(1, 3))
    _, opt, _ = train_detector(dict(model=CFG, total_epochs=1), ds,
                               device='cpu')
    assert opt.count == 2 and seen == [(True, False)] * 4
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)

    def fail(*a, **k):
        raise RuntimeError('step')
    monkeypatch.setattr(maskrcnn.MaskRCNNDetector, 'train_losses', fail)
    with pytest.raises(RuntimeError, match='step'):
        train_detector(dict(model=CFG, total_epochs=1), ds, device='cpu')
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)


# ------------------------------------------------------- entry points --

@pytest.fixture(scope='module')
def dets(tmp_path_factory):
    """(JAX detector, its variables, the port's from a .pth of them, the
    .pth)."""
    jdet, v = jax_detector(4)
    pth = str(tmp_path_factory.mktemp('maskrcnn') / 'det.pth')
    torch.save({'meta': {}, 'state_dict': state_dict_from_jax(v, CFG)}, pth)
    det = init_detector(dict(model=CFG), pth, img_size=SIZE, device='cpu')
    return jdet, v, det, pth


def pages(n, seed=0, size=SIZE):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (*size, 3), np.uint8) for _ in range(n)]


def same_or_tied(det, imgs, jdet):
    """``detect_batch``'s boundaries of ``imgs`` are JAX's (points within
    1e-3 px), but on an image where ``maskrcnn_decisions``, tracing that
    call, finds a decision within 1e-4 of its threshold or a box corner
    within 1e-3 px of an integer; returns (the port's boundaries, the
    number compared)."""
    got, margins = maskrcnn_decisions(det.postprocessor,
                                      lambda: det.detect_batch(imgs))
    want = jdet.detect_batch(imgs)
    n = 0
    for a, b, m in zip(got, want, margins):
        if len(a) == len(b) and all(
                np.allclose(p[:-1], q[:-1], rtol=0, atol=1e-3)
                and abs(p[-1] - q[-1]) <= 1e-5 for p, q in zip(a, b)):
            n += len(a)
            continue
        assert min([m['box_margin']] + m['mask_margins']) <= 1e-4 or min(
            m['px_margins']) <= 1e-3
    return got, n


def test_detect_batch_and_init_detector_match_jax(dets):
    """``init_detector`` from a ``.pth``: eval mode, Mask R-CNN's detector
    around the model; ``detect_batch`` of four 96 x 80 uint8 pages gives
    JAX's boundaries, scaled back to the pages, but on an image with a
    decision tie; ``detect``, the batch of one, within 1e-5 of it (the
    convolutions of one page and of four sum in other orders)."""
    jdet, _, det, _ = dets
    assert isinstance(det.postprocessor, maskrcnn.MaskRCNNDetector)
    assert det.postprocessor.model is det.model and not det.model.training
    imgs = pages(4, seed=5, size=(96, 80))
    got, compared = same_or_tied(det, imgs, jdet)
    assert len(got) == 4 and compared >= 4
    one = det.detect(imgs[2])
    assert len(one) == len(got[2])
    for a, b in zip(one, got[2]):
        close(a, b, 1e-5)


def test_mask_rcnn_entry_points_without_a_card_raise(monkeypatch):
    """``init_detector`` and ``train_detector`` run Mask R-CNN on the card
    unless the CPU is asked for: with no card they raise."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_detector(dict(model=CFG), img_size=SIZE)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_detector(dict(model=CFG), Pages(1, hw=SIZE))


def write_config(tmp_path, ann, prefix, extra=''):
    path = str(tmp_path / 'maskrcnn_toy.py')
    with open(path, 'w') as f:
        f.write(f'''model = {CFG!r}
det_img_size = {SIZE!r}
ds = dict(type='IcdarDataset', ann_file={ann!r}, img_prefix={prefix!r},
          img_size={SIZE!r})
data = dict(samples_per_gpu=2,
            train=dict(type='UniformConcatDataset', datasets=[ds]),
            test=dict(type='UniformConcatDataset', datasets=[ds]))
{extra}''')
    return path


def test_tools_test_and_train_on_a_maskrcnn_config(dets, tmp_path):
    """tools/test.py: the hmean-iou of JAX's boundaries on the same weights
    and images; tools/train.py: an epoch of one page a step (its
    ``samples_per_gpu`` of 2 not read), a checkpoint, finite losses."""
    from test_torch_detector import write_dataset
    jdet, _, _, pth = dets
    ann = write_dataset(str(tmp_path), [SIZE] * 3, seed=4)
    prefix = str(tmp_path / 'imgs')
    path = write_config(tmp_path, ann, prefix, 'total_epochs = 1\n')
    metrics = test_tool.main([path, pth, '--eval', 'hmean-iou'],
                             device='cpu')
    jds = JaxDataset(ann, img_prefix=prefix, img_size=SIZE, test_mode=True)
    preds = jdet.detect_batch([(jds[i]['img'] * 255).astype(np.uint8)
                               for i in range(3)])
    for k, val in jds.evaluate(preds, metric='hmean-iou').items():
        assert metrics[f'mean_{k}'] == val
    wd = str(tmp_path / 'wd')
    _, opt, hist = train_tool.main([path, '--work-dir', wd, '--load-from',
                                    pth], device='cpu')
    assert opt.count == 3 and np.isfinite(hist[-1]['loss'])
    assert os.path.exists(os.path.join(wd, 'epoch_1.pth'))


def test_readtext_with_a_maskrcnn_config_path(dets, tmp_path):
    """MMOCR with a Mask R-CNN config file and its ``.pth`` (no
    recognizer): each page's boxes are those of ``TextDetector.detect``'s
    boundaries whose crops are not empty (``MMOCR.crops``)."""
    _, _, det, pth = dets
    path = str(tmp_path / 'maskrcnn_toy.py')
    with open(path, 'w') as f:
        f.write(f'model = {CFG!r}\n')
    ocr = MMOCR(det=path, det_ckpt=pth, recog=None, det_img_size=SIZE,
                device='cpu')
    imgs = pages(2, seed=8)
    res = ocr.readtext(imgs)
    assert len(res) == 2 and sum(len(r['result']) for r in res) >= 1
    for img, r in zip(imgs, res):
        assert [b['box'] for b in r['result']] == [
            box for box, _ in ocr.crops(img, det.detect(img))[1]]
