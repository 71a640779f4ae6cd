"""Detection training in the port against the JAX package on the CPU:
``cv_ops.distance_transform`` against ``cv2.distanceTransform`` (the
image's borders, a stack, and the bounding-box form that the targets
run), ``DBNetTargets`` exact against JAX's, ``DBLoss`` and its
gradients against ``jax.value_and_grad``, ``TextDetDataset`` in train
mode, ``train_detector`` (a narrow DBNet, two epochs) against JAX's loop
on the same weights and pages, its ``.pth`` resume, ``tools/train.py`` on
a det config shaped like the shipped ones (whose ``data.train`` the JAX
CLI cannot build), and the detectors whose training still raises. Pages
and polygons are made from seeds with numpy."""
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tps_pp_tpu.apis.train_det import build_detector_module as jax_build
from tps_pp_tpu.apis.train_det import train_detector as jax_train
from tps_pp_tpu.datasets.textdet_dataset import TextDetDataset as JaxDataset
from tps_pp_tpu.models.textdet import dbnet as jdb
from tps_pp_tpu.models.textdet import targets as jt

from tps_pp_tpu_torch.apis.detector import build_detector_module
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.datasets import TextDetDataset
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.models.textdet import DBLoss, targets
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (64, 64)
DB_CFG = dict(
    type='DBNet',
    backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                  base_channels=8),
    neck=dict(type='FPNC', in_channels=[8, 16, 32, 64], lateral_channels=16,
              out_channels=4),
    head=dict(type='DBHead', in_channels=16, k=50),
    loss=dict(type='DBLoss', alpha=5.0, beta=10.0, negative_ratio=3.0))
SCHEDULE = dict(optimizer=dict(type='SGD', lr=0.007, momentum=0.9,
                               weight_decay=0.0001),
                optimizer_config=dict(grad_clip=None),
                lr_config=dict(policy='poly', power=0.9, min_lr=1e-7,
                               by_epoch=True))


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads while this file's tests run (ROADMAP queue 3:
    torch's oneDNN corrupts the heap at 3 or more in a channels-last
    conv)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def word_polygons(g, n, h, w, curved=0.3):
    """``n`` word boxes (quads, some curved 8-point polygons), tilted,
    some crossing the image's edges, of a few pixels to half the image."""
    out = []
    for _ in range(n):
        c = g.uniform([0, 0], [w, h])
        bw, bh = g.uniform(4, w * 0.6), g.uniform(3, h * 0.4)
        a = g.uniform(-0.5, 0.5)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        if g.random() < curved:
            t = np.linspace(0, 1, 4)
            bend = bh * 0.3 * np.sin(3 * t)
            top = np.stack([-bw / 2 + t * bw, -bh / 2 + bend], 1)
            bot = np.stack([bw / 2 - t * bw, bh / 2 + bend[::-1]], 1)
            p = np.concatenate([top, bot])
        else:
            p = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * [bw, bh] / 2
        out.append((p @ rot.T + c).astype(np.float32))
    return out


# ------------------------------------------------- distance transform --

def dt_masks(seed, n=60):
    """Random speckle and polygon masks of 1 x 1 up to 70 x 90."""
    g = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(g.integers(1, 70)), int(g.integers(1, 90))
        if i % 2:
            m = (g.random((h, w)) < g.uniform(0.3, 1.0)).astype(np.uint8)
        else:
            m = np.zeros((h, w), np.uint8)
            cv2.fillPoly(m, [g.uniform(-10, max(h, w) + 10, (5, 2)).astype(
                np.int32)], 1)
            m = m if i % 4 else 1 - m
        out.append(m)
    return out


@pytest.mark.parametrize('seed', range(4))
def test_distance_transform_matches_cv2(seed):
    """cv2 5.0's float32 chamfer distances bit for bit on every map (0.955
    and 1.3693, FLT_MAX where no zero is reached, pixels outside the image
    never zeros), the image's last row included."""
    for m in dt_masks(seed):
        want = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        got = cv_ops.distance_transform(m)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('h', [1, 2, 3, 5])
def test_distance_transform_long_rows_match_cv2(h):
    """A single zero in each row of an image 300 wide (chains of up to 299
    steps, where cv2's last row takes two steps at once and its rows
    between run four-column blocks), and sparse zeros in wide images."""
    for r in range(h):
        for s in (0, 1, 2, 3, 5, 150, 299):
            m = np.ones((h, 300), np.uint8)
            m[r, s] = 0
            np.testing.assert_array_equal(
                cv_ops.distance_transform(m),
                cv2.distanceTransform(m, cv2.DIST_L2, 3))
    g = np.random.default_rng(h)
    for _ in range(5):
        hw = (h + int(g.integers(0, 40)), int(g.integers(100, 400)))
        m = (g.random(hw) > 0.005).astype(np.uint8)
        np.testing.assert_array_equal(
            cv_ops.distance_transform(m),
            cv2.distanceTransform(m, cv2.DIST_L2, 3))


def test_distance_transform_of_a_stack():
    """A stack of masks is each mask's transform."""
    g = np.random.default_rng(3)
    stack = (g.random((3, 40, 50)) < 0.9).astype(np.uint8)
    full = cv_ops.distance_transform(stack)
    for k in range(3):
        np.testing.assert_array_equal(full[k],
                                      cv_ops.distance_transform(stack[k]))


@pytest.mark.parametrize('seed', range(3))
def test_box_form_equals_the_full_image_where_the_targets_read(seed):
    """The targets' transforms on the polygon's widened box
    (``targets._box``) equal the full image's at every pixel the targets
    read: a distance below ``d``, or which side of ``d`` it lies."""
    g = np.random.default_rng(seed)
    h, w = 96, 120
    for poly in word_polygons(g, 12, h, w):
        mask = targets._poly_mask(poly, h, w)
        if not mask.any():
            continue
        d = int(g.integers(1, 12))
        box = targets._box(mask, d)
        for m in (mask, 1 - mask):
            full = cv2.distanceTransform(m, cv2.DIST_L2, 3)[box]
            crop = cv_ops.distance_transform(m[box])
            read = full < d
            np.testing.assert_array_equal(crop[read], full[read])
            assert (crop[~read] >= d).all()


# ------------------------------------------------------------ targets --

@pytest.mark.parametrize('hw', [(64, 64), (96, 96), (150, 200)])
@pytest.mark.parametrize('seed', range(3))
def test_db_targets_match_jax(hw, seed):
    """Cared polygons (quads and curved, tiny ones ignored, some past the
    edges) and don't-care polygons: all four maps bit for bit."""
    g = np.random.default_rng(10 * seed + hw[0])
    h, w = hw
    polys = word_polygons(g, int(g.integers(1, 9)), h, w)
    ignore = word_polygons(g, int(g.integers(0, 3)), h, w)
    cfg = dict(shrink_ratio=float(g.choice([0.4, 0.6])))
    want = jt.DBNetTargets(**cfg).generate(polys, h, w,
                                           polygons_ignore=ignore)
    item = targets.DBNetTargets(**cfg)(dict(img=np.zeros((h, w, 3)),
                                            gt_polygons=polys,
                                            gt_polygons_ignore=ignore))
    assert set(want) <= set(item)
    for k, v in want.items():
        assert item[k].dtype == np.float32
        np.testing.assert_array_equal(item[k], v, err_msg=k)
    assert want['gt_shrink'].any() and want['gt_thr_mask'].any()


# --------------------------------------------------------------- loss --

def db_batch(seed, n=2, hw=SIZE):
    """Maps in (0, 1) and the targets of random polygons."""
    g = np.random.default_rng(seed)
    preds = 1 / (1 + np.exp(-g.normal(0, 2, (n, *hw, 3))))
    tg = [jt.DBNetTargets().generate(word_polygons(g, 4, *hw), *hw,
                                     polygons_ignore=word_polygons(g, 1, *hw))
          for _ in range(n)]
    return preds.astype(np.float32), {k: np.stack([t[k] for t in tg])
                                      for k in tg[0]}


@pytest.mark.parametrize('seed', range(3))
def test_db_loss_and_gradients_match_jax(seed):
    preds, tgt = db_batch(seed)
    loss = jdb.DBLoss()

    def total(p):
        out = loss(p, {k: jnp.asarray(v) for k, v in tgt.items()})
        return sum(out.values()), out
    (j_total, j_out), j_grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    out = DBLoss()(p, {k: torch.from_numpy(v) for k, v in tgt.items()})
    t_total = sum(out.values())
    t_total.backward()
    assert set(out) == set(j_out)
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(j_out[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-5)
    g = np.asarray(j_grad)
    np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                               atol=1e-5 * np.abs(g).max())


# ---------------------------------------------------------- the loop --

class Pages:
    """Seeded float32 pages with polygons; a fresh dict an item (the JAX
    loop writes its targets into the item it gets)."""

    def __init__(self, n, seed=0, hw=SIZE, words=(2, 6)):
        g = np.random.default_rng(seed)
        self.items = [dict(img=g.random((*hw, 3)).astype(np.float32),
                           gt_polygons=word_polygons(
                               g, int(g.integers(*words)), *hw),
                           gt_polygons_ignore=word_polygons(g, 1, *hw))
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


def jax_init(cfg, seed=0):
    """The variables JAX's ``train_detector`` starts from (its own
    ``module.init`` on ``PRNGKey(seed)``) as the port's model."""
    jm = jax_build(cfg)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SIZE, 3)))
    model = build_detector_module(cfg)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, v), cfg), strict=True)
    return model


def test_train_detector_matches_the_jax_loop():
    """Two epochs of six pages in batches of 4 (the last one short), the
    shipped schedule: each epoch's last loss within 1e-4 of JAX's."""
    cfg = dict(model=DB_CFG, total_epochs=2, **SCHEDULE)
    ds = Pages(6)
    _, want = jax_train(cfg, ds, batch_size=4, seed=3)
    _, opt, hist = train_detector(cfg, ds, batch_size=4, seed=3,
                                  device='cpu', model=jax_init(DB_CFG, 3))
    got = [h['loss'] for h in hist]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert opt.count == 4 and [h['steps'] for h in hist] == [2, 4]
    assert set(hist[0]) >= {'loss_prob', 'loss_thr', 'loss_db', 'lr',
                            'seconds', 'batch_seconds'}


def test_train_detector_resumes_from_a_pth(tmp_path):
    """A run resumed from epoch 1's ``.pth`` repeats epoch 2: the same
    step count, lr and loss as the uninterrupted run."""
    cfg = dict(model=DB_CFG, total_epochs=2, **SCHEDULE)
    ds = Pages(5, seed=1)
    _, _, whole = train_detector(cfg, ds, work_dir=str(tmp_path),
                                 batch_size=2, seed=0, device='cpu')
    assert sorted(os.listdir(tmp_path)) == ['epoch_1.pth', 'epoch_2.pth']
    _, opt, resumed = train_detector(
        cfg, ds, batch_size=2, seed=0, device='cpu',
        resume_from=str(tmp_path / 'epoch_1.pth'))
    assert [h['epoch'] for h in resumed] == [1]
    assert opt.count == whole[-1]['steps'] == 6
    assert resumed[0]['lr'] == whole[-1]['lr']
    np.testing.assert_allclose(resumed[0]['loss'], whole[-1]['loss'],
                               rtol=1e-6)
    _, _, none = train_detector(cfg, ds, batch_size=2, seed=0, device='cpu',
                                resume_from=str(tmp_path))
    assert none == []


@pytest.mark.parametrize('batch_size', [pytest.param(1, id='bs1'),
                                        pytest.param(3, id='bs3')])
def test_maskrcnn_trains_one_page_a_step(batch_size):
    """Mask R-CNN trains one page a step whatever ``batch_size`` says,
    with finite losses (``tests/test_torch_maskrcnn.py`` holds it against
    JAX's loop)."""
    cfg = dict(type='OCRMaskRCNN', backbone=DB_CFG['backbone'],
               neck=dict(type='FPNDet', in_channels=[8, 16, 32, 64],
                         out_channels=8),
               rpn_head=dict(type='RPNHead', feat_channels=8),
               box_head=dict(fc_out=16), mask_head=dict(channels=8),
               num_train_rois=8)
    _, opt, hist = train_detector(dict(model=cfg, total_epochs=1), Pages(3),
                                  batch_size=batch_size, device='cpu')
    assert opt.count == 3 and hist[0]['steps'] == 3
    assert np.isfinite(hist[0]['loss']) and hist[0]['loss_mask'] > 0


def test_train_detector_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_detector(dict(model=DB_CFG), Pages(1))


# -------------------------------------------------- dataset and CLI --

def write_pages(root, n, seed=0):
    """PNG pages at SIZE and a JSON-lines annotation file; returns its
    path."""
    g = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'imgs'), exist_ok=True)
    lines = []
    for i in range(n):
        name = f'page_{i}.png'
        cv2.imwrite(os.path.join(root, 'imgs', name),
                    g.integers(0, 256, (*SIZE, 3), np.uint8))
        anns = [{'polygon': p.reshape(-1).tolist(), 'text': 'ab',
                 'ignore': bool(j == 3)}
                for j, p in enumerate(word_polygons(g, 4, *SIZE, curved=0))]
        lines.append(json.dumps({'file_name': name, 'annotations': anns}))
    ann = os.path.join(root, 'ann.jsonl')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


def test_textdet_dataset_train_items_match_jax(tmp_path):
    ann = write_pages(str(tmp_path), 3)
    prefix = str(tmp_path / 'imgs')
    kw = dict(img_prefix=prefix, img_size=SIZE,
              target_cfg=dict(shrink_ratio=0.5))
    ds, jds = TextDetDataset(ann, **kw), JaxDataset(ann, **kw)
    for i in range(3):
        got, want = ds[i], jds[i]
        np.testing.assert_array_equal(got['img'], want['img'])
        for k in ('gt_shrink', 'gt_shrink_mask', 'gt_thr', 'gt_thr_mask'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert len(got['gt_polygons_ignore']) == 1


def write_config(root, ann, epochs=2):
    """A config shaped like dbnet_r18_fpnc_1200e_icdar2015.py:
    data.train a UniformConcatDataset of IcdarDatasets with a train
    pipeline (which, as in JAX, nothing runs)."""
    path = os.path.join(root, 'dbnet_toy.py')
    with open(path, 'w') as f:
        f.write(f'''model = {DB_CFG!r}
optimizer = {SCHEDULE['optimizer']!r}
optimizer_config = dict(grad_clip=None)
lr_config = {SCHEDULE['lr_config']!r}
total_epochs = {epochs}
train = dict(type='IcdarDataset', ann_file={ann!r},
             img_prefix={os.path.join(root, 'imgs')!r}, pipeline=None,
             img_size={SIZE!r})
train_pipeline = [dict(type='LoadImageFromFile'),
                  dict(type='RandomRotateTextDet')]
data = dict(samples_per_gpu=2, workers_per_gpu=0,
            train=dict(type='UniformConcatDataset', datasets=[train],
                       pipeline=train_pipeline))
log_config = dict(interval=1)
''')
    return path


def test_tools_train_trains_a_uniform_concat_dbnet_config(tmp_path):
    """The port's CLI builds data.train through its registry and trains
    the config's schedule in batches of samples_per_gpu: the losses of
    ``train_detector`` on the same dataset, checkpoints each epoch, and a
    resume from the work dir that runs nothing more."""
    ann = write_pages(str(tmp_path), 3, seed=2)
    cfg_path = write_config(str(tmp_path), ann)
    wd = str(tmp_path / 'wd')
    model, opt, hist = train_tool.main([cfg_path, '--work-dir', wd,
                                        '--seed', '1'], device='cpu')
    assert sorted(os.listdir(wd)) == ['epoch_1.pth', 'epoch_2.pth']
    assert opt.count == 4 and all(np.isfinite(h['loss']) for h in hist)
    from tps_pp_tpu_torch.config import load_config
    from tps_pp_tpu_torch.datasets import build_dataset
    cfg = load_config(cfg_path)
    _, _, want = train_detector(cfg, build_dataset(cfg['data']['train']),
                                batch_size=2, seed=1, device='cpu')
    np.testing.assert_allclose([h['loss'] for h in hist],
                               [h['loss'] for h in want], rtol=1e-6)
    _, _, again = train_tool.main([cfg_path, '--resume-from', wd],
                                  device='cpu')
    assert again == []


def test_jax_cli_cannot_build_the_uniform_concat_train_set(tmp_path):
    """The JAX CLI passes cfg.data.train to TextDetDataset(**d), which a
    UniformConcatDataset entry (the shipped detection configs') cannot
    satisfy; the port builds it (the test above)."""
    ann = write_pages(str(tmp_path), 1, seed=4)
    cfg_path = write_config(str(tmp_path), ann)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, 'tools/train.py', cfg_path,
                          '--work-dir', str(tmp_path / 'wd')], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "missing 1 required positional argument: 'ann_file'" in \
        out.stderr
