"""KIE (SDMGR) and NER (BERT-softmax) in the PyTorch port against the JAX
package on the CPU, at small widths: the F1 metrics; the three datasets'
items bit for bit (an unknown character, more annotations than
``max_nodes``, an empty receipt, the visual modality's image and boxes
from a file, from ``images=`` and from a missing file); the openset pair
decode in each ``link_type``; the UNet in eval and train mode; BlockFusion,
GNNLayer (a graph with a single valid node too), SDMGRHead with and
without visual features, SDMGRLoss; BertEncoder + FCDecoder with an
all-padding row, MaskedCrossEntropyLoss; ``train_kie`` (with and without
the UNet) and ``train_ner`` against JAX's loops over 2 epochs, their lr
schedules' epoch; the resume; the train and test CLIs on the shipped
configs, their data paths overridden with ``--cfg-options``.

Tolerances: outputs within 1e-5 of their largest magnitude (at least 1),
losses of the training loops within 1e-4 relative.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import perturb_batch_stats, to_numpy

from tps_pp_tpu.datasets import kie_dataset as jds
from tps_pp_tpu.evaluation import f1 as jf1
from tps_pp_tpu.models import common as jcommon
from tps_pp_tpu.models.kie import sdmgr as jsdmgr
from tps_pp_tpu.models.ner import bert as jbert

from tps_pp_tpu_torch.apis import train_kie as tk
from tps_pp_tpu_torch.datasets import kie_dataset as ds
from tps_pp_tpu_torch.evaluation import f1
from tps_pp_tpu_torch.models import common
from tps_pp_tpu_torch.models.kie import sdmgr
from tps_pp_tpu_torch.models.ner import bert
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5          # of the largest magnitude
LOSS_RTOL = 1e-4
HEAD = dict(type='SDMGRHead', num_chars=92, node_input=8, node_embed=16,
            edge_embed=16, fusion_dim=32, visual_dim=4, num_classes=5)
UNET = dict(type='UNet', base_channels=4, num_stages=3)
BERT = dict(type='BertEncoder', vocab_size=20200, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
CATS = ['name', 'address']


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def close(got, want, tol=TOL, scale=None):
    """Within ``tol`` of ``scale``, by default the largest magnitude of
    ``want`` (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if scale is None:
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_head(cfg, rel, texts, vis=None, seed=0):
    """A JAX SDMGRHead of ``cfg`` initialised on one graph."""
    c = dict(cfg)
    c.pop('type')
    head = jsdmgr.SDMGRHead(**c)
    args = (jnp.asarray(rel[0]), jnp.asarray(texts[0]))
    if vis is not None:
        args += (jnp.asarray(vis[0]),)
    return head, to_numpy(head.init(jax.random.PRNGKey(seed), *args))


def graphs(g, B=2, N=6, L=5, n_valid=(6, 3), num_chars=92):
    """B padded graphs: texts with 0 to L characters on the first
    n_valid[b] nodes, relations of random boxes."""
    texts = np.zeros((B, N, L), np.int32)
    rel = np.zeros((B, N, N, 5), np.float32)
    for b in range(B):
        n = n_valid[b]
        for i in range(n):
            k = int(g.integers(1, L + 1))
            texts[b, i, :k] = g.integers(1, num_chars, k)
        xy = g.uniform(0, 200, (n, 2))
        wh = g.uniform(5, 60, (n, 2))
        rel[b, :n, :n] = ds.compute_relations(
            np.concatenate([xy, xy + wh], 1).astype(np.float32))
    return rel, texts


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize('seed', range(4))
def test_f1_scores_match_jax(seed):
    g = np.random.default_rng(seed)
    preds, gts = g.integers(0, 6, 200), g.integers(0, 5, 200)
    for ignores, n in (((), None), ((0, 2), 8), ((1,), 6)):
        np.testing.assert_array_equal(
            f1.compute_f1_score(preds, gts, ignores, n),
            jf1.compute_f1_score(preds, gts, ignores, n))
    tags = ['O', 'B-a', 'I-a', 'B-b', 'I-b']
    p = [[tags[i] for i in g.integers(0, 5, int(g.integers(0, 30)))]
         for _ in range(12)]
    q = [[tags[i] for i in g.integers(0, 5, len(s))] for s in p]
    for s in p + q:
        assert f1._extract_entities(s) == jf1._extract_entities(s)
    assert f1.eval_ner_f1(p, q) == jf1.eval_ner_f1(p, q)


# ---------------------------------------------------------------- datasets

def write_receipts(tmp_path, n=4, seed=0, with_edges=False):
    """wildreceipt lines: an unknown character, more annotations than
    max_nodes (8) on the second receipt, an empty third one."""
    g = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        k = [5, 11, 0, 3][i % 4]
        anns = []
        for j in range(k):
            x, y = g.uniform(0, 60, 2)
            w, h = g.uniform(4, 30), g.uniform(3, 12)
            ann = {'box': [x, y, x + w, y, x + w, y + h, x, y + h],
                   'text': ['total', 'Item%d' % j, 'a$b~', ''][j % 4] * 3,
                   'label': int(g.integers(0, 4 if with_edges else 5))}
            if with_edges:
                ann['edge'] = int(g.integers(-1, 3))
            anns.append(ann)
        lines.append({'file_name': f'{i}.png', 'height': 80 + i,
                      'width': 96, 'annotations': anns})
    p = tmp_path / ('openset.jsonl' if with_edges else 'kie.jsonl')
    p.write_text('\n'.join(json.dumps(ln) for ln in lines))
    return str(p), lines


def same_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_kie_dataset_items_match_jax(tmp_path):
    import cv2
    ann, lines = write_receipts(tmp_path)
    g = np.random.default_rng(1)
    imgs = {}
    for ln in lines[:3]:          # the fourth image is missing
        imgs[ln['file_name']] = g.integers(
            0, 256, (ln['height'], ln['width'], 3), np.uint8)
        cv2.imwrite(str(tmp_path / ln['file_name']), imgs[ln['file_name']])
    kw = dict(max_nodes=8, max_chars=6, norm=7.0)
    for visual in (False, True):
        vkw = dict(kw, with_visual=visual, img_prefix=str(tmp_path),
                   img_size=(40, 48))
        mine, ref = ds.KIEDataset(ann, **vkw), jds.KIEDataset(ann, **vkw)
        arrays = ds.KIEDataset(ann, images=imgs, **vkw)
        assert len(mine) == len(ref) == 4
        for i in range(4):
            same_items(mine[i], ref[i])
            same_items(arrays[i], ref[i])
    item = mine[0]
    assert (item['texts'] == len(mine.char2idx) + 1).any()   # '$', '~'
    assert (mine[1]['labels'] != -100).sum() == 8
    assert (mine[2]['labels'] == -100).all()
    assert (mine[2]['edge_labels'] == -1).all()
    # the missing image is black
    np.testing.assert_array_equal(mine[3]['img'][0, 0],
                                  -ds.IMG_MEAN / ds.IMG_STD)
    preds = [np.random.default_rng(i).integers(0, 5, 8) for i in range(4)]
    for ign in ((), (0, 2)):
        assert mine.evaluate(preds, ignores=ign, num_classes=5) == \
            ref.evaluate(preds, ignores=ign, num_classes=5)


def test_kie_dataset_dict_file_and_cv2_free_route(tmp_path, monkeypatch):
    import builtins
    ann, lines = write_receipts(tmp_path)
    dict_file = tmp_path / 'dict.txt'
    dict_file.write_text('\n'.join('abcdefghijklmnopqrstuvwxyz'))
    a = ds.KIEDataset(ann, dict_file=str(dict_file), max_nodes=8)
    b = jds.KIEDataset(ann, dict_file=str(dict_file), max_nodes=8)
    for i in range(4):
        same_items(a[i], b[i])
    # images= and a missing file need no cv2
    real = builtins.__import__

    def refuse(name, *args, **kw):
        if name == 'cv2':
            raise ImportError('cv2 is blocked')
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, '__import__', refuse)
    img = np.full((50, 60, 3), 7, np.uint8)
    c = ds.KIEDataset(ann, with_visual=True, img_prefix=str(tmp_path),
                      img_size=(16, 16), images={'0.png': img})
    assert c[0]['img'].shape == (16, 16, 3) and c[1]['img'].shape == \
        (16, 16, 3)
    (tmp_path / '2.png').write_bytes(b'not an image')
    with pytest.raises(ImportError, match='images='):
        c[2]


@pytest.mark.parametrize('link_type', ['one-to-one', 'one-to-many',
                                       'many-to-one', 'many-to-many',
                                       'none'])
def test_openset_items_and_decode_match_jax(tmp_path, link_type):
    ann, lines = write_receipts(tmp_path, with_edges=True)
    kw = dict(max_nodes=8, link_type=link_type, edge_thr=0.4)
    mine, ref = ds.OpensetKIEDataset(ann, **kw), \
        jds.OpensetKIEDataset(ann, **kw)
    g = np.random.default_rng(3)
    results = []
    for i in range(len(mine)):
        same_items(mine[i], ref[i])
        n = int((mine[i]['labels'] != -100).sum())
        nodes = g.dirichlet(np.ones(4), n).astype(np.float32)
        results.append({'filename': lines[i]['file_name'], 'nodes': nodes,
                        'edges': g.random((n, n)).astype(np.float32)})
        labels = nodes.argmax(-1)
        assert mine._decode_pairs_pred(nodes, labels, results[-1]['edges']) \
            == ref._decode_pairs_pred(nodes, labels, results[-1]['edges'])
    assert mine.evaluate(results) == ref.evaluate(results)


def test_ner_dataset_items_match_jax(tmp_path):
    path, _ = write_cluener(tmp_path)
    vocab = tmp_path / 'vocab.txt'
    vocab.write_text('\n'.join(['[PAD]', '[UNK]'] + list('alicewntopr ')))
    for v in (None, str(vocab)):
        mine = ds.NerDataset(path, CATS, vocab_file=v, max_len=20)
        ref = jds.NerDataset(path, CATS, vocab_file=v, max_len=20)
        for i in range(len(mine)):
            same_items(mine[i], ref[i])
        g = np.random.default_rng(0)
        preds = [g.integers(0, 5, 20) for _ in range(len(mine))]
        assert mine.evaluate(preds) == ref.evaluate(preds)
        gts = [mine[i]['labels'] for i in range(len(mine))]
        assert mine.evaluate(gts)['f1-score'] == 1.0


def write_cluener(tmp_path, n=8):
    lines = []
    for i in range(n):
        text = f'alice went to paris {i}' + ' far' * (i % 3)
        lines.append({'text': text,
                      'label': {'name': {'alice': [[0, 4]]},
                                'address': {'paris': [[14, 18]],
                                            'far': [[22, 40]]}}})
    p = tmp_path / 'ner.jsonl'
    p.write_text('\n'.join(json.dumps(ln) for ln in lines))
    return str(p), lines


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize('hw', [(32, 40), (30, 22)])
def test_unet_matches_jax(hw):
    g = np.random.default_rng(0)
    x = g.standard_normal((2, *hw, 3)).astype(np.float32)
    jnet = jcommon.UNet(base_channels=4, num_stages=3)
    v = perturb_batch_stats(jnet.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)), 0)
    net = common.UNet(base_channels=4, num_stages=3)
    rules = [(tp[len('backbone.'):], fp[len('unet/'):], k)
             for tp, fp, k in convert.unet_rules(3)]
    net.load_state_dict(convert.convert_rules(v, rules), strict=True)
    net.eval()
    close(net(t(x)).detach(), jnet.apply(v, jnp.asarray(x)))
    net.train()
    want, state = jnet.apply(v, jnp.asarray(x), train=True,
                             mutable=['batch_stats'])
    close(net(t(x)).detach(), want)
    sd = convert.convert_rules({'params': v['params'], **to_numpy(state)},
                               rules)
    for k, val in net.state_dict().items():
        if 'running' in k:
            close(val, sd[k])


def test_dice_and_focal_losses_match_jax():
    g = np.random.default_rng(0)
    p, tg, m = (g.random((2, 8, 8)).astype(np.float32) for _ in range(3))
    logits = g.standard_normal((2, 8, 8)).astype(np.float32)
    close(common.DiceLoss()(t(p), t(tg), t(m)),
          jcommon.DiceLoss()(p, tg, m))
    close(common.DiceLoss()(t(p), t(tg)), jcommon.DiceLoss()(p, tg))
    close(common.FocalLoss()(t(logits), t(tg > 0.5)),
          jcommon.FocalLoss()(logits, tg > 0.5))


def test_block_fusion_matches_jax():
    g = np.random.default_rng(0)
    x0 = g.standard_normal((2, 6, 4)).astype(np.float32)
    x1 = g.standard_normal((2, 6, 16)).astype(np.float32)
    x0[0, 5] = 0                          # a zero row: the guarded norm
    jm = jsdmgr.BlockFusion(16, 32)
    v = to_numpy(jm.init(jax.random.PRNGKey(1), x0, x1))
    m = sdmgr.BlockFusion((4, 16), 16, 32)
    rules = [(tp[len('head.fusion.'):], fp[len('head/fusion/'):], k)
             for tp, fp, k in convert.sdmgr_rules(
                 dict(head=HEAD, backbone=UNET), True)
             if tp.startswith('head.fusion.')]
    m.load_state_dict(convert.convert_rules(v, rules), strict=True)
    close(m(t(x0), t(x1)).detach(), jm.apply(v, x0, x1))


@pytest.mark.parametrize('valid', [(6, 3), (1, 0)])
def test_gnn_layer_matches_jax(valid):
    """A graph with one valid node keeps its self pair; one with none
    attends uniformly, as in JAX."""
    g = np.random.default_rng(0)
    nodes = g.standard_normal((2, 6, 8)).astype(np.float32)
    edges = g.standard_normal((2, 6, 6, 8)).astype(np.float32)
    mask = np.zeros((2, 6), np.float32)
    for b, n in enumerate(valid):
        mask[b, :n] = 1
    jm = jsdmgr.GNNLayer(8, 8)
    v = to_numpy(jm.init(jax.random.PRNGKey(0), nodes[0], edges[0],
                         mask[0]))
    m = sdmgr.GNNLayer(8, 8)
    m.load_state_dict(convert.convert_rules(v, [
        (k, k, 'linear') for k in ('in_fc', 'coef_fc', 'out_fc')]),
        strict=True)
    got = m(t(nodes), t(edges), t(mask))
    want = jax.vmap(lambda a, b, c: jm.apply(v, a, b, c))(nodes, edges, mask)
    for a, b in zip(got, want):
        close(a.detach(), b)


@pytest.mark.parametrize('visual', [False, True])
def test_sdmgr_head_and_loss_match_jax(visual):
    g = np.random.default_rng(0)
    rel, texts = graphs(g, n_valid=(6, 1))
    vis = g.standard_normal((2, 6, 4)).astype(np.float32) if visual else None
    jhead, v = jax_head(HEAD, rel, texts, vis)
    head = sdmgr.SDMGRHead(**{k: x for k, x in HEAD.items() if k != 'type'},
                           visual_modality=visual)
    sd = convert.state_dict_from_jax({'params': {'head': v['params']}},
                                     dict(type='SDMGR', head=HEAD))
    head.load_state_dict({k[len('head.'):]: x for k, x in sd.items()},
                         strict=True)
    node, edge = head(t(rel), t(texts), None if vis is None else t(vis))
    fn = (lambda r, x: jhead.apply(v, r, x)) if vis is None else \
        (lambda r, x, z: jhead.apply(v, r, x, z))
    wn, we = jax.vmap(fn)(*((rel, texts) if vis is None
                            else (rel, texts, vis)))
    close(node.detach(), wn)
    close(edge.detach(), we)
    labels = np.where(texts.any(-1), g.integers(0, 5, (2, 6)), -100)
    edge_labels = np.full((2, 6, 6), -1, np.int32)
    edge_labels[0] = g.integers(0, 2, (6, 6))
    got = sdmgr.SDMGRLoss()(node.reshape(-1, 5), edge.reshape(-1, 2),
                            t(labels).reshape(-1), t(edge_labels).reshape(-1))
    want = jsdmgr.SDMGRLoss()(np.asarray(wn).reshape(-1, 5),
                              np.asarray(we).reshape(-1, 2),
                              labels.reshape(-1), edge_labels.reshape(2, -1))
    for k in want:
        close(got[k].detach(), want[k])


def jax_ner(cfg, T, seed=0):
    enc = dict(cfg['encoder'])
    enc.pop('type')
    dec = dict(cfg['decoder'])
    dec.pop('type')
    module = jbert.NerClassifierModule(encoder=jbert.BertEncoder(**enc),
                                       decoder=jbert.FCDecoder(**dec))
    v = to_numpy(module.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, T), jnp.int32)))
    return module, v


def ner_cfg(**enc):
    return dict(type='NerClassifier', encoder=dict(BERT, **enc),
                decoder=dict(type='FCDecoder', num_labels=2 * len(CATS) + 1))


def test_bert_classifier_and_loss_match_jax():
    """Two layers, B=3, one row all padding (uniform attention in both)."""
    cfg = ner_cfg()
    module, v = jax_ner(cfg, 12)
    model = bert.NerClassifier(cfg)
    model.load_state_dict(convert.state_dict_from_jax(v, cfg), strict=True)
    model.eval()
    g = np.random.default_rng(0)
    ids = g.integers(0, 20200, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0
    mask[2] = 0
    types = g.integers(0, 2, (3, 12)).astype(np.int32)
    got = model(t(ids), t(mask), t(types)).detach()
    want = module.apply(v, ids, mask, types)
    close(got, want)
    assert torch.isfinite(got).all()
    labels = g.integers(0, 5, (3, 12))
    close(bert.MaskedCrossEntropyLoss(num_labels=5)(got, t(labels), t(mask))
          ['loss_cls'], jbert.MaskedCrossEntropyLoss(num_labels=5)(
              np.asarray(want), labels, mask)['loss_cls'])
    with pytest.raises(ValueError, match='num_labels'):
        bert.MaskedCrossEntropyLoss(num_labels=7)(got, t(labels), t(mask))


def test_bert_dropout_in_train_mode_only():
    cfg = ner_cfg()
    model = tk.init_kie_weights(bert.NerClassifier(cfg), 0)
    ids = torch.randint(0, 100, (2, 10))
    mask = torch.ones(2, 10, dtype=torch.long)
    model.eval()
    a = model(ids, mask)
    model.train()
    b = model(ids, mask, rng=torch.Generator().manual_seed(1))
    c = model(ids, mask, rng=torch.Generator().manual_seed(1))
    assert not torch.equal(a, b) and torch.equal(b, c)


# ---------------------------------------------------------------- training

def kie_cfg(visual=False, epochs=2, **extra):
    model = dict(type='SDMGR', head=HEAD, loss=dict(type='SDMGRLoss'))
    if visual:
        model.update(backbone=UNET, visual_modality=True)
    return dict(model=model, optimizer=dict(type='Adam', lr=1e-2),
                total_epochs=epochs, **extra)


def jax_kie_init(cfg, sample, visual, seed=0):
    """The variables JAX's train_kie starts from (its own init calls)."""
    rng0 = jax.random.PRNGKey(seed)
    c = dict(cfg['model']['head'])
    c.pop('type')
    head = jsdmgr.SDMGRHead(**c)
    r, x = jnp.asarray(sample['relations']), jnp.asarray(sample['texts'])
    if not visual:
        return {'params': {'head': head.init(rng0, r, x)['params']}}
    unet = jcommon.UNet(base_channels=4, num_stages=3)
    img0 = jnp.asarray(sample['img'])[None]
    uv = unet.init(rng0, img0)
    from tps_pp_tpu.apis.train_kie import roi_visual_pool
    vis0 = roi_visual_pool(unet.apply(uv, img0)[0],
                           jnp.asarray(sample['boxes']))
    hv = head.init(rng0, r, x, vis0)
    return to_numpy({'params': {'head': hv['params'],
                                'unet': uv['params']},
                     'batch_stats': uv['batch_stats']})


def receipts_with_images(tmp_path, n=8):
    import cv2
    ann, lines = write_receipts(tmp_path, n=n)
    g = np.random.default_rng(2)
    for ln in lines:
        cv2.imwrite(str(tmp_path / ln['file_name']), g.integers(
            0, 256, (ln['height'], ln['width'], 3), np.uint8))
    return ann


@pytest.mark.parametrize('visual', [False, True])
def test_train_kie_matches_jax_loop(tmp_path, visual):
    """2 epochs of 8 receipts at B=4 (the tail padded), from JAX's init:
    each epoch's last loss within LOSS_RTOL; the checkpoints."""
    from tps_pp_tpu.apis.train_kie import train_kie as jax_train_kie
    from tps_pp_tpu.config import ConfigDict
    ann = receipts_with_images(tmp_path)
    kw = dict(max_nodes=8, max_chars=6, with_visual=visual,
              img_prefix=str(tmp_path), img_size=(32, 32))
    cfg = kie_cfg(visual)
    jds_ = jds.KIEDataset(ann, **kw)
    _, want = jax_train_kie(ConfigDict._wrap(cfg), jds_, batch_size=4)
    train = ds.KIEDataset(ann, **kw)
    model = sdmgr.build_sdmgr(cfg['model'], visual)
    model.load_state_dict(convert.state_dict_from_jax(
        jax_kie_init(cfg, jds_[0], visual), cfg['model']), strict=True)
    wd = str(tmp_path / 'wd')
    model, opt, hist = tk.train_kie(cfg, train, work_dir=wd, batch_size=4,
                                    device='cpu', model=model)
    np.testing.assert_allclose([h['loss'] for h in hist], want,
                               rtol=LOSS_RTOL)
    assert opt.count == 4 and [h['steps'] for h in hist] == [2, 4]
    assert sorted(os.listdir(wd)) == ['epoch_1.pth', 'epoch_2.pth']
    assert not model.training
    # the resume from epoch 1 runs epoch 2 again
    _, opt2, again = tk.train_kie(
        cfg, train, batch_size=4, device='cpu',
        resume_from=os.path.join(wd, 'epoch_1.pth'))
    assert [h['epoch'] for h in again] == [1] and opt2.count == 4
    np.testing.assert_allclose(again[0]['loss'], hist[1]['loss'],
                               rtol=1e-6)


def test_train_ner_matches_jax_loop(tmp_path):
    from tps_pp_tpu.apis.train_kie import train_ner as jax_train_ner
    from tps_pp_tpu.config import ConfigDict
    path, _ = write_cluener(tmp_path)
    cfg = dict(model=ner_cfg(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0),
               optimizer=dict(type='Adam', lr=1e-3), total_epochs=2)
    cfg['model']['decoder']['hidden_dropout_prob'] = 0.0
    cfg['model']['loss'] = dict(type='MaskedCrossEntropyLoss')
    train = ds.NerDataset(path, CATS, max_len=32)
    _, want = jax_train_ner(ConfigDict._wrap(cfg),
                            jds.NerDataset(path, CATS, max_len=32),
                            batch_size=3)
    _, v = jax_ner(cfg['model'], 32)
    model = bert.NerClassifier(cfg['model'])
    model.load_state_dict(convert.state_dict_from_jax(v, cfg['model']),
                          strict=True)
    _, opt, hist = tk.train_ner(cfg, train, batch_size=3, device='cpu',
                                model=model, work_dir=str(tmp_path / 'wd'))
    np.testing.assert_allclose([h['loss'] for h in hist], want,
                               rtol=LOSS_RTOL)
    assert opt.count == 6
    # with dropout: finite and repeatable (masks seeded by the step)
    cfg = dict(cfg, model=ner_cfg())
    runs = [tk.train_ner(cfg, train, batch_size=3, device='cpu')[2]
            for _ in range(2)]
    assert runs[0] == [dict(h, seconds=runs[0][i]['seconds'])
                       for i, h in enumerate(runs[1])]
    assert np.isfinite(runs[0][-1]['loss'])


@pytest.mark.parametrize('family', ['kie', 'ner'])
def test_lr_drops_at_jax_steps_per_epoch(tmp_path, family):
    """JAX's optimizer epoch: len(train_ds) steps for KIE, len // batch
    for NER; 8 items at B=4 take 2 steps an epoch, so a step policy at
    epoch 1 drops the lr at step 8 (epoch 4) for KIE, at step 2 for
    NER."""
    lr_config = dict(policy='step', warmup='linear', warmup_iters=1,
                     warmup_ratio=1, step=[1])
    if family == 'kie':
        ann, _ = write_receipts(tmp_path, n=8)
        cfg = kie_cfg(epochs=5, lr_config=lr_config)
        _, _, hist = tk.train_kie(cfg, ds.KIEDataset(ann, max_nodes=8),
                                  batch_size=4, device='cpu')
        drop = 4
    else:
        path, _ = write_cluener(tmp_path)
        cfg = dict(model=ner_cfg(), optimizer=dict(type='Adam', lr=1e-2),
                   total_epochs=5, lr_config=lr_config)
        _, _, hist = tk.train_ner(cfg, ds.NerDataset(path, CATS, max_len=32),
                                  batch_size=4, device='cpu')
        drop = 1
    lrs = [h['lr'] for h in hist]
    assert lrs == [1e-2] * drop + [pytest.approx(1e-3)] * (5 - drop), lrs


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tk.train_kie(kie_cfg(), [None])
    with pytest.raises(RuntimeError, match='CUDA'):
        tk.build_ner_model(dict(model=ner_cfg()))
    with pytest.raises(RuntimeError, match='CUDA'):
        tk.build_sdmgr_apply(kie_cfg(), None, {})
    with pytest.raises(RuntimeError, match='CUDA'):
        tk.train_ner(dict(model=ner_cfg()), [None])


# ---------------------------------------------------------------- the CLIs

KIE_CONFIGS = {
    'closed': 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py',
    'openset': 'configs/kie/sdmgr/sdmgr_novisual_60e_wildreceipt_openset.py',
}


@pytest.mark.parametrize('kind', list(KIE_CONFIGS))
def test_kie_clis_on_shipped_configs(tmp_path, kind):
    """tools/train.py then tools/test.py on a shipped SDMGR config, its
    data and widths overridden (the JAX CLI's own test,
    tests/test_train_kie_ner.py), the macro F1 / openset F1 that of the
    checkpoint's predictions."""
    ann, _ = write_receipts(tmp_path, n=6, with_edges=kind == 'openset')
    cfg_path = os.path.join(REPO, KIE_CONFIGS[kind])
    opts = []
    for split in ('train', 'test'):
        opts += [f'data.{split}.ann_file={ann}', f'data.{split}.dict_file=',
                 f'data.{split}.max_nodes=8', f'data.{split}.max_chars=8',
                 f'data.{split}.with_visual=False']
    opts += ['model.head.node_embed=16', 'model.head.edge_embed=16',
             'model.head.fusion_dim=32', 'data.samples_per_gpu=4',
             'total_epochs=2']
    wd = str(tmp_path / 'wd')
    model, opt, hist = train_tool.main(
        [cfg_path, '--work-dir', wd, '--cfg-options'] + opts, device='cpu')
    assert opt.count == 4 and sorted(os.listdir(wd)) == \
        ['epoch_1.pth', 'epoch_2.pth']
    assert all(np.isfinite(h['loss']) for h in hist)
    if kind == 'closed':
        opts.append('evaluation.metric_options.macro_f1.ignores=[]')
    out = str(tmp_path / 'out.json')
    metrics = test_tool.main([cfg_path, os.path.join(wd, 'epoch_2.pth'),
                              '--out', out, '--cfg-options'] + opts,
                             device='cpu')
    saved = json.load(open(out))
    assert saved['metrics'] == metrics and len(saved['results']) == 6
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    cfg = merge_cli_options(load_config(cfg_path),
                            test_tool.parse_cfg_options(opts))
    test_ds = tk.build_task_dataset(cfg, 'test')
    with torch.no_grad():
        node_cls, edge_cls = model(*(torch.from_numpy(np.stack(
            [test_ds[i][k] for i in range(6)])) for k in ('relations',
                                                          'texts')))
    if kind == 'closed':
        assert set(metrics) == {'macro_f1'}
        assert metrics == test_ds.evaluate(
            list(node_cls.numpy().argmax(-1)), ignores=[], num_classes=26)
    else:
        assert set(metrics) == {'edge_openset_f1', 'node_openset_micro_f1',
                                'node_openset_macro_f1'}


def test_ner_clis_on_shipped_config(tmp_path):
    path, _ = write_cluener(tmp_path)
    cfg_path = os.path.join(
        REPO, 'configs/ner/bert_softmax/bert_softmax_cluener_18e.py')
    opts = [f'data.{s}.{k}' for s in ('train', 'test') for k in (
        f'ann_file={path}', 'vocab_file=', 'max_len=32')]
    opts += ['model.encoder.hidden_size=32', 'model.encoder.vocab_size=20200',
             'model.encoder.num_hidden_layers=2',
             'model.encoder.num_attention_heads=4',
             'model.encoder.intermediate_size=64',
             'model.encoder.max_position_embeddings=64',
             'data.samples_per_gpu=4', 'total_epochs=2',
             'optimizer.lr=1e-3']
    wd = str(tmp_path / 'wd')
    model, opt, hist = train_tool.main(
        [cfg_path, '--work-dir', wd, '--cfg-options'] + opts, device='cpu')
    assert opt.count == 4 and os.path.exists(os.path.join(wd, 'epoch_2.pth'))
    metrics = test_tool.main([cfg_path, os.path.join(wd, 'epoch_2.pth'),
                              '--cfg-options'] + opts, device='cpu')
    from tps_pp_tpu_torch.config import load_config, merge_cli_options
    cfg = merge_cli_options(load_config(cfg_path),
                            test_tool.parse_cfg_options(opts))
    test_ds = tk.build_task_dataset(cfg, 'test')
    preds = []
    with torch.no_grad():
        for i in range(len(test_ds)):
            it = test_ds[i]
            preds.append(model(torch.from_numpy(it['input_ids'])[None],
                               torch.from_numpy(it['attention_mask'])[None]
                               ).numpy().argmax(-1)[0])
    assert metrics == test_ds.evaluate(preds)
    assert set(metrics) == {'precision', 'recall', 'f1-score'}


def test_jax_cli_fails_on_the_openset_config(tmp_path):
    """The JAX ``tools/test.py:155`` reads ``evaluation.metric_options``
    as a dict, and the shipped openset config sets it to None: its KIE
    branch raises after the test set's pass. The port's reads None as no
    options (``test_kie_clis_on_shipped_configs[openset]``)."""
    import argparse
    import importlib.util
    from tps_pp_tpu.config import load_config as jax_load_config
    from tps_pp_tpu.config import merge_cli_options as jax_merge
    spec = importlib.util.spec_from_file_location(
        'jax_test_cli', os.path.join(REPO, 'tools/test.py'))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    ann, _ = write_receipts(tmp_path, n=2, with_edges=True)
    cfg = jax_load_config(os.path.join(REPO, KIE_CONFIGS['openset']))
    jax_merge(cfg, {'data.test.ann_file': ann, 'data.test.dict_file': '',
                    'data.test.max_nodes': 8, 'model.head.node_embed': 16,
                    'model.head.edge_embed': 16})
    with pytest.raises(AttributeError, match='NoneType'):
        cli._eval_kie_ner(cfg, argparse.Namespace(checkpoint=None,
                                                  eval='openset_f1'))
