"""The port stands alone: importing it, serving (through every decode mode,
the fused decode step, the fused stem and the two-stage sampler) and
training on the CPU (``train_recognizer`` on crops through the flagship's
train augmentations), and the same for a tiny ABINet + TPS++, for a
small CRNN + TPS-STN (the CTC family, grayscale crops), for a small SAR
(beam search) and RobustScanner on ResNet31 and for a small SATRN and NRTR
on the modality transform, loads neither JAX,
flax, cv2 nor the JAX package, and launches no kernel (CPU tensors go to
the kernels' plain versions; nothing is built). So do detection (DBNet on
ResNetDet and on ResNetDet50 with DCNv2), its evaluation modules and
``MMOCR.readtext``, detection training (DBNet, PANet, PSENet) with
PAN and PSE serving, FCENet's and TextSnake's training and serving,
DRRG's and Mask R-CNN's, and KIE's and NER's (SDMGR with the UNet, BERT,
their CLIs, ``MMOCR(kie='SDMGR')``), and the deployment slice (export,
the CPU ``aot_compile``, the server on a PNG body, ``fileio``)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import tps_pp_tpu_torch
from tps_pp_tpu_torch import registry
from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.apis import flagship, recognizer, train
from tps_pp_tpu_torch.convertors import attn, base
from tps_pp_tpu_torch.losses import ce
from tps_pp_tpu_torch.models import layers, transformer
from tps_pp_tpu_torch.models.backbones import resnet_abi
from tps_pp_tpu_torch.models.decoders import base as dbase, nrtr as dnrtr
from tps_pp_tpu_torch.models.encoders import nrtr as enrtr
from tps_pp_tpu_torch.models.recognizers import encode_decode
from tps_pp_tpu_torch.models.rectifiers import tps_pp
from tps_pp_tpu_torch.ops import (_lib, decode_step, encoder, full_decode,
                                  grid_sample, stem, tps, tps_sampler)
from tps_pp_tpu_torch.parallel import train as ptrain
from tps_pp_tpu_torch.utils import batching, convert

wrappers = (tps_sampler.tps_sampler, encoder.encoder_forward,
            full_decode.full_decode, grid_sample.grid_sample_forward,
            grid_sample.grid_sample_grad, grid_sample.grid_sample_grad_img,
            decode_step.self_attn_step, decode_step.cross_ffn_step,
            stem.conv3x3_cp, stem.basic_block_cp)
for mode, fused_step, stem_mode, variant in (
        ('fused40_bf16', False, 'xla', 'dense'),
        ('fused40', False, 'fused', 'twostage'),
        ('steps', False, 'xla', 'dense'), ('steps', True, 'fused', 'dense')):
    os.environ['TPS_SAMPLER_VARIANT'] = variant
    cfg = nrtr_tps_pp_cfg(tiny=True, decode_mode=mode)
    cfg['decoder']['use_fused_step'] = fused_step
    cfg['stem_mode'] = stem_mode
    cfg['tpsnet']['sample_mode'] = 'pallas'
    rec = build_recognizer(cfg, device='cpu')
    assert rec.resolved_stem_mode() == stem_mode
    rec.init_weights(0)
    res = rec.simple_test(np.zeros((3, 32, 64, 3), np.float32),
                          [1.0, 0.5, 0.8])
    assert len(res) == 3
from tps_pp_tpu_torch.datasets import seeded_rngs
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.datasets.pipelines.transforms import Compose
from tps_pp_tpu_torch.parallel import dist
from tps_pp_tpu_torch.tools import train as train_tool
from tps_pp_tpu_torch.utils import checkpoint


class Crops:
    """uint8 crops through the flagship's train augmentations."""

    def __init__(self):
        g = np.random.default_rng(0)
        self.imgs = [g.integers(0, 256, (20 + 4 * i, 40 + 9 * i, 3),
                                np.uint8) for i in range(4)]
        self.pipeline = Compose([
            dict(type='LoadImageFromNdarray'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='RandomWrapper', p=1.0, transforms=[
                dict(type='OneOfWrapper', transforms=[
                    dict(type='RandomRotateTextDet'),
                    dict(type='RandomAffine'),
                    dict(type='RandomPerspective')]),
                dict(type='PyramidRescale', randomize_factor=False,
                     factor=2),
                dict(type='GaussNoise'), dict(type='MotionBlur'),
                dict(type='ColorJitter')]),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.5] * 3, std=[0.25] * 3),
            dict(type='Collect', keys=['img'])])

    def __len__(self):
        return len(self.imgs)

    def sample(self, i, key=None):
        return self.pipeline(dict(img=self.imgs[i], text='ab'[:i % 2 + 1],
                                  img_info=dict(filename=None),
                                  **seeded_rngs(key)))


opt, history = train.train_recognizer(
    rec, Crops(), dict(optimizer=dict(type='Adam', lr=1e-4),
                       samples_per_gpu=4, total_epochs=1, log_interval=1))
assert opt.count == 1 and np.isfinite(history[0]['loss'])

# the ABINet family: serving and a training step of a tiny ABINet + TPS++
from tps_pp_tpu_torch.apis import abinet
from tps_pp_tpu_torch.convertors import abi as cabi
from tps_pp_tpu_torch.losses import abi as labi
from tps_pp_tpu_torch.models import fusers
from tps_pp_tpu_torch.models.decoders import abi as dabi
from tps_pp_tpu_torch.models.encoders import abi as eabi
from tps_pp_tpu_torch.models.recognizers import abinet as rabinet
abi_cfg = dict(
    type='ABINet',
    label_convertor=dict(type='ABIConvertor', dict_type='DICT36',
                         with_unknown=False, lower=True),
    backbone=dict(type='ResNetABI', stem_channels=4, base_channels=4,
                  arch_settings=[1, 1, 1, 1, 1], strides=[1, 2, 2, 1, 1]),
    tpsnet=dict(type='TPS_PP', num_img_channel=8, img_size=(16, 32),
                rectified_img_size=(16, 32), point_size=(2, 8)),
    encoder=dict(type='ABIVisionModel',
                 encoder=dict(type='TransformerEncoder', n_layers=1,
                              n_head=2, d_model=64, d_inner=64,
                              max_len=128),
                 decoder=dict(type='ABIVisionDecoder', in_channels=64,
                              num_channels=16)),
    decoder=dict(type='ABILanguageDecoder', d_model=64, n_head=2,
                 d_inner=64, n_layers=1),
    fuser=dict(type='ABIFuser', d_model=64),
    loss=dict(type='ABILoss'), max_seq_len=8, iter_size=2)
rec = build_recognizer(abi_cfg, device='cpu', param_dtype='float32')
assert isinstance(rec, abinet.ABINetRecognizer)
rec.init_weights(0)
assert len(rec.simple_test(np.zeros((3, 32, 64, 3), np.float32))) == 3
opt, history = train.train_recognizer(
    rec, Crops(), dict(optimizer=dict(type='Adam', lr=1e-4),
                       samples_per_gpu=4, total_epochs=1, log_interval=1))
assert opt.count == 1 and np.isfinite(history[0]['loss_fusion'])

# the CTC family: serving and a training step of a small CRNN + TPS-STN
from tps_pp_tpu_torch.convertors import ctc as cctc
from tps_pp_tpu_torch.losses import ctc as lctc
from tps_pp_tpu_torch.models.backbones import vgg
from tps_pp_tpu_torch.models.decoders import crnn as dcrnn
from tps_pp_tpu_torch.models.rectifiers import tps_stn
crnn_cfg = dict(
    type='CRNNNet',
    label_convertor=dict(type='CTCConvertor', dict_type='DICT36',
                         with_unknown=False, lower=True),
    preprocessor=dict(type='TPSPreprocessor', num_fiducial=6,
                      img_size=(32, 64), rectified_img_size=(32, 64),
                      num_img_channel=1),
    backbone=dict(type='VeryDeepVgg', leaky_relu=False, input_channels=1),
    decoder=dict(type='CRNNDecoder', in_channels=512, rnn_flag=True),
    loss=dict(type='CTCLoss'), max_seq_len=8)
rec = build_recognizer(crnn_cfg, device='cpu', param_dtype='float32')
assert rec.resolved_decode_mode() == 'single_pass'
rec.init_weights(0)
assert len(rec.simple_test(np.zeros((3, 32, 64, 1), np.float32),
                           [1.0, 0.5, 0.8])) == 3
gray = Crops()
gray.pipeline = Compose([
    dict(type='LoadImageFromNdarray', color_type='grayscale'),
    dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
         keep_aspect_ratio=False),
    dict(type='ToTensorOCR'), dict(type='NormalizeOCR', mean=[0.5],
                                   std=[0.5]),
    dict(type='Collect', keys=['img'])])
opt, history = train.train_recognizer(
    rec, gray, dict(optimizer=dict(type='Adadelta', lr=1.0),
                    samples_per_gpu=4, total_epochs=1, log_interval=1))
assert opt.count == 1 and np.isfinite(history[0]['loss_ctc'])

# the ResNet31 attention family: serving (greedy and beam) and a training
# step of a small SAR and a small RobustScanner
from tps_pp_tpu_torch.models.backbones import resnet31
from tps_pp_tpu_torch.models.decoders import robust_scanner as drs, sar as dsar
from tps_pp_tpu_torch.models.encoders import sar as esar
r31 = dict(type='ResNet31OCR', layers=[1, 1, 1, 1],
           channels=[8, 8, 8, 8, 16, 16, 16])
lc36 = dict(type='AttnConvertor', dict_type='DICT36', with_unknown=True)
for family_cfg in (
        dict(type='SARNet', label_convertor=lc36, backbone=r31,
             encoder=dict(type='SAREncoder', d_model=16, d_enc=16,
                          enc_do_rnn=0.1),
             decoder=dict(type='ParallelSARDecoderWithBS', d_model=16,
                          d_enc=16, d_k=8, pred_concat=True, beam_width=2),
             loss=dict(type='SARLoss'), max_seq_len=5),
        dict(type='RobustScanner', label_convertor=lc36, backbone=r31,
             encoder=dict(type='ChannelReductionEncoder', in_channels=16,
                          out_channels=8),
             decoder=dict(type='RobustScannerDecoder', dim_input=16,
                          dim_model=8),
             loss=dict(type='SARLoss'), max_seq_len=5)):
    rec = build_recognizer(family_cfg, device='cpu', param_dtype='float32')
    assert rec.resolved_decode_mode() == 'steps'
    rec.init_weights(0)
    assert len(rec.simple_test(np.zeros((3, 32, 64, 3), np.float32),
                               [1.0, 0.5, 0.8])) == 3
    opt, history = train.train_recognizer(
        rec, Crops(), dict(optimizer=dict(type='Adam', lr=1e-3),
                           samples_per_gpu=4, total_epochs=1,
                           log_interval=1))
    assert opt.count == 1 and np.isfinite(history[0]['loss_ce'])
# the transformer family on its other trunks: serving (steps and the
# whole decode's plain version) and a training step of a small SATRN and a
# small NRTR on the modality transform
from tps_pp_tpu_torch.models.backbones import misc
from tps_pp_tpu_torch.models.encoders import satrn as esatrn
tf_dims = dict(n_head=2, d_k=16, d_v=16, d_inner=32, dropout=0.1)
for family_cfg in (
        dict(type='SATRN', label_convertor=lc36,
             backbone=dict(type='ShallowCNN', input_channels=3,
                           hidden_dim=32),
             encoder=dict(type='SatrnEncoder', n_layers=1, d_model=32,
                          **tf_dims),
             decoder=dict(type='TFDecoder', n_layers=1, d_model=32,
                          d_embedding=32, **tf_dims),
             loss=dict(type='TFLoss'), max_seq_len=5),
        dict(type='NRTR', label_convertor=lc36,
             backbone=dict(type='NRTRModalityTransform'),
             encoder=dict(type='NRTREncoder', n_layers=1),
             decoder=dict(type='NRTRDecoder', n_layers=1),
             loss=dict(type='TFLoss'), max_seq_len=5)):
    for mode in ('steps', 'fused40_bf16'):
        rec = build_recognizer(dict(family_cfg, decode_mode=mode),
                               device='cpu', param_dtype='float32')
        assert rec.resolved_decode_mode() == mode
        rec.init_weights(0)
        assert len(rec.simple_test(np.zeros((3, 32, 64, 3), np.float32),
                                   [1.0, 0.5, 0.8])) == 3
    opt, history = train.train_recognizer(
        rec, Crops(), dict(optimizer=dict(type='Adam', lr=1e-3),
                           samples_per_gpu=4, total_epochs=1,
                           log_interval=1))
    assert opt.count == 1 and np.isfinite(history[0]['loss_ce'])
assert not dist.is_active()
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'launches': [w.launches for w in wrappers] + [
        full_decode.full_decode.launches_int8,
        tps_sampler.tps_sampler.launches_twostage],
    'library': _lib._lib is not None}))
'''


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'launches': [0] * 12, 'library': False}


SEG_PREPROC_SCRIPT = r'''
import importlib.abc, json, sys


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import SegRecognizer, build_recognizer
from tps_pp_tpu_torch.convertors import seg as cseg
from tps_pp_tpu_torch.datasets import ocr_seg_dataset
from tps_pp_tpu_torch.datasets.pipelines import ocr_seg_targets
from tps_pp_tpu_torch.models.recognizers import seg as rseg
from tps_pp_tpu_torch.models.rectifiers import moran, spin
from tps_pp_tpu_torch.ops import grid_sample
from tps_pp_tpu_torch.parallel import build_optimizer, make_train_step

lc = dict(type='SegConvertor', dict_type='DICT36', with_unknown=True,
          lower=True)
seg_cfg = dict(
    type='SegRecognizer', label_convertor=lc,
    backbone=dict(type='ResNet31OCR', layers=[1, 1, 1, 1],
                  channels=[8, 8, 8, 16, 16, 16], out_indices=[0, 1, 2, 3],
                  stage4_pool=(2, 2), last_stage_pool=True),
    neck=dict(type='FPNOCR', in_channels=[8, 16, 16, 16], out_channels=8),
    head=dict(type='SegHead', in_channels=8, upsample=2.0),
    loss=dict(type='SegLoss'))
targets = ocr_seg_targets.OCRSegTargets(label_convertor=lc)
kern = targets(dict(resize_shape=(32, 50), pad_shape=(32, 64),
                    pre_resize_shape=(20, 40), ann_info=dict(
                        chars=['a', 'b'], char_rects=[[2, 2, 18, 18],
                                                      [20, 3, 38, 19]],
                        char_quads=[])))['gt_seg']
rec = build_recognizer(seg_cfg, device='cpu', param_dtype='float32')
assert isinstance(rec, SegRecognizer)
rec.init_weights(0)
res = rec.simple_test(np.zeros((2, 32, 64, 3), np.float32), [1.0, 0.5])
assert len(res) == 2
opt, _ = build_optimizer(dict(type='Adam', lr=1e-3),
                         rec.model.named_parameters())
step = make_train_step(rec, opt)
seg_loss = float(step(dict(img=np.zeros((2, 32, 64, 3), np.float32),
                           gt_seg=np.stack([kern, kern])))['loss'])

crnn_cfg = dict(
    type='CRNNNet',
    label_convertor=dict(type='CTCConvertor', dict_type='DICT36',
                         with_unknown=False, lower=True),
    preprocessor=dict(type='MORAN', num_img_channel=1, img_size=(32, 64)),
    backbone=dict(type='VeryDeepVgg', leaky_relu=False, input_channels=1),
    decoder=dict(type='CRNNDecoder', in_channels=512, rnn_flag=True),
    loss=dict(type='CTCLoss'), max_seq_len=8)
abi_cfg = dict(
    type='ABINet', preprocessor=dict(type='SPIN'),
    label_convertor=dict(type='ABIConvertor', dict_type='DICT36',
                         with_unknown=False, lower=True),
    backbone=dict(type='ResNetABI', stem_channels=4, base_channels=4,
                  arch_settings=[1, 1, 1, 1, 1], strides=[2, 1, 2, 1, 1]),
    encoder=dict(type='ABIVisionModel',
                 encoder=dict(type='TransformerEncoder', n_layers=1,
                              n_head=2, d_model=64, d_inner=64,
                              max_len=128),
                 decoder=dict(type='ABIVisionDecoder', in_channels=64,
                              num_channels=16)),
    decoder=dict(type='ABILanguageDecoder', d_model=64, n_head=2,
                 d_inner=64, n_layers=1),
    fuser=dict(type='ABIFuser', d_model=64),
    loss=dict(type='ABILoss'), max_seq_len=8, iter_size=1)
losses = [seg_loss]
for cfg, c in ((crnn_cfg, 1), (abi_cfg, 3)):
    rec = build_recognizer(cfg, device='cpu', param_dtype='float32')
    rec.init_weights(0)
    x = np.random.default_rng(0).standard_normal((2, 32, 64, c)).astype(
        np.float32)
    assert len(rec.simple_test(x, [1.0, 0.5])) == 2
    td = rec.label_convertor.str2tensor(['ab', 'c'])
    opt, _ = build_optimizer(dict(type='Adam', lr=1e-3),
                             rec.model.named_parameters())
    losses.append(float(make_train_step(rec, opt)(dict(
        img=x, valid_ratio=np.ones(2, np.float32),
        padded_targets=td['padded_targets'],
        target_lengths=td['target_lengths']))['loss']))
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'finite': bool(np.isfinite(losses).all()),
    'launches': [grid_sample.grid_sample_forward.launches,
                 grid_sample.grid_sample_grad.launches,
                 grid_sample.grid_sample_grad_img.launches]}))
'''


def test_seg_and_preprocessors_serve_and_train_with_jax_blocked():
    """A small SegRecognizer (``OCRSegTargets`` kernels as its targets),
    CRNN + MORAN and ABINet + SPIN serve and take a training step on the
    CPU with jax, flax, cv2 and the JAX package refused at import; no
    kernel launches (CPU tensors take the plain versions)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', SEG_PREPROC_SCRIPT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'finite': True, 'launches': [0, 0, 0]}


SERVE_SCRIPT = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import bench_torch
from tps_pp_tpu_torch import config, datasets, evaluation
from tps_pp_tpu_torch.apis import (eval_recognizer, init_recognizer,
                                   model_inference, nrtr_tps_pp_cfg)
from tps_pp_tpu_torch.apis import inference, test
from tps_pp_tpu_torch.datasets import loader, ocr_dataset
from tps_pp_tpu_torch.datasets.pipelines import test_time_aug, transforms
from tps_pp_tpu_torch.evaluation import eval_ocr_metric, ocr_metric
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.utils import string_util

pipeline = [dict(type='LoadImageFromNdarray'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.5] * 3, std=[0.25] * 3),
            dict(type='Collect', keys=['img'])]


class ArrayDataset:
    """Decoded crops and their labels, through the test pipeline."""

    def __init__(self, imgs, texts):
        self.imgs, self.texts = imgs, texts
        self.pipeline = transforms.Compose(pipeline)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        info = dict(filename=None, text=self.texts[i])
        return self.pipeline(dict(img=self.imgs[i], img_info=info,
                                  text=self.texts[i]))

    def evaluate(self, results, metric='acc'):
        return eval_ocr_metric([r['text'] for r in results], self.texts)


rec = init_recognizer(dict(model=nrtr_tps_pp_cfg(tiny=True),
                           test_pipeline=pipeline), device='cpu')
g = np.random.default_rng(0)
imgs = [g.integers(0, 256, (int(g.integers(16, 48)), int(g.integers(24, 200)),
                            3), np.uint8) for _ in range(6)]
texts = ['ab', 'c', '12', 'xyz', '', 'q']
alone = model_inference(rec, imgs)
batched = model_inference(rec, imgs, batch_mode=True)
metrics = eval_recognizer(rec, ArrayDataset(imgs, texts), batch_size=4)
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'alone': [r['text'] for r in alone],
    'batched': [r['text'] for r in batched],
    'metrics': metrics,
    'expected': eval_ocr_metric([r['text'] for r in alone], texts)}))
'''


def test_serving_and_eval_entry_points_load_no_jax_or_cv2():
    """init_recognizer, model_inference on ndarrays and eval_recognizer
    on an in-memory dataset run on the CPU without JAX, flax, cv2 or the
    JAX package; the eval metrics are those of the texts."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', SERVE_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got['loaded'] == []
    assert len(got['alone']) == 6 and got['alone'] == got['batched']
    assert got['metrics'] == got['expected']


def test_bench_torch_without_a_gpu_fails_and_prints_no_result():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, 'bench_torch.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '{' not in out.stdout
    assert 'no CUDA device' in out.stderr


DET_SCRIPT = r'''
import importlib.abc, json, sys


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import (MMOCR, TextDetector, init_detector,
                                   nrtr_tps_pp_cfg)
from tps_pp_tpu_torch.apis import detector, ocr
from tps_pp_tpu_torch.datasets import textdet_dataset
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.evaluation import eval_hmean_iou, hmean_ic13, polygon
from tps_pp_tpu_torch.models.textdet import dbnet, pan, postprocess
from tps_pp_tpu_torch.ops import deform_conv, grid_sample, tps_sampler
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.utils import box_util

neck = dict(type='FPNC', lateral_channels=16, out_channels=4)
head = dict(type='DBHead', in_channels=16)
boxes = []
for backbone, ins in (
        (dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
              base_channels=8), [8, 16, 32, 64]),
        (dict(type='ResNetDet50', stage_blocks=[1, 1, 1, 1],
              base_channels=8, dcn=dict(type='DCNv2'),
              stage_with_dcn=[False, True, True, True]),
         [32, 64, 128, 256])):
    cfg = dict(type='DBNet', backbone=backbone,
               neck=dict(neck, in_channels=ins), head=head)
    det = init_detector(dict(model=cfg), img_size=(64, 96), device='cpu')
    imgs = [np.random.default_rng(i).integers(0, 256, (50 + i, 90, 3),
                                              np.uint8) for i in range(3)]
    boxes.append([len(b) for b in det.detect_batch(imgs)])
pipeline = [dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False), dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.5] * 3, std=[0.25] * 3),
            dict(type='Collect', keys=['img'])]
reader = MMOCR(det_config=dict(model=cfg), det_img_size=(64, 96),
               recog_config=dict(model=nrtr_tps_pp_cfg(tiny=True),
                                 test_pipeline=pipeline), device='cpu')
pages = reader.readtext(imgs[:2], merge=True)
gt = [np.array([[0, 0], [10, 0], [10, 8], [0, 8]], np.float32)]
pred = [np.array([1, 0, 10, 0, 10, 8, 1, 8, 0.9], np.float32)]
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'images': [len(b) for b in boxes], 'pages': len(pages),
    'hmean': [eval_hmean_iou([pred], [gt])['hmean'],
              hmean_ic13.eval_hmean_ic13([pred], [gt])['hmean']],
    'launches': [tps_sampler.tps_sampler.launches,
                 grid_sample.grid_sample_forward.launches]}))
'''


def test_detection_and_readtext_with_jax_blocked():
    """DBNet (R18 and R50-DCNv2, narrow) detects on the CPU, MMOCR reads
    pages with a tiny recognizer, and the hmean metrics score, with jax,
    flax, cv2 and the JAX package refused at import; nothing launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', DET_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'images': [3, 3], 'pages': 2,
                   'hmean': [1.0, 1.0], 'launches': [0, 0]}


DET_TRAIN_SCRIPT = r'''
import importlib.abc, json, sys


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.models.textdet import pixel_ops, targets
from tps_pp_tpu_torch.ops import grid_sample, tps_sampler


class Pages:
    def __init__(self, n):
        g = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            quads = [np.array([[x, y], [x + 20, y], [x + 20, y + 10],
                               [x, y + 10]], np.float32)
                     for x, y in g.uniform(2, 40, (3, 2))]
            self.items.append(dict(img=g.random((64, 64, 3)).astype(
                np.float32), gt_polygons=quads, gt_polygons_ignore=[]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


r18 = dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1], base_channels=8)
r50 = dict(type='ResNetDet50', stage_blocks=[1, 1, 1, 1], base_channels=8)
cfgs = [
    dict(type='DBNet', backbone=r18,
         neck=dict(type='FPNC', in_channels=[8, 16, 32, 64],
                   lateral_channels=16, out_channels=4),
         head=dict(type='DBHead', in_channels=16), loss=dict(type='DBLoss')),
    dict(type='PANet', backbone=r18,
         neck=dict(type='FPEM_FFM', in_channels=[8, 16, 32, 64],
                   conv_out=8),
         head=dict(type='PANHead', out_channels=6), loss=dict(type='PANLoss'),
         postprocessor=dict(type='PANPostprocessor', text_repr_type='poly')),
    dict(type='PSENet', backbone=r50,
         neck=dict(type='FPNF', in_channels=[32, 64, 128, 256],
                   out_channels=8),
         head=dict(type='PSEHead', out_channels=7), loss=dict(type='PSELoss'),
         postprocessor=dict(type='PSEPostprocessor', text_repr_type='quad'))]
losses, boxes = [], []
for cfg in cfgs:
    _, opt, hist = train_detector(dict(model=cfg, total_epochs=1), Pages(3),
                                  batch_size=2, device='cpu')
    losses.append(hist[-1]['loss'])
    det = init_detector(dict(model=cfg), img_size=(64, 96), device='cpu')
    imgs = [np.random.default_rng(i).integers(0, 256, (50 + i, 90, 3),
                                              np.uint8) for i in range(3)]
    boxes.append(len(det.detect_batch(imgs)))
reader = MMOCR(det_config=dict(model=cfgs[1]), det_img_size=(64, 96),
               recog=None, device='cpu')
pages = reader.readtext(imgs[:2])
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'finite': bool(np.isfinite(losses).all()), 'images': boxes,
    'pages': len(pages),
    'launches': [tps_sampler.tps_sampler.launches,
                 grid_sample.grid_sample_forward.launches]}))
'''


def test_detection_training_and_pan_pse_serving_with_jax_blocked():
    """train_detector (DBNet, PANet, PSENet, narrow, their targets made on
    the host), PAN and PSE detection and MMOCR with a PANet detector run
    on the CPU with jax, flax, cv2 and the JAX package refused at import;
    nothing launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', DET_TRAIN_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'finite': True, 'images': [3, 3, 3],
                   'pages': 2, 'launches': [0, 0]}


FCE_TEXTSNAKE_SCRIPT = r'''
import importlib.abc, json, sys


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.models.textdet import postprocess, targets
from tps_pp_tpu_torch.ops import grid_sample, tps_sampler


class Pages:
    def __init__(self, n):
        g = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            quads = [np.array([[x, y], [x + 20, y], [x + 20, y + 10],
                               [x, y + 10]], np.float32)
                     for x, y in g.uniform(2, 40, (3, 2))]
            self.items.append(dict(img=g.random((64, 64, 3)).astype(
                np.float32), gt_polygons=quads, gt_polygons_ignore=[]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


r50 = dict(type='ResNetDet50', stage_blocks=[1, 1, 1, 1], base_channels=8)
cfgs = [
    dict(type='FCENet', backbone=r50,
         neck=dict(type='FPNDet', in_channels=[64, 128, 256],
                   out_channels=8),
         head=dict(type='FCEHead', in_channels=8), loss=dict(type='FCELoss'),
         postprocessor=dict(type='FCEPostprocessor', score_thr=0.36)),
    dict(type='TextSnake', backbone=r50,
         neck=dict(type='FPN_UNet', in_channels=[32, 64, 128, 256],
                   out_channels=4),
         head=dict(type='TextSnakeHead'), loss=dict(type='TextSnakeLoss'),
         postprocessor=dict(type='TextSnakePostprocessor'))]
losses, images = [], []
for cfg in cfgs:
    _, opt, hist = train_detector(dict(model=cfg, total_epochs=1), Pages(3),
                                  batch_size=2, device='cpu')
    losses.append(hist[-1]['loss'])
    det = init_detector(dict(model=cfg), img_size=(64, 96), device='cpu')
    imgs = [np.random.default_rng(i).integers(0, 256, (50 + i, 90, 3),
                                              np.uint8) for i in range(3)]
    images.append(len(det.detect_batch(imgs)))
# the TextSnake postprocessor on maps drawn from its own targets
t = targets.TextSnakeTargets().generate(Pages(1)[0]['gt_polygons'], [],
                                        64, 64)
maps = np.stack([(2 * t['gt_text_mask'] - 1) * 4,
                 (2 * t['gt_center_region_mask'] - 1) * 4, t['gt_sin_map'],
                 t['gt_cos_map'], t['gt_radius_map']], -1)
reader = MMOCR(det_config=dict(model=cfgs[0]), det_img_size=(64, 96),
               recog=None, device='cpu')
pages = reader.readtext(imgs[:2])
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'finite': bool(np.isfinite(losses).all()), 'images': images,
    'snakes': len(postprocess.TextSnakePostprocessor()(maps)) > 0,
    'pages': len(pages),
    'launches': [tps_sampler.tps_sampler.launches,
                 grid_sample.grid_sample_forward.launches]}))
'''


def test_fce_textsnake_training_and_serving_with_jax_blocked():
    """train_detector (FCENet and TextSnake, narrow, their targets made on
    the host), their detection, the TextSnake postprocessor on maps of its
    targets and MMOCR with an FCENet detector run on the CPU with jax,
    flax, cv2 and the JAX package refused at import; nothing launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', FCE_TEXTSNAKE_SCRIPT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'finite': True, 'images': [3, 3],
                   'snakes': True, 'pages': 2, 'launches': [0, 0]}


DRRG_SCRIPT = r'''
import importlib.abc, json, os, sys, tempfile


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.models.textdet import drrg, targets
from tps_pp_tpu_torch.ops import grid_sample, tps_sampler


class Pages:
    def __init__(self, n):
        g = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            quads = [np.array([[x, y], [x + 30, y], [x + 30, y + 12],
                               [x, y + 12]], np.float32)
                     for x, y in g.uniform(2, 30, (2, 2))]
            self.items.append(dict(img=g.random((64, 64, 3)).astype(
                np.float32), gt_polygons=quads, gt_polygons_ignore=[]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


cfg = dict(type='DRRG',
           backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                         base_channels=8),
           neck=dict(type='FPN_UNet', in_channels=[8, 16, 32, 64],
                     out_channels=8))
_, opt, hist = train_detector(dict(model=cfg, total_epochs=1), Pages(2),
                              device='cpu')
det = init_detector(dict(model=cfg), img_size=(64, 96), device='cpu')
imgs = [np.random.default_rng(i).integers(0, 256, (50 + i, 90, 3),
                                          np.uint8) for i in range(3)]
images = len(det.detect_batch(imgs))
# the detector on maps drawn from DRRG's own targets, the GCN's link bias
# raised
quads = [np.array([[8, y], [120, y], [120, y + 14], [8, y + 14]],
                  np.float32) for y in (10, 80)]
t = targets.DRRGTargets(seed=0).generate(quads, [], 110, 128)
maps = np.stack([(2 * t['gt_text_mask'] - 1) * 8,
                 (2 * t['gt_center_region_mask'] - 1) * 8, t['gt_sin_map'],
                 t['gt_cos_map'], t['gt_top_height_map'],
                 t['gt_bot_height_map']], -1)
with torch.no_grad():
    det.model.head.gcn.classifier[2].bias[1] += 8
feat = np.concatenate([np.zeros((110, 128, 8), np.float32), maps], -1)
words = len(det.postprocessor(feat.astype(np.float32)))
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'drrg.py')
    with open(path, 'w') as f:
        f.write(f'model = {cfg!r}\n')
    reader = MMOCR(det=path, det_img_size=(64, 96), recog=None,
                   device='cpu')
    pages = reader.readtext(imgs[:2])
# and every module of the port imports with the JAX side refused
import importlib, pkgutil, tps_pp_tpu_torch
unimportable = []
for m in pkgutil.walk_packages(tps_pp_tpu_torch.__path__,
                               'tps_pp_tpu_torch.'):
    try:
        importlib.import_module(m.name)
    except ImportError as e:
        unimportable.append(f'{m.name}: {e}')
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'finite': bool(np.isfinite(hist[-1]['loss'])), 'steps': opt.count,
    'images': images, 'words': words, 'pages': len(pages),
    'unimportable': unimportable,
    'launches': [tps_sampler.tps_sampler.launches,
                 grid_sample.grid_sample_forward.launches]}))
'''


def test_drrg_training_and_serving_with_jax_blocked():
    """DRRG's train_detector (narrow, its targets made on the host, one
    page a step), its detection, the detector on maps of its targets with
    the link bias raised (one boundary a word) and MMOCR with a DRRG
    config path run on the CPU with jax, flax, cv2 and the JAX package
    refused at import, and every module of the port imports so; nothing
    launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', DRRG_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'finite': True, 'steps': 2, 'images': 3,
                   'words': 2, 'pages': 2, 'unimportable': [],
                   'launches': [0, 0]}


MASKRCNN_SCRIPT = r'''
import importlib.abc, json, os, sys, tempfile


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import MMOCR, init_detector
from tps_pp_tpu_torch.apis.train_det import train_detector
from tps_pp_tpu_torch.ops import grid_sample, tps_sampler


class Pages:
    def __init__(self, n):
        g = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            quads = [np.array([[x, y], [x + 30, y], [x + 30, y + 12],
                               [x, y + 12]], np.float32)
                     for x, y in g.uniform(2, 30, (2, 2))]
            self.items.append(dict(img=g.random((64, 64, 3)).astype(
                np.float32), gt_polygons=quads, gt_polygons_ignore=[]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


cfg = dict(type='OCRMaskRCNN',
           backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                         base_channels=8),
           neck=dict(type='FPNDet', in_channels=[8, 16, 32, 64],
                     out_channels=16),
           rpn_head=dict(type='RPNHead', feat_channels=16),
           box_head=dict(fc_out=64), mask_head=dict(channels=16),
           num_train_rois=16)
with tempfile.TemporaryDirectory() as d:
    _, opt, hist = train_detector(dict(model=cfg, total_epochs=1), Pages(2),
                                  work_dir=d, device='cpu')
    saved = sorted(os.listdir(d))
det = init_detector(dict(model=cfg), img_size=(64, 96), device='cpu')
imgs = [np.random.default_rng(i).integers(0, 256, (50 + i, 90, 3),
                                          np.uint8) for i in range(3)]
found = det.detect_batch(imgs)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'maskrcnn.py')
    with open(path, 'w') as f:
        f.write(f'model = {cfg!r}\n')
    reader = MMOCR(det=path, det_img_size=(64, 96), recog=None,
                   device='cpu')
    pages = reader.readtext(imgs[:2])
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'finite': bool(np.isfinite(hist[-1]['loss'])), 'steps': opt.count,
    'saved': saved, 'images': len(found),
    'boundaries': all(np.isfinite(b).all() and b.size % 2 == 1
                      for page in found for b in page),
    'pages': len(pages),
    'launches': [tps_sampler.tps_sampler.launches,
                 grid_sample.grid_sample_forward.launches]}))
'''


def test_maskrcnn_training_and_serving_with_jax_blocked():
    """Mask R-CNN's train_detector (narrow, one page a step, its
    checkpoint), its batched detection and MMOCR with a Mask R-CNN config
    path run on the CPU with jax, flax, cv2 and the JAX package refused at
    import; nothing launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', MASKRCNN_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'finite': True, 'steps': 2,
                   'saved': ['epoch_1.pth'], 'images': 3,
                   'boundaries': True, 'pages': 2, 'launches': [0, 0]}


KIE_NER_SCRIPT = r'''
import importlib.abc, json, os, sys, tempfile


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import MMOCR, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.apis.train_kie import (build_sdmgr_apply, train_kie,
                                             train_ner)
from tps_pp_tpu_torch.datasets import KIEDataset, NerDataset
from tps_pp_tpu_torch.ops import grid_sample, tps_sampler
from tps_pp_tpu_torch.tools import test as test_tool
from tps_pp_tpu_torch.tools import train as train_tool

g = np.random.default_rng(0)
d = tempfile.mkdtemp()
ann = os.path.join(d, 'receipts.jsonl')
with open(ann, 'w') as f:
    for i in range(3):
        f.write(json.dumps({'file_name': f'{i}.png', 'height': 40,
                            'width': 48, 'annotations': [
            {'box': [2, 9 * j, 30, 9 * j, 30, 9 * j + 7, 2, 9 * j + 7],
             'text': f'item{j}', 'label': j % 2} for j in range(3)]}) + '\n')
ner = os.path.join(d, 'ner.jsonl')
with open(ner, 'w') as f:
    for i in range(3):
        f.write(json.dumps({'text': f'alice in paris {i}', 'label': {
            'name': {'alice': [[0, 4]]}}}) + '\n')
images = {f'{i}.png': g.integers(0, 256, (40, 48, 3), np.uint8)
          for i in range(3)}
kie = KIEDataset(ann, max_nodes=4, max_chars=8, with_visual=True,
                 img_size=(32, 32), images=images)
cfg = dict(model=dict(type='SDMGR', visual_modality=True,
                      backbone=dict(type='UNet', base_channels=4,
                                    num_stages=3),
                      head=dict(type='SDMGRHead', node_embed=16,
                                edge_embed=16, fusion_dim=32, visual_dim=4,
                                num_classes=3)))
with tempfile.TemporaryDirectory() as wd:
    model, opt, kie_hist = train_kie(cfg, kie, work_dir=wd, batch_size=2,
                                     device='cpu')
    apply, m, visual = build_sdmgr_apply(
        cfg, os.path.join(wd, 'epoch_1.pth'), kie[0], device='cpu')
    node, edge = apply(m, kie[0])
ner_cfg = dict(model=dict(type='NerClassifier', encoder=dict(
    type='BertEncoder', vocab_size=20200, hidden_size=16,
    num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
    max_position_embeddings=32), decoder=dict(type='FCDecoder',
                                              num_labels=3)))
_, ner_opt, ner_hist = train_ner(ner_cfg, NerDataset(ner, ['name'],
                                                     max_len=24),
                                 batch_size=2, device='cpu')
kie_path = 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py'
opts = ['data.train.ann_file=' + ann, 'data.test.ann_file=' + ann,
        'data.train.dict_file=', 'data.test.dict_file=',
        'data.train.with_visual=False', 'data.test.with_visual=False',
        'model.head.node_embed=16', 'model.head.edge_embed=16',
        'total_epochs=1']
with tempfile.TemporaryDirectory() as wd:
    train_tool.main([kie_path, '--work-dir', wd, '--cfg-options'] + opts,
                    device='cpu')
    metrics = test_tool.main([kie_path, os.path.join(wd, 'epoch_1.pth'),
                              '--cfg-options'] + opts, device='cpu')
det_cfg = dict(type='DBNet',
               backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                             base_channels=8),
               neck=dict(type='FPNC', in_channels=[8, 16, 32, 64],
                         lateral_channels=16, out_channels=4),
               head=dict(type='DBHead', in_channels=16, k=50))
pipeline = [dict(type='LoadImageFromNdarray'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.5] * 3, std=[0.25] * 3),
            dict(type='Collect', keys=['img'])]
reader = MMOCR(det='DBNet', det_config=dict(model=det_cfg),
               recog='NRTR_TPS', recog_config=dict(
                   model=nrtr_tps_pp_cfg(tiny=True), test_pipeline=pipeline),
               det_img_size=(64, 64), kie='SDMGR', device='cpu')
pages = reader.readtext([g.integers(0, 256, (64, 64, 3), np.uint8)])
boxes = reader.kie_infer([{'box': [0, 10 * i, 20, 10 * i, 20, 10 * i + 8,
                                   0, 10 * i + 8], 'text': 'ab'}
                          for i in range(3)])
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'finite': bool(np.isfinite([kie_hist[-1]['loss'],
                                ner_hist[-1]['loss']]).all()),
    'steps': [opt.count, ner_opt.count], 'visual': visual,
    'logits': [list(node.shape), list(edge.shape)],
    'metrics': sorted(metrics), 'pages': len(pages),
    'labelled': all('label' in b and 'label_score' in b for b in boxes),
    'launches': [tps_sampler.tps_sampler.launches,
                 grid_sample.grid_sample_forward.launches]}))
'''


def test_kie_and_ner_train_and_serve_with_jax_blocked():
    """SDMGR with the UNet (images given as arrays) and BERT-softmax NER
    train on the CPU, the KIE CLIs run on the shipped UNet16 config and
    MMOCR labels boxes with ``kie='SDMGR'``, with jax, flax, cv2 and the
    JAX package refused at import; nothing launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', KIE_NER_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'finite': True, 'steps': [2, 2],
                   'visual': True, 'logits': [[4, 3], [16, 2]],
                   'metrics': ['macro_f1'], 'pages': 1, 'labelled': True,
                   'launches': [0, 0]}


DEPLOY_SCRIPT = r'''
import importlib.abc, json, os, sys, tempfile, threading, urllib.request


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.ops import encoder, full_decode, tps_sampler
from tps_pp_tpu_torch.tools import (det_test_imgs, export_model,
                                    kie_test_imgs, recog_test_imgs,
                                    serve_model)
from tps_pp_tpu_torch.utils import export, fileio, visualize

rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True, decode_mode='fused40_bf16'),
                       device='cpu').init_weights(0)
img = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (2, 32, 64, 3)).astype(np.float32))
ep = export.load_serialized(export.export_serialized(rec, 2, (32, 64, 3)))
with torch.no_grad():
    out = ep.module()(img, torch.ones(2))
same = bool(torch.equal(out, rec.predict(img, bucket_batch=False)))
aot = export.aot_compile(rec, 2, (32, 64, 3))
same_aot = bool(torch.equal(aot(img, torch.ones(2)), out))
crop = np.random.default_rng(1).integers(0, 256, (20, 50, 3), np.uint8)
png = cv_ops.png_encode(crop)
decoded = bool(np.array_equal(serve_model.decode_image(png), crop))
jpeg_without_cv2 = serve_model.decode_image(b'\xff\xd8\xff\xe0 not png')
with tempfile.TemporaryDirectory() as wd:
    cfg = os.path.join(wd, 'cfg.py')
    with open(cfg, 'w') as f:
        f.write(f'model = {nrtr_tps_pp_cfg(tiny=True)!r}\n'
                'test_pipeline = [dict(type="ResizeOCR", height=32, '
                'min_width=64, max_width=64, keep_aspect_ratio=False), '
                'dict(type="ToTensorOCR"), dict(type="NormalizeOCR", '
                'mean=[0.5] * 3, std=[0.25] * 3), '
                'dict(type="Collect", keys=["img"])]\n')
    server = serve_model.make_server([cfg, '--port', '0', '--device', 'cpu'])
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    req = urllib.request.Request(base + '/predictions/ocr', data=png,
                                 method='POST')
    served = json.loads(urllib.request.urlopen(req, timeout=60).read())
    server.shutdown()
    server.server_close()
    server.model.close()
    t.join(timeout=30)
    fileio.list_to_file(os.path.join(wd, 'a', 'l.txt'), ['x y', 'z'])
    lines = fileio.list_from_file(os.path.join(wd, 'a', 'l.txt'))
try:
    visualize.imshow_text_label(crop, 'a')
    drew = True
except ImportError as e:
    drew = str(e)
env = fileio.collect_env()
print(json.dumps({
    'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'tps_pp_tpu')
                     if m in sys.modules),
    'same': [same, same_aot], 'decoded': decoded,
    'jpeg': jpeg_without_cv2 is None, 'served': sorted(served),
    'lines': lines, 'drew': 'cv2 is not installed' in drew,
    'env': [env['cv2'], env['cuda.is_available']],
    'launches': [tps_sampler.tps_sampler.launches,
                 encoder.encoder_forward.launches,
                 full_decode.full_decode.launches]}))
'''


def test_deployment_with_jax_and_cv2_blocked():
    """The deployment slice on the CPU with jax, flax, cv2 and the JAX
    package refused at import: export, load and run, the CPU
    ``aot_compile``, the server answering a PNG body (decoded without cv2;
    a JPEG body gets None), ``fileio``, ``collect_env``; drawing raises the
    ImportError that names cv2; nothing launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', DEPLOY_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'same': [True, True], 'decoded': True,
                   'jpeg': True, 'served': ['score', 'text'],
                   'lines': ['x y', 'z'], 'drew': True,
                   'env': ['missing', False], 'launches': [0, 0, 0]}


TOOLS_SCRIPT = r'''
import importlib.abc, json, os, sys, tempfile


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2 and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import contextlib, io
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.datasets import OCRDataset
from tps_pp_tpu_torch.datasets.pipelines.cv_ops import png_decode, png_encode
from tps_pp_tpu_torch.tools import (benchmark_processing, convert_checkpoint,
                                    publish_model)
from tps_pp_tpu_torch.tools.data import (closeset_to_openset, lmdb_converter,
                                         pack_converter, textdet_converter,
                                         textrecog_converter)
from tps_pp_tpu_torch.tools.misc import print_config
from tps_pp_tpu_torch.utils import export, profiling
from tps_pp_tpu_torch.utils.packed import PackedReader

out = {}
quiet = contextlib.redirect_stdout(io.StringIO())
with tempfile.TemporaryDirectory() as d, quiet:
    crop = np.random.default_rng(0).integers(0, 256, (20, 40, 3), np.uint8)
    with open(os.path.join(d, 'a.png'), 'wb') as f:
        f.write(png_encode(crop))
    txt = os.path.join(d, 'label.txt')
    with open(txt, 'w') as f:
        f.write('a.png hello\na.png world\n')
    pack = os.path.join(d, 'label.pack')
    out['packed'] = pack_converter.main([txt, pack])
    out['records'] = [PackedReader(pack)[i].decode() for i in range(2)]
    try:
        lmdb_converter.main(['txt2lmdb', txt, os.path.join(d, 'x.lmdb')])
        out['lmdb'] = 'ran'
    except ImportError as e:
        out['lmdb'] = 'pack_converter' in str(e)

    def load(results):
        path = os.path.join(results['img_prefix'],
                            results['img_info']['filename'])
        results['img'] = png_decode(open(path, 'rb').read())
        return results
    ds = OCRDataset(ann_file=pack, img_prefix=d, test_mode=True,
                    loader=dict(type='PackedLoader',
                                parser=dict(type='LineStrParser')),
                    pipeline=[load])
    out['dataset'] = [bool(np.array_equal(ds[i]['img'], crop)) and
                      ds[i]['text'] for i in range(2)]
    jl = os.path.join(d, 'a.jsonl')
    with open(jl, 'w') as f:
        f.write('{"filename": "a.png", "text": "x"}\n')
    out['jsonl'] = textrecog_converter.main(
        ['jsonl', jl, d, os.path.join(d, 'r'), '--pack'])
    svt = os.path.join(d, 'svt.xml')
    with open(svt, 'w') as f:
        f.write('<tagset><image><imageName>a.png</imageName>'
                '<taggedRectangles><taggedRectangle x="1" y="1" width="9" '
                'height="9"><tag>HI</tag></taggedRectangle>'
                '</taggedRectangles></image></tagset>')
    try:
        textrecog_converter.main(['svt', svt, d, os.path.join(d, 's')])
        out['svt'] = 'ran'
    except ImportError as e:
        out['svt'] = 'cv2' in str(e)
    coco = os.path.join(d, 'coco.json')
    with open(coco, 'w') as f:
        json.dump({'images': [{'id': 1, 'file_name': 'a.png'}],
                   'annotations': [{'image_id': 1, 'segmentation': [
                       [0, 0, 4, 0, 4, 4, 0, 4]]}]}, f)
    out['det'] = len(textdet_converter.main(
        ['coco', coco, d, os.path.join(d, 'det.jsonl')]))
    close = os.path.join(d, 'close.txt')
    with open(close, 'w') as f:
        f.write(json.dumps({'file_name': 'a', 'height': 1, 'width': 1,
                            'annotations': [{'label': 1}, {'label': 2}]})
                + '\n')
    out['openset'] = closeset_to_openset.main(
        [close, os.path.join(d, 'open.txt')])
    out['config'] = "'type': 'NRTR'" in print_config.main(
        ['configs/textrecog/nrtr/nrtr_tps++.py'])
    with profiling.trace(os.path.join(d, 'tr')) as path:
        torch.ones(8) @ torch.ones(8)
    out['trace'] = os.path.isfile(path)
    cfg = dict(nrtr_tps_pp_cfg(tiny=True), decode_mode='steps')
    cfg['decoder'] = dict(cfg['decoder'], use_fused_step=True)
    rec = build_recognizer(cfg, device='cpu').init_weights(0)
    img = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 64, 3)).astype(np.float32))
    ep = export.load_serialized(export.export_serialized(rec, 2,
                                                         (32, 64, 3)))
    with torch.no_grad():
        same = torch.equal(ep.module()(img, torch.ones(2)),
                           rec.predict(img, bucket_batch=False))
    out['steps_exit_export'] = bool(same)
print(json.dumps({'loaded': sorted(m for m in ('jax', 'flax', 'cv2',
                                               'tps_pp_tpu')
                                   if m in sys.modules), **out}))
'''


def test_data_tools_and_steps_export_with_jax_and_cv2_blocked():
    """The TPSPACK1 format, ``PackedLoader``, the data and config CLIs,
    ``profiling.trace`` and the export of greedy ``steps`` with its early
    exit on the CPU with jax, flax, cv2 and the JAX package refused at
    import: the LMDB branch raises the ImportError that names
    ``pack_converter``, a JPEG crop the one that names cv2."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', TOOLS_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'packed': 2,
                   'records': ['a.png hello', 'a.png world'], 'lmdb': True,
                   'dataset': ['hello', 'world'], 'jsonl': ['a.png x'],
                   'svt': True, 'det': 1, 'openset': 1, 'config': True,
                   'trace': True, 'steps_exit_export': True}


MESH_SCRIPT = r'''
import importlib.abc, json, os, sys


class Blocked(importlib.abc.MetaPathFinder):
    """Refuses jax, flax, cv2, PIL and the JAX package outright."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'PIL',
                                  'tps_pp_tpu'):
            raise ImportError(f'{name} is blocked')
        return None


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
torch.set_num_threads(1)
from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
from tps_pp_tpu_torch.convertors import mask
from tps_pp_tpu_torch.datasets import seeded_rngs
from tps_pp_tpu_torch.datasets.pipelines import Compose, extras, tps_aug
from tps_pp_tpu_torch.losses import kd
from tps_pp_tpu_torch.models.decoders import tf_common
from tps_pp_tpu_torch.parallel import create_mesh, mesh, tp
from tps_pp_tpu_torch.tools import compare_activations
from tps_pp_tpu_torch.utils import synth_text

out = {}
rec = build_recognizer(nrtr_tps_pp_cfg(tiny=True, decode_mode='steps'),
                       device='cpu').init_weights(0)
img = np.random.default_rng(0).standard_normal((6, 32, 64, 3)).astype(
    np.float32)
m = create_mesh(data=4, devices=['cpu'] * 4)
out['mesh'] = bool(torch.allclose(rec.predict(img, mesh=m), rec.predict(img),
                                  atol=2e-5))
pipe = Compose([dict(type='OpencvToPil'),
                dict(type='RandomRotateImageBox', max_angle=20),
                dict(type='PilToOpencv'), dict(type='Stretch', prob=1.0),
                dict(type='Distort', prob=1.0), dict(type='Curve', prob=1.0),
                dict(type='FancyPCA'), dict(type='RandomPaddingOCR')])
crop = np.random.default_rng(1).integers(0, 256, (32, 100, 3), np.uint8)
res = pipe(dict(img=crop, ann_info=dict(chars=['a'], char_quads=[
    [10, 10, 20, 10, 20, 20, 10, 20]]), **seeded_rngs(3)))
out['augment'] = list(res['img'].shape[2:])
out['kd'] = bool(torch.isfinite(kd.kd_loss(torch.ones(2, 2, 2, 3),
                                           torch.rand(2, 2, 2, 3))))
try:
    synth_text.render_dataset(2)
except ImportError as e:
    out['synth_text'] = 'cv2' in str(e)
print(json.dumps({'loaded': sorted(m for m in ('jax', 'flax', 'cv2', 'PIL',
                                               'tps_pp_tpu')
                                   if m in sys.modules), **out}))
'''


def test_mesh_and_training_extras_with_jax_cv2_and_pil_blocked():
    """The mesh, tensor parallelism, the TPS and extra augmentations, the
    KD loss, the mask convertors, TFCommonDecoder, ``synth_text`` and
    ``compare_activations`` import with jax, flax, cv2, PIL and the JAX
    package refused; ``predict(mesh=)`` and the augmentations run;
    ``render_dataset`` raises the ImportError of cv2 only when called."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', MESH_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'loaded': [], 'mesh': True, 'augment': [3], 'kd': True,
                   'synth_text': True}
