"""The port's server (``tps_pp_tpu_torch/tools/serve_model.py``) beside the
JAX package's (``tools/deployment/serve_model.py``) on the same weights,
and the PNG codec it decodes bodies with (``cv_ops.png_decode`` /
``png_encode``) against cv2.

* ``_Model`` of the tiny flagship (one ``.pth`` both load) behind each
  server: PNG and JPEG bodies, raw and base64, give the same text and a
  score within 1e-5; ``/ping``, a body that does not decode (400), a wrong
  path (404) as JAX's; with ``--det`` (a narrow DBNet, its JAX variables
  as ``.npz`` for JAX and ``.pth`` for the port) the boundaries within
  1e-3 (score 1e-6), as ``tests/test_torch_ocr.py`` holds ``readtext``.
* ``make_server`` / the CLI's arguments on the CPU; the model's worker
  thread answers requests from many threads at once, one at a time, and
  stops with ``close``.
* ``png_decode`` bit for bit against ``cv2.imdecode`` with
  ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE`` over colour types 0, 2, 3, 4
  and 6 with every row filter, and over cv2's own PNGs; ``png_encode``'s
  grey, BGR and BGRA read back by cv2 unchanged; the PNGs it does not take
  raise, naming cv2.
"""
import base64
import importlib.util
import json
import os
import struct
import threading
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import cv2
import jax
import numpy as np
import pytest
import torch
from torch_port_util import jax_flagship, perturb_batch_stats

from tps_pp_tpu.utils.checkpoint import save_variables

from tps_pp_tpu_torch.datasets.pipelines import cv_ops
from tps_pp_tpu_torch.tools import serve_model
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)
PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.485, 0.456, 0.406],
                 std=[0.229, 0.224, 0.225]),
            dict(type='Collect', keys=['img'])]
DET_CFG = dict(
    type='DBNet',
    backbone=dict(type='ResNetDet', stage_blocks=[1, 1, 1, 1],
                  base_channels=8),
    neck=dict(type='FPNC', in_channels=[8, 16, 32, 64], lateral_channels=16,
              out_channels=4),
    head=dict(type='DBHead', in_channels=16, k=50),
    postprocessor=dict(type='DBPostprocessor', text_repr_type='quad'))


def jax_serve_module():
    spec = importlib.util.spec_from_file_location(
        'jax_serve_model', os.path.join(REPO, 'tools', 'deployment',
                                        'serve_model.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Served:
    """A handler factory's server on a free port, in a thread."""

    def __init__(self, make_handler, model, name='ocr'):
        self.model = model
        self.server = ThreadingHTTPServer(('127.0.0.1', 0),
                                          make_handler(model, name))
        self.base = f'http://127.0.0.1:{self.server.server_address[1]}'
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def get(self, path):
        try:
            r = urllib.request.urlopen(self.base + path, timeout=120)
            return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post(self, path, body):
        req = urllib.request.Request(self.base + path, data=body,
                                     method='POST')
        try:
            r = urllib.request.urlopen(req, timeout=120)
            return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        if hasattr(self.model, 'close'):      # the port's: its worker
            self.model.close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope='module')
def recog_servers(tmp_path_factory):
    _, rv, rcfg = jax_flagship(tiny=True, seed=2)
    pth = str(tmp_path_factory.mktemp('rec') / 'tiny.pth')
    torch.save({'state_dict': state_dict_from_jax(rv, rcfg)}, pth)
    cfg = dict(model=rcfg, test_pipeline=PIPELINE, input_shape=(32, 64, 3))
    jsm = jax_serve_module()
    servers = (Served(jsm.make_handler, jsm._Model(cfg, pth)),
               Served(serve_model.make_handler,
                      serve_model._Model(cfg, pth, device='cpu')))
    yield servers
    for s in servers:
        s.close()


def crops(n=4, seed=0):
    g = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = np.full((32, 100, 3), 255, np.uint8)
        img[:, :, :] = g.integers(150, 256, 3, np.uint8)
        cv2.putText(img, 'ab%d' % i, (5, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                    tuple(int(c) for c in g.integers(0, 90, 3)), 2)
        out.append(img)
    return out


@pytest.mark.parametrize('fmt', ['png', 'jpeg'])
@pytest.mark.parametrize('b64', [False, True])
def test_predictions_match_jax(recog_servers, fmt, b64):
    jserve, serve = recog_servers
    for img in crops(seed=int(b64)):
        raw = (cv_ops.png_encode(img) if fmt == 'png'
               else cv2.imencode('.jpg', img)[1].tobytes())
        body = base64.b64encode(raw) if b64 else raw
        code, got = serve.post('/predictions/ocr', body)
        jcode, want = jserve.post('/predictions/ocr', body)
        assert code == jcode == 200
        assert set(got) == set(want) == {'text', 'score'}
        assert got['text'] == want['text']
        assert abs(got['score'] - want['score']) <= 1e-5


def test_ping_bad_body_and_bad_path_match_jax(recog_servers):
    jserve, serve = recog_servers
    raw = cv_ops.png_encode(crops(1)[0])
    for s in (jserve, serve):
        assert s.get('/ping') == (200, {'status': 'Healthy'})
        code, err = s.get('/nope')
        assert code == 404 and 'error' in err
        code, err = s.post('/predictions/ocr', b'garbage\x00')
        assert code == 400 and 'error' in err
        code, err = s.post('/predictions/ocr', b'')
        assert code == 400
        code, err = s.post('/predictions/nope', raw)
        assert code == 404 and 'error' in err


def test_det_mode_matches_jax(tmp_path):
    from tps_pp_tpu.apis.detector import init_detector as jax_init_detector
    jdet = jax_init_detector(dict(model=DET_CFG))
    v = jax.tree.map(np.asarray, perturb_batch_stats(jdet.variables, 0))
    up2 = v['params']['head']['binarize']['up2']
    up2['kernel'] = up2['kernel'] * 6
    up2['bias'] = np.full((1,), -0.6, np.float32)
    npz, pth = str(tmp_path / 'det.npz'), str(tmp_path / 'det.pth')
    save_variables(npz, v)
    torch.save({'state_dict': state_dict_from_jax(v, DET_CFG)}, pth)
    jsm = jax_serve_module()
    cfg = dict(model=DET_CFG)
    jserve = Served(jsm.make_handler, jsm._Model(cfg, npz, det=True))
    serve = Served(serve_model.make_handler,
                   serve_model._Model(cfg, pth, det=True, device='cpu'))
    try:
        page = np.random.default_rng(0).integers(0, 256, (96, 128, 3),
                                                 np.uint8)
        body = cv_ops.png_encode(page)
        code, got = serve.post('/predictions/ocr', body)
        jcode, want = jserve.post('/predictions/ocr', body)
        assert code == jcode == 200
        got, want = got['boundary_result'], want['boundary_result']
        assert len(got) == len(want) >= 5
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[:-1], b[:-1], atol=1e-3)
            assert abs(a[-1] - b[-1]) <= 1e-6
    finally:
        jserve.close()
        serve.close()


def test_make_server_from_the_command_line(tmp_path):
    _, rv, rcfg = jax_flagship(tiny=True, seed=2)
    cfg_path = tmp_path / 'tiny_cfg.py'
    cfg_path.write_text(f'model = {rcfg!r}\ntest_pipeline = {PIPELINE!r}\n')
    server = serve_model.make_server([str(cfg_path), '--port', '0',
                                      '--name', 'rec', '--device', 'cpu'])
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f'http://127.0.0.1:{server.server_address[1]}'
        req = urllib.request.Request(
            base + '/predictions/rec', method='POST',
            data=cv_ops.png_encode(crops(1)[0]))
        out = json.loads(urllib.request.urlopen(req, timeout=120).read())
        want = server.model.predict(crops(1)[0])
        assert out == json.loads(json.dumps(want))
    finally:
        server.shutdown()
        server.server_close()
        server.model.close()
        t.join(timeout=30)
    assert not t.is_alive()
    assert not server.model.worker._threads or not any(
        th.is_alive() for th in server.model.worker._threads)


def test_the_model_worker_serialises_concurrent_requests():
    """32 client threads (more than the cores) post at once with a short
    switch interval: each gets its own image's answer, and the model never
    runs two images at a time."""
    import sys
    import time
    from concurrent.futures import ThreadPoolExecutor
    state = {'active': 0, 'most': 0}
    guard = threading.Lock()

    def infer(rec, img):
        with guard:
            state['active'] += 1
            state['most'] = max(state['most'], state['active'])
        time.sleep(0.001)
        with guard:
            state['active'] -= 1
        return {'text': str(int(img[0, 0, 0])), 'score': [1.0]}

    model = serve_model._Model.__new__(serve_model._Model)
    model.det, model.rec, model._infer = False, None, infer
    model.worker = ThreadPoolExecutor(max_workers=1)
    served = Served(serve_model.make_handler, model)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        bodies = [cv_ops.png_encode(np.full((4, 6, 3), i, np.uint8))
                  for i in range(32)]
        got = [None] * 32

        def client(i):
            got[i] = served.post('/predictions/ocr', bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
        served.close()
    assert got == [(200, {'text': str(i), 'score': 1.0}) for i in range(32)]
    assert state['most'] == 1


def test_decode_image_takes_raw_and_base64():
    img = crops(1)[0]
    raw = cv_ops.png_encode(img)
    for body in (raw, base64.b64encode(raw), base64.b64encode(raw) + b'\n'):
        np.testing.assert_array_equal(serve_model.decode_image(body), img)
    jpg = cv2.imencode('.jpg', img)[1].tobytes()
    np.testing.assert_array_equal(
        serve_model.decode_image(base64.b64encode(jpg)),
        cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR))
    assert serve_model.decode_image(b'') is None
    assert serve_model.decode_image(b'garbage\x00') is None
    assert serve_model.decode_image(raw[:-20]) is None


# ---------------------------------------------------------- the PNG codec

def _chunk(kind, data):
    return (struct.pack('>I', len(data)) + kind + data +
            struct.pack('>I', zlib.crc32(kind + data)))


def _filter_rows(rows, bpp, ftypes):
    """Each row filtered by its type in ``ftypes`` (the PNG filters)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 255
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = ftypes
    out[:, 1:] = cands[ftypes, np.arange(x.shape[0])]
    return out


def make_png(px, ctype, palette=None, extra=b'', depth=8, interlace=0):
    """A PNG of the (H, W, ch) samples ``px`` of colour type ``ctype``,
    row y filtered by type y % 5."""
    h, w, ch = px.shape
    data = _filter_rows(px.reshape(h, w * ch), ch, np.arange(h) % 5)
    out = cv_ops.PNG_SIGNATURE + _chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b'PLTE', palette.tobytes())
    return (out + extra + _chunk(b'IDAT', zlib.compress(data.tobytes())) +
            _chunk(b'IEND', b''))


CTYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize('grayscale', [False, True])
@pytest.mark.parametrize('ctype', sorted(CTYPES))
def test_png_decode_matches_cv2_on_every_colour_type(ctype, grayscale):
    g = np.random.default_rng(ctype)
    for h, w in ((23, 37), (10, 1), (1, 9)):
        px = g.integers(0, 256 if ctype != 3 else 20, (h, w, CTYPES[ctype]),
                        dtype=np.uint8)
        palette = (g.integers(0, 256, (20, 3), dtype=np.uint8)
                   if ctype == 3 else None)
        buf = make_png(px, ctype, palette)
        want = cv2.imdecode(np.frombuffer(buf, np.uint8),
                            cv2.IMREAD_GRAYSCALE if grayscale
                            else cv2.IMREAD_COLOR)
        got = cv_ops.png_decode(buf, grayscale=grayscale)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', [(40, 61), (40, 61, 1), (33, 50, 3),
                                   (17, 29, 4)])
def test_png_decode_of_cv2s_png_and_encode_roundtrip(shape):
    g = np.random.default_rng(len(shape))
    noise = g.integers(0, 256, shape, dtype=np.uint8)
    smooth = (np.cumsum(np.cumsum(g.integers(-3, 4, shape), 0), 1) % 256
              ).astype(np.uint8)
    for img in (noise, smooth):
        bufs = (cv2.imencode('.png', img)[1].tobytes(), cv_ops.png_encode(img))
        for buf in bufs:
            for grayscale, flag in ((False, cv2.IMREAD_COLOR),
                                    (True, cv2.IMREAD_GRAYSCALE)):
                np.testing.assert_array_equal(
                    cv_ops.png_decode(buf, grayscale),
                    cv2.imdecode(np.frombuffer(buf, np.uint8), flag))
        back = cv2.imdecode(np.frombuffer(bufs[1], np.uint8),
                            cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back.reshape(img.shape), img)
    # the filter heuristic picks more than one filter on a smooth image
    raw = zlib.decompress(bufs[1][8 + 25 + 8:-12 - 4])
    stride = int(np.prod(shape[1:])) + 1
    assert len(set(raw[::stride])) > 1


def test_png_decode_refuses_what_it_does_not_take():
    px = np.zeros((4, 5, 3), np.uint8)
    for buf, why in (
            (make_png(px[..., :1], 0, depth=16), 'bit depth'),
            (make_png(px, 2, interlace=1), 'interlaced'),
            (make_png(px[..., :1], 3, np.zeros((1, 3), np.uint8),
                      extra=_chunk(b'tRNS', b'\x00')), 'tRNS')):
        with pytest.raises(ValueError, match='cv2'):
            cv_ops.png_decode(buf)
        assert why
    good = make_png(px, 2)
    bad_crc = bytearray(good)
    bad_crc[-20] ^= 1
    for buf in (b'not a png', good[:-12], bytes(bad_crc)):
        with pytest.raises(ValueError, match='png_decode'):
            cv_ops.png_decode(buf)
    with pytest.raises(ValueError, match='uint8'):
        cv_ops.png_encode(px.astype(np.float32))
    with pytest.raises(ValueError, match='grey, BGR or BGRA'):
        cv_ops.png_encode(np.zeros((4, 5, 2), np.uint8))
