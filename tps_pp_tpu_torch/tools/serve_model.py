"""Serve a recognizer or a detector over HTTP (counterpart of
``tools/deployment/serve_model.py:35-140``, the reference's TorchServe
handler ``mmocr_handler.py``):

    python -m tps_pp_tpu_torch.tools.serve_model CONFIG [--port 8080] \\
        [--checkpoint X.pth] [--name ocr] [--det] \\
        [--cfg-options model.dtype=bfloat16] [--device cpu]

* ``GET /ping`` -> ``{"status": "Healthy"}``;
* ``POST /predictions/<name>`` with an image as the body, raw or as base64
  text -> a recognizer's ``{"text", "score"}`` (``model_inference``, the
  score the mean of the characters') or, with ``--det``, a detector's
  ``{"boundary_result": [[x1, y1, ..., score], ...]}`` (``detect``);
* a body that does not decode -> 400, another path -> 404, a failure of
  the model -> 500, each with ``{"error": ...}``.

A PNG body is decoded without cv2 (``cv_ops.png_decode``, as
``cv2.imdecode(..., IMREAD_COLOR)``); any other format goes through
``cv2.imdecode``, imported at the request (JPEG needs cv2). The model is
built once, on the card unless ``--device cpu``. The server's threads (one
a request) hand each image to one worker thread that owns the model, which
serialises the requests, as the JAX server's lock does, and keeps the
thread that calls CUDA the same: on an H100 a one-crop ``model_inference``
took 28.3 ms (p50) in a thread that had run it before and 160.7 ms in a
new thread a call (``chip_smoke.py`` ``deploy_phase``). Standard library
``ThreadingHTTPServer`` only, on 127.0.0.1.
"""
from __future__ import annotations

import argparse
import base64
import binascii
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..datasets.pipelines.cv_ops import PNG_SIGNATURE, png_decode

_B64 = frozenset('ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz'
                 '0123456789+/=\n')


def decode_image(body: bytes) -> Optional[np.ndarray]:
    """The BGR image of a request body (raw bytes, or their base64 text, as
    the JAX server tells them apart), or None where it does not decode."""
    if not body:
        return None
    try:
        text = body.decode('ascii').strip()
        if text and all(c in _B64 for c in text[:64]):
            body = base64.b64decode(text, validate=True)
    except (UnicodeDecodeError, binascii.Error, ValueError):
        pass
    if body[:8] == PNG_SIGNATURE:
        try:
            return png_decode(body)
        except ValueError:
            pass                      # a PNG png_decode does not take
    try:
        import cv2
    except ImportError:
        return None
    return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)


class _Model:
    """The model, built once; ``predict`` runs each image on the one
    worker thread that owns the model, a request at a time. ``close``
    stops that thread."""

    def __init__(self, config, checkpoint: Optional[str] = None,
                 det: bool = False, device=None):
        self.det = det
        self.worker = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix='serve_model')
        if det:
            from ..apis.detector import init_detector
            self.detector = init_detector(config, checkpoint, device=device)
        else:
            from ..apis.inference import init_recognizer, model_inference
            self.rec = init_recognizer(config, checkpoint, device=device)
            self._infer = model_inference

    def _predict(self, img: np.ndarray) -> dict:
        if self.det:
            boundaries = self.detector.detect(img)
            return {'boundary_result': [list(map(float, b))
                                        for b in boundaries]}
        out = self._infer(self.rec, img)
        score = out['score']
        return {'text': out['text'],
                'score': float(np.mean(score))
                if hasattr(score, '__len__') else float(score)}

    def predict(self, img: np.ndarray) -> dict:
        return self.worker.submit(self._predict, img).result()

    def close(self):
        self.worker.shutdown(wait=True)


def make_handler(model: _Model, name: str):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode('utf-8')
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/ping':
                self._send(200, {'status': 'Healthy'})
            else:
                self._send(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            length = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(length)
            if self.path != f'/predictions/{name}':
                self._send(404, {'error': f'unknown model path {self.path}; '
                                          f'expected /predictions/{name}'})
                return
            img = decode_image(body)
            if img is None:
                self._send(400, {'error': 'request body is not a decodable '
                                          'image (raw or base64 bytes)'})
                return
            try:
                self._send(200, model.predict(img))
            except Exception as e:  # noqa: BLE001 (the serving boundary)
                self._send(500, {'error': repr(e)})

        def log_message(self, fmt, *args):
            sys.stderr.write('serve: %s\n' % (fmt % args))

    return Handler


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Serve a model over HTTP')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--name', default='ocr')
    p.add_argument('--det', action='store_true',
                   help='serve a detection config instead of recognition')
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default=None,
                   help="'cpu' for the CPU; the card when left out")
    return p.parse_args(argv)


def make_server(argv: Optional[List[str]] = None) -> ThreadingHTTPServer:
    """The server of the command line ``argv``, bound and not yet
    serving (``--port 0`` takes a free port: ``server.server_address``)."""
    from ..config import load_config, merge_cli_options
    from .test import parse_cfg_options
    args = parse_args(argv)
    cfg = load_config(args.config)
    merge_cli_options(cfg, parse_cfg_options(args.cfg_options))
    model = _Model(cfg, args.checkpoint, det=args.det, device=args.device)
    server = ThreadingHTTPServer(('127.0.0.1', args.port),
                                 make_handler(model, args.name))
    server.model, server.name = model, args.name
    return server


def main(argv: Optional[List[str]] = None):
    server = make_server(argv)
    host, port = server.server_address[:2]
    print(f'serving at http://{host}:{port}/predictions/{server.name}',
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        server.model.close()


if __name__ == '__main__':
    main()
