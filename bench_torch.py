"""Benchmark: NRTR + TPS++ inference throughput on one NVIDIA GPU, through
the PyTorch + CUDA port (the twin of ``bench.py``, which measures the JAX
package on a TPU).

    python bench_torch.py

Builds the flagship (``tps_pp_tpu_torch.apis.nrtr_tps_pp_cfg``) in bf16
with seed-0 random weights, makes seed-0 ``standard_normal`` 32x128x3
crops in bf16 on the card, and times the device path of a batch,
``TextRecognizer._predict_impl`` (trunk, TPS++, encoder, greedy decode;
no host convertor), under ``torch.inference_mode()``: ``BENCH_WARMUP``
batches, then ``BENCH_ITERS`` batches back to back between two
``torch.cuda.synchronize()``. Knobs, as ``bench.py``'s: ``BENCH_BATCH``
(512), ``BENCH_ITERS`` (18: the batches bench.py times by default, 3
rounds of 6), ``BENCH_WARMUP`` (2), ``BENCH_DECODE`` (``auto``, which is
``fused40_bf16`` here; or ``fused40``, ``steps``) and ``BENCH_KV``
(``bfloat16``; the decoder's ``kv_dtype``).

Prints one JSON line: ``metric``, ``value`` (images/s), ``unit``, the
resolved ``decode_mode`` and ``stem_mode``, ``kv_dtype``, ``batch`` and
``device`` (the card's ``nvidia-smi`` name and power limit). Without a
CUDA device it exits non-zero and prints no JSON line.
"""
import json
import os
import subprocess
import sys
import time


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('bench_torch: no CUDA device '
                 '(torch.cuda.is_available() is False)')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)

    batch = int(os.environ.get('BENCH_BATCH', '512'))
    iters = int(os.environ.get('BENCH_ITERS', '18'))
    warmup = int(os.environ.get('BENCH_WARMUP', '2'))
    kv_dtype = os.environ.get('BENCH_KV', 'bfloat16')
    decode_mode = os.environ.get('BENCH_DECODE', 'auto')
    rec = build_recognizer(nrtr_tps_pp_cfg(
        dtype='bfloat16', kv_dtype=kv_dtype,
        decode_mode=decode_mode)).init_weights(0)
    h, w, c = FLAGSHIP_INPUT
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((batch, h, w, c))).to(
        rec.device, torch.bfloat16)
    vr = torch.ones((batch,), dtype=torch.float32, device=rec.device)
    model = rec.serving_model()

    def run():
        return rec._predict_impl(model, img, vr)

    with rec._mode(model, False), torch.inference_mode():
        out = run()
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError('bench_torch: non-finite output')
        for _ in range(warmup - 1):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print(json.dumps({
        'metric': 'nrtr_tpspp_infer_images_per_sec_per_gpu',
        'value': batch * iters / dt,
        'unit': 'images/sec/gpu',
        'decode_mode': rec.resolved_decode_mode(),
        'kv_dtype': kv_dtype,
        'batch': batch,
        'stem_mode': rec.resolved_stem_mode(),
        'device': card(),
    }), flush=True)


if __name__ == '__main__':
    main()
