#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path and training step,
on one CUDA GPU.

    python tools/torch_profile_slice.py
        [--stages serve,train,decode,encoder,predict,fused_step]
        [--batch 512]
        [--train-batch 256] [--stem-mode xla|fused]
        [--sampler-variant dense|twostage] [--trace DIR]

Builds the full-width NRTR + TPS++ flagship with seeded random weights.

* ``serve`` (bf16): times each stage of ``decode_full_fused``
  (``extract_feat``, the encoder, the decode with bf16 and with int8
  encoder K/V, with and without the EOS check) and of the ``steps`` decode
  with ``use_fused_step`` (the module encoder, the greedy decode) on the
  kernel path and on the plain path, with CUDA events; beside them the
  module stem against the fused stem (``ops.stem.fused_stem_forward``,
  kernels 11-12) alone and inside ``extract_feat``, and ``extract_feat``
  with the dense sampler against the two-stage one. Then ``predict`` in
  each decode mode, and a profile of one ``predict`` on the kernel path in
  ``fused40_bf16``, ``fused40`` and ``steps`` with ``use_fused_step``; these
  run with ``--stem-mode`` (default ``xla``, the module stem) and
  ``--sampler-variant`` (default ``dense``; the flagship's
  ``sample_mode='pallas'`` reads it from ``TPS_SAMPLER_VARIANT``).
* ``decode`` (bf16): the whole decode alone at the batch, bf16 and int8
  encoder K/V, no exit: its time, then a profile of each, its
  device time by part (the encoder K/V projection, the step GEMMs,
  attention, head, gate + embed; LayerNorm and
  the int8 quantization where they run apart) and its idle share. With
  dependent launch a kernel starts before the one it follows ends, so its
  interval holds its wait and the parts add up to more than the busy
  time. It reads the kernels of an earlier tree of the port too, so that
  the same file run from a parent's checkout gives the before of a
  change.
* ``predict`` (bf16): ``predict`` on the kernel path in ``fused40_bf16``
  and ``fused40`` alone, CUDA events, mean of 5 batches: the main path's
  end-to-end time, quick enough to run in turns against a parent's tree.
* ``encoder`` (bf16): kernel 3 (the whole encoder) alone at the batch,
  beside the module encoder, with CUDA events; then a profile of kernel 3:
  its device time by part (each of the four products of a layer, QKV, fc,
  W1 and W2, told apart by their order of launch; the attention;
  LayerNorm, with or without the bf16 to f32 cast, and the cast where
  they run apart), launches and idle share. Like ``decode`` it reads an
  earlier tree's kernels too.
* ``fused_step`` (bf16): the ``steps`` decode with ``use_fused_step`` at
  B=512 and B=8 (``--batch`` is not read). Kernels 6 and 7 alone on one
  layer's weights and the path's own encoder K/V: their device time by
  internal launch (position in the call, kernel name, mean device ms;
  kernel 6 over the 40 steps t = 0..39), launches a call, and the host
  ms a call (the enqueue, no synchronisation); beside them the same
  layer-step through the module path (``use_fused_step=False``: cuBLAS
  products, PyTorch attention), its self-attention part and its
  cross-attention + FFN part. Then the path: ``predict``,
  and apart, ``extract_feat`` (the trunk), the module encoder and the
  greedy decode (the 40 steps with the EOS check), with CUDA events; and
  a profile of one ``predict``: its idle share and the host's time
  blocked on the device (the trace's ``cuda*Synchronize`` calls, which
  hold ``greedy_decode``'s wait on its exit flag). Like ``decode`` it
  reads an earlier tree's kernels too.
* ``train`` (f32 parameters and Adam state, bf16 autocast, dropout 0.1,
  Adam at 1e-4 with grad clip 5.0, random DICT90 labels): times the
  forward (``compute_loss``), the backward and the optimizer step of a
  training step on the kernel path and on the plain path, with CUDA
  events; then profiles one step on the kernel path.

A profile reports the device's idle share over the kernel window, the
device time of the grid_sample kernels, and the device time of each
kernel, summed by name. With ``--trace`` the Chrome traces are written
there. Every timing line carries the card's ``nvidia-smi`` name and power
limit.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile


def smi(query):
    return subprocess.run(
        ['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_table(trace_path):
    """(window ms, busy ms, {kernel name: (ms, count)}) of a Chrome trace's
    device events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and e.get('cat') in
                  ('kernel', 'gpu_memcpy', 'gpu_memset')]
    events.sort(key=lambda e: e['ts'])
    busy, cur = 0.0, None
    for e in events:
        s, f = e['ts'], e['ts'] + e['dur']
        if cur is None or s > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [s, f]
        else:
            cur[1] = max(cur[1], f)
    busy += cur[1] - cur[0]
    window = max(e['ts'] + e['dur'] for e in events) - events[0]['ts']
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        name = e['name'].replace('(anonymous namespace)::', '')
        by_name[name.split('(')[0]][0] += e['dur'] / 1e3
        by_name[name.split('(')[0]][1] += 1
    return window / 1e3, busy / 1e3, by_name


def profiled(fn, what, card, out_dir):
    """Profile one call of ``fn`` and print its device summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = os.path.join(out_dir, what.replace(' ', '_').replace(',', '') +
                         '_trace.json')
    prof.export_chrome_trace(trace)
    window, busy, by_name = kernel_table(trace)
    warp = [(ms, n) for name, (ms, n) in by_name.items()
            if 'grid_sample' in name or 'grid_sampler' in name]
    print(f'profiled {what}: kernel window {window:.3f} ms, busy '
          f'{busy:.3f} ms, idle share {1 - busy / window:.4f}; grid_sample '
          f'kernels {sum(m for m, _ in warp):.3f} ms in '
          f'{sum(n for _, n in warp)} launches [{card}]', flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if ms >= 0.1:
            print(f'  {ms:9.3f} ms {n:6d}x  {name[:90]}')
    return trace


# the whole decode's kernels by part, matched on their names (the card's
# kernels of this tree or of an earlier one, so that one tool reads both)
DECODE_PARTS = (('K/V projection', ('gemm_bf16', 'wgmma_gemm')),
                ('GEMM', ('step_gemm',)),
                ('attention', ('attend',)),
                ('head', ('decode_head',)),
                ('gate + embed', ('embed',)),
                ('LayerNorm', ('layernorm', 'ln_rows')),
                ('int8 quantize', ('absmax', 'quantize')))


def decode_stage(dev, card, B, out_dir):
    """Profile the whole decode alone at ``B`` rows, bf16 and int8 encoder
    K/V, no exit: the device time of its GEMMs, attention, head, gate and
    embedding (and LayerNorm, where the kernels have it apart) and the
    idle share of its kernel window."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16'), device=dev)
    rec.init_weights(0)
    m = rec.model
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, 32, 128, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    vr = torch.ones(B, device=dev)
    traces = []
    with torch.inference_mode():
        enc = m.encoder(m.extract_feat(img), vr, fused=True)
        for dt in ('bfloat16', 'int8'):
            fn = (lambda dt=dt: m.decoder.fused_full_decode(enc, vr,
                                                            enc_dtype=dt))
            print(f'decode {dt:9s} {cuda_ms(fn, 3):9.3f} ms (B={B}, no '
                  f'exit) [{card}]', flush=True)
            trace = profiled(fn, f'decode {dt}', card, out_dir)
            window, busy, by_name = kernel_table(trace)
            parts = collections.OrderedDict((p, [0.0, 0])
                                            for p, _ in DECODE_PARTS)
            parts['other'] = [0.0, 0]
            for name, (ms, n) in by_name.items():
                part = next((p for p, keys in DECODE_PARTS
                             if any(k in name for k in keys)), 'other')
                parts[part][0] += ms
                parts[part][1] += n
            print(f'decode {dt} by part: ' + '; '.join(
                f'{p} {ms:.3f} ms in {n}' for p, (ms, n) in parts.items()
                if n) + f'; idle share {1 - busy / window:.4f} [{card}]',
                flush=True)
            traces.append(trace)
    return traces


# kernel 3's kernels by part, matched on their names (this tree's or an
# earlier one's); the products run in the order QKV, fc, W1, W2 each layer
ENCODER_PRODUCTS = ('QKV', 'fc', 'W1', 'W2')
ENCODER_PARTS = (('GEMM', ('gemm',)), ('attention', ('attn',)),
                 ('LayerNorm', ('layernorm', 'ln_rows')),
                 ('cast', ('bf16_to_f32',)))


def encoder_stage(dev, card, B, out_dir):
    """Kernel 3 alone at ``B`` images beside the module encoder, then its
    device time by part: each product (the GEMM launches in order of
    launch, four a layer), the attention, LayerNorm and the cast where
    they run apart; launches and the idle share of its kernel window."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16'), device=dev)
    rec.init_weights(0)
    m = rec.model
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, 32, 128, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    vr = torch.ones(B, device=dev)
    with torch.inference_mode():
        feat = m.extract_feat(img)
        for what, fn in (
                ('kernel 3', lambda: m.encoder(feat, vr, fused=True)),
                ('module encoder', lambda: m.encoder(feat, vr))):
            print(f'encoder {what:15s} {cuda_ms(fn, 10):9.3f} ms (B={B}) '
                  f'[{card}]', flush=True)
        trace = profiled(lambda: m.encoder(feat, vr, fused=True),
                         'encoder kernel 3', card, out_dir)
    window, busy, _ = kernel_table(trace)
    with open(trace) as f:
        events = sorted((e for e in json.load(f)['traceEvents']
                         if e.get('ph') == 'X' and e.get('cat') == 'kernel'),
                        key=lambda e: e['ts'])
    parts = collections.OrderedDict(
        [(f'GEMM {p}', [0.0, 0]) for p in ENCODER_PRODUCTS] +
        [(p, [0.0, 0]) for p, _ in ENCODER_PARTS[1:]] + [('other', [0.0, 0])])
    n_gemm = 0
    for e in events:
        part = next((p for p, keys in ENCODER_PARTS
                     if any(k in e['name'] for k in keys)), 'other')
        if part == 'GEMM':
            part = f'GEMM {ENCODER_PRODUCTS[n_gemm % 4]}'
            n_gemm += 1
        parts[part][0] += e['dur'] / 1e3
        parts[part][1] += 1
    print(f'encoder kernel 3 by part (B={B}): ' + '; '.join(
        f'{p} {ms:.3f} ms in {n}' for p, (ms, n) in parts.items() if n) +
        f'; {len(events)} launches, busy {busy:.3f} ms, idle share '
        f'{1 - busy / window:.4f} [{card}]', flush=True)
    return [trace]


def predict_stage(dev, card, B):
    """``predict`` of a batch of ``B`` crops in ``fused40_bf16`` and
    ``fused40`` on the kernel path: ms a batch and images/s."""
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16',
                                           decode_mode='auto'), device=dev)
    rec.init_weights(0)
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, 32, 128, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        for mode in ('fused40_bf16', 'fused40'):
            rec.decode_mode = mode
            ms = cuda_ms(lambda: rec.predict(img), 5)
            print(f'predict {mode:12s} {ms:9.3f} ms, {B / ms * 1e3:.1f} '
                  f'images/s (B={B}, mean of 5) [{card}]', flush=True)


def serve_stage(dev, card, B, out_dir, stem_mode, variant):
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    from tps_pp_tpu_torch.models.decoders import greedy_decode
    from tps_pp_tpu_torch.ops.stem import fused_stem_forward

    bf = torch.bfloat16
    cfg = dict(nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='auto'),
               stem_mode=stem_mode)
    rec = build_recognizer(cfg, device=dev)
    rec.init_weights(0)
    rec_fs = build_recognizer(dict(cfg, decoder=dict(
        cfg['decoder'], use_fused_step=True)), device=dev)
    rec_fs.model.load_state_dict(rec.model.state_dict())
    m, end_idx = rec.model, rec.label_convertor.end_idx
    start_idx, S = rec.label_convertor.start_idx, rec.max_seq_len
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, 32, 128, 3)).astype(np.float32)).to(dev, bf)
    vr = torch.ones(B, device=dev)

    def sampler(v, fn):
        """``fn()`` with the rectifier's sampler variant ``v``."""
        def run():
            os.environ['TPS_SAMPLER_VARIANT'] = v
            try:
                return fn()
            finally:
                os.environ['TPS_SAMPLER_VARIANT'] = variant
        return run

    os.environ['TPS_SAMPLER_VARIANT'] = variant
    with torch.inference_mode():
        feat = m.extract_feat(img)
        enc = m.encoder(feat, vr, fused=True)
        enc_mod = m.encoder(feat, vr)
        for plain in (False, True):
            path = 'plain' if plain else 'kernel'
            stages = [
                ('stem, module', 5, lambda: m.backbone.stem_and_head(img)),
                ('stem, fused', 5, lambda: fused_stem_forward(
                    m.backbone, img, bf, plain=plain)),
                ('extract_feat', 5, sampler('dense', lambda: m.extract_feat(
                    img, plain=plain))),
                ('extract_feat, fused stem', 5, sampler(
                    'dense', lambda: m.extract_feat(
                        img, plain=plain, stem=fused_stem_forward(
                            m.backbone, img, bf, plain=plain)))),
                ('extract_feat, two-stage sampler', 5, sampler(
                    'twostage', lambda: m.extract_feat(img, plain=plain))),
                ('encoder', 5,
                 lambda: m.encoder(feat, vr, fused=True, plain=plain)),
                ('encoder, module', 5, lambda: m.encoder(feat, vr))]
            for dt in ('bfloat16', 'int8'):
                stages += [
                    (f'decode {dt}, EOS check', 3,
                     lambda dt=dt: m.decoder.fused_full_decode(
                         enc, vr, end_idx=end_idx, plain=plain,
                         enc_dtype=dt)),
                    (f'decode {dt}, no exit', 3,
                     lambda dt=dt: m.decoder.fused_full_decode(
                         enc, vr, plain=plain, enc_dtype=dt))]
            stages.append(('decode fused step, EOS check', 3,
                           lambda: greedy_decode(
                               rec_fs.model.decoder, enc_mod, vr,
                               max_seq_len=S, start_idx=start_idx,
                               end_idx=end_idx, plain=plain)))
            for name, reps, fn in stages:
                print(f'{path:6s} {name:32s} {cuda_ms(fn, reps):9.3f} ms '
                      f'(B={B}) [{card}]', flush=True)
        modes = {'fused40_bf16': (rec, 'fused40_bf16'),
                 'fused40': (rec, 'fused40'), 'steps': (rec, 'steps'),
                 'steps, use_fused_step': (rec_fs, 'steps')}
        setting = f'stem {rec.resolved_stem_mode()}, sampler {variant}'
        for plain in (False, True):
            for mode, (r, dm) in modes.items():
                r.decode_mode, r.plain = dm, plain
                print(f'predict {mode:22s} {"plain" if plain else "kernel":6s}'
                      f' {cuda_ms(lambda: r.predict(img), 3):9.3f} ms '
                      f'(B={B}; {setting}) [{card}]', flush=True)
        traces = []
        for mode in ('fused40_bf16', 'fused40', 'steps, use_fused_step'):
            r, dm = modes[mode]
            r.decode_mode, r.plain = dm, False
            traces.append(profiled(lambda: r.predict(img),
                                   f'predict {mode}', card, out_dir))
        return traces


def _launch_parts(trace, calls):
    """[(position, kernel name, mean interval ms, mean exclusive ms)] of
    the last ``calls`` calls of one entry point in a trace, by the
    launch's position in its call, and the launches a call. A launch's
    exclusive time is what it adds to the chain: its end less the later
    of its start and the end of the launch before it (under dependent
    launch a kernel starts before the one it follows ends, and its
    interval holds that wait). The trace holds twice ``calls`` calls: the
    profiler may miss the first kernels of its window."""
    with open(trace) as f:
        events = sorted((e for e in json.load(f)['traceEvents']
                         if e.get('ph') == 'X' and e.get('cat') == 'kernel'),
                        key=lambda e: e['ts'])
    per = round(len(events) / (2 * calls))
    first = len(events) - per * calls
    excl = [e['ts'] + e['dur'] - max(e['ts'], p['ts'] + p['dur'])
            for p, e in zip(events[first - 1:], events[first:])]
    events = events[first:]
    parts = []
    for i in range(per):
        ev = events[i::per]
        name = ev[0]['name'].replace('(anonymous namespace)::', '')
        parts.append((i, name.split('(')[0][:60],
                      sum(e['dur'] for e in ev) / len(ev) / 1e3,
                      sum(excl[i::per]) / len(ev) / 1e3))
    return parts, per


def _host_waits(trace):
    """(ms, count) of the host's ``cuda*Synchronize`` calls in a trace."""
    with open(trace) as f:
        ev = [e for e in json.load(f)['traceEvents']
              if e.get('ph') == 'X' and e.get('cat') == 'cuda_runtime' and
              'Synchronize' in e.get('name', '')]
    return sum(e['dur'] for e in ev) / 1e3, len(ev)


def fused_step_stage(dev, card, out_dir):
    """Kernels 6 and 7 by internal launch and their host ms a call, then
    the ``steps`` + ``use_fused_step`` path split into its stages, at
    B=512 and B=8."""
    import time
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import build_recognizer, nrtr_tps_pp_cfg
    from tps_pp_tpu_torch.models.decoders import greedy_decode
    from tps_pp_tpu_torch.models.transformer import attend
    from tps_pp_tpu_torch.ops.decode_step import (cross_ffn_step,
                                                  self_attn_step)
    from torch.profiler import ProfilerActivity, profile

    cfg = nrtr_tps_pp_cfg(dtype='bfloat16', decode_mode='steps')
    cfg['decoder'] = dict(cfg['decoder'], use_fused_step=True)
    rec = build_recognizer(cfg, device=dev)
    rec.init_weights(0)
    m, dec = rec.model, rec.model.decoder
    lc = rec.label_convertor
    traces = []
    for B in (512, 8):
        img = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (B, 32, 128, 3)).astype(np.float32)).to(dev, torch.bfloat16)
        vr = torch.ones(B, device=dev)
        with torch.inference_mode():
            feat = m.extract_feat(img)
            enc = m.encoder(feat, vr)
            carry, (enc_kvs, mask) = dec.decode_init(enc, vr)
            ws = {k: v[0] for k, v in dec.step_weights().items()}
            sa_w = (ws['wqkv'], ws['wfc1'], ws['ln1_s'], ws['ln1_b'])
            cf_w = tuple(ws[k] for k in (
                'wq2', 'wfc2', 'ln2_s', 'ln2_b', 'w1', 'b1', 'w2', 'b2',
                'ln3_s', 'ln3_b'))
            x = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (B, 512)).astype(np.float32)).to(dev, torch.bfloat16)
            (ck, cv), (ek, ev) = carry[0], enc_kvs[0]
            S = dec.max_seq_len
            calls = {
                'kernel 6 (self_attn_step)': (S, lambda: [
                    self_attn_step(x, ck, cv, t, *sa_w) for t in range(S)]),
                'kernel 7 (cross_ffn_step)': (S, lambda: [
                    cross_ffn_step(x, ek, ev, mask, *cf_w)
                    for _ in range(S)])}
            for what, (n, fn) in calls.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host = (time.perf_counter() - t0) / n * 1e3
                torch.cuda.synchronize()
                dev_ms = cuda_ms(fn, 3) / n
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    fn()
                    torch.cuda.synchronize()
                trace = os.path.join(out_dir, f'fused_step_{B}_{what[:8]}'
                                     .replace(' ', '_') + '_trace.json')
                prof.export_chrome_trace(trace)
                parts, per = _launch_parts(trace, n)
                print(f'fused_step B={B} {what}: {dev_ms:.4f} ms a call '
                      f'(CUDA events, back to back), host {host:.4f} ms a '
                      f'call, {per:g} launches a call [{card}]', flush=True)
                for i, name, ms, ex in parts:
                    print(f'  launch {i}: {ms:8.4f} ms interval, {ex:8.4f} '
                          f'ms exclusive  {name}', flush=True)
                traces.append(trace)
            # the same layer-step on the module path, from its own
            # decode_init (its caches and K/V layouts, the (N,1,1,TE) mask)
            dec.use_fused_step = False
            mcarry, (mkvs, mmask) = dec.decode_init(enc, vr)
            dec.use_fused_step = True
            layer, x3 = dec.layer_stack[0], x[:, None]
            sa, (mck, mcv), (mek, mev) = layer.self_attn, mcarry[0], mkvs[0]
            T = S + 1

            def module_self(t):
                y = layer.norm1(x3)
                q = sa.split(sa.linear_q(y), dec.d_k)
                mck[:, :, t:t + 1] = sa.split(sa.linear_k(y), dec.d_k)
                mcv[:, :, t:t + 1] = sa.split(sa.linear_v(y), dec.d_v)
                pos = (torch.arange(T, device=dev) <= t).float()
                return x3 + sa.fc(attend(q, mck, mcv, pos, dec.d_k ** -0.5))

            def module_cross():
                x2 = x3 + layer.enc_attn.attend_cached(layer.norm2(x3), mek,
                                                       mev, mmask)
                return x2 + layer.mlp(layer.norm3(x2))
            self_ms = cuda_ms(lambda: [module_self(t) for t in range(S)],
                              3) / S
            cross_ms = cuda_ms(lambda: [module_cross() for _ in range(S)],
                               3) / S
            print(f'fused_step B={B} module layer-step (use_fused_step='
                  f'False): self-attention {self_ms:.4f} ms, cross-attention '
                  f'+ FFN {cross_ms:.4f} ms a call (CUDA events, back to '
                  f'back) [{card}]', flush=True)
            del carry, enc_kvs, mcarry, mkvs
            rec.decode_mode = 'steps'
            end_idx, start_idx = lc.end_idx, lc.start_idx
            stages = (
                ('predict', lambda: rec.predict(img)),
                ('trunk (extract_feat)', lambda: m.extract_feat(img)),
                ('module encoder', lambda: m.encoder(feat, vr)),
                ('greedy decode, 40 steps, EOS check', lambda: greedy_decode(
                    dec, enc, vr, max_seq_len=S, start_idx=start_idx,
                    end_idx=end_idx)))
            for name, fn in stages:
                print(f'fused_step B={B} {name:36s} {cuda_ms(fn, 3):9.3f} ms '
                      f'[{card}]', flush=True)
            trace = profiled(lambda: rec.predict(img),
                             f'fused_step predict B={B}', card, out_dir)
            wait, n_wait = _host_waits(trace)
            print(f'fused_step B={B} predict: host blocked on the device '
                  f'{wait:.3f} ms in {n_wait} cuda*Synchronize calls '
                  f'(profiled) [{card}]', flush=True)
            traces.append(trace)
        torch.cuda.empty_cache()
    return traces


def train_stage(dev, card, B, out_dir):
    import numpy as np
    import torch
    from tps_pp_tpu_torch.apis import (FLAGSHIP_INPUT, build_recognizer,
                                       nrtr_tps_pp_cfg)
    from tps_pp_tpu_torch.parallel import build_optimizer

    rec = build_recognizer(nrtr_tps_pp_cfg(dtype='bfloat16'), device=dev,
                           param_dtype='float32').init_weights(0)
    opt, _ = build_optimizer(dict(type='Adam', lr=1e-4,
                                  grad_clip=dict(max_norm=5.0)),
                             rec.model.named_parameters())
    g = np.random.default_rng(0)
    lc = rec.label_convertor
    chars = [c for c in lc.idx2char if len(c) == 1]
    texts = [''.join(g.choice(chars, int(g.integers(1, 26))))
             for _ in range(B)]
    batch = dict(
        img=torch.from_numpy(g.standard_normal((B,) + FLAGSHIP_INPUT).astype(
            np.float32)).to(dev),
        valid_ratio=g.uniform(0.5, 1.0, B).astype(np.float32),
        padded_targets=lc.str2tensor(texts)['padded_targets'])
    gen = torch.Generator(device=dev).manual_seed(1)

    def step(plain, events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        opt.zero_grad()
        total, _ = rec.compute_loss(batch, gen, plain=plain)
        mark(1)
        total.backward()
        mark(2)
        opt.step()
        mark(3)

    reps = 3
    for plain in (False, True):
        step(plain)
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                  for _ in range(reps)]
        for ev in events:
            step(plain, ev)
        torch.cuda.synchronize()
        ms = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / reps
              for i in range(3)]
        path = 'plain' if plain else 'kernel'
        print(f'train {path:6s} forward {ms[0]:9.3f} ms, backward '
              f'{ms[1]:9.3f} ms, optimizer {ms[2]:8.3f} ms, step '
              f'{sum(ms):9.3f} ms, {B / sum(ms) * 1e3:.1f} images/s '
              f'(B={B}, mean of {reps}) [{card}]', flush=True)
    return profiled(lambda: step(False), 'train step', card, out_dir)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--stages', default='serve,train',
                    help='comma-separated: serve, train, decode, encoder, '
                    'predict, fused_step')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--train-batch', type=int, default=256)
    ap.add_argument('--stem-mode', default='xla', choices=('xla', 'fused'),
                    help='the stem of the predict and profile runs')
    ap.add_argument('--sampler-variant', default='dense',
                    choices=('dense', 'twostage'),
                    help='the TPS++ sampler of the predict and profile runs')
    ap.add_argument('--trace', help='directory for the Chrome traces')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_profile_slice: no CUDA device')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi('name,power.limit')
    dev = torch.device('cuda')
    out_dir = args.trace or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    traces = []
    stages = args.stages.split(',')
    if 'serve' in stages:
        traces += serve_stage(dev, card, args.batch, out_dir,
                              args.stem_mode, args.sampler_variant)
        torch.cuda.empty_cache()
    if 'predict' in stages:
        predict_stage(dev, card, args.batch)
        torch.cuda.empty_cache()
    if 'encoder' in stages:
        traces += encoder_stage(dev, card, args.batch, out_dir)
        torch.cuda.empty_cache()
    if 'decode' in stages:
        traces += decode_stage(dev, card, args.batch, out_dir)
        torch.cuda.empty_cache()
    if 'fused_step' in stages:
        traces += fused_step_stage(dev, card, out_dir)
        torch.cuda.empty_cache()
    if 'train' in stages:
        traces.append(train_stage(dev, card, args.train_batch, out_dir))
    if not args.trace:
        for t in traces:
            os.remove(t)
        os.rmdir(out_dir)


if __name__ == '__main__':
    main()
