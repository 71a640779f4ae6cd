"""Synthetic rendered-text crops (counterpart of
``tps_pp_tpu/utils/synth_text.py``): cv2-rendered words for training and
evaluation runs without a dataset.

cv2 is imported inside ``render_dataset``, as ``LoadImageFromFile`` does, so
the module imports without it; the renderer itself needs cv2 (the card's
machine has none: render on a host that has it). The images are those of
the JAX renderer, pixel for pixel, from the same seed.
"""
from __future__ import annotations

import numpy as np

# alphanumerics render reliably with the cv2 HERSHEY fonts; all are in
# DICT36/DICT90 so no convertor changes are needed
_CHARS = ('0123456789'
          'abcdefghijklmnopqrstuvwxyz'
          'ABCDEFGHIJKLMNOPQRSTUVWXYZ')


def render_dataset(n: int, seed: int = 0, h: int = 32, w: int = 128,
                   lower: bool = False, max_len: int = 8,
                   length_dist: str = 'uniform'):
    """n synthetic word crops: (imgs float32 (n,h,w,3) in [-1,1], texts).

    cv2.putText over a light background with per-sample font, scale and
    colour jitter: enough variety that memorising the set exercises the
    whole backbone + TPS + encoder + decoder stack, cheap enough to render
    4k images in seconds on one core.

    length_dist:
      'uniform' — 3..min(8, max_len) chars.
      'real' — 1..min(25, max_len) chars from a discretized lognormal
        (median 5, sigma 0.55), the word lengths of the six academic
        benchmarks. Long words render on a proportionally wide canvas and
        are squeezed to (h, w), as the ResizeOCR pipeline stage does to
        real crops."""
    import cv2
    rng = np.random.default_rng(seed)
    chars = _CHARS[:36] if lower else _CHARS
    fonts = [cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_DUPLEX,
             cv2.FONT_HERSHEY_COMPLEX_SMALL, cv2.FONT_HERSHEY_TRIPLEX]
    imgs = np.empty((n, h, w, 3), np.float32)
    texts = []
    for i in range(n):
        if length_dist == 'real':
            k = int(np.clip(round(rng.lognormal(np.log(5.0), 0.55)),
                            1, min(25, max_len)))
        else:
            k = int(rng.integers(3, min(9, max_len + 1)))
        txt = ''.join(rng.choice(list(chars), size=k))
        bg = int(rng.integers(180, 256))
        # the draw order below fixes the images of a seed: noise (h, w)
        # first, then font, scale, colour, x0, y0, thickness
        noise = rng.integers(0, 20, (h, w, 3), dtype=np.uint8,
                             endpoint=False)
        font = fonts[int(rng.integers(len(fonts)))]
        scale = float(rng.uniform(0.55, 0.85)) * (h / 32.0)
        color = tuple(int(v) for v in rng.integers(0, 90, 3))
        x0 = int(rng.integers(1, 6))
        y0 = int(rng.integers(20, 27) * h / 32.0)
        thick = 1 + int(rng.integers(0, 2))
        cw = w
        if length_dist == 'real':
            (tw, _), _ = cv2.getTextSize(txt, font, scale, thick)
            cw = max(w, tw + x0 + 4)
            if cw != w:
                noise = rng.integers(0, 20, (h, cw, 3), dtype=np.uint8,
                                     endpoint=False)
        img = np.full((h, cw, 3), bg, np.uint8)
        # mild background noise
        img = cv2.add(img, noise)
        cv2.putText(img, txt, (x0, y0), font, scale, color,
                    thick, cv2.LINE_AA)
        if cw != w:
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        imgs[i] = img.astype(np.float32) / 127.5 - 1.0
        texts.append(txt)
    return imgs, texts
