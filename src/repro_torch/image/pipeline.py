"""The deterministic synthetic test image (the port's own copy of
``repro.image.pipeline.synthetic_image``; the FFT reconstruction that
module also holds is not ported yet).

The paper's 512x512 test image is not redistributable offline, so
:func:`synthetic_image` builds a deterministic 8-bit image with
comparable content classes: smooth shading, sharp edges, fine texture,
and small high-contrast objects.
"""

from __future__ import annotations

import numpy as np


def synthetic_image(size: int = 512, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size
    img = 96 + 80 * xx + 40 * np.sin(2 * np.pi * yy * 1.5)
    # sharp-edged shapes
    img[(yy - 0.3) ** 2 + (xx - 0.35) ** 2 < 0.04] = 230
    img[(yy - 0.7) ** 2 + (xx - 0.25) ** 2 < 0.015] = 25
    img[int(0.55 * size):int(0.8 * size), int(0.6 * size):int(0.9 * size)] = 180
    # fine texture band
    band = (yy > 0.82) & (yy < 0.95)
    img += band * 30 * np.sin(2 * np.pi * xx * 40)
    # gaussian blobs
    for (cy, cx, amp, s) in ((0.15, 0.75, 60, 0.05), (0.45, 0.6, -50, 0.08)):
        img += amp * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / s ** 2))
    img += rng.normal(0, 2.0, (size, size))
    return np.clip(img, 0, 255).astype(np.uint8)
