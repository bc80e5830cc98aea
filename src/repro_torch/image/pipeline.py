"""Image reconstruction pipeline (paper Fig 5): FFT -> IFFT with
approximate adders; PSNR/SSIM against the source image (the port of
``repro.image.pipeline``).

It is also registered as the ``"fft_reconstruct"`` workload of
:mod:`repro_torch.imgproc` (``run_corpus(include_fft=True)``).

The paper's 512x512 test image is not redistributable offline, so
:func:`synthetic_image` builds a deterministic 8-bit image with
comparable content classes: smooth shading, sharp edges, fine texture,
and small high-contrast objects.  The ADDER ORDERING of the
reconstruction quality is the reproduction target, not the absolute
values.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.specs import AdderSpec
from repro_torch.image.fft import (FixedFFTConfig, from_fixed, to_fixed,
                                   transform2d)
from repro_torch.image.quality import psnr, ssim


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


def reconstruct(img, spec: AdderSpec, frac_bits: int = 6, block: int = 16,
                backend=None, device=None) -> torch.Tensor:
    """FFT -> IFFT of ``img`` through the given adder; returns uint8 on
    the engine's device (the card unless ``backend``/``device`` say
    otherwise).

    ``img`` is (..., H, W) in [0, 255] (array or tensor); leading batch
    axes are transformed independently, as if one call per image.  The
    transform runs block-wise (``block`` x ``block`` tiles, batched over
    tiles) in Q(N-f).f fixed point; ``block=0`` (or a block at least the
    image height) runs one whole-image transform.  The transforms address
    the tiles where they lie in the image (no tiling copy): at N = 32 the
    card runs one launch per axis, four in all.  (block=16,
    frac_bits=6) is the reference's calibration, under which the
    accurate adder is lossless and the six approximate adders keep the
    paper's quality ordering."""
    cfg = FixedFFTConfig(spec=spec, frac_bits=frac_bits, backend=backend,
                         device=device)
    x = cfg.engine.tensor(img)
    h = x.shape[-2]
    re = to_fixed(x, cfg).contiguous()
    im = torch.zeros_like(re)
    bs = block if block and block < h else None
    re, im = transform2d(re, im, cfg, block=bs)
    re, im = transform2d(re, im, cfg, inverse=True, block=bs)
    out = from_fixed(re, cfg)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def evaluate(img: np.ndarray, specs, frac_bits: int = 6, block: int = 16,
             backend=None, device=None) -> Dict[str, dict]:
    """PSNR/SSIM of :func:`reconstruct` against ``img`` per adder spec."""
    out = {}
    for spec in specs:
        rec = reconstruct(img, spec, frac_bits, block, backend=backend,
                          device=device).cpu().numpy()
        out[spec.kind] = {"psnr": psnr(img, rec), "ssim": ssim(img, rec)}
    return out
