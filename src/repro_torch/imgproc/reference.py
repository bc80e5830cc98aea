"""Ideal float64 reference implementations of the image operators (the
port's own copy of ``repro.imgproc.reference``: plain numpy).

These are the *golden* operators the approximate datapath is scored
against (corpus PSNR/SSIM): plain numpy, float64, no fixed-point
quantization and no intermediate rounding.  Edge handling (replicate)
and the final round-half-up-to-uint8 match :mod:`repro_torch.imgproc.ops`
exactly, so for operators whose fixed-point path is exact under the
accurate adder (add, blend at alpha=0.5) the reference is bit-identical
to the engine output.

All functions accept ``(..., H, W)`` arrays in [0, 255] — leading batch
dims are free.
"""

from __future__ import annotations

import numpy as np


def _finish(x: np.ndarray) -> np.ndarray:
    """Round half up and saturate to uint8 (matches ops._finish)."""
    return np.clip(np.floor(np.asarray(x, np.float64) + 0.5),
                   0, 255).astype(np.uint8)


def _taps(x: np.ndarray, axis: int, offsets) -> np.ndarray:
    """Stack replicate-padded shifted views on a new axis 0 (out[i] =
    in[i + offset], edges replicated) — mirrors ops._taps."""
    axis = axis % x.ndim
    left = max(-min(offsets), 0)
    right = max(max(offsets), 0)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (left, right)
    p = np.pad(x, pad, mode="edge")
    n = x.shape[axis]
    views = []
    for o in offsets:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(o + left, o + left + n)
        views.append(p[tuple(sl)])
    return np.stack(views)


def _sep3(x: np.ndarray, taps) -> np.ndarray:
    """Separable 3x3 filter with identical row/column taps."""
    w = np.asarray(taps, np.float64).reshape(-1, *([1] * x.ndim))
    h = (_taps(x, -1, (-1, 0, 1)) * w).sum(axis=0)
    return (_taps(h, -2, (-1, 0, 1)) * w).sum(axis=0)


def box_blur(img) -> np.ndarray:
    x = np.asarray(img, np.float64)
    return _finish(_sep3(x, (1, 1, 1)) / 9.0)


def gaussian_blur(img) -> np.ndarray:
    x = np.asarray(img, np.float64)
    return _finish(_sep3(x, (1, 2, 1)) / 16.0)


def sharpen(img, amount: int = 1) -> np.ndarray:
    x = np.asarray(img, np.float64)
    blur = _sep3(x, (1, 2, 1)) / 16.0
    return _finish((1 + amount) * x - amount * blur)


def sobel(img) -> np.ndarray:
    x = np.asarray(img, np.float64)
    w = np.asarray((1, 2, 1), np.float64).reshape(-1, *([1] * x.ndim))
    sx = (_taps(x, -2, (-1, 0, 1)) * w).sum(axis=0)
    gx = (_taps(sx, -1, (1, -1)) * np.asarray((1.0, -1.0)).reshape(
        -1, *([1] * x.ndim))).sum(axis=0)
    sy = (_taps(x, -1, (-1, 0, 1)) * w).sum(axis=0)
    gy = (_taps(sy, -2, (1, -1)) * np.asarray((1.0, -1.0)).reshape(
        -1, *([1] * x.ndim))).sum(axis=0)
    return _finish((np.abs(gx) + np.abs(gy)) / 4.0)


def img_add(a, b) -> np.ndarray:
    return _finish(np.asarray(a, np.float64) + np.asarray(b, np.float64))


def blend(a, b, alpha: float = 0.5) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return _finish(alpha * a + (1.0 - alpha) * b)


def brightness(img, delta: float = 37.0) -> np.ndarray:
    return _finish(np.asarray(img, np.float64) + delta)


def downsample2x(img) -> np.ndarray:
    x = np.asarray(img, np.float64)
    h = x.shape[-2] & ~1
    w = x.shape[-1] & ~1
    x = x[..., :h, :w]
    quad = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
            + x[..., 1::2, 0::2] + x[..., 1::2, 1::2])
    return _finish(quad / 4.0)
