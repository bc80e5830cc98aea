"""Image quality metrics: PSNR and SSIM (paper Section IV).  The port's
own copy of ``repro.image.quality`` (numpy and scipy only)."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def psnr(ref: np.ndarray, img: np.ndarray, peak: float = 255.0) -> float:
    ref = np.asarray(ref, np.float64)
    img = np.asarray(img, np.float64)
    mse = np.mean((ref - img) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def ssim(ref: np.ndarray, img: np.ndarray, peak: float = 255.0,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """Single-scale SSIM with a Gaussian window (Wang et al. 2004)."""
    x = np.asarray(ref, np.float64)
    y = np.asarray(img, np.float64)
    c1 = (k1 * peak) ** 2
    c2 = (k2 * peak) ** 2
    mu_x = gaussian_filter(x, sigma)
    mu_y = gaussian_filter(y, sigma)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x2 = gaussian_filter(x * x, sigma) - mu_x2
    sig_y2 = gaussian_filter(y * y, sigma) - mu_y2
    sig_xy = gaussian_filter(x * y, sigma) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x2 + sig_y2 + c2)
    return float(np.mean(num / den))


def quality_band(s: float) -> str:
    """The paper's SSIM quality bands."""
    if s > 0.90:
        return "high"
    if s > 0.70:
        return "acceptable"
    if s > 0.30:
        return "low"
    return "poor"
