"""ABFT checksums for the MAC datapaths, calibrated by the exact error
analytics (the port of ``repro.integrity.abft``).

Classic algorithm-based fault tolerance (Huang & Abraham) checks a
matmul by comparing row/column sums of the output against checksums
computed from the inputs: ``sum_i C[i, j] == (sum_i A[i, :]) @ B[:, j]``
— O(MK + KN) exact work guarding an O(MKN) product.  On an EXACT
datapath any deviation is a fault.  On an *approximate* datapath the
deviation is nonzero by design, so the acceptance band is calibrated
from the closed-form per-config moments — each output element folds
``n_adds`` approximate adds (mean |error| ``med_add``, variance
``var_add``, exact from :func:`repro_torch.ax.analytics.exact_error_moments`)
and ``n_products`` approximate multiplies (moments taken exactly off the
compiled mul delta table), so a checksum over ``count`` elements accepts
within

    band * count * (n_adds * med_add + n_products * med_mul)
      + z * sqrt(count * (n_adds * var_add + n_products * var_mul))

Design-intended approximation stays far inside the band; a
stuck-at/bus fault at bit ``b`` shifts every touched element by
~``2^b`` — orders of magnitude past it.  Flagged rows/columns (or conv
images) are selectively recomputed on the exact datapath, so a detected
fault degrades to exact results instead of serving silently-wrong sums.

The budget is host float64.  The checksums run in int64 on the output's
device: CUDA has no int64 matrix product, so ``a.sum(0) @ b`` and
``a @ b.sum(1)`` are broadcast products and sums, and the exact
recompute takes only the flagged columns, rows or images (in chunks of
bounded size).  :class:`AbftVerdict` carries the served output as a
tensor on the engine's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs

__all__ = ["AbftVerdict", "AbftChecker", "mac_error_budget"]

#: int64 elements one exact-recompute chunk may hold (256 MiB).
_CHUNK_ELEMS = 1 << 25


@functools.lru_cache(maxsize=None)
def _add_moments(spec) -> Tuple[float, float]:
    """(mean |error|, variance of |error|) per approximate add."""
    from repro_torch.ax.analytics import analytics_supported, \
        exact_error_moments
    from repro_torch.ax.registry import get_adder
    if get_adder(spec.kind).is_exact:
        return 0.0, 0.0
    if not analytics_supported(spec):
        raise ValueError(
            f"no exact moments for {spec.short_name}; ABFT bands need "
            f"the closed-form analytics")
    mom = exact_error_moments(spec, backend="numpy")
    return mom.med, mom.var_ed


@functools.lru_cache(maxsize=None)
def _mul_moments(mul_spec) -> Tuple[float, float]:
    """(mean |error|, variance of |error|) per approximate product,
    exact over the compiled delta table."""
    from repro_torch.ax.mul.lut import MAX_MUL_DELTA_BITS, \
        mul_error_delta_table
    if mul_spec is None or mul_spec.is_exact:
        return 0.0, 0.0
    if mul_spec.n_bits > MAX_MUL_DELTA_BITS:
        raise ValueError(
            f"no exact mul delta table for {mul_spec.short_name} "
            f"(n_bits > {MAX_MUL_DELTA_BITS}); ABFT bands need it")
    d = np.abs(mul_error_delta_table(mul_spec).astype(np.float64))
    med = float(d.mean())
    return med, float((d * d).mean() - med * med)


def mac_error_budget(spec, mul_spec, count: int, n_adds: int,
                     n_products: int, *, band: float = 2.0,
                     z: float = 8.0) -> float:
    """Accepted |checksum deviation| for a sum over ``count`` output
    elements, each folding ``n_adds`` approximate adds and
    ``n_products`` approximate products."""
    med_a, var_a = _add_moments(spec)
    med_m, var_m = _mul_moments(mul_spec)
    mean = count * (n_adds * med_a + n_products * med_m)
    var = count * (n_adds * var_a + n_products * var_m)
    return band * mean + z * math.sqrt(var)


@dataclasses.dataclass(frozen=True)
class AbftVerdict:
    """One checked (and possibly repaired) MAC output.

    ``out`` is the served tensor, on the engine's device: the engine's
    output when clean, or a copy with every flagged row/column/image
    recomputed on the exact datapath when not."""

    out: torch.Tensor
    ok: bool
    flagged_rows: Tuple[int, ...]
    flagged_cols: Tuple[int, ...]
    max_deviation: float
    budget: float

    def __repr__(self) -> str:
        return (f"AbftVerdict(ok={self.ok}, rows={self.flagged_rows}, "
                f"cols={self.flagged_cols}, "
                f"max_dev={self.max_deviation:.1f}, "
                f"budget={self.budget:.1f})")


def _flagged(dev: torch.Tensor, budget: float) -> Tuple[int, ...]:
    """Indices whose deviation exceeds ``budget`` (compared in float64,
    as numpy compares an int64 array with a Python float)."""
    return tuple(int(i) for i in
                 torch.nonzero(dev.to(torch.float64) > budget).reshape(-1)
                 .tolist())


def _max_dev(*devs: torch.Tensor) -> float:
    tops = [d.max() for d in devs if d.numel()]
    return float(torch.stack(tops).max()) if tops else 0.0


def _chunks(idx: Sequence[int], per: int):
    """``idx`` in runs of at most ``_CHUNK_ELEMS // per`` indices."""
    step = max(1, _CHUNK_ELEMS // max(per, 1))
    for i in range(0, len(idx), step):
        yield list(idx[i:i + step])


def _wrap(x64: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values wrapped into the output container ``dtype`` (its low
    bits, two's complement), as the reference's ``_wrap``."""
    if dtype == torch.int64:
        return x64
    width = torch.iinfo(dtype).bits
    v = x64 & ((1 << width) - 1)
    if dtype.is_signed:
        v = v - ((v >> (width - 1)) << width)
    return v.to(dtype)


def _edge_pad(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(..., H, W) replicate-padded by (ph, pw), any integer dtype."""
    h, w = img.shape[-2:]
    rows = torch.arange(-ph, h + ph, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=img.device).clamp(0, w - 1)
    return img[..., rows, :][..., cols]


class AbftChecker:
    """Checksum-verified ``matmul``/``conv2d`` over one engine.

    Args:
      engine: the :class:`~repro_torch.ax.engine.AxEngine` whose MAC ops
        are checked (adder + optional multiplier specs drive the band).
      band / z: acceptance-band knobs of :func:`mac_error_budget`.
    """

    def __init__(self, engine, *, band: float = 2.0, z: float = 8.0):
        self.engine = engine
        self.band = float(band)
        self.z = float(z)
        self.checks = 0
        self.flags = 0

    def _budget(self, count: int, n_adds: int, n_products: int) -> float:
        return mac_error_budget(self.engine.spec, self.engine.mul_spec,
                                count, n_adds, n_products,
                                band=self.band, z=self.z)

    def _on(self, x, device) -> torch.Tensor:
        return torch.as_tensor(x, device=device)

    # ---------------------------------------------------------- matmul --

    def matmul(self, a, b, block=(128, 128, 128)) -> AbftVerdict:
        """Run ``engine.matmul`` and verify it (row + column
        checksums); flagged rows/columns are recomputed exactly."""
        out = self.engine.matmul(a, b, block=block)
        return self.verify_matmul(out, a, b, block=block)

    def verify_matmul(self, out, a, b,
                      block=(128, 128, 128)) -> AbftVerdict:
        """Checksum-verify an already-computed matmul output."""
        out = self._on(out, self.engine.device)
        dev = out.device
        a64 = self._on(a, dev).to(torch.int64)
        b64 = self._on(b, dev).to(torch.int64)
        o64 = out.to(torch.int64)
        m, k = a64.shape
        n = b64.shape[1]
        tiles = max(1, -(-k // int(block[2])))
        n_adds = tiles - 1
        n_products = k if (self.engine.mul_spec is not None
                           and not self.engine.mul_spec.is_exact) else 0

        col_dev = (o64.sum(0) - (a64.sum(0)[:, None] * b64).sum(0)).abs()
        row_dev = (o64.sum(1) - (a64 * b64.sum(1)[None, :]).sum(1)).abs()
        col_budget = self._budget(m, n_adds, n_products)
        row_budget = self._budget(n, n_adds, n_products)
        bad_cols = _flagged(col_dev, col_budget)
        bad_rows = _flagged(row_dev, row_budget)
        max_dev = _max_dev(col_dev, row_dev)
        ok = not bad_cols and not bad_rows
        self._count(ok)
        if ok:
            return AbftVerdict(out=out, ok=True, flagged_rows=(),
                               flagged_cols=(), max_deviation=max_dev,
                               budget=col_budget)
        repaired = out.clone()
        # Exact-datapath recompute of just the flagged strips: plain
        # integer MAC as int64 broadcast products, cast back through the
        # output container.
        for cols in _chunks(bad_cols, m * k):
            exact = (a64[:, :, None] * b64[None, :, cols]).sum(1)
            repaired[:, cols] = _wrap(exact, repaired.dtype)
        for rows in _chunks(bad_rows, k * n):
            exact = (a64[rows][:, :, None] * b64[None]).sum(1)
            repaired[rows, :] = _wrap(exact, repaired.dtype)
        return AbftVerdict(out=repaired, ok=False,
                           flagged_rows=bad_rows, flagged_cols=bad_cols,
                           max_deviation=max_dev, budget=col_budget)

    # ---------------------------------------------------------- conv2d --

    def conv2d(self, q, kernel, shift: int = 0) -> AbftVerdict:
        """Run ``engine.conv2d`` and verify per-image total-sum
        checksums; flagged images are recomputed exactly."""
        out = self.engine.conv2d(q, kernel, shift=shift)
        return self.verify_conv2d(out, q, kernel, shift=shift)

    def verify_conv2d(self, out, q, kernel,
                      shift: int = 0) -> AbftVerdict:
        """Checksum-verify an already-computed conv2d output.

        The product-sum checksum commutes with the tap structure:
        ``sum_pixels acc = sum_t sum_pixels product_t(padded_view_t)``
        — one O(pixels) pass per tap.  For an approximate multiplier
        the per-tap products are gathered from FRESHLY-BUILT tap
        columns (off-cache, 2^N entries per tap — immune to cached-LUT
        corruption), so the multiplier's design error is inside the
        checksum and only the adder folds + the rounding shift (at most
        ``2^{shift-1}`` per pixel) remain in the band."""
        out = self._on(out, self.engine.device)
        dev = out.device
        q64 = self._on(q, dev).to(torch.int64)
        o64 = out.to(torch.int64)
        if q64.ndim == 2:
            q64, o64 = q64[None], o64[None]
        weights = [w for row in kernel for w in row]
        taps = len(weights)
        pixels = int(q64.shape[-2] * q64.shape[-1])
        budget = self._budget(pixels, taps - 1, 0)
        if shift:
            budget += pixels * float(1 << (shift - 1))

        tap_cols = self._tap_columns(kernel, dev)
        exact_sums = self._conv_checksums(q64, kernel, tap_cols)
        got_sums = o64.sum(dim=(-2, -1)) * (1 << shift)
        dev_ = (got_sums - exact_sums).abs()
        bad = _flagged(dev_, budget)
        ok = not bad
        self._count(ok)
        served = out
        if not ok:
            served = out.clone()
            flat = served if served.ndim == 3 else served[None]
            for i in bad:
                flat[i] = _wrap(self._exact_conv(q64[i], kernel, shift),
                                served.dtype)
        return AbftVerdict(out=served, ok=ok, flagged_rows=bad,
                           flagged_cols=(), max_deviation=_max_dev(dev_),
                           budget=budget)

    # ------------------------------------------------------- internals --

    def _tap_columns(self, kernel, device) -> Optional[torch.Tensor]:
        """Fresh (off-cache) per-tap signed product columns, int64 on
        ``device``, when the engine multiplies approximately; None on
        the exact-product path, where ``w * sum(view)`` needs no
        table."""
        ms = self.engine.mul_spec
        if ms is None or ms.is_exact:
            return None
        from repro_torch.ax.mul.lut import _canonical, _tap_tables_nocache
        weights = tuple(int(w) for row in kernel for w in row)
        cols = _tap_tables_nocache(_canonical(ms), weights)
        return torch.from_numpy(cols.astype(np.int64)).to(device)

    @staticmethod
    def _conv_checksums(q64: torch.Tensor, kernel,
                        tap_cols: Optional[torch.Tensor]) -> torch.Tensor:
        """The exact per-image checksums of (B, H, W) ``q64``: int64
        (B,) on its device."""
        kh, kw = len(kernel), len(kernel[0])
        h, w = q64.shape[-2:]
        p = _edge_pad(q64, kh // 2, kw // 2)
        total = torch.zeros(q64.shape[0], dtype=torch.int64,
                            device=q64.device)
        t = 0
        for r, row in enumerate(kernel):
            for c, wt in enumerate(row):
                view = p[:, r:r + h, c:c + w]
                if tap_cols is None:
                    total += int(wt) * view.sum(dim=(-2, -1))
                else:
                    prods = tap_cols[t][view.abs()]
                    total += torch.where(view < 0, -prods,
                                         prods).sum(dim=(-2, -1))
                t += 1
        return total

    @staticmethod
    def _exact_conv(img: torch.Tensor, kernel, shift: int) -> torch.Tensor:
        kh, kw = len(kernel), len(kernel[0])
        h, w = img.shape
        p = _edge_pad(img, kh // 2, kw // 2)
        acc = torch.zeros((h, w), dtype=torch.int64, device=img.device)
        for r, row in enumerate(kernel):
            for c, wt in enumerate(row):
                acc += int(wt) * p[r:r + h, c:c + w]
        if shift:
            acc = (acc + (1 << (shift - 1))) >> shift
        return acc

    def _count(self, ok: bool) -> None:
        self.checks += 1
        if not ok:
            self.flags += 1
        if _obs._ENABLED:
            _metrics.counter("integrity.abft_checks").inc()
            if not ok:
                _metrics.counter("integrity.abft_flags").inc()

    def __repr__(self) -> str:
        return (f"AbftChecker({self.engine.spec.short_name}, "
                f"checks={self.checks}, flags={self.flags})")
