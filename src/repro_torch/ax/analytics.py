"""Exact closed-form error analytics for approximate adders and
multipliers (the port of ``repro.ax.analytics``).

Every LUT-compilable adder's full-sum error ``delta = approx(a, b) -
(a + b)`` is a pure function of the low ``m`` bits of each operand
(:func:`repro_torch.ax.lut.error_delta_table`).  Under uniform N-bit
operands the paper's Table-1 metrics are therefore finite expectations
over that ``2^m x 2^m`` table — computable EXACTLY, no Monte-Carlo:

.. code-block:: text

    MED  = 4^-m  * sum |delta|                 (high bits never matter)
    ER   = 4^-m  * #{delta != 0}
    WCE  = max |delta|
    NMED = MED / (2^{N+1} - 2)

MRED composes the table with the exact high-sum PMF.  Writing the
exact sum as ``S = h*2^m + l`` with ``l = a_low + b_low`` and
``h = a_high + b_high`` (independent of ``delta``), and grouping the
table by low-sum class,

.. code-block:: text

    MRED = 4^-N * sum_l  U[l] * R(l)
    U[l] = sum of |delta| over low pairs with a_low + b_low = l
    R(l) = sum_h  c(h) / (h*2^m + l)        c(h) = triangular counts
                                            (2^{N-m+1}-1 terms)

with the ``S = 0`` pair (``a = b = 0``) excluded, matching the
simulator's guard.  ``R`` is evaluated two ways:

- ``method="compose"`` — exact integer composition: scatter
  ``c(h) * U[l]`` into per-exact-sum numerators ``T[S]`` (all integer,
  overflow-free for N <= 20) and reduce ``sum_S T[S]/S`` with
  :func:`math.fsum`, which is *exactly rounded* and therefore
  order-independent: the result is BIT-IDENTICAL to brute-force
  enumeration over all ``4^N`` operand pairs reduced the same way
  (``repro_torch.core.metrics.exhaustive_error_metrics``).
- ``method="closed"`` — digamma closed form.  The triangular weights
  are piecewise linear in ``h``, so each low-sum class reduces to
  harmonic-number differences: with ``q = 2^m``, ``M = 2^{N-m}`` and
  ``x = l/q``,

  .. code-block:: text

      R(l) = 1/q + (q-l)/q^2 * (psi(M+x) - psi(x))
                 + ((2M-1)q+l)/q^2 * (psi(2M-1+x) - psi(M+x))

  (``psi`` = scipy's digamma; second moments use trigamma the same
  way).  This is what makes N=32 exact: the 2^23-term high reduction
  collapses to three special-function calls per class.

Where the work runs (``backend=``):

- ``"torch"`` (the default) — on ``device`` (``None`` is the card, and
  raises without one, naming ``device="cpu"``).  The table is built there
  (:func:`repro_torch.ax.lut.build_delta`, when ``cache_tables=False``)
  or uploaded from the host cache, and the heavy reduction — ``|delta|``,
  the nonzero count, the max and the two low-sum histograms over the
  ``4^m`` entries — runs there in int64; only the ``2^{m+1}-1`` stats
  come back.
- ``"numpy"`` — the same reduction on the host.

Both backends produce the same *integers* (integer reductions are
order-independent), and the final float composition (the numerators,
the scipy reciprocal tables, the :func:`math.fsum`) is shared host code,
so every report, the moments included, is bit-identical to the
reference's by construction.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ax.lut import (
    MAX_LUT_LSM_BITS,
    abs_error_table,
    build_delta,
    device_abs_error_table,
    error_delta_table_nocache,
    lut_supported,
)
from repro_torch.ax.registry import get_adder, registered_kinds
from repro_torch.core.metrics import (ErrorReport, MulErrorReport,
                                      analysis_device, mul_population_report)
from repro_torch.core.specs import AdderSpec
from repro_torch.obs.caches import register_lru as _register_lru

#: ``method="auto"`` composes exactly up to this width and uses the
#: digamma closed form above it (the exact path scatters into a
#: ``2^{N+1}``-entry numerator array).
MAX_COMPOSE_BITS = 16

#: Hard feasibility bound for ``method="compose"`` (int64 numerators
#: and a 2^{N+1}-entry fsum stay exact and affordable to here).
_COMPOSE_LIMIT_BITS = 20

_METHODS = ("auto", "compose", "closed")

#: Where the table reduction runs.
BACKENDS = ("torch", "numpy")


@dataclasses.dataclass(frozen=True)
class ErrorMoments:
    """First and second exact moments of the error distributions.

    ``var_ed`` / ``var_red`` are the per-sample variances of ``|ED|``
    and ``|ED|/S`` under uniform operands — what a Monte-Carlo run's
    mean estimator fluctuates with (``sigma/sqrt(n)``).
    """

    spec: AdderSpec
    med: float
    mred: float
    nmed: float
    error_rate: float
    wce: int
    var_ed: float
    var_red: float


@dataclasses.dataclass(frozen=True)
class _LowStats:
    """Exact integer aggregates of one ``2^m x 2^m`` delta table (``u2``
    only when second moments are asked for)."""

    sum_abs: int                    # sum |delta|
    n_err: int                      # #{delta != 0}
    wce: int                        # max |delta|
    u1: np.ndarray                  # int64[2^{m+1}-1]: sum |delta| per l
    u2: Optional[np.ndarray] = None  # int64[...]: sum delta^2 per l


def analytics_supported(spec: AdderSpec) -> bool:
    """Whether ``spec`` has exact closed-form metrics (same reach as the
    LUT strategy: every kind, ``lsm_bits <= MAX_LUT_LSM_BITS``)."""
    return lut_supported(spec)


def _spectrum_scan(values: np.ndarray, m: int) -> np.ndarray:
    """``U[l] = sum of values over table entries with a_low+b_low = l``.

    The padded-reshape trick: writing the ``2^m x 2^m`` table into the
    left half of a ``2^m x 2^{m+1}`` zero buffer and re-viewing the
    flat buffer with row length ``2^{m+1}-1`` shifts row ``a`` left by
    ``a``, so the antidiagonals line up as COLUMNS — one sequential
    axis-0 reduction instead of a scatter.  Exact: int64 accumulation.
    """
    q = 1 << m
    x = np.zeros((q, 2 * q), dtype=np.int32)
    x[:, :q] = values.reshape(q, q)
    z = x.ravel()[:q * (2 * q - 1)].reshape(q, 2 * q - 1)
    return z.sum(axis=0, dtype=np.int64)


def _low_stats_numpy(d: np.ndarray, m: int, moments: bool) -> _LowStats:
    u1 = _spectrum_scan(d, m)
    u2 = None
    if moments:
        d32 = d.astype(np.int32)
        u2 = _spectrum_scan(d32 * d32, m)  # delta^2 < 2^{2m+2} fits int32
    return _LowStats(
        sum_abs=int(u1.sum()),
        n_err=int(np.count_nonzero(d)), wce=int(d.max(initial=0)),
        u1=u1, u2=u2)


def _spectrum_scan_torch(values: torch.Tensor, m: int) -> torch.Tensor:
    """:func:`_spectrum_scan` on the device (the same padded reshape; an
    int32 buffer, an int64 column sum)."""
    q = 1 << m
    x = values.new_zeros((q, 2 * q))
    x[:, :q] = values.view(q, q)
    z = x.view(-1)[:q * (2 * q - 1)].view(q, 2 * q - 1)
    return z.sum(dim=0, dtype=torch.int64)


def _low_stats_torch(d: torch.Tensor, m: int, moments: bool) -> _LowStats:
    """The table reduction on ``d``'s device (int32 ``|delta|``): the
    low-sum spectra, the nonzero count and the max, copied back in one
    transfer of ``2^{m+1}+1`` (or ``2^{m+2}``) int64 values."""
    parts = [_spectrum_scan_torch(d, m)]
    if moments:
        parts.append(_spectrum_scan_torch(d * d, m))  # < 2^{2m+2}
    parts.append(torch.stack([torch.count_nonzero(d),
                              d.max().to(torch.int64)]))
    host = torch.cat(parts).cpu().numpy()
    nb = 2 * (1 << m) - 1
    u1 = host[:nb]
    u2 = host[nb:2 * nb] if moments else None
    return _LowStats(sum_abs=int(u1.sum()), n_err=int(host[-2]),
                     wce=int(host[-1]), u1=u1, u2=u2)


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown analytics backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    return backend


def _low_stats(spec: AdderSpec, backend: str, cache_tables: bool,
               device: Optional[torch.device],
               moments: bool = False) -> _LowStats:
    # |delta| is all the stats need: the cached view shares the LUT cache
    # with the Monte-Carlo fast path; transient builds (breadth sweeps)
    # take the |.| of a throwaway delta table.
    if backend == "numpy":
        d = (abs_error_table(spec) if cache_tables
             else np.abs(error_delta_table_nocache(spec)))
        return _low_stats_numpy(d, spec.lsm_bits, moments)
    d = (device_abs_error_table(spec, device) if cache_tables
         else build_delta(spec, device).abs())
    return _low_stats_torch(d, spec.lsm_bits, moments)


def _high_counts(n_bits: int, m: int) -> np.ndarray:
    """Triangular high-sum counts ``c(h) = #{(a_h, b_h): a_h+b_h = h}``."""
    big = 1 << (n_bits - m)
    h = np.arange(2 * big - 1, dtype=np.int64)
    return np.where(h < big, h + 1, 2 * big - 1 - h)


@functools.lru_cache(maxsize=None)
def _reciprocal_tables(n_bits: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """``R1(l) = sum_h c(h)/(h*q+l)`` and ``R2(l) = sum_h c(h)/(h*q+l)^2``
    in closed form (digamma/trigamma; module docstring), ``l = 0``
    excluding the ``S = 0`` term.  float64, read-only, cached per
    (N, m) — shared by every kind and k."""
    from scipy.special import digamma, polygamma
    q = float(1 << m)
    big = float(1 << (n_bits - m))
    top = 2.0 * big - 1.0
    l = np.arange(1, 2 * (1 << m) - 1, dtype=np.float64)
    x = l / q
    ps_x, ps_mx, ps_tx = digamma(x), digamma(big + x), digamma(top + x)
    pg_x, pg_mx, pg_tx = (polygamma(1, x), polygamma(1, big + x),
                          polygamma(1, top + x))
    r1 = (1.0 / q
          + (q - l) / q ** 2 * (ps_mx - ps_x)
          + (top * q + l) / q ** 2 * (ps_tx - ps_mx))
    r2 = ((ps_mx - ps_x) / q ** 2
          + (q - l) / q ** 3 * (pg_x - pg_mx)
          + (top * q + l) / q ** 3 * (pg_mx - pg_tx)
          - (ps_tx - ps_mx) / q ** 2)
    # l = 0: harmonic forms H_n = psi(n+1) + gamma (the gammas cancel;
    # written out so M = 1, where the sums are empty, degrades to 0).
    g = np.euler_gamma

    def hsum(n):          # H_n
        return digamma(n + 1.0) + g

    def h2sum(n):         # sum_{i<=n} 1/i^2
        return polygamma(1, 1.0) - polygamma(1, n + 1.0)

    r1_0 = (hsum(big - 1) + top * (hsum(top - 1) - hsum(big - 1))) / q
    r2_0 = (hsum(big - 1) + h2sum(big - 1)
            + top * (h2sum(top - 1) - h2sum(big - 1))
            - (hsum(top - 1) - hsum(big - 1))) / q ** 2
    r1 = np.concatenate([[r1_0], r1])
    r2 = np.concatenate([[r2_0], r2])
    r1.flags.writeable = False
    r2.flags.writeable = False
    return r1, r2


_register_lru("ax.analytics.reciprocals", _reciprocal_tables)


def _compose_numerators(u: np.ndarray, n_bits: int, m: int) -> np.ndarray:
    """Exact per-exact-sum numerators ``T[S] = sum_h c(h) * u[S - h*q]``
    (the triangular convolution, int64, strided scatter)."""
    q = 1 << m
    cnt = _high_counts(n_bits, m)
    t = np.zeros((cnt.size - 1) * q + u.size, dtype=np.int64)
    for l in range(u.size):
        if u[l]:
            t[l:l + cnt.size * q:q] += cnt * int(u[l])
    return t


def _ratio_sum_compose(u: np.ndarray, n_bits: int, m: int,
                       power: int) -> float:
    """``sum_{S>=1} T[S]/S^power`` with an exactly-rounded fsum."""
    t = _compose_numerators(u, n_bits, m)
    s = np.arange(t.size, dtype=np.float64)
    nz = np.flatnonzero(t[1:] != 0) + 1
    return math.fsum((t[nz] / s[nz] ** power).tolist())


def _ratio_sum_closed(u: np.ndarray, n_bits: int, m: int,
                      power: int) -> float:
    r = _reciprocal_tables(n_bits, m)[power - 1]
    return math.fsum((u * r).tolist())


def _resolve_method(method: str, n_bits: int) -> str:
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{_METHODS}")
    if method == "auto":
        return "compose" if n_bits <= MAX_COMPOSE_BITS else "closed"
    if method == "compose" and n_bits > _COMPOSE_LIMIT_BITS:
        raise ValueError(
            f"method='compose' needs n_bits <= {_COMPOSE_LIMIT_BITS} "
            f"(2^{n_bits + 1}-entry numerator array); use 'closed'")
    return method


def _ratio_sum(u: np.ndarray, n_bits: int, m: int, method: str,
               power: int = 1) -> float:
    if method == "compose":
        return _ratio_sum_compose(u, n_bits, m, power)
    return _ratio_sum_closed(u, n_bits, m, power)


def _check_spec(spec: AdderSpec) -> None:
    if not analytics_supported(spec):
        raise ValueError(
            f"no exact analytics for {spec.short_name}: lsm_bits="
            f"{spec.lsm_bits} > MAX_LUT_LSM_BITS={MAX_LUT_LSM_BITS} has "
            f"no compilable delta table; use the Monte-Carlo simulator")


def _zero_report(spec: AdderSpec) -> ErrorReport:
    return ErrorReport(spec=spec, n_samples=4 ** spec.n_bits, med=0.0,
                       mred=0.0, nmed=0.0, error_rate=0.0, wce=0,
                       exact=True)


def _reduction_device(backend: str, device) -> Optional[torch.device]:
    """The device the ``"torch"`` backend reduces on (the card for
    ``None``); the host backend has none."""
    if _check_backend(backend) == "numpy":
        return None
    return analysis_device(device)


def exact_error_metrics(
    spec: AdderSpec,
    backend: str = "torch",
    method: str = "auto",
    cache_tables: bool = True,
    device=None,
) -> ErrorReport:
    """Exact MED/MRED/NMED/ER/WCE under uniform operands (no sampling).

    Returns the same :class:`~repro_torch.core.metrics.ErrorReport` rows
    as the Monte-Carlo simulator, with ``exact=True`` and ``n_samples``
    equal to the full population ``4^N``.  ``backend`` picks where the
    ``4^m``-entry table reduction runs (``"torch"`` on ``device``, or
    ``"numpy"`` on the host — bit-identical).  ``method`` picks the MRED
    reduction (module docstring); ``"auto"`` composes exactly for
    ``N <= MAX_COMPOSE_BITS`` (16) and uses the digamma closed form
    above.  With ``cache_tables=False`` the delta table is built
    transiently (on the device, for ``"torch"``).
    """
    dev = _reduction_device(backend, device)
    if get_adder(spec.kind).is_exact:
        return _zero_report(spec)
    _check_spec(spec)
    method = _resolve_method(method, spec.n_bits)
    stats = _low_stats(spec, backend, cache_tables, dev)
    return _report_from_stats(spec, stats, method)


def _report_from_stats(spec: AdderSpec, stats: _LowStats,
                       method: str) -> ErrorReport:
    n, m = spec.n_bits, spec.lsm_bits
    pop = float(4 ** n)
    # med/er: exact integers scaled by the 4^{N-m} high multiplicity,
    # then ONE correctly-rounded float division — bit-for-bit what the
    # brute-force enumeration computes.
    mult = 4 ** (n - m)
    med = float(stats.sum_abs * mult) / pop
    mred = _ratio_sum(stats.u1, n, m, method) / pop
    max_out = float((1 << (n + 1)) - 2)
    return ErrorReport(
        spec=spec, n_samples=4 ** n, med=med, mred=mred,
        nmed=med / max_out,
        error_rate=float(stats.n_err * mult) / pop,
        wce=stats.wce, exact=True)


def exact_error_moments(
    spec: AdderSpec,
    backend: str = "torch",
    method: str = "auto",
    cache_tables: bool = True,
    device=None,
) -> ErrorMoments:
    """Exact metrics plus per-sample variances of ``|ED|`` and ``|ED|/S``.

    The second moments come from the same machinery with squared
    weights/reciprocals (``U2[l] = sum delta^2``, ``R2(l) = sum
    c(h)/S^2``); they put exact error bars on any Monte-Carlo run
    (``sigma/sqrt(n)``).
    """
    dev = _reduction_device(backend, device)
    if get_adder(spec.kind).is_exact:
        return ErrorMoments(spec=spec, med=0.0, mred=0.0, nmed=0.0,
                            error_rate=0.0, wce=0, var_ed=0.0, var_red=0.0)
    _check_spec(spec)
    method = _resolve_method(method, spec.n_bits)
    stats = _low_stats(spec, backend, cache_tables, dev, moments=True)
    rep = _report_from_stats(spec, stats, method)
    n, m = spec.n_bits, spec.lsm_bits
    pop = float(4 ** n)
    ed2 = float(int(stats.u2.sum()) * 4 ** (n - m)) / pop
    red2 = _ratio_sum(stats.u2, n, m, method, power=2) / pop
    return ErrorMoments(
        spec=spec, med=rep.med, mred=rep.mred, nmed=rep.nmed,
        error_rate=rep.error_rate, wce=rep.wce,
        var_ed=max(ed2 - rep.med ** 2, 0.0),
        var_red=max(red2 - rep.mred ** 2, 0.0))


def exact_error_metrics_sweep(
    specs: Iterable[AdderSpec],
    backend: str = "torch",
    method: str = "auto",
    cache_tables: bool = True,
    device=None,
) -> List[ErrorReport]:
    """Exact reports for MANY specs — any mix of kinds AND widths.

    Low stats are memoized *within the call* under the table identity
    ``(kind, m, k)``: an N in {8, 16, 32} design-space sweep reduces
    each table once, whatever ``cache_tables`` says.
    """
    dev = _reduction_device(backend, device)
    memo: Dict[Tuple[str, int, int], _LowStats] = {}
    out = []
    for spec in specs:
        if get_adder(spec.kind).is_exact:
            out.append(_zero_report(spec))
            continue
        _check_spec(spec)
        key = (spec.kind, spec.lsm_bits, spec.effective_const_bits)
        if key not in memo:
            memo[key] = _low_stats(spec, backend, cache_tables, dev)
        out.append(_report_from_stats(
            spec, memo[key], _resolve_method(method, spec.n_bits)))
    return out


def design_space(
    n_bits: Sequence[int] = (8, 16, 32),
    kinds: Optional[Sequence[str]] = None,
    max_lsm: Optional[int] = None,
    include_exact: bool = True,
) -> Tuple[AdderSpec, ...]:
    """Every analytics-supported configuration: registered kinds x
    widths x all valid (m, k) partitions (m capped at ``max_lsm``,
    default ``MAX_LUT_LSM_BITS``) — the Fig-6 sweep's input."""
    if kinds is None:
        kinds = registered_kinds()
    cap = MAX_LUT_LSM_BITS if max_lsm is None else max_lsm
    out = []
    for n in n_bits:
        for kind in kinds:
            entry = get_adder(kind)
            if entry.is_exact:
                if include_exact:
                    out.append(AdderSpec(kind=kind, n_bits=n))
                continue
            for m in range(entry.min_lsm_bits, min(n, cap) + 1):
                ks = (range(0, m - entry.const_margin + 1)
                      if entry.const_section else (0,))
                for k in ks:
                    out.append(AdderSpec(kind=kind, n_bits=n, lsm_bits=m,
                                         const_bits=k))
    return tuple(out)


# ===================================================== multipliers ====
#
# A multiplier's error delta is NOT a pure function of operand low bits
# in general, so two exact methods instead:
#
# * ``method="compose"`` (N <= MAX_MUL_COMPOSE_BITS): reduce the full
#   4^N delta table through the SAME canonical population reduction as
#   brute-force enumeration (repro_torch.core.metrics.
#   mul_population_report) — bit-identical to
#   ``exhaustive_mul_error_metrics`` by construction.  The table is built
#   on the device (or uploaded from the host cache) and reduced there.
#
# * ``method="closed"``: for the *low-delta* kinds (truncated always;
#   broken_array when row_bits == 0) the delta IS a pure function of
#   ``(a mod 2^t, b mod 2^t)`` with ``t = trunc_bits``, and the product
#   reference FACTORIZES:
#
#       MRED = 4^-N * sum_{al,bl} |d(al,bl)| * R(al) * R(bl)
#       R(l) = sum_{h: h*q+l != 0} 1/(h*q+l)
#            = (psi(M + l/q) - psi(l/q)) / q      for l >= 1
#            = H_{M-1} / q                        for l == 0
#
#   with q = 2^t, M = 2^{N-t} high values per operand.  The 4^t low
#   table and its terms are computed on the device, the reciprocals and
#   the fsum on the host.


#: ``method="auto"`` composes the full delta table up to this operand
#: width (a 4^12 = 16M-entry pass) and uses the factorized closed form
#: above it.
MAX_MUL_COMPOSE_BITS = 12


def _mul_entry(kind: str):
    from repro_torch.ax.mul.registry import get_multiplier
    return get_multiplier(kind)


def _mul_closed_bits(spec) -> Optional[int]:
    """The low-delta width ``t`` when the closed form applies, else
    None.  ``t = 0`` means the spec is errorless."""
    entry = _mul_entry(spec.kind)
    if entry.is_exact:
        return 0
    if entry.low_delta and spec.effective_row_bits == 0:
        return spec.effective_trunc_bits
    return None


def mul_analytics_supported(spec) -> bool:
    """Whether exact analytics exist for ``spec`` (any kind up to the
    compose width; low-delta kinds at any supported width)."""
    if spec.n_bits <= MAX_MUL_COMPOSE_BITS:
        return True
    t = _mul_closed_bits(spec)
    return t is not None and t <= MAX_MUL_COMPOSE_BITS


def _zero_mul_report(spec) -> MulErrorReport:
    return MulErrorReport(spec=spec, n_samples=4 ** spec.n_bits, med=0.0,
                          mred=0.0, nmed=0.0, error_rate=0.0, wce=0,
                          exact=True)


def _mul_low_abs_table(spec, t: int, device: torch.device) -> torch.Tensor:
    """``|d(al, bl)|`` over the 2^t x 2^t low-operand grid (int64, (q, q),
    row-major in ``al``) on ``device`` — the impls evaluated directly on
    the low values (valid because the delta only depends on them)."""
    vals = torch.arange(1 << t, dtype=torch.int64, device=device)
    a, b = vals[:, None], vals[None, :]
    return (_mul_entry(spec.kind).impl(a, b, spec) - a * b).abs()


@functools.lru_cache(maxsize=None)
def _mul_reciprocals(n_bits: int, t: int) -> np.ndarray:
    """``R(l) = sum_{h=0}^{M-1} 1/(h*2^t + l)`` for each low residue
    ``l``, the h = 0 term dropped at l = 0 (digamma closed form;
    float64, read-only, cached per (N, t))."""
    from scipy.special import digamma
    q = float(1 << t)
    big = float(1 << (n_bits - t))
    l = np.arange(1, 1 << t, dtype=np.float64)
    r = (digamma(big + l / q) - digamma(l / q)) / q
    # l = 0: H_{M-1}/q (harmonic form; M = 1 degrades to 0).
    r0 = (digamma(big) + np.euler_gamma) / q
    r = np.concatenate([[r0], r])
    r.flags.writeable = False
    return r


_register_lru("ax.analytics.mul_reciprocals", _mul_reciprocals)


def _mul_compose_report(spec, cache_tables: bool, device: torch.device):
    from repro_torch.ax.mul.lut import build_mul_delta, mul_error_delta_table
    table = (torch.from_numpy(mul_error_delta_table(spec).copy()).to(device)
             if cache_tables else build_mul_delta(spec, device))
    ed = table.to(torch.int64).abs()
    vals = torch.arange(1 << spec.n_bits, dtype=torch.int64, device=device)
    s = (vals[:, None] * vals[None, :]).reshape(-1)
    return mul_population_report(spec, ed, s)


def _mul_closed_report(spec, t: int, device: torch.device):
    n = spec.n_bits
    low = _mul_low_abs_table(spec, t, device)
    mult = 4 ** (n - t)
    pop = 4 ** n
    r = torch.from_numpy(_mul_reciprocals(n, t).copy()).to(device)
    # (low * R(al)) * R(bl): the reference's float64 products, in its
    # order; their exactly-rounded fsum over the nonzero entries.
    terms = low * r[:, None] * r[None, :]
    nz = low != 0
    total, n_err, wce = torch.stack([low.sum(), nz.sum(),
                                     low.max()]).cpu().tolist()
    med = float(total * mult) / float(pop)
    mred = math.fsum(terms[nz].cpu().tolist()) / float(pop)
    return MulErrorReport(
        spec=spec,
        n_samples=pop,
        med=med,
        mred=mred,
        nmed=med / float(((1 << n) - 1) ** 2),
        error_rate=float(n_err * mult) / float(pop),
        wce=wce,
        exact=True,
    )


def _resolve_mul_method(method: str, spec) -> str:
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{_METHODS}")
    if method == "auto":
        method = ("compose" if spec.n_bits <= MAX_MUL_COMPOSE_BITS
                  else "closed")
    if method == "compose" and spec.n_bits > MAX_MUL_COMPOSE_BITS:
        raise ValueError(
            f"method='compose' needs n_bits <= {MAX_MUL_COMPOSE_BITS} "
            f"(4^N delta-table pass); use 'closed'")
    if method == "closed":
        t = _mul_closed_bits(spec)
        if t is None:
            raise ValueError(
                f"no closed form for {spec.short_name}: the delta is "
                f"not a pure function of operand low bits (only the "
                f"low-delta kinds factorize); use 'compose'")
        if t > MAX_MUL_COMPOSE_BITS:
            raise ValueError(
                f"closed form needs trunc_bits <= {MAX_MUL_COMPOSE_BITS} "
                f"(4^t low-table pass), got {t}")
    return method


def exact_mul_error_metrics(spec, method: str = "auto",
                            cache_tables: bool = True, device=None):
    """Exact MED/MRED/NMED/ER/WCE for one multiplier spec, on ``device``
    (``None`` is the card).

    ``method="compose"`` is bit-identical to
    :func:`repro_torch.core.metrics.exhaustive_mul_error_metrics` (shared
    canonical reduction); ``method="closed"`` agrees with it to float64
    rounding of the digamma evaluations and scales to widths where
    enumeration is infeasible.
    """
    dev = analysis_device(device)
    if _mul_entry(spec.kind).is_exact:
        return _zero_mul_report(spec)
    method = _resolve_mul_method(method, spec)
    if method == "compose":
        return _mul_compose_report(spec, cache_tables, dev)
    t = _mul_closed_bits(spec)
    if t == 0:
        return _zero_mul_report(spec)
    return _mul_closed_report(spec, t, dev)


def exact_mul_error_metrics_sweep(specs, method: str = "auto",
                                  cache_tables: bool = True, device=None):
    """Exact reports for many multiplier specs, memoized per canonical
    table identity within the call (mirrors
    :func:`exact_error_metrics_sweep`)."""
    from repro_torch.ax.mul.lut import _canonical
    dev = analysis_device(device)
    memo: Dict[object, object] = {}
    out = []
    for spec in specs:
        key = (_canonical(spec), method)
        if key not in memo:
            memo[key] = exact_mul_error_metrics(
                spec, method=method, cache_tables=cache_tables, device=dev)
        rep = memo[key]
        if rep.spec is not spec:
            rep = dataclasses.replace(rep, spec=spec)
        out.append(rep)
    return out


def mul_design_space(
    n_bits: Sequence[int] = (8,),
    kinds: Optional[Sequence[str]] = None,
    include_exact: bool = True,
) -> tuple:
    """Every analytics-supported multiplier configuration: registered
    kinds x widths x valid (trunc, rows) knob settings, duplicates
    pruned (a broken array with ``trunc <= rows`` is the same hardware
    as ``trunc = 0``)."""
    from repro_torch.ax.mul.registry import (get_multiplier,
                                             registered_multipliers)
    from repro_torch.ax.mul.specs import MulSpec
    if kinds is None:
        kinds = registered_multipliers()
    out = []
    for n in n_bits:
        for kind in kinds:
            entry = get_multiplier(kind)
            if entry.is_exact:
                if include_exact:
                    out.append(MulSpec(kind=kind, n_bits=n))
                continue
            if entry.uses_rows:
                for v in range(n + 1):
                    for t in range(n + 1):
                        if (t and t <= v) or (t == 0 and v == 0):
                            continue
                        spec = MulSpec(kind=kind, n_bits=n, trunc_bits=t,
                                       row_bits=v)
                        if mul_analytics_supported(spec):
                            out.append(spec)
            elif entry.uses_trunc:
                lo = 0 if entry.trunc_margin else 1
                for t in range(lo, n + 1 - entry.trunc_margin):
                    spec = MulSpec(kind=kind, n_bits=n, trunc_bits=t)
                    if mul_analytics_supported(spec):
                        out.append(spec)
            else:
                spec = MulSpec(kind=kind, n_bits=n)
                if mul_analytics_supported(spec):
                    out.append(spec)
    return tuple(out)
