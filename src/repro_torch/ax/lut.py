"""Compiled lookup tables for approximate-adder low parts (the port of
``repro.ax.lut``).

Every registered adder's approximate section is a pure function of the
low ``m`` bits of each operand: the LSM sum bits plus the speculated
carry into the exact MSM.  For a given :class:`AdderSpec` that is a
``2^m x 2^m`` truth table, so the ``"lut"`` strategy of the elementwise
add

1. gathers one packed entry ``low_bits | cin << m`` (uint16), and
2. runs one exact high-part add ``((a >> m) + (b >> m)) << m``.

:func:`compile_lut` builds that table once per canonical spec by
evaluating the registered *reference* implementation on low-bits-only
operands (the high parts are zero, so the returned "high sum" is exactly
the carry); :func:`device_table` keeps one tensor copy of it per
(canonical spec, device), so no call builds or uploads a table.

:func:`error_delta_table` derives the signed full-sum error
``approx(a, b) - (a + b)`` (a pure function of the same low bits), which
turns error analysis into one gather and an ``abs``;
:func:`build_delta` builds that table on a device, for the exact
analytics of :mod:`repro_torch.ax.analytics`.

Tables are ``2^{2m}`` entries: m=10, the paper's N=32 partition, is a
2 MiB table; the N=16 image datapath's m=8 is 128 KiB.
:data:`MAX_LUT_LSM_BITS` caps compilation at m=12 (32 MiB); wider LSMs
must use the reference or fused strategies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.ax.registry import get_adder
from repro_torch.core.specs import AdderSpec
from repro_torch.integrity.digests import record_golden as _record_golden
from repro_torch.integrity.digests import record_upload as _record_upload
from repro_torch.obs.caches import register_lru as _register_lru

#: Widest LSM the LUT strategy compiles (2^{2m} uint16 entries).
MAX_LUT_LSM_BITS = 12


def lut_supported(spec: AdderSpec) -> bool:
    """Whether ``spec`` has a compilable LUT (exact kinds need none)."""
    if get_adder(spec.kind).is_exact:
        return True  # strategy degrades to the exact add, no table
    return spec.lsm_bits <= MAX_LUT_LSM_BITS


def _validate_lut_spec(spec: AdderSpec) -> None:
    if get_adder(spec.kind).is_exact:
        raise ValueError(
            f"{spec.kind!r} is exact; the lut strategy uses the plain add")
    if spec.lsm_bits > MAX_LUT_LSM_BITS:
        raise ValueError(
            f"lsm_bits={spec.lsm_bits} exceeds MAX_LUT_LSM_BITS="
            f"{MAX_LUT_LSM_BITS} (2^{2 * spec.lsm_bits} entries); use the "
            f"reference or fused strategy")


def _canonical(spec: AdderSpec) -> AdderSpec:
    """``spec`` reduced to the table identity ``(kind, m, effective k)``.

    Every registered impl adds the high parts (bits >= m) exactly, so the
    table built from low-bits-only operands cannot depend on N, and kinds
    without a constant section ignore ``const_bits``: N=8/16/32 specs
    share one table per (kind, m, k)."""
    k = spec.effective_const_bits
    if spec.n_bits != spec.lsm_bits or spec.const_bits != k:
        return spec.replace(n_bits=spec.lsm_bits, const_bits=k)
    return spec


def _build_packed(spec: AdderSpec) -> np.ndarray:
    """Uncached table build (see :func:`compile_lut` for the contract)."""
    _validate_lut_spec(spec)
    m = spec.lsm_bits
    # uint32 lanes: every intermediate of the reference impls fits in
    # m+2 <= 14 bits here.
    vals = np.arange(1 << m, dtype=np.uint32)
    a = np.repeat(vals, 1 << m)
    b = np.tile(vals, 1 << m)
    # With zero high parts the reference impl returns (cin << m) | low:
    # exactly the packed entry.  cin <= 1 and low < 2^m, so m <= 15 fits
    # uint16 (guaranteed by MAX_LUT_LSM_BITS).
    packed = get_adder(spec.kind).impl(a, b, spec).astype(np.uint16)
    packed.flags.writeable = False
    return packed


@functools.lru_cache(maxsize=None)
def _compile_canonical(spec: AdderSpec) -> np.ndarray:
    from repro_torch.integrity.store import cache_get, cache_put
    table = cache_get("ax.lut.packed", spec)
    if table is None:
        table = _build_packed(spec)
        cache_put("ax.lut.packed", spec, table)
    return _record_golden("ax.lut.packed", (spec,), table,
                          functools.partial(_build_packed, spec))


_register_lru("ax.lut.packed", _compile_canonical)


def compile_lut(spec: AdderSpec) -> np.ndarray:
    """The packed low-part table for ``spec``: a read-only uint16 array of
    ``2^{2m}`` entries indexed by ``(a_low << m) | b_low``; each entry
    packs ``low_bits | cin << m``, which, read as an integer, IS the
    approximate sum of the two low parts.  Cached per canonical spec: the
    same (kind, m, k) always yields the same array object.

    Every compile registers the table's golden content digest with
    :mod:`repro_torch.integrity.digests` (the scrubber's detection source)
    and, when the persistent compile cache is active, loads/publishes the
    table through :mod:`repro_torch.integrity.store` — a verified disk
    hit replaces the build; a corrupt or stale entry silently falls back
    to recompilation."""
    _validate_lut_spec(spec)
    return _compile_canonical(_canonical(spec))


def compile_lut_nocache(spec: AdderSpec) -> np.ndarray:
    """Like :func:`compile_lut` but built transiently, NOT cached: the
    fault injector (:mod:`repro_torch.resilience.faults`) corrupts a copy
    of it, and building off-cache keeps the shared table (and its device
    copies) clean."""
    return _build_packed(_canonical(spec))


def _upload_packed(table: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(table.view(np.int16).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _device_table(spec: AdderSpec, device: torch.device) -> torch.Tensor:
    return _record_upload(
        "ax.lut.device", (spec, device), "ax.lut.packed", (spec,),
        compile_lut(spec), lambda t: _upload_packed(t, device),
        functools.partial(_build_packed, spec))


_register_lru("ax.lut.device", _device_table)


def device_table(spec: AdderSpec, device) -> torch.Tensor:
    """:func:`compile_lut` as an int16 tensor on ``device`` holding the
    uint16 pattern (readers mask with ``0xFFFF``), built once per
    (canonical spec, device) and registered as a golden entry whose
    digest is the host table's (a scrub repairs it in place)."""
    _validate_lut_spec(spec)
    return _device_table(_canonical(spec), torch.device(device))


# ------------------------------------------------------- error tables --

def _delta_from_packed(packed: np.ndarray, m: int) -> np.ndarray:
    vals = np.arange(1 << m, dtype=np.int64)
    exact = (vals[:, None] + vals[None, :]).reshape(-1)
    delta = (packed.astype(np.int64) - exact).astype(np.int32)
    delta.flags.writeable = False
    return delta


def _build_delta(spec: AdderSpec) -> np.ndarray:
    """Off-cache delta rebuild (the scrubber's repair source — built from
    a FRESH packed table so a corrupted cached one cannot leak into the
    repair)."""
    return _delta_from_packed(_build_packed(spec), spec.lsm_bits)


def _build_abs_error(spec: AdderSpec) -> np.ndarray:
    ed = np.abs(_build_delta(spec)).astype(np.uint16)
    ed.flags.writeable = False
    return ed


@functools.lru_cache(maxsize=None)
def _delta_canonical(spec: AdderSpec) -> np.ndarray:
    delta = _delta_from_packed(_compile_canonical(spec), spec.lsm_bits)
    return _record_golden("ax.lut.delta", (spec,), delta,
                          functools.partial(_build_delta, spec))


_register_lru("ax.lut.delta", _delta_canonical)


def error_delta_table(spec: AdderSpec) -> np.ndarray:
    """Signed full-sum error ``approx(a, b) - (a + b)`` per low-bit pair.

    The exact and approximate sums share the high parts (up to the
    speculated carry, which the packed entry already contains), so the
    error of the FULL add is this table gathered at
    ``(a_low << m) | b_low``.  int32, read-only, cached per canonical
    spec (shared across ``n_bits``, like :func:`compile_lut`)."""
    _validate_lut_spec(spec)
    return _delta_canonical(_canonical(spec))


def error_delta_table_nocache(spec: AdderSpec) -> np.ndarray:
    """Like :func:`error_delta_table` but built transiently, NOT cached:
    breadth sweeps reduce each table to a handful of scalars, and caching
    every table would pin gigabytes (an m=12 delta table is 64 MiB)."""
    canon = _canonical(spec)
    return _delta_from_packed(_build_packed(canon), canon.lsm_bits)


@functools.lru_cache(maxsize=None)
def _abs_error_canonical(spec: AdderSpec) -> np.ndarray:
    ed = np.abs(_delta_canonical(spec)).astype(np.uint16)
    ed.flags.writeable = False
    return _record_golden("ax.lut.abs_error", (spec,), ed,
                          functools.partial(_build_abs_error, spec))


_register_lru("ax.lut.abs_error", _abs_error_canonical)


def abs_error_table(spec: AdderSpec) -> np.ndarray:
    """``|approx(a, b) - (a + b)|`` per low-bit pair, uint16, read-only:
    the unsigned view of :func:`error_delta_table` (|delta| < 2^{m+1}
    fits uint16 for every compilable m)."""
    _validate_lut_spec(spec)
    return _abs_error_canonical(_canonical(spec))


def _upload_abs_error(table: np.ndarray,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(table.astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _device_abs_error(spec: AdderSpec, device: torch.device) -> torch.Tensor:
    return _record_upload(
        "ax.lut.device_abs_error", (spec, device), "ax.lut.abs_error",
        (spec,), _abs_error_canonical(spec),
        lambda t: _upload_abs_error(t, device),
        functools.partial(_build_abs_error, spec))


_register_lru("ax.lut.device_abs_error", _device_abs_error)


def device_abs_error_table(spec: AdderSpec, device) -> torch.Tensor:
    """:func:`abs_error_table` as an int32 tensor on ``device``, uploaded
    once per (canonical spec, device): the Monte-Carlo lut strategy
    gathers from it, and the cached analytics reduce it."""
    _validate_lut_spec(spec)
    return _device_abs_error(_canonical(spec), torch.device(device))


def build_delta(spec: AdderSpec, device) -> torch.Tensor:
    """:func:`error_delta_table` built on ``device``, not cached: the
    registered reference impl evaluated on int64 lanes of the ``2^m x
    2^m`` low grid (a broadcast pair of ``arange`` columns), the packed
    entry masked to its uint16 pattern, minus the exact low sum.  An
    int32 tensor of ``4^m`` entries, equal bit for bit to the host build
    (the analytics' transient tables)."""
    _validate_lut_spec(spec)
    canon = _canonical(spec)
    vals = torch.arange(1 << canon.lsm_bits, dtype=torch.int64,
                        device=torch.device(device))
    a, b = vals[:, None], vals[None, :]
    packed = get_adder(canon.kind).impl(a, b, canon) & 0xFFFF
    return (packed - (a + b)).to(torch.int32).reshape(-1)


# ---------------------------------------------------- gathers and adds --

def lut_index(a, b, spec: AdderSpec):
    """Gather index ``(a_low << m) | b_low`` (arrays or tensors)."""
    m = spec.lsm_bits
    low = (1 << m) - 1
    return ((a & low) << m) | (b & low)


def lut_gather_full(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
                    spec: AdderSpec) -> torch.Tensor:
    """THE lut add on int64 lanes, full width: one gather from the int16
    ``table`` (:func:`device_table`, masked back to its uint16 pattern:
    the approximate low sum, carry included) and one exact add of the
    high parts above bit m."""
    m = spec.lsm_bits
    entry = torch.take(table, lut_index(a, b, spec)).to(torch.int64) & 0xFFFF
    return (((a >> m) + (b >> m)) << m) + entry


def lut_add_full(a: torch.Tensor, b: torch.Tensor,
                 spec: AdderSpec) -> torch.Tensor:
    """Full (N+1)-bit approximate sum via the table, on int64 lanes holding
    N-bit unsigned values (N <= 63: the high-part shifts read operands,
    below 2^63), on any device."""
    return lut_gather_full(a, b, device_table(spec, a.device), spec)


def lut_add_mod(a: torch.Tensor, b: torch.Tensor,
                spec: AdderSpec) -> torch.Tensor:
    """LUT add reduced mod 2^N (same contract as ``approx_add_mod``)."""
    return lut_add_full(a, b, spec) & ((1 << spec.n_bits) - 1)
