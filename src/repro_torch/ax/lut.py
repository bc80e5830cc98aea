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
    return _build_packed(spec)


def compile_lut(spec: AdderSpec) -> np.ndarray:
    """The packed low-part table for ``spec``: a read-only uint16 array of
    ``2^{2m}`` entries indexed by ``(a_low << m) | b_low``; each entry
    packs ``low_bits | cin << m``, which, read as an integer, IS the
    approximate sum of the two low parts.  Cached per canonical spec: the
    same (kind, m, k) always yields the same array object."""
    _validate_lut_spec(spec)
    return _compile_canonical(_canonical(spec))


@functools.lru_cache(maxsize=None)
def _device_table(spec: AdderSpec, device: torch.device) -> torch.Tensor:
    table = compile_lut(spec)
    return torch.from_numpy(table.view(np.int16).copy()).to(device)


def device_table(spec: AdderSpec, device) -> torch.Tensor:
    """:func:`compile_lut` as an int16 tensor on ``device`` holding the
    uint16 pattern (readers mask with ``0xFFFF``), built once per
    (canonical spec, device)."""
    _validate_lut_spec(spec)
    return _device_table(_canonical(spec), torch.device(device))
