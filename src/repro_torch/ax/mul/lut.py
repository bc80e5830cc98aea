"""Compiled lookup tables for approximate multipliers (the port of
``repro.ax.mul.lut``).

The multiplier-side twin of :mod:`repro_torch.ax.lut`.  A multiplier's
error surface is not a function of operand low bits alone, so these
tables cover the full ``2^N x 2^N`` operand domain, which is why
compilation is capped at :data:`MAX_MUL_LUT_BITS` operand bits (a 10-bit
signed MAC table is 4 MiB of int32; an 8-bit product table is 128 KiB of
uint16).

Three table families, byte-identical to the reference's, built once per
*canonical* spec (irrelevant knobs zeroed via ``effective_*``) and
returned read-only:

* :func:`compile_mul_lut` — unsigned full products, indexed by
  ``(a << N) | b``; the ``lut`` strategy's gather operand.
* :func:`signed_mul_table` — signed (sign-magnitude) products for the MAC
  GEMM, gathered per (a, b) lane pair.
* :func:`tap_tables` — one signed column table per static conv kernel
  weight, gathered per pixel by ``|x|``.

The ``device_*`` functions keep one tensor copy of each per (canonical
spec, device), and per weights for the tap tables, so no call builds or
uploads a table.  (The reference's integrity digests, cache registration
and persistent store, and its error-delta tables, are not ported here.)
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.ax.mul.registry import get_multiplier
from repro_torch.ax.mul.specs import MulSpec

#: Full-domain tables: 4^10 = 1M entries is the largest compiled.
MAX_MUL_LUT_BITS = 10


def mul_lut_supported(spec: MulSpec) -> bool:
    """Whether the ``lut`` strategy can serve ``spec`` (exact kinds use
    the native multiply and are always supported)."""
    if spec.is_exact:
        return True
    return spec.n_bits <= MAX_MUL_LUT_BITS


def _canonical(spec: MulSpec) -> MulSpec:
    """Zero the knobs the kind ignores, so equivalent specs share one
    cached table."""
    return MulSpec(kind=spec.kind, n_bits=spec.n_bits,
                   trunc_bits=spec.effective_trunc_bits,
                   row_bits=spec.effective_row_bits)


def _check_compilable(spec: MulSpec) -> None:
    if spec.n_bits > MAX_MUL_LUT_BITS:
        raise ValueError(
            f"mul LUT limited to n_bits <= {MAX_MUL_LUT_BITS} "
            f"(4^N-entry tables), got n_bits={spec.n_bits}")


def _operand_grids(n_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """All (a, b) pairs as flat uint64 arrays, row-major in ``a``
    (matching the ``(a << N) | b`` index)."""
    vals = np.arange(1 << n_bits, dtype=np.uint64)
    return np.repeat(vals, 1 << n_bits), np.tile(vals, 1 << n_bits)


@functools.lru_cache(maxsize=None)
def _mul_lut_cached(spec: MulSpec) -> np.ndarray:
    _check_compilable(spec)
    a, b = _operand_grids(spec.n_bits)
    prod = get_multiplier(spec.kind).impl(a, b, spec)
    dtype = np.uint16 if spec.product_bits <= 16 else np.uint32
    table = prod.astype(dtype)
    table.flags.writeable = False
    return table


def compile_mul_lut(spec: MulSpec) -> np.ndarray:
    """Unsigned full-product table ``T[(a << N) | b] = approx(a, b)``:
    uint16 when the product bus has at most 16 bits, else uint32."""
    return _mul_lut_cached(_canonical(spec))


def mul_lut_index(a, b, n_bits: int):
    """Gather index for the full-domain tables (container arrays or
    tensors in, indices out)."""
    mask = (1 << n_bits) - 1
    return ((a & mask) << n_bits) | (b & mask)


@functools.lru_cache(maxsize=None)
def _signed_table_cached(spec: MulSpec) -> np.ndarray:
    _check_compilable(spec)
    n = spec.n_bits
    patt = np.arange(1 << n, dtype=np.int64)
    signed = np.where(patt >= (1 << (n - 1)), patt - (1 << n), patt)
    mag = np.abs(signed).astype(np.uint64)
    a = np.repeat(mag, 1 << n)
    b = np.tile(mag, 1 << n)
    prod = get_multiplier(spec.kind).impl(a, b, spec).astype(np.int64)
    sgn = np.sign(np.repeat(signed, 1 << n) * np.tile(signed, 1 << n))
    table = (sgn * prod).astype(np.int32)
    table.flags.writeable = False
    return table


def signed_mul_table(spec: MulSpec) -> np.ndarray:
    """Sign-magnitude product table for signed MAC datapaths.

    Indexed by ``((a & mask) << N) | (b & mask)`` where a, b are N-bit
    two's-complement lane patterns; the entry is
    ``sign(a)*sign(b)*approx(|a|, |b|)`` as int32.  ``|-2^(N-1)| =
    2^(N-1)`` still fits the N-bit unsigned operand domain of the
    implementations.
    """
    return _signed_table_cached(_canonical(spec))


@functools.lru_cache(maxsize=None)
def _tap_tables_cached(spec: MulSpec,
                       weights: Tuple[int, ...]) -> np.ndarray:
    n = spec.n_bits
    limit = 1 << n
    for w in weights:
        if abs(w) >= limit:
            raise ValueError(
                f"kernel weight {w} exceeds the {n}-bit multiplier "
                f"operand range (|w| < {limit})")
    vals = np.arange(limit, dtype=np.uint64)
    entry = get_multiplier(spec.kind)
    rows = []
    for w in weights:
        prod = entry.impl(vals, np.uint64(abs(w)), spec).astype(np.int64)
        rows.append((prod if w >= 0 else -prod).astype(np.int32))
    table = np.stack(rows)
    table.flags.writeable = False
    return table


def tap_tables(spec: MulSpec, weights: Tuple[int, ...]) -> np.ndarray:
    """Per-tap signed product columns for conv2d: ``T[t][v] =
    sign(w_t) * approx(v, |w_t|)`` for input magnitudes ``v``, shaped
    ``(len(weights), 2^N)`` int32.  One gather per tap replaces the
    multiplier at run time; every backend shares these tables."""
    return _tap_tables_cached(_canonical(spec),
                              tuple(int(w) for w in weights))


# ------------------------------------------------------ device copies --

def _to_device(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A table as a tensor of the same width: uint16 is held as int16 and
    uint32 as int32 (the same bytes; readers of a uint16 table mask with
    0xFFFF, and no uint32 product table entry reaches 2^31)."""
    signed = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
    arr = table.view(signed.get(table.dtype, table.dtype)).copy()
    return torch.from_numpy(arr).to(device)


@functools.lru_cache(maxsize=None)
def _device_mul_table(spec: MulSpec, device: torch.device) -> torch.Tensor:
    return _to_device(compile_mul_lut(spec), device)


def device_mul_table(spec: MulSpec, device) -> torch.Tensor:
    """:func:`compile_mul_lut` on ``device``: int16 holding the uint16
    pattern when ``2N <= 16``, else int32; built once per (canonical
    spec, device)."""
    return _device_mul_table(_canonical(spec), torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_signed_table(spec: MulSpec,
                         device: torch.device) -> torch.Tensor:
    return _to_device(signed_mul_table(spec), device)


def device_signed_table(spec: MulSpec, device) -> torch.Tensor:
    """:func:`signed_mul_table` as an int32 tensor on ``device``."""
    return _device_signed_table(_canonical(spec), torch.device(device))


@functools.lru_cache(maxsize=None)
def _signed_table_fits_int16(spec: MulSpec) -> bool:
    table = signed_mul_table(spec)
    return bool(np.array_equal(table, table.astype(np.int16)))


def signed_table_fits_int16(spec: MulSpec) -> bool:
    """Whether every entry of :func:`signed_mul_table` is an int16 value
    (computed from the table, once per canonical spec)."""
    return _signed_table_fits_int16(_canonical(spec))


@functools.lru_cache(maxsize=None)
def _device_signed_table16(spec: MulSpec,
                           device: torch.device) -> torch.Tensor:
    if not signed_table_fits_int16(spec):
        raise ValueError(f"the signed product table of {spec.short_name} "
                         f"has entries outside int16")
    table = signed_mul_table(spec).astype(np.int16)
    return torch.from_numpy(table).to(device)


def device_signed_table16(spec: MulSpec, device) -> torch.Tensor:
    """:func:`signed_mul_table` as an int16 tensor on ``device`` (half the
    bytes: 128 KiB at N = 8); raises ``ValueError`` when an entry does not
    fit int16."""
    return _device_signed_table16(_canonical(spec), torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_tap_tables(spec: MulSpec, weights: Tuple[int, ...],
                       device: torch.device) -> torch.Tensor:
    return _to_device(tap_tables(spec, weights), device)


def device_tap_tables(spec: MulSpec, weights, device) -> torch.Tensor:
    """:func:`tap_tables` as an int32 (T, 2^N) tensor on ``device``."""
    return _device_tap_tables(_canonical(spec),
                              tuple(int(w) for w in weights),
                              torch.device(device))
