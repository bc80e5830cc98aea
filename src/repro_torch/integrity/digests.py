"""Golden content digests for compiled lookup tables (the port of
``repro.integrity.digests``).

Every shared LUT in the process — adder low-part tables, multiplier
product/signed/tap tables, their delta derivatives — is registered here
at compile time with a SHA-256 **golden digest** of its contents plus a
rebuild closure.  So is every copy of a table that a kernel gathers
from on a device (``ax.lut.device``, ``ax.lut.device_abs_error``,
``ax.mul.lut.device*``, ``conv2d_mac``'s signed tap tables): the
kernels do not read the host arrays, so a scrubber that hashed only
those would miss a flip where the gathers happen.  The scrubber
(:mod:`repro_torch.integrity.scrub`) walks this registry to detect
silent corruption of the live tables and to repair them in place from a
fresh off-cache rebuild.

A golden entry may hold a numpy array or a tensor on any device.
:func:`table_digest` hashes a table's host bytes in the dtype of the
*pattern* it holds: the int16 ``device_table`` is hashed as the uint16
table it was uploaded from, the int32 ``device_abs_error`` as uint16,
the int16 ``device_signed16`` as int32.  So a device copy has the same
digest as its host table, and verifying it costs one device-to-host
copy.

This module is a LEAF: it imports only ``hashlib``/``numpy``/``torch``,
so the table compilers can register without any import cycle through
the engine or serving stack.  Registration is a one-time cost per table
compile or upload (one SHA-256 over host bytes that were just built)
and the registry is pull-based — nothing here runs unless a scrubber or
the ``integrity=`` engine knob asks, so the hot path pays nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["GoldenEntry", "table_digest", "record_golden", "record_upload",
           "golden_entries", "golden_digest", "verify_entry",
           "registry_size", "clear_registry"]

Table = Union[np.ndarray, torch.Tensor]


def _host_pattern(table: Table, pattern=None) -> np.ndarray:
    """``table``'s contents on the host (a tensor costs one device-to-host
    copy), read as ``pattern``: a dtype of the same width reinterprets
    the bytes (int16 holding a uint16 table), another width converts the
    values (an int16 copy of an int32 table, an int32 copy of a uint16
    table).

    Nothing is narrowed away: a table holding a value that ``pattern``
    cannot represent (a flip in bits 16-31 of an int32 copy of a uint16
    table) is returned in its own dtype, so its digest can never equal
    the pattern's golden."""
    if isinstance(table, torch.Tensor):
        arr = table.detach().cpu().numpy()
    else:
        arr = np.asarray(table)
    arr = np.ascontiguousarray(arr)
    if pattern is None or np.dtype(pattern) == arr.dtype:
        return arr
    pattern = np.dtype(pattern)
    if pattern.itemsize == arr.dtype.itemsize:
        return arr.view(pattern)
    out = arr.astype(pattern)
    if (pattern.itemsize < arr.dtype.itemsize
            and not np.array_equal(out.astype(arr.dtype), arr)):
        return arr
    return out


def table_digest(table: Table, pattern=None) -> str:
    """Hex SHA-256 over a table's dtype, shape, and raw bytes, read as
    ``pattern`` (default: its own dtype; see :func:`_host_pattern`).

    Covering dtype/shape means a corrupted reinterpretation (same
    bytes, different view) can never collide with the golden."""
    arr = _host_pattern(table, pattern)
    h = hashlib.sha256()
    h.update(arr.dtype.str.encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class GoldenEntry:
    """One registered table: where it lives and how to rebuild it.

    Attributes:
      cache: the :mod:`repro_torch.obs.caches` facade name of the owning
        cache (``"ax.lut.packed"``, ``"ax.lut.device"``, ...).
      key: the canonical cache key (spec first, then weights, width or
        device where the cache has them).
      digest: SHA-256 of the healthy table contents at compile time.
      table: the LIVE cached array or tensor (the same object the
        engines and kernels read — which is exactly why scrubbing it
        matters).
      rebuild: zero-argument closure producing a fresh, off-cache
        rebuild of the same table, on the same device (the repair
        source).
      pattern: the dtype the digest reads the table as (``None``: its
        own).
    """

    cache: str
    key: Tuple
    digest: str
    table: Table
    rebuild: Callable[[], Table]
    pattern: Optional[np.dtype] = None


_REGISTRY: Dict[Tuple[str, Tuple], GoldenEntry] = {}


def record_golden(cache: str, key: Tuple, table: Table,
                  rebuild: Callable[[], Table], *, pattern=None,
                  digest: Optional[str] = None) -> Table:
    """Register ``table`` under ``(cache, key)``; returns it unchanged.

    Called by the cached table builders at compile or upload time.  A
    device copy passes its ``digest`` (:func:`record_upload`), so
    registering costs no device-to-host copy.  Re-compiling the same key
    (e.g. after an lru ``cache_clear`` in tests) simply re-registers the
    fresh object."""
    pattern = None if pattern is None else np.dtype(pattern)
    if digest is None:
        digest = table_digest(table, pattern)
    _REGISTRY[(cache, key)] = GoldenEntry(
        cache=cache, key=key, digest=digest, table=table, rebuild=rebuild,
        pattern=pattern)
    return table


def record_upload(cache: str, key: Tuple, host_cache: str,
                  host_key: Tuple, table: np.ndarray,
                  upload: Callable[[np.ndarray], torch.Tensor],
                  rebuild: Callable[[], np.ndarray], *,
                  transform: Optional[Callable[[np.ndarray],
                                               np.ndarray]] = None
                  ) -> torch.Tensor:
    """Register the device copy ``upload(table)`` of the host ``table``
    (registered under ``(host_cache, host_key)``) under ``(cache, key)``;
    returns the copy.

    Its golden is the host entry's (so a copy uploaded from a table
    corrupted since its compile is caught; ``table``'s own digest when
    the host entry is gone), read in the host table's dtype, and its
    rebuild uploads a fresh off-cache ``rebuild()``.

    With ``transform`` the copy is ``upload(transform(table))``, a table
    derived from the host one (``conv2d_mac``'s signed tap rows), read in
    the derived dtype.  Its golden is the digest of ``transform`` over
    the host table when that still hashes to its golden, else over a
    fresh ``rebuild()``: a host table corrupted before the upload is
    never baked in as golden."""
    golden = golden_digest(host_cache, host_key)
    if transform is None:
        return record_golden(
            cache, key, upload(table), lambda: upload(rebuild()),
            pattern=table.dtype,
            digest=golden if golden is not None else table_digest(table))
    healthy = (table if golden is not None and table_digest(table) == golden
               else rebuild())
    derived = transform(healthy)
    return record_golden(
        cache, key, upload(transform(table)),
        lambda: upload(transform(rebuild())), pattern=derived.dtype,
        digest=table_digest(derived))


def golden_entries(cache: Optional[str] = None) -> Tuple[GoldenEntry, ...]:
    """All registered entries (optionally restricted to one cache),
    in registration order."""
    return tuple(e for e in _REGISTRY.values()
                 if cache is None or e.cache == cache)


def golden_digest(cache: str, key: Tuple) -> Optional[str]:
    e = _REGISTRY.get((cache, key))
    return None if e is None else e.digest


def verify_entry(entry: GoldenEntry) -> bool:
    """Whether the live table still hashes to its golden digest (a
    device entry: one device-to-host copy)."""
    return table_digest(entry.table, entry.pattern) == entry.digest


def registry_size() -> int:
    return len(_REGISTRY)


def clear_registry() -> None:
    """Forget every golden (test isolation only — a cleared registry
    cannot detect corruption of tables compiled before the clear)."""
    _REGISTRY.clear()
