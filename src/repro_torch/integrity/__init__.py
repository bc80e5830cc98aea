"""``repro_torch.integrity`` — silent-corruption detection and online
repair for the compiled-LUT serving stack (the port of
``repro.integrity``).

Four cooperating pieces close the silent-data-corruption loop:

- :mod:`repro_torch.integrity.digests`: golden content digests recorded at
  LUT compile time and at each table's upload to a device (the detection
  ground truth; a leaf module so the compile paths can import it without
  cycles).
- :mod:`repro_torch.integrity.scrub`: :class:`LutScrubber` — cadenced
  re-hash of every live cached table, on the host or the card, against
  its golden digest, with recompile-and-swap in-place repair.
- :mod:`repro_torch.integrity.abft`: :class:`AbftChecker` — row/column
  checksum verification of the MAC datapaths with acceptance bands
  calibrated from the exact per-config error analytics.
- :mod:`repro_torch.integrity.canary`: :class:`CanarySuite` — deterministic
  known-answer probes through the live engine, bit-exact against the
  delta-table predictions.
- :mod:`repro_torch.integrity.store`: :class:`PersistentCache` — crash-safe
  on-disk compile cache (atomic tmp-write + rename, SHA-256 manifest);
  corrupt or truncated entries are never served.

Attribute access is lazy (PEP 562): ``repro_torch.ax.lut`` imports
``digests``/``store`` (leaf modules), while ``scrub``/``canary``/
``abft`` import the ax and serving stacks on top of them — eager
re-exports here would close that cycle.
"""

from __future__ import annotations

_EXPORTS = {
    "table_digest": "digests", "record_golden": "digests",
    "golden_entries": "digests", "golden_digest": "digests",
    "verify_entry": "digests", "registry_size": "digests",
    "clear_registry": "digests", "GoldenEntry": "digests",
    "ScrubReport": "scrub", "LutScrubber": "scrub",
    "scrub_entries": "scrub", "verify_engine_tables": "scrub",
    "CanaryReport": "canary", "CanarySuite": "canary",
    "make_probe": "canary", "expected_add_outputs": "canary",
    "AbftVerdict": "abft", "AbftChecker": "abft",
    "mac_error_budget": "abft",
    "PersistentCache": "store", "activate": "store",
    "deactivate": "store", "active_cache": "store",
    "CACHE_ENV": "store",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return __all__
