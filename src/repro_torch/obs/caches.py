"""Named cache-stats facade over the package's ``lru_cache`` sites (the
port's copy of ``repro.obs.caches``).

The system leans on ``functools.lru_cache`` sites (engine handles,
adder/multiplier LUT tables, analytics reciprocals, hw-cost toggle
sweeps) whose hit/miss behavior decides both warm-call latency and
resident memory — but ``cache_info()`` is only reachable if you know
each private function.  Every site registers itself here under a stable
name at import time:

    from repro_torch.obs.caches import register_lru
    register_lru("ax.lut.packed", compile_lut)

and :func:`cache_stats` reads hits/misses/size across all of them in
one call.  Registration is import-time-only and stats are PULL-based —
there is no per-call hook, so this facade is zero-cost on the hot paths
by construction and needs no telemetry flag.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_CACHES: Dict[str, Callable] = {}


def register_lru(name: str, fn):
    """Register ``fn`` (anything exposing ``functools.lru_cache``'s
    ``cache_info()``) under ``name``.  Re-registration overwrites (module
    reloads); returns ``fn`` so it can wrap a definition in place."""
    if not hasattr(fn, "cache_info"):
        raise TypeError(
            f"register_lru({name!r}): object has no cache_info(); "
            f"expected a functools.lru_cache-wrapped callable")
    _CACHES[name] = fn
    return fn


def cache_names():
    return tuple(sorted(_CACHES))


def get_cached(name: str):
    """The registered cached callable itself (e.g. to ``cache_clear``)."""
    return _CACHES[name]


def cache_stats(prefix: Optional[str] = None) -> Dict[str, Dict[str, int]]:
    """``{name: {hits, misses, size, maxsize}}`` for every registered
    cache (optionally filtered by name ``prefix``)."""
    out: Dict[str, Dict[str, int]] = {}
    for name in sorted(_CACHES):
        if prefix is not None and not name.startswith(prefix):
            continue
        info = _CACHES[name].cache_info()
        out[name] = {"hits": info.hits, "misses": info.misses,
                     "size": info.currsize, "maxsize": info.maxsize}
    return out


def format_cache_stats(prefix: Optional[str] = None) -> str:
    """Human-readable hit/miss/size table."""
    stats = cache_stats(prefix)
    if not stats:
        return "(no caches registered)"
    width = max(len(n) for n in stats)
    lines = [f"{'cache':{width}s} {'hits':>8s} {'misses':>8s} {'size':>6s}"]
    for name, s in stats.items():
        lines.append(f"{name:{width}s} {s['hits']:8d} {s['misses']:8d} "
                     f"{s['size']:6d}")
    return "\n".join(lines)
