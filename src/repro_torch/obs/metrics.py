"""Counter / gauge / histogram registry — the metrics pillar of
:mod:`repro_torch.obs` (the port's copy of ``repro.obs.metrics``).

Instruments are named, created lazily, and live in one process-wide
:class:`MetricsRegistry`; a snapshot is a plain nested dict so
benchmarks can write it next to the ``BENCH_*.json`` trajectory.

Zero-cost when disabled: the module-level accessors
(:func:`counter`/:func:`gauge`/:func:`histogram`) check the shared
telemetry flag (:mod:`repro_torch.obs.trace`) and hand back ONE shared no-op
instrument — the hot-path cost of ``obs.counter("x").inc()`` with
telemetry off is a flag test plus two no-op calls.

Histogram percentiles use linear interpolation (``numpy.percentile``'s
default), so ``p50`` of ``1..100`` is exactly 50.5 — the convention the
:class:`repro_torch.imgproc.corpus.StreamResult` latency summary and
the tests share via :func:`quantile`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import trace as _trace

#: Samples kept per histogram; beyond this, count/sum/min/max keep
#: accumulating but the percentile reservoir stops growing (a streaming
#: benchmark records thousands, not millions, of batch latencies).
MAX_HISTOGRAM_SAMPLES = 65536


def quantile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (``q`` in [0, 100]); ``nan`` on
    an empty sample set.  THE percentile definition of this package."""
    if len(samples) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


class Counter:
    """Monotone event count (pixels processed, batches dispatched)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A point-in-time level (batches in flight, tiles resident)."""

    __slots__ = ("name", "value", "high_water")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.high_water = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.high_water:
            self.high_water = v

    def inc(self, n: int = 1) -> None:
        self.set(self.value + n)

    def dec(self, n: int = 1) -> None:
        self.value -= n


class Histogram:
    """Sample distribution with exact count/sum/extrema and a bounded
    percentile reservoir (first :data:`MAX_HISTOGRAM_SAMPLES` samples)."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []

    def record(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._samples) < MAX_HISTOGRAM_SAMPLES:
            self._samples.append(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        return quantile(self._samples, q)

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count, "mean": self.mean,
            "min": self.min if self.count else float("nan"),
            "max": self.max if self.count else float("nan"),
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class _NoopInstrument:
    """Disabled fast path: one shared instance absorbs every method."""

    __slots__ = ()
    name = "<noop>"
    value = 0

    def inc(self, n=1):
        pass

    dec = set = record = inc

    def percentile(self, q):
        return float("nan")


_NOOP = _NoopInstrument()


class MetricsRegistry:
    """Named instruments, created on first touch."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def _get(self, table: Dict, cls, name: str):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, cls(name))
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self.counters, Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(self.gauges, Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(self.histograms, Histogram, name)

    def clear(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()

    def snapshot(self, prefix: str = "") -> Dict[str, Dict]:
        """Plain-dict view: counters, gauges, histogram summaries, plus
        the live named-cache stats (:mod:`repro_torch.obs.caches`).

        ``prefix`` restricts the instrument tables to names starting
        with it (``"serve."`` → just the serving layer's instruments) —
        subsystem reports then stay readable next to a busy registry.
        The cache table has no instrument names, so it is included only
        for the unfiltered snapshot."""
        from repro_torch.obs.caches import cache_stats
        snap: Dict[str, Dict] = {
            "counters": {n: c.value for n, c in self.counters.items()
                         if n.startswith(prefix)},
            "gauges": {n: {"value": g.value, "high_water": g.high_water}
                       for n, g in self.gauges.items()
                       if n.startswith(prefix)},
            "histograms": {n: h.summary()
                           for n, h in self.histograms.items()
                           if n.startswith(prefix)},
        }
        if not prefix:
            snap["caches"] = cache_stats()
        return snap


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    """The named counter — or the shared no-op when telemetry is off."""
    if not _trace._ENABLED:
        return _NOOP
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    if not _trace._ENABLED:
        return _NOOP
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    if not _trace._ENABLED:
        return _NOOP
    return _REGISTRY.histogram(name)


def metrics_snapshot(prefix: str = "") -> Dict[str, Dict]:
    """Snapshot of every instrument (works with telemetry off too —
    whatever was recorded while it was on is still readable); an
    optional name ``prefix`` filters to one subsystem's instruments."""
    return _REGISTRY.snapshot(prefix)


def write_metrics(path: str) -> str:
    """Dump :func:`metrics_snapshot` as JSON (nan/inf-safe) to ``path``."""
    import json

    def _safe(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: _safe(x) for k, x in v.items()}
        return v

    with open(path, "w") as f:
        json.dump(_safe(metrics_snapshot()), f, indent=1)
    return path


def reset_metrics() -> None:
    _REGISTRY.clear()
