"""``repro_torch.obs`` — structured telemetry for the port's execution
stack (the port of ``repro.obs``).

Three pillars, instrumented through engine -> plan -> tiles -> streaming:

1. **Tracing** (:mod:`repro_torch.obs.trace`): nestable, thread-safe
   context-var spans (``obs.span("stage:blur")``) with optional
   ``torch.cuda.synchronize`` device-sync points (:func:`sync_span`),
   exported as Chrome trace-event JSON loadable in Perfetto.
2. **Metrics** (:mod:`repro_torch.obs.metrics`): named counters /
   gauges / histograms plus a named cache-stats facade
   (:mod:`repro_torch.obs.caches`) over the ``lru_cache`` sites —
   engine handles, host and device LUT tables, compiled plans, tiled
   executors, fault masks.
3. **Quality drift** (:mod:`repro_torch.obs.drift`): an online
   per-stage mean-error monitor against the exact MED/NMED budgets of
   the active ``(kind, m, k)`` config.

Everything is ZERO-COST when disabled: one module-level flag
(:func:`enable` / :func:`disable`, or ``REPRO_OBS=1`` in the
environment) gates no-op fast paths for spans, instruments and drift
capture.

    from repro_torch import obs

    obs.enable()
    ...run pipelines / streams...
    obs.export_chrome_trace("trace.json")   # open in ui.perfetto.dev
    obs.write_metrics("metrics.json")
    print(obs.format_cache_stats())
"""

from __future__ import annotations

import os

from repro_torch.obs.caches import (  # noqa: F401
    cache_names,
    cache_stats,
    format_cache_stats,
    get_cached,
    register_lru,
)
from repro_torch.obs.drift import (  # noqa: F401
    DriftMonitor,
    DriftStatus,
    active_monitor,
    install,
    installed,
    uninstall,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    metrics_snapshot,
    quantile,
    registry,
    reset_metrics,
    write_metrics,
)
from repro_torch.obs.trace import (  # noqa: F401
    SpanEvent,
    Tracer,
    current_span,
    current_stack,
    disable,
    enable,
    enabled,
    export_chrome_trace,
    get_tracer,
    reset,
    span,
    sync_span,
)


class _TelemetryScope:
    """``with obs.telemetry(): ...`` — enable, then restore on exit."""

    def __init__(self, on: bool):
        self._on = on

    def __enter__(self):
        self._was = enabled()
        enable() if self._on else disable()
        return self

    def __exit__(self, *exc):
        enable() if self._was else disable()
        return False


def telemetry(on: bool = True) -> _TelemetryScope:
    """Scoped enable/disable (restores the previous flag state)."""
    return _TelemetryScope(on)


def reset_all() -> None:
    """Clear recorded spans AND metrics (cache stats are live views and
    are not resettable from here)."""
    reset()
    reset_metrics()


__all__ = [
    "Counter", "DriftMonitor", "DriftStatus", "Gauge", "Histogram",
    "MetricsRegistry", "SpanEvent", "Tracer", "active_monitor",
    "cache_names", "cache_stats", "counter", "current_span",
    "current_stack", "disable", "enable", "enabled",
    "export_chrome_trace", "format_cache_stats", "gauge", "get_cached",
    "get_tracer", "histogram", "install", "installed",
    "metrics_snapshot", "quantile", "register_lru", "registry", "reset",
    "reset_all", "reset_metrics", "span", "sync_span", "telemetry",
    "uninstall", "write_metrics",
]

if os.environ.get("REPRO_OBS", "") not in ("", "0"):
    enable()
