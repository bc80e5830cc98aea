"""Context-var span tracer with Chrome-trace-event export (the port's
copy of ``repro.obs.trace``).

The tracing pillar of :mod:`repro_torch.obs`: nestable wall-clock spans
over the execution stack (plan stage seams, tile dispatch, engine entry
points, the streaming runner), recorded into one process-wide
:class:`Tracer` and exported as Chrome trace-event JSON — the format
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load
directly.

Zero-cost when disabled: :func:`span` checks the module-level
:data:`_ENABLED` flag and returns a shared no-op context manager — one
branch plus one ``with`` on an empty ``__enter__``/``__exit__`` pair —
so instrumentation can live permanently on hot call paths.  Nesting is
tracked through a :class:`contextvars.ContextVar` stack, which makes
the tracer thread-safe (each thread sees its own stack) while the event
list itself is guarded by a lock.

Semantics on the card: CUDA launches are asynchronous, so a span around
a kernel-launching call measures host-side enqueue time, not device
compute.  Pair it with :func:`sync_span` (an explicit
``torch.cuda.synchronize`` point) where a host sync already happens to
see true device latency.

    from repro_torch import obs

    obs.enable()
    with obs.span("stage:blur", kind="haloc_axa"):
        ...
    obs.export_chrome_trace("trace.json")    # load in Perfetto
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: THE module-level telemetry flag (shared by the metrics fast paths and
#: the drift-capture hooks).  Flip via :func:`enable`/:func:`disable`.
_ENABLED = False


def enabled() -> bool:
    """Whether telemetry (spans, metrics, drift capture) is live."""
    return _ENABLED


def enable() -> None:
    """Turn telemetry on (spans/metrics record, drift capture runs)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn telemetry off — every hook degrades to its no-op fast path.
    Recorded events/metrics are kept until :func:`reset`."""
    global _ENABLED
    _ENABLED = False


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One finished span: times are seconds relative to the tracer
    epoch; ``depth``/``parent`` encode the nesting at record time."""

    name: str
    ts: float                 # start, s since Tracer epoch
    dur: float                # wall seconds
    tid: int                  # small per-tracer thread index
    depth: int                # 0 = top level
    parent: Optional[str]     # enclosing span name (None at top level)
    args: Dict[str, Any]


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class Tracer:
    """Process-wide span sink.  Appends are lock-guarded (cheap: one
    tuple build per finished span); reads snapshot under the lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[SpanEvent] = []
        self._tids: Dict[int, int] = {}
        self.epoch = time.perf_counter()

    def _tid(self, ident: int) -> int:
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def record(self, name: str, t0: float, dur: float, depth: int,
               parent: Optional[str], args: Dict[str, Any]) -> None:
        ev = SpanEvent(name=name, ts=t0 - self.epoch, dur=dur,
                       tid=self._tid(threading.get_ident()),
                       depth=depth, parent=parent, args=args)
        with self._lock:
            self._events.append(ev)

    @property
    def events(self) -> Tuple[SpanEvent, ...]:
        with self._lock:
            return tuple(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tids.clear()
            self.epoch = time.perf_counter()

    # ------------------------------------------------- chrome export --

    def chrome_trace(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event object: ``"X"`` (complete)
        events with microsecond ``ts``/``dur``, plus thread-name
        metadata — loadable in Perfetto / ``chrome://tracing``."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        with self._lock:
            tids = dict(self._tids)
            snapshot = list(self._events)
        for ident, tid in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"thread-{ident}"}})
        for e in snapshot:
            events.append({
                "name": e.name, "cat": "repro", "ph": "X",
                "ts": e.ts * 1e6, "dur": e.dur * 1e6,
                "pid": pid, "tid": e.tid,
                "args": {**{k: _json_safe(v) for k, v in e.args.items()},
                         "depth": e.depth,
                         "parent": e.parent or ""},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_TRACER = Tracer()

#: Per-context stack of open span names (nesting + stage attribution
#: for the drift monitor's engine capture).
_STACK: contextvars.ContextVar[Tuple[str, ...]] = \
    contextvars.ContextVar("repro_torch_obs_span_stack", default=())


def get_tracer() -> Tracer:
    return _TRACER


def reset() -> None:
    """Drop all recorded spans and re-zero the trace epoch."""
    _TRACER.clear()


def current_stack() -> Tuple[str, ...]:
    """Names of the open spans in this context, outermost first."""
    return _STACK.get()


def current_span() -> Optional[str]:
    """The innermost open span name, or ``None``."""
    stack = _STACK.get()
    return stack[-1] if stack else None


class _NoopSpan:
    """The disabled fast path: a shared, state-free context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):  # attribute updates are dropped
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "_tok", "_depth", "_parent")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self):
        stack = _STACK.get()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        self._tok = _STACK.set(stack + (self.name,))
        self._t0 = time.perf_counter()
        return self

    def set(self, **kw):
        """Attach extra args to the span before it closes."""
        self.args.update(kw)

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        _STACK.reset(self._tok)
        _TRACER.record(self.name, self._t0, dur, self._depth,
                       self._parent, self.args)
        return False


def span(name: str, **args):
    """A wall-clock span context manager; no-op when telemetry is off.

    ``args`` become the Chrome trace event's ``args`` (JSON-coerced on
    export).  Spans nest; nesting is per-thread/per-context."""
    if not _ENABLED:
        return _NOOP
    return _Span(name, args)


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or lists,
    tuples and dict values nesting them)."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def sync_span(value, name: str = "device_sync", **args):
    """An explicit device-sync point: ``torch.cuda.synchronize`` of every
    CUDA device that holds a tensor of ``value`` (a tensor, or nested
    lists, tuples and dicts of them), under a span; returns ``value``.

    When telemetry is DISABLED this returns ``value`` untouched — no
    sync is forced — so it must only be placed where the caller either
    tolerates or already performs a sync.  A value on the CPU passes
    through under the span with nothing to wait for.  When enabled, the
    span's duration is the device-compute drain the host would otherwise
    observe lumped into its next blocking read."""
    if not _ENABLED:
        return value
    with span(name, **args):
        devices = _cuda_devices(value, set())
        if devices:
            import torch
            for dev in devices:
                torch.cuda.synchronize(dev)
        return value


def export_chrome_trace(path: str) -> str:
    """Write the process tracer's Chrome trace-event JSON to ``path``."""
    return _TRACER.export_chrome_trace(path)
