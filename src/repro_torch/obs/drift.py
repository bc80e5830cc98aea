"""Online quality-drift monitor (the port of ``repro.obs.drift``): the
runtime counterpart of ``repro_torch.imgproc.plan.fused_psnr_gate``.

The Table-1 error metrics of every LUT-compilable ``(kind, m, k)`` adder
config are exact (closed-form expectations over the ``2^m x 2^m`` delta
table, :mod:`repro_torch.ax.analytics`).  Those budgets assume UNIFORM
operands; a production stream whose operand distribution drifts can sit
far off the predicted quality.  :class:`DriftMonitor` closes that loop
online: it accumulates the measured per-ADD mean absolute error per
pipeline stage and flags any stage whose running mean leaves the
predicted band of the budget spec,

    threshold(stage) = MED * band + z * sigma / sqrt(n)

with ``MED``/``sigma`` the exact first/second moments of the budgeted
``(kind, m, k)`` (:func:`repro_torch.ax.analytics.exact_error_moments`,
reduced on the host: the moments are bit-identical on every backend).

Three feeds, coarsest to finest:

- :meth:`DriftMonitor.observe_errors`: raw per-add absolute errors.
- :meth:`DriftMonitor.observe_operands`: operand pairs that entered an
  adder — the exact per-add error is one gather from the datapath's
  delta table (:func:`repro_torch.ax.lut.error_delta_table`).
- engine capture: with telemetry enabled and a monitor
  :func:`install`-ed, the engines feed ``add`` operands and
  ``accumulate``/``filter_chain`` fold errors automatically, with the
  stage label taken from the innermost open ``stage:*`` span.

Where capture fires is where the reference's does: every engine call on
the ``"torch"`` backend (the counterpart of the reference's host
engines, and the CPU shadow a :class:`~repro_torch.resilience.degrade.
DegradePolicy` runs) and every eager engine call on the card.  Calls
made inside a compiled pipeline or tiled executor on the ``"cuda"``
backend record nothing (:func:`suppressed`), as the reference's
``jax.jit`` sees tracers there: the card's fast path never syncs for
drift.  A tensor is strided down to at most :data:`MAX_OBS_ELEMENTS` on
its own device before the one copy to the host, so a capture costs
O(cap) transfers whatever the image size.

Stage errors from the fold feeds are normalized by the adds per output
element, so everything is compared in per-add units against the same MED
budget.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as _trace

#: Per-observation element cap: larger arrays are strided down so a
#: shadow capture costs O(cap) regardless of crop size.
MAX_OBS_ELEMENTS = 4096


@dataclasses.dataclass
class _StageAcc:
    n: int = 0
    sum_abs: float = 0.0
    max_abs: float = 0.0


@dataclasses.dataclass(frozen=True)
class DriftStatus:
    """One stage's running verdict against the budget."""

    stage: str
    n: int                 # adds observed
    mean_abs: float        # measured per-add mean |error|
    budget_med: float      # exact MED of the budgeted spec
    threshold: float       # trip level (band + sampling slack)
    tripped: bool

    @property
    def ratio(self) -> float:
        """measured / budget (inf when the budget is exact-zero)."""
        if self.budget_med == 0.0:
            return math.inf if self.mean_abs > 0 else 0.0
        return self.mean_abs / self.budget_med


class DriftMonitor:
    """Accumulate per-stage mean |error| against a spec's exact budget.

    Args:
      spec: the BUDGETED adder config — what the pipeline is believed to
        run; the exact MED/NMED/variance of this spec define the band.
      band: relative headroom on the exact MED.
      z: sampling-slack width in exact-sigma units.
      min_samples: adds a stage must accumulate before it may trip.
    """

    def __init__(self, spec, band: float = 1.25, z: float = 4.0,
                 min_samples: int = 1024):
        from repro_torch.ax.analytics import exact_error_moments
        self.spec = spec
        self.band = float(band)
        self.z = float(z)
        self.min_samples = int(min_samples)
        mom = exact_error_moments(spec, backend="numpy")
        self.budget_med = mom.med
        self.budget_nmed = mom.nmed
        self.budget_sigma = math.sqrt(mom.var_ed)
        self._stages: Dict[str, _StageAcc] = {}

    # ------------------------------------------------------------ feeds --

    def observe_errors(self, stage: str, abs_errors,
                       n_adds: int = 1) -> None:
        """Raw measured absolute errors for ``stage``; ``n_adds`` is the
        number of approximate adds each error value folded through."""
        e = np.abs(np.asarray(_host(abs_errors),
                              dtype=np.float64)).ravel()
        if e.size == 0:
            return
        acc = self._stages.setdefault(stage, _StageAcc())
        scale = max(int(n_adds), 1)
        acc.n += e.size * scale
        acc.sum_abs += float(e.sum())
        acc.max_abs = max(acc.max_abs, float(e.max()) / scale)

    def observe_operands(self, stage: str, a, b, spec=None) -> None:
        """Operand pairs that entered the ACTUAL datapath ``spec``
        (default: the budgeted spec): per-add errors are gathered from
        that spec's exact delta table.  Operands are N-bit unsigned
        containers (numpy arrays or tensors)."""
        from repro_torch.ax.lut import error_delta_table, lut_index, \
            lut_supported
        from repro_torch.ax.registry import get_adder
        spec = spec if spec is not None else self.spec
        a = _flat_sample(a)
        b = _flat_sample(b)
        if get_adder(spec.kind).is_exact:
            self.observe_errors(stage, np.zeros(a.size))
            return
        if not lut_supported(spec):
            return  # no compilable delta table — nothing exact to gather
        idx = lut_index(a.astype(np.uint64), b.astype(np.uint64), spec)
        self.observe_errors(stage,
                            error_delta_table(spec)[np.asarray(idx)])

    # ---------------------------------------------------------- verdicts --

    def threshold(self, n: int) -> float:
        slack = self.z * self.budget_sigma / math.sqrt(max(n, 1))
        return self.budget_med * self.band + slack

    def status(self, stage: str) -> DriftStatus:
        acc = self._stages.get(stage) or _StageAcc()
        mean = acc.sum_abs / acc.n if acc.n else 0.0
        thr = self.threshold(acc.n)
        return DriftStatus(
            stage=stage, n=acc.n, mean_abs=mean,
            budget_med=self.budget_med, threshold=thr,
            tripped=acc.n >= self.min_samples and mean > thr)

    def statuses(self) -> Tuple[DriftStatus, ...]:
        return tuple(self.status(s) for s in self._stages)

    def drifted(self) -> Tuple[str, ...]:
        """Stages currently outside their predicted band."""
        return tuple(st.stage for st in self.statuses() if st.tripped)

    def ok(self) -> bool:
        return not self.drifted()

    def reset(self) -> None:
        self._stages.clear()

    def report(self) -> str:
        """Human-readable per-stage drift table."""
        head = (f"drift budget {self.spec.short_name}: "
                f"MED={self.budget_med:.4f} NMED={self.budget_nmed:.3e} "
                f"band={self.band}x")
        if not self._stages:
            return head + "\n(no observations)"
        width = max(len(s) for s in self._stages)
        lines = [head, f"{'stage':{width}s} {'n_adds':>10s} "
                       f"{'mean|e|':>10s} {'ratio':>8s}  verdict"]
        for st in self.statuses():
            ratio = "inf" if math.isinf(st.ratio) else f"{st.ratio:.3f}"
            lines.append(
                f"{st.stage:{width}s} {st.n:10d} {st.mean_abs:10.4f} "
                f"{ratio:>8s}  "
                f"{'DRIFT' if st.tripped else 'ok'}")
        return "\n".join(lines)


# ------------------------------------------------------ engine capture --

#: The installed monitor (one at a time; ``None`` = capture off).
_MONITOR: Optional[DriftMonitor] = None

#: Set inside a compiled pipeline or tiled executor on the ``"cuda"``
#: backend: capture records nothing there.
_SUPPRESSED: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("repro_torch_drift_suppressed", default=False)


def install(monitor: DriftMonitor) -> DriftMonitor:
    """Make ``monitor`` the engine-capture sink (telemetry must also be
    enabled for the capture hooks to fire)."""
    global _MONITOR
    _MONITOR = monitor
    return monitor


def uninstall() -> None:
    global _MONITOR
    _MONITOR = None


def active_monitor() -> Optional[DriftMonitor]:
    return _MONITOR


class _Installed:
    def __init__(self, monitor):
        self.monitor = monitor

    def __enter__(self):
        install(self.monitor)
        return self.monitor

    def __exit__(self, *exc):
        uninstall()
        return False


def installed(monitor: DriftMonitor) -> Iterator[DriftMonitor]:
    """``with installed(DriftMonitor(spec)): ...`` scoped capture."""
    return _Installed(monitor)


@contextlib.contextmanager
def suppressed():
    """Capture records nothing inside this scope (the compiled ``"cuda"``
    pipelines and tiled executors enter it, the counterpart of the
    reference's jit)."""
    tok = _SUPPRESSED.set(True)
    try:
        yield
    finally:
        _SUPPRESSED.reset(tok)


def capturing() -> bool:
    """Whether an engine call here would feed a monitor (telemetry on, a
    monitor installed, not inside a compiled ``"cuda"`` region)."""
    return (_trace._ENABLED and _MONITOR is not None
            and not _SUPPRESSED.get())


def _step(size: int) -> int:
    """The reference's subsample stride for ``size`` elements (1: all)."""
    return size // MAX_OBS_ELEMENTS + 1 if size > MAX_OBS_ELEMENTS else 1


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (tensors copied to the host once)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flat_sample(x) -> np.ndarray:
    """``x`` flattened and strided down to at most ``MAX_OBS_ELEMENTS``
    (the reference's ``_subsample``), on a tensor's own device before its
    copy to the host."""
    if isinstance(x, torch.Tensor):
        flat = x.reshape(-1)
        return _host(flat[::_step(flat.numel())])
    flat = np.asarray(x).ravel()
    return flat[::_step(flat.size)]


def _stage_label() -> str:
    """The innermost open ``stage:*`` span names the pipeline stage the
    capture belongs to; otherwise the innermost span, else 'unlabeled'."""
    stack = _trace.current_stack()
    for name in reversed(stack):
        if name.startswith("stage:"):
            return name[len("stage:"):]
    return stack[-1] if stack else "unlabeled"


def _signed_mod_diff(approx, exact, n_bits: int) -> np.ndarray:
    """Minimal signed difference of two mod-2^N container values."""
    mask = (1 << n_bits) - 1
    d = (approx.astype(np.int64) - exact.astype(np.int64)) & mask
    half = 1 << (n_bits - 1)
    return np.where(d >= half, d - (1 << n_bits), d)


def _monitor() -> Optional[DriftMonitor]:
    return None if _SUPPRESSED.get() else _MONITOR


def capture_add(spec, a, b, out=None) -> None:
    """Engine hook: one elementwise ``add``.

    Without ``out`` the per-add error is gathered from the spec's exact
    delta table.  With ``out`` — the fault-injected engines — the
    measured output is compared against the exact mod-2^N sum."""
    mon = _monitor()
    if mon is None:
        return
    if out is not None:
        if not (tuple(a.shape) == tuple(b.shape) == tuple(out.shape)):
            return
        av = _flat_sample(a).astype(np.uint64)
        bv = _flat_sample(b).astype(np.uint64)
        ov = _flat_sample(out).astype(np.uint64)
        exact = (av + bv) & np.uint64((1 << spec.n_bits) - 1)
        mon.observe_errors(
            _stage_label(),
            np.abs(_signed_mod_diff(ov, exact, spec.n_bits)))
        return
    mon.observe_operands(_stage_label(), a, b, spec=spec)


def capture_accumulate(spec, terms, weights, out) -> None:
    """Engine hook: a K-term weighted fold.  Measures the fold's total
    error against the exact mod-2^N weighted sum, normalized per add."""
    mon = _monitor()
    if mon is None:
        return
    k = terms.shape[0]
    cols = terms.reshape(k, -1)
    # the reference strides the (columns, K) transpose by its whole size
    step = _step(cols.shape[1] * k)
    t = _host(cols[:, ::step])
    o = _flat_sample(out)
    if k < 2 or t.shape[1] != o.size:
        return
    ws = tuple(weights) if weights is not None else (1,) * k
    mask = (1 << spec.n_bits) - 1
    exact = np.zeros(t.shape[1], dtype=np.uint64)
    for i, w in enumerate(ws):
        exact = (exact + t[i].astype(np.uint64)
                 * np.uint64(w % (1 << spec.n_bits))) & np.uint64(mask)
    err = np.abs(_signed_mod_diff(o.astype(np.uint64), exact,
                                  spec.n_bits))
    mon.observe_errors(_stage_label(), err / (k - 1), n_adds=k - 1)


def capture_filter_chain(spec, q, stages, out) -> None:
    """Engine hook: a chained separable-filter pass.  Compares the whole
    approximate chain against its exact integer twin (replicate-padded
    taps, exact weighted sums, the same rounding shifts), normalized by
    the chain's total adds per output element.  A tensor's exact twin
    runs on its own device; only the strided error comes back."""
    mon = _monitor()
    if mon is None:
        return
    n_adds = sum(max(len(st.offsets) - 1, 1) for st in stages)
    if isinstance(q, torch.Tensor):
        err = (out.to(torch.int64) - _exact_filter_chain_torch(q, stages)
               ).abs()
    else:
        err = np.abs(np.asarray(out).astype(np.int64)
                     - _exact_filter_chain(np.asarray(q), stages))
    mon.observe_errors(_stage_label(), _flat_sample(err) / n_adds,
                       n_adds=n_adds)


def _exact_filter_chain(q: np.ndarray, stages) -> np.ndarray:
    """The exact-adder twin of ``Backend.filter_chain`` on signed ints."""
    x = q.astype(np.int64)
    for st in stages:
        n = x.shape[st.axis]
        acc = np.zeros_like(x)
        for off, w in zip(st.offsets, st.weights):
            idx = np.clip(np.arange(n) + off, 0, n - 1)
            acc = acc + int(w) * np.take(x, idx, axis=st.axis)
        if st.shift:
            acc = (acc + (1 << (st.shift - 1))) >> st.shift
        x = acc
    return x


def _exact_filter_chain_torch(q: torch.Tensor, stages) -> torch.Tensor:
    """:func:`_exact_filter_chain` on int64 lanes on ``q``'s device (the
    same integers: exact products and sums, arithmetic shifts)."""
    x = q.to(torch.int64)
    for st in stages:
        axis = st.axis % x.ndim
        n = x.shape[axis]
        base = torch.arange(n, device=x.device)
        acc = torch.zeros_like(x)
        for off, w in zip(st.offsets, st.weights):
            acc = acc + int(w) * x.index_select(axis,
                                                (base + off).clamp(0, n - 1))
        if st.shift:
            acc = (acc + (1 << (st.shift - 1))) >> st.shift
        x = acc
    return x
