"""Canary probes: known-answer vectors through the live engine (the port
of ``repro.integrity.canary``).

Scrubbing (:mod:`repro_torch.integrity.scrub`) covers the shared tables,
but a fault can also live PAST them — a stuck output bus
(``make_engine(..., fault=...)`` models exactly this), a broken kernel
build, a wrong backend dispatch.  The canary closes that gap: a tiny
deterministic operand vector runs through the *live* engine, on its own
device, on a cadence, and the output is compared bit-for-bit against the
expected approximate sums **precomputed from the exact delta tables** —
``expected = (a + b + delta[(a_low << m) | b_low]) mod 2^N``.

Because every strategy/backend is bit-identical to the delta-table
prediction by contract, a healthy engine can NEVER fail its canary
(zero false positives by construction, no statistical band needed),
while any datapath fault that touches even one probe output trips it.
The probes go through the engine as the containers its backend takes:
int64 lanes on ``"torch"``, the kernels' int32 patterns on ``"cuda"``
(so a canary on a ``"cuda"`` engine launches ``lut_add`` or
``approx_add``, and ``mul`` for the multiplier probe); the outputs are
masked back to N bits.  Detections feed the same alarm paths as the
scrubber: a :class:`~repro_torch.serving.breaker.CircuitBreaker`, a
:class:`~repro_torch.resilience.degrade.DegradePolicy`, and
``integrity.*`` metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.serving.clock import Clock, WallClock

__all__ = ["CanaryReport", "CanarySuite", "make_probe",
           "expected_add_outputs"]


@dataclasses.dataclass(frozen=True)
class CanaryReport:
    """One canary pass: probe count and bit-exact mismatch counts."""

    checked: int
    add_mismatches: int
    mul_mismatches: int
    at: float

    @property
    def ok(self) -> bool:
        return self.add_mismatches == 0 and self.mul_mismatches == 0

    def __repr__(self) -> str:
        return (f"CanaryReport(checked={self.checked}, "
                f"add_mismatches={self.add_mismatches}, "
                f"mul_mismatches={self.mul_mismatches}, at={self.at:.3f})")


def make_probe(n_bits: int, n: int = 256,
               seed: int = 0) -> tuple:
    """Seeded deterministic operand pair covering the N-bit range
    (uniform draws plus the all-zeros / all-ones / sign-boundary corner
    values every stuck-at fault must touch), as uint64 host arrays."""
    rng = np.random.default_rng(seed)
    top = 1 << n_bits
    corners = np.array([0, top - 1, top >> 1, (top >> 1) - 1, 1],
                       dtype=np.uint64)
    a = np.concatenate([corners,
                        rng.integers(0, top, size=n, dtype=np.uint64)])
    b = np.concatenate([corners[::-1],
                        rng.integers(0, top, size=n, dtype=np.uint64)])
    return a, b


def expected_add_outputs(spec, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The bit-exact expected approximate sums, from the exact delta
    table (or the plain sum for exact kinds): uint64 mod 2^N."""
    from repro_torch.ax.lut import error_delta_table, lut_index, \
        lut_supported
    from repro_torch.ax.registry import get_adder

    mask = np.uint64((1 << spec.n_bits) - 1)
    exact = (a + b) & mask
    if get_adder(spec.kind).is_exact:
        return exact
    if not lut_supported(spec):
        raise ValueError(
            f"no delta table for {spec.short_name} (lsm_bits too wide); "
            f"canary expectations need a compilable LUT")
    delta = error_delta_table(spec)[np.asarray(lut_index(a, b, spec),
                                               dtype=np.int64)]
    return (exact + delta.astype(np.uint64)) & mask


def _lanes(x: np.ndarray, backend: str, device) -> torch.Tensor:
    """Probe operands as the engine's backend takes them: the kernels'
    int32 patterns on ``"cuda"``, int64 lanes elsewhere."""
    if backend == "cuda":
        arr = x.astype(np.uint32).view(np.int32)
    else:
        arr = x.astype(np.int64)
    return torch.from_numpy(arr).to(device)


class CanarySuite:
    """Cadenced known-answer checks against one live engine.

    Args:
      engine: the :class:`~repro_torch.ax.engine.AxEngine` under watch
        (its backend/strategy/fault/device knobs are exactly what gets
        probed).
      n / seed: probe-vector size and seed (deterministic).
      interval_s / clock: cadence on the injectable serving clock.
      breaker / policy / alarm: detection alarm feed, identical to
        :class:`~repro_torch.integrity.scrub.LutScrubber`.
    """

    def __init__(self, engine, *, n: int = 256, seed: int = 0,
                 interval_s: float = 60.0,
                 clock: Optional[Clock] = None, breaker=None, policy=None,
                 alarm: Optional[Callable[[CanaryReport], None]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0; got {interval_s}")
        self.engine = engine
        self.interval_s = float(interval_s)
        self.clock = clock if clock is not None else WallClock()
        self.breaker = breaker
        self.policy = policy
        self.alarm = alarm
        self.runs = 0
        self.failures = 0
        self.last_report: Optional[CanaryReport] = None
        self._next_due = self.clock.now() + self.interval_s

        spec = engine.spec
        backend, dev = engine.backend.name, engine.device
        self._a, self._b = make_probe(spec.n_bits, n=n, seed=seed)
        self._expected = expected_add_outputs(spec, self._a, self._b)
        self._a_dev = _lanes(self._a, backend, dev)
        self._b_dev = _lanes(self._b, backend, dev)
        self._expected_dev = torch.from_numpy(
            self._expected.astype(np.int64)).to(dev)
        self._mul = self._prepare_mul(engine, n, seed)

    def _prepare_mul(self, engine, n: int, seed: int):
        """Multiplier probe (engines with ``mul_spec``): expected
        products from the exact mul delta table, where compilable; the
        operands and expectations held on the engine's device."""
        from repro_torch.ax.mul.lut import (MAX_MUL_DELTA_BITS,
                                            mul_error_delta_table,
                                            mul_lut_index)
        ms = engine.mul_spec
        if ms is None or ms.is_exact or ms.n_bits > MAX_MUL_DELTA_BITS:
            return None
        ma, mb = make_probe(ms.n_bits, n=n, seed=seed + 1)
        idx = np.asarray(mul_lut_index(ma, mb, ms.n_bits), dtype=np.int64)
        delta = mul_error_delta_table(ms)[idx].astype(np.int64)
        expected = (ma * mb).astype(np.int64) + delta
        backend, dev = engine.backend.name, engine.device
        return (_lanes(ma, backend, dev), _lanes(mb, backend, dev),
                torch.from_numpy(expected).to(dev))

    # ------------------------------------------------------------ runs --

    def due(self, now: Optional[float] = None) -> bool:
        now = self.clock.now() if now is None else now
        return now >= self._next_due

    def maybe_run(self, now: Optional[float] = None
                  ) -> Optional[CanaryReport]:
        """One cadence tick (the scheduler calls this every pump)."""
        now = self.clock.now() if now is None else now
        if not self.due(now):
            return None
        return self.run_once(now)

    def run_once(self, now: Optional[float] = None) -> CanaryReport:
        now = self.clock.now() if now is None else now
        self._next_due = now + self.interval_s
        if _obs._ENABLED:
            with _obs.span("integrity:canary",
                           kind=self.engine.spec.kind,
                           backend=self.engine.backend.name):
                report = self._probe(now)
            _metrics.counter("integrity.canary_runs").inc()
            if not report.ok:
                _metrics.counter("integrity.canary_failures").inc()
        else:
            report = self._probe(now)
        self.runs += 1
        self.last_report = report
        if not report.ok:
            self.failures += 1
            self._raise_alarm(report, now)
        return report

    def _probe(self, now: float) -> CanaryReport:
        mask = (1 << self.engine.spec.n_bits) - 1
        got = self.engine.add(self._a_dev, self._b_dev).to(torch.int64)
        bad = [torch.count_nonzero((got & mask) != self._expected_dev)]
        checked = int(self._expected.size)
        if self._mul is not None:
            ma, mb, expected = self._mul
            prod = self.engine.mul(ma, mb).to(torch.int64)
            bad.append(torch.count_nonzero(prod != expected))
            checked += int(expected.numel())
        # One device-to-host copy a run: every mismatch count.
        add_bad, mul_bad = torch.stack(bad).tolist() + [0] * (2 - len(bad))
        return CanaryReport(checked=checked, add_mismatches=add_bad,
                            mul_mismatches=mul_bad, at=now)

    def _raise_alarm(self, report: CanaryReport, now: float) -> None:
        if self.breaker is not None:
            self.breaker.record_integrity(now)
        if self.policy is not None:
            self.policy.on_integrity_alarm(report)
        if self.alarm is not None:
            self.alarm(report)

    def __repr__(self) -> str:
        return (f"CanarySuite({self.engine.spec.short_name}, "
                f"runs={self.runs}, failures={self.failures})")
