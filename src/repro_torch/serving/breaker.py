"""Circuit breaker over the serving executor (the port's copy of
``repro.serving.breaker``).

A pipeline that fails persistently — a poisoned config, a hardware
defect the drift monitor keeps flagging, an executor that throws on
every batch — must not be hammered with live traffic while it burns.
:class:`CircuitBreaker` implements the classic three-state machine on
the serving stack's clock:

- **closed**: traffic flows; consecutive failures are counted (any
  success resets the count).
- **open**: tripped — dispatch is blocked for ``cooldown_s``.  On the
  trip, if a :class:`~repro_torch.resilience.degrade.DegradePolicy` is
  attached, the serving config is stepped one rung down the exact
  Pareto ladder (:meth:`DegradePolicy.force_fallback`) — the same
  self-healing path the policy's drift trips take, so when traffic resumes it
  runs on a healthier operating point.
- **half-open**: the cooldown elapsed; ONE probe batch is allowed
  through.  ``probe_successes`` clean probes close the breaker;
  any probe failure re-opens it (and may step another rung).

Trips come from two signals, matching the resilience stack:
consecutive executor failures (:meth:`record_failure`) and
:class:`~repro_torch.obs.drift.DriftMonitor` alarms (:meth:`record_drift` —
an alarm trips immediately; drift is a measured quality breach, not a
maybe).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs

#: Breaker states.
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Trip/recovery knobs.

    Attributes:
      failure_threshold: consecutive failures that trip a closed
        breaker.
      cooldown_s: seconds an open breaker blocks dispatch before
        allowing a half-open probe.
      probe_successes: clean half-open probes required to close.
    """

    failure_threshold: int = 3
    cooldown_s: float = 1.0
    probe_successes: int = 1

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1; "
                             f"got {self.failure_threshold}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0; got {self.cooldown_s}")
        if self.probe_successes < 1:
            raise ValueError(f"probe_successes must be >= 1; "
                             f"got {self.probe_successes}")


class CircuitBreaker:
    """Three-state breaker; optionally degrades via a
    :class:`~repro_torch.resilience.degrade.DegradePolicy` on every trip.

    All timing flows through the caller-supplied ``now`` arguments so
    the breaker is clock-agnostic (virtual in tests, wall in
    production) and fully deterministic.
    """

    def __init__(self, cfg: Optional[BreakerConfig] = None, *,
                 policy=None):
        self.cfg = cfg if cfg is not None else BreakerConfig()
        self.policy = policy
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = float("-inf")
        self._probe_successes = 0

    # ------------------------------------------------------------ gate --

    def allow(self, now: float) -> bool:
        """Whether a batch may dispatch at ``now``.  An open breaker
        whose cooldown elapsed transitions to half-open and allows the
        probe."""
        if self.state == OPEN:
            if now - self._opened_at >= self.cfg.cooldown_s:
                self.state = HALF_OPEN
                self._probe_successes = 0
        return self.state != OPEN

    @property
    def probing(self) -> bool:
        """Half-open: dispatch is restricted to one probe batch."""
        return self.state == HALF_OPEN

    def retry_after(self, now: float) -> float:
        """Seconds until an open breaker will allow its half-open probe
        (0 when dispatch is already possible)."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self.cfg.cooldown_s - (now - self._opened_at))

    # --------------------------------------------------------- signals --

    def record_success(self, now: float) -> None:
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self._probe_successes += 1
            if self._probe_successes >= self.cfg.probe_successes:
                self.state = CLOSED
                if _obs._ENABLED:
                    _metrics.counter("serve.breaker_closes").inc()

    def record_failure(self, now: float) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._trip(now)                      # failed probe: re-open
        elif self.state == CLOSED and \
                self.consecutive_failures >= self.cfg.failure_threshold:
            self._trip(now)

    def record_drift(self, now: float) -> None:
        """A DriftMonitor alarm: measured quality left the config's
        exact band — trip immediately (no failure count needed)."""
        if self.state != OPEN:
            self._trip(now)

    def record_integrity(self, now: float) -> None:
        """An integrity alarm (LUT scrub detection, failed canary,
        ABFT flag): corruption was OBSERVED, not suspected — trip
        immediately, same contract as :meth:`record_drift`."""
        if _obs._ENABLED:
            _metrics.counter("serve.integrity_alarms").inc()
        if self.state != OPEN:
            self._trip(now)

    def _trip(self, now: float) -> None:
        self.trips += 1
        self.state = OPEN
        self._opened_at = now
        self.consecutive_failures = 0
        if self.policy is not None:
            self.policy.force_fallback()
        if _obs._ENABLED:
            _metrics.counter("serve.breaker_trips").inc()

    def __repr__(self) -> str:
        rung = "" if self.policy is None else \
            f", rung={self.policy.level}/{len(self.policy.ladder)}"
        return (f"CircuitBreaker({self.state}, trips={self.trips}, "
                f"consecutive_failures={self.consecutive_failures}{rung})")
