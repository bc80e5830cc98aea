"""Synthetic traffic: seeded open-loop Poisson arrivals + the report (the
port's copy of ``repro.serving.traffic``).

Open-loop means arrivals do NOT wait for the system — request ``i``
arrives at its scripted instant whether or not the scheduler has kept
up, which is what makes overload measurable (a closed loop self-throttles
and hides saturation).  Inter-arrival gaps are exponential
(Poisson process) from a seeded generator, image sizes/priorities are
drawn from the mix's weights, and image CONTENT is the deterministic
synthetic generator — so a traffic run is a pure function of
``(mix, n, seed)`` and replays exactly under a virtual clock.

:class:`ServeReport` aggregates the typed outcomes into the serving
SLO numbers: p50/p99 latency of accepted requests, sustained goodput
(MPix/s of in-deadline completions over the makespan), and
shed / reject / retry / deadline-miss rates — the record shape
committed to ``BENCH_serve.json``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.serving.clock import Clock
from repro_torch.serving.request import (Completed, Failed, Outcome, Rejected,
                                   Request, Shed)
from repro_torch.serving.scheduler import Scheduler


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """One traffic shape.

    Attributes:
      name: mix identity (trajectory key).
      rate_rps: mean arrival rate, requests/second.
      sizes: square image sides to draw from.
      size_weights: draw weights (defaults to uniform).
      deadline_s: relative deadline stamped on every request
        (``inf`` = no SLO).
      priorities / priority_weights: priority levels to draw from.
      pipeline: pipeline key every request asks for.
    """

    name: str
    rate_rps: float
    sizes: Tuple[int, ...] = (32,)
    size_weights: Optional[Tuple[float, ...]] = None
    deadline_s: float = float("inf")
    priorities: Tuple[int, ...] = (0,)
    priority_weights: Optional[Tuple[float, ...]] = None
    pipeline: str = "pipe_blur_sharpen_down"

    def __post_init__(self):
        if not self.rate_rps > 0:
            raise ValueError(f"rate_rps must be > 0; got {self.rate_rps}")
        if not self.sizes:
            raise ValueError("sizes must be non-empty")

    @property
    def mean_pixels(self) -> float:
        w = self.size_weights or (1.0,) * len(self.sizes)
        tot = sum(w)
        return sum(s * s * wi / tot for s, wi in zip(self.sizes, w))


#: Stock mixes: many small images vs. a megapixel-heavy tail.
SMALL_MIX = TrafficMix("small", rate_rps=200.0, sizes=(32,),
                       deadline_s=0.25)
MIXED_MIX = TrafficMix("mixed", rate_rps=60.0, sizes=(32, 64, 128),
                       size_weights=(0.7, 0.2, 0.1), deadline_s=0.5,
                       priorities=(0, 1), priority_weights=(0.8, 0.2))


def make_arrivals(mix: TrafficMix, n: int, seed: int = 0,
                  start: float = 0.0
                  ) -> List[Tuple[float, Request]]:
    """``n`` seeded open-loop arrivals: ``(absolute_instant, Request)``
    pairs, time-ordered.  Deterministic in ``(mix, n, seed, start)``."""
    from repro_torch.image.pipeline import synthetic_image
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / mix.rate_rps, size=n)
    t = start + np.cumsum(gaps)
    size_w = np.asarray(mix.size_weights
                        or (1.0,) * len(mix.sizes), dtype=np.float64)
    sizes = rng.choice(np.asarray(mix.sizes), size=n,
                       p=size_w / size_w.sum())
    prio_w = np.asarray(mix.priority_weights
                        or (1.0,) * len(mix.priorities), dtype=np.float64)
    prios = rng.choice(np.asarray(mix.priorities), size=n,
                       p=prio_w / prio_w.sum())
    arrivals = []
    for i in range(n):
        img = synthetic_image(int(sizes[i]), seed=seed + 31 * i)
        arrivals.append((float(t[i]), Request(
            image=img, pipeline=mix.pipeline,
            deadline=float(t[i]) + mix.deadline_s,
            priority=int(prios[i]))))
    return arrivals


def run_traffic(scheduler: Scheduler,
                arrivals: Sequence[Tuple[float, Request]],
                mix_name: str = "") -> "ServeReport":
    """Replay ``arrivals`` open-loop through ``scheduler`` on ITS clock:
    wait (on the clock) until each scripted instant, submit, pump; then
    drain.  Per-request deadlines are shifted by the clock's offset
    from the arrival script's epoch, so relative SLOs survive wall- and
    virtual-clock runs alike."""
    clock: Clock = scheduler.clock
    t_base = clock.now()
    first = len(scheduler.outcomes)
    # The timer tick a real serving loop has: while waiting out an
    # arrival gap with work queued, pump every ``max_wait_s`` so a
    # partial batch dispatches on ITS schedule, not the next arrival's
    # (otherwise light-load latency would be an artifact of the gaps).
    tick = max(scheduler.batcher.cfg.max_wait_s, 1e-4)
    for t, req in arrivals:
        due = t_base + t
        while True:
            now = clock.now()
            if due <= now:
                break
            if len(scheduler.queue):
                clock.sleep(min(due - now, tick))
                scheduler.pump()
            else:
                clock.sleep(due - now)
        shifted = dataclasses.replace(
            req, deadline=req.deadline + t_base)
        scheduler.submit(shifted)
        scheduler.pump()
    scheduler.drain()
    return ServeReport(
        mix=mix_name,
        outcomes=tuple(scheduler.outcomes[first:]),
        seconds=clock.now() - t_base,
        breaker_trips=(scheduler.breaker.trips
                       if scheduler.breaker is not None else 0))


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Aggregated SLO view of one traffic run."""

    mix: str
    outcomes: Tuple[Outcome, ...]
    seconds: float
    breaker_trips: int = 0

    # ------------------------------------------------------ partitions --

    @property
    def completed(self) -> Tuple[Completed, ...]:
        return tuple(o for o in self.outcomes if isinstance(o, Completed))

    @property
    def rejected(self) -> Tuple[Rejected, ...]:
        return tuple(o for o in self.outcomes if isinstance(o, Rejected))

    @property
    def shed(self) -> Tuple[Shed, ...]:
        return tuple(o for o in self.outcomes if isinstance(o, Shed))

    @property
    def failed(self) -> Tuple[Failed, ...]:
        return tuple(o for o in self.outcomes if isinstance(o, Failed))

    @property
    def offered(self) -> int:
        """Requests that entered the system (everything but re-emits)."""
        return len(self.completed) + len(self.rejected) \
            + len(self.shed) + len(self.failed)

    # --------------------------------------------------------- metrics --

    @property
    def latencies(self) -> Tuple[float, ...]:
        return tuple(o.latency for o in self.completed)

    @property
    def p50_s(self) -> float:
        return _metrics.quantile(self.latencies, 50.0)

    @property
    def p99_s(self) -> float:
        return _metrics.quantile(self.latencies, 99.0)

    @property
    def deadline_misses(self) -> int:
        return sum(o.missed_deadline for o in self.completed)

    @property
    def retries(self) -> int:
        """Extra dispatch attempts beyond each request's first."""
        return sum(o.attempts - 1 for o in self.completed) \
            + sum(o.attempts - 1 for o in self.failed)

    @property
    def goodput_mpix_per_s(self) -> float:
        """In-deadline completed megapixels over the makespan — the
        only pixels the SLO gives credit for."""
        if self.seconds <= 0:
            return 0.0
        pix = sum(o.request.pixels for o in self.completed
                  if not o.missed_deadline)
        return pix / self.seconds / 1e6

    def _rate(self, k: int) -> float:
        return k / self.offered if self.offered else 0.0

    @property
    def reject_rate(self) -> float:
        return self._rate(len(self.rejected))

    @property
    def shed_rate(self) -> float:
        return self._rate(len(self.shed))

    @property
    def deadline_miss_rate(self) -> float:
        return self._rate(self.deadline_misses)

    # ---------------------------------------------------------- export --

    def record(self, **identity) -> Dict[str, object]:
        """One ``BENCH_serve.json`` trajectory record; ``identity``
        adds/overrides cell-identity fields (load factor, backend...)."""
        rec: Dict[str, object] = {
            "op": "serve_traffic", "mix": self.mix,
            "offered": self.offered,
            **identity,
            "completed": len(self.completed),
            "p50_ms": self.p50_s * 1e3,
            "p99_ms": self.p99_s * 1e3,
            "goodput_mpix_per_s": self.goodput_mpix_per_s,
            "reject_rate": self.reject_rate,
            "shed_rate": self.shed_rate,
            "deadline_miss_rate": self.deadline_miss_rate,
            "retries": self.retries,
            "breaker_trips": self.breaker_trips,
        }
        for k in ("p50_ms", "p99_ms"):
            if isinstance(rec[k], float) and math.isnan(rec[k]):
                rec[k] = None
        return rec

    def summary(self) -> str:
        return (f"{self.mix or 'traffic'}: {self.offered} offered, "
                f"{len(self.completed)} completed "
                f"({self.deadline_misses} late), "
                f"{len(self.rejected)} rejected, {len(self.shed)} shed, "
                f"{len(self.failed)} failed | "
                f"p50={self.p50_s * 1e3:.2f} ms "
                f"p99={self.p99_s * 1e3:.2f} ms "
                f"goodput={self.goodput_mpix_per_s:.2f} MPix/s")
