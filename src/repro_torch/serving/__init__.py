"""``repro_torch.serving`` — deadline-aware request scheduling over the
compiled-plan / tiled / streaming stack (the port of ``repro.serving``).

The resilience layer hardens the inside of a stream (fault injection,
drift-triggered degradation, deadline retries); this package is the
FRONT DOOR: the layer that protects the pipeline from overload, expired
work and persistently failing configs.  Plans run on the card by
default; integrity watchdogs (:mod:`repro_torch.integrity`) ride the
scheduler's pump.

Components (each its own module, composed by :class:`Scheduler`):

- :class:`Request` + typed outcomes (:class:`Completed`,
  :class:`Rejected`, :class:`Shed`, :class:`Failed`) —
  ``repro_torch.serving.request``;
- bounded admission queue with backpressure and priority preemption —
  ``repro_torch.serving.queue``;
- deadline-aware dynamic batcher (dispatch on full / deadline margin /
  max wait; shed expired and doomed work) — ``repro_torch.serving.batcher``;
- circuit breaker with Pareto-ladder degradation and half-open probes
  — ``repro_torch.serving.breaker``;
- EWMA service-time estimator — ``repro_torch.serving.estimator``;
- injectable clocks (wall / virtual-deterministic) —
  ``repro_torch.serving.clock``;
- executors (compiled plans or deterministic simulation) —
  ``repro_torch.serving.executor``;
- seeded open-loop Poisson traffic + the ``BENCH_serve.json`` report —
  ``repro_torch.serving.traffic``.

    from repro_torch import serving

    sched = serving.Scheduler(
        serving.PlanExecutor.compile(("pipe_blur_sharpen_down",)),
        admission=serving.AdmissionConfig(max_depth=64,
                                          max_backlog_s=0.25),
        batching=serving.BatcherConfig(max_batch=4, max_wait_s=0.005))
    report = serving.run_traffic(
        sched, serving.make_arrivals(serving.SMALL_MIX, n=200, seed=0))
    print(report.summary())
"""

from repro_torch.serving.batcher import (  # noqa: F401
    Batch,
    Batcher,
    BatcherConfig,
)
from repro_torch.serving.breaker import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerConfig,
    CircuitBreaker,
)
from repro_torch.serving.clock import (  # noqa: F401
    Clock,
    VirtualClock,
    WallClock,
)
from repro_torch.serving.estimator import CostEstimator  # noqa: F401
from repro_torch.serving.executor import (  # noqa: F401
    PlanExecutor,
    SimExecutor,
)
from repro_torch.serving.queue import (  # noqa: F401
    AdmissionConfig,
    AdmissionQueue,
)
from repro_torch.serving.request import (  # noqa: F401
    Completed,
    Failed,
    Outcome,
    Rejected,
    Request,
    Shed,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Scheduler,
    SchedulerConfig,
)
from repro_torch.serving.traffic import (  # noqa: F401
    MIXED_MIX,
    SMALL_MIX,
    ServeReport,
    TrafficMix,
    make_arrivals,
    run_traffic,
)

__all__ = [
    "AdmissionConfig", "AdmissionQueue", "Batch", "Batcher",
    "BatcherConfig", "BreakerConfig", "CLOSED", "CircuitBreaker",
    "Clock", "Completed", "CostEstimator", "Failed", "HALF_OPEN",
    "MIXED_MIX", "OPEN", "Outcome", "PlanExecutor", "Rejected",
    "Request", "Scheduler", "SchedulerConfig", "ServeReport", "Shed",
    "SimExecutor", "SMALL_MIX", "TrafficMix", "VirtualClock",
    "WallClock", "make_arrivals", "run_traffic",
]
