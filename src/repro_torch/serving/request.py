"""Request model and typed serving outcomes (the port's copy of
``repro.serving.request``).

A :class:`Request` is one image + the pipeline that should run on it +
an absolute completion deadline + a priority.  Every request submitted
to the scheduler ends in exactly ONE typed :class:`Outcome`:

- :class:`Completed` — it ran; carries the output, timing breakdown and
  attempt count (``missed_deadline`` marks a result that arrived after
  its deadline — late but served).
- :class:`Rejected` — admission control turned it away at ``submit``
  time (queue depth or estimated backlog over capacity).  Backpressure
  is a VALUE, not an exception: an overloaded front door returns
  ``Rejected`` objects, it does not raise.
- :class:`Shed` — admitted but dropped before running: its deadline
  expired in the queue, it became doomed (could not possibly finish in
  time), or a higher-priority request evicted it from a full queue.
- :class:`Failed` — dispatched but the executor raised on every
  attempt (after retries and poisoned-request isolation).

The partition matters for the overload contract: work the system will
not finish in time is refused or shed *up front* (cheap), never run to
a worthless late result (expensive).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Tuple

import numpy as np

_RID = itertools.count()


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of serving work.

    Attributes:
      image: the input image, ``(H, W)`` uint8 (batched by the
        scheduler with shape-compatible peers).
      pipeline: key of the compiled pipeline to run (a name the
        executor resolves, e.g. one of
        :data:`repro_torch.imgproc.plan.PIPELINES`).
      deadline: ABSOLUTE clock instant (scheduler's clock) by which the
        result must be on the host.  ``inf`` = no SLO.
      priority: larger = more important; ties break FIFO.
      rid: unique request id (auto-assigned).
      arrival: stamped by the scheduler at ``submit`` time.
    """

    image: np.ndarray = dataclasses.field(compare=False)
    pipeline: str = "pipe_blur_sharpen_down"
    deadline: float = float("inf")
    priority: int = 0
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))
    arrival: float = float("nan")

    @property
    def pixels(self) -> int:
        return int(np.prod(np.shape(self.image)))

    @property
    def bucket(self) -> Tuple[str, Tuple[int, ...]]:
        """Batching compatibility key: same pipeline, same image shape
        (stacked requests must form a rectangular batch)."""
        return (self.pipeline, tuple(np.shape(self.image)))


@dataclasses.dataclass(frozen=True)
class Outcome:
    """Base of the four terminal request states."""

    request: Request

    ok = False

    @property
    def rid(self) -> int:
        return self.request.rid


@dataclasses.dataclass(frozen=True)
class Completed(Outcome):
    """Served.  ``latency`` is what the caller experienced (arrival →
    result on host); ``started``/``finished`` bound the execution, and
    ``attempts`` counts dispatches (1 = clean first try)."""

    output: Any = None
    started: float = float("nan")
    finished: float = float("nan")
    queue_wait: float = float("nan")
    service_s: float = float("nan")
    attempts: int = 1
    late: bool = False          # StragglerMonitor.late verdict on the batch

    ok = True

    @property
    def latency(self) -> float:
        return self.finished - self.request.arrival

    @property
    def missed_deadline(self) -> bool:
        return self.finished > self.request.deadline


@dataclasses.dataclass(frozen=True)
class Rejected(Outcome):
    """Refused at admission (backpressure).  ``reason`` is one of
    ``"queue_full"`` / ``"backlog"``; ``depth``/``backlog_s`` snapshot
    the queue state that justified the refusal."""

    reason: str = "queue_full"
    depth: int = 0
    backlog_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Shed(Outcome):
    """Admitted, then dropped without running.  ``reason``:

    - ``"expired"``: its deadline passed while it waited.
    - ``"doomed"``: estimated service time says it cannot finish before
      its deadline — running it would be wasted work.
    - ``"preempted"``: evicted from a full queue by a higher-priority
      arrival.
    """

    reason: str = "expired"
    at: float = float("nan")


@dataclasses.dataclass(frozen=True)
class Failed(Outcome):
    """Every dispatch attempt raised; ``error`` is the last exception's
    text, ``attempts`` how many times it ran."""

    error: str = ""
    attempts: int = 1
