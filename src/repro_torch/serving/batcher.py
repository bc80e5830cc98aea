"""Deadline-aware dynamic batching (the port's copy of
``repro.serving.batcher``).

Batching amortizes dispatch overhead (one plan call serves many
requests), but a batch held too long trades throughput for latency.
The batcher dispatches a bucket (same pipeline × same image shape) when
ANY of:

- it is **full** (``max_batch`` requests stacked);
- the **oldest request's deadline margin** is about to be violated:
  remaining slack ``deadline - now`` no longer covers the estimated
  batch service time times a ``safety`` factor — waiting any longer
  risks the SLO;
- the oldest request has waited ``max_wait_s`` (the light-load latency
  floor: with arrivals too sparse to fill batches, nobody waits more
  than this for company).

Before forming batches it sheds work that is no longer worth running:
**expired** requests (deadline already passed) and **doomed** ones
(estimated service time cannot fit in the remaining slack) are dropped
as typed :class:`~repro_torch.serving.request.Shed` outcomes instead of
burning capacity on results nobody can use.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.serving.estimator import CostEstimator
from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.request import Request, Shed


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Batching knobs.

    Attributes:
      max_batch: requests stacked per dispatch (the batch axis).
      max_wait_s: light-load latency floor — dispatch a partial batch
        once its oldest member has waited this long.
      safety: margin factor on estimated service time for both the
        dispatch-now decision and the doomed test (1.0 = trust the
        estimate exactly; >1 leaves headroom for estimate error).
      shed_doomed: whether to shed requests whose deadline cannot be
        met even if dispatched immediately.
    """

    max_batch: int = 4
    max_wait_s: float = 0.005
    safety: float = 1.5
    shed_doomed: bool = True

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0; got {self.max_wait_s}")
        if self.safety <= 0:
            raise ValueError(f"safety must be > 0; got {self.safety}")


@dataclasses.dataclass(frozen=True)
class Batch:
    """One dispatch unit: shape-compatible requests, oldest first."""

    bucket: Tuple
    requests: Tuple[Request, ...]
    formed_at: float

    @property
    def pipeline(self) -> str:
        return self.bucket[0]

    @property
    def pixels(self) -> int:
        return sum(r.pixels for r in self.requests)

    def __len__(self) -> int:
        return len(self.requests)


class Batcher:
    def __init__(self, cfg: Optional[BatcherConfig] = None,
                 estimator: Optional[CostEstimator] = None):
        self.cfg = cfg if cfg is not None else BatcherConfig()
        self.estimator = estimator if estimator is not None \
            else CostEstimator()

    # ---------------------------------------------------------- shedding --

    def shed(self, queue: AdmissionQueue, now: float) -> List[Shed]:
        """Drop expired/doomed requests from ``queue``; returns the
        typed outcomes (empty on a healthy queue)."""
        sheds: List[Shed] = []
        for bucket in queue.buckets():
            for req in queue.requests(bucket):
                if now >= req.deadline:
                    queue.remove(req)
                    sheds.append(Shed(req, reason="expired", at=now))
                elif self.cfg.shed_doomed and req.deadline != float("inf") \
                        and now + self._service(req.pixels) > req.deadline:
                    queue.remove(req)
                    sheds.append(Shed(req, reason="doomed", at=now))
        return sheds

    def _service(self, pixels: int) -> float:
        return self.estimator.estimate(pixels) * self.cfg.safety

    # ---------------------------------------------------------- batching --

    def due(self, queue: AdmissionQueue, bucket, now: float) -> bool:
        """Whether ``bucket`` should dispatch now (full, deadline
        margin about to be violated, or max-wait exceeded)."""
        reqs = queue.requests(bucket)
        if not reqs:
            return False
        if len(reqs) >= self.cfg.max_batch:
            return True
        oldest = reqs[0]
        if now - oldest.arrival >= self.cfg.max_wait_s:
            return True
        batch_pixels = sum(r.pixels
                           for r in reqs[:self.cfg.max_batch])
        slack = oldest.deadline - now
        return slack <= self._service(batch_pixels)

    def collect(self, queue: AdmissionQueue, now: float, *,
                force: bool = False,
                limit: Optional[int] = None) -> List[Batch]:
        """Form every due batch (or, with ``force``, every non-empty
        bucket — the drain path).  ``limit`` caps the number of batches
        formed (the circuit breaker's half-open probe takes 1)."""
        batches: List[Batch] = []
        for bucket in queue.buckets():
            while queue.requests(bucket) and \
                    (force or self.due(queue, bucket, now)):
                reqs = queue.take(bucket, self.cfg.max_batch)
                if not reqs:
                    break
                batches.append(Batch(bucket=bucket, requests=reqs,
                                     formed_at=now))
                if limit is not None and len(batches) >= limit:
                    return batches
                if not force and not self.due(queue, bucket, now):
                    break
        return batches
