"""Bounded admission queue: backpressure at the front door (the
port's copy of ``repro.serving.queue``).

An unprotected queue turns overload into unbounded memory growth and
unbounded latency — every queued request waits behind all earlier ones,
so once offered load exceeds capacity, latency diverges for EVERYONE.
:class:`AdmissionQueue` bounds both: a request is admitted only while
(a) queue depth is under ``max_depth`` and (b) the ESTIMATED backlog
latency — total estimated service time already queued, plus the
newcomer's own — fits in ``max_backlog_s``.  Refusal is a typed
:class:`~repro_torch.serving.request.Rejected` value (backpressure the caller
can act on), never an exception.

Priorities matter exactly at the full boundary: a higher-priority
arrival may evict ("preempt") the lowest-priority queued request
instead of being rejected, so importance survives overload without
unbounding the queue.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.estimator import CostEstimator
from repro_torch.serving.request import Rejected, Request


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control knobs.

    Attributes:
      max_depth: hard cap on queued (admitted, undispatched) requests.
      max_backlog_s: cap on estimated backlog latency — the sum of
        estimated service times of everything queued.  ``inf`` disables
        the latency bound (depth still applies).
      preempt: whether a strictly-higher-priority arrival may evict the
        lowest-priority queued request when the queue is full.
    """

    max_depth: int = 64
    max_backlog_s: float = float("inf")
    preempt: bool = True

    def __post_init__(self):
        if self.max_depth < 1:
            raise ValueError(
                f"max_depth must be >= 1; got {self.max_depth}")
        if not self.max_backlog_s > 0:
            raise ValueError(
                f"max_backlog_s must be > 0; got {self.max_backlog_s}")


class AdmissionQueue:
    """FIFO-per-bucket queue with depth + estimated-latency admission.

    Requests are held per :attr:`Request.bucket` (pipeline × image
    shape) so the batcher can always stack what it takes.  Within a
    bucket, dispatch order is priority-descending then FIFO.
    """

    def __init__(self, cfg: Optional[AdmissionConfig] = None,
                 estimator: Optional[CostEstimator] = None):
        self.cfg = cfg if cfg is not None else AdmissionConfig()
        self.estimator = estimator if estimator is not None \
            else CostEstimator()
        self._buckets: Dict[Tuple, List[Request]] = {}
        self._seq: Dict[int, int] = {}      # rid -> admission order
        self._next_seq = 0

    # ----------------------------------------------------------- state --

    @property
    def depth(self) -> int:
        return sum(len(v) for v in self._buckets.values())

    def backlog_s(self) -> float:
        """Estimated seconds of service already queued."""
        return sum(self.estimator.estimate(r.pixels)
                   for v in self._buckets.values() for r in v)

    def buckets(self) -> Tuple[Tuple, ...]:
        """Non-empty bucket keys, oldest-admission first."""
        order = {b: min(self._seq[r.rid] for r in v)
                 for b, v in self._buckets.items() if v}
        return tuple(sorted(order, key=order.get))

    def requests(self, bucket) -> Tuple[Request, ...]:
        """The bucket's queued requests in admission order."""
        return tuple(sorted(self._buckets.get(bucket, ()),
                            key=lambda r: self._seq[r.rid]))

    def oldest(self, bucket) -> Optional[Request]:
        reqs = self.requests(bucket)
        return reqs[0] if reqs else None

    # ------------------------------------------------------- admission --

    def offer(self, req: Request
              ) -> Tuple[Optional[Rejected], Optional[Request]]:
        """Try to admit ``req``.

        Returns ``(rejected, evicted)``: ``rejected`` is a typed
        :class:`Rejected` when the request was refused (and ``evicted``
        is then ``None``); on admission ``rejected`` is ``None`` and
        ``evicted`` is the lower-priority request that was preempted to
        make room, if any."""
        evicted = None
        if self.depth >= self.cfg.max_depth:
            victim = self._lowest_priority()
            if (self.cfg.preempt and victim is not None
                    and victim.priority < req.priority):
                self.remove(victim)
                evicted = victim
            else:
                return Rejected(req, reason="queue_full",
                                depth=self.depth,
                                backlog_s=self.backlog_s()), None
        backlog = self.backlog_s()
        if backlog + self.estimator.estimate(req.pixels) \
                > self.cfg.max_backlog_s:
            # Undo a preemption that turned out not to help: the
            # backlog bound, unlike depth, is not freed by one eviction
            # of a possibly-smaller request.
            if evicted is not None:
                self._admit(evicted)
                evicted = None
            return Rejected(req, reason="backlog", depth=self.depth,
                            backlog_s=backlog), None
        self._admit(req)
        return None, evicted

    def requeue(self, req: Request) -> None:
        """Put an already-admitted request back (scheduler use: a batch
        interrupted by a breaker trip).  Skips admission control — the
        request paid it once — but rejoins at the back of its bucket;
        deadline shedding still applies while it waits."""
        self._admit(req)

    def _admit(self, req: Request) -> None:
        self._buckets.setdefault(req.bucket, []).append(req)
        self._seq[req.rid] = self._next_seq
        self._next_seq += 1

    def _lowest_priority(self) -> Optional[Request]:
        """The eviction victim: lowest priority, newest-admitted last
        (so FIFO fairness breaks ties in favor of older work)."""
        worst = None
        for v in self._buckets.values():
            for r in v:
                if worst is None or (r.priority, -self._seq[r.rid]) \
                        < (worst.priority, -self._seq[worst.rid]):
                    worst = r
        return worst

    # --------------------------------------------------------- removal --

    def remove(self, req: Request) -> None:
        bucket = self._buckets.get(req.bucket)
        if bucket is not None and req in bucket:
            bucket.remove(req)
            self._seq.pop(req.rid, None)
            if not bucket:
                del self._buckets[req.bucket]

    def take(self, bucket, n: int) -> Tuple[Request, ...]:
        """Pop up to ``n`` requests from ``bucket`` for dispatch:
        priority descending, FIFO within a priority level."""
        queued = self.requests(bucket)
        chosen = tuple(sorted(
            queued, key=lambda r: (-r.priority, self._seq[r.rid]))[:n])
        # Dispatch preserves arrival order within the chosen set.
        chosen = tuple(sorted(chosen, key=lambda r: self._seq[r.rid]))
        for r in chosen:
            self.remove(r)
        return chosen

    def __len__(self) -> int:
        return self.depth
