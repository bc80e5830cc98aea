"""Service-time estimation from measured per-pixel throughput (the
port's copy of ``repro.serving.estimator``).

Admission control and the deadline-aware batcher both need "how long
would this request take" BEFORE running it.  The pipelines here are
data-independent (fixed operator chains over fixed-size images), so
cost is very nearly ``pixels / throughput`` — the estimator keeps an
exponentially-weighted moving average of measured per-pixel throughput
plus a fixed per-dispatch overhead, seeded either from a prior
(constructor argument) or from a calibration run
(:meth:`CostEstimator.calibrate`).

The EWMA tracks drift (thermal throttling, a degraded Pareto rung with
a different strategy, competing load) without letting one straggler
batch poison the estimate.
"""

from __future__ import annotations

from typing import Optional


class CostEstimator:
    """pixels → estimated service seconds, updated from observations.

    Args:
      pix_per_s: initial per-pixel throughput estimate (pixels/second).
      overhead_s: fixed per-dispatch overhead added to every estimate
        (python + dispatch + host round-trip floor).
      alpha: EWMA weight of each new observation (0 < alpha <= 1).
    """

    def __init__(self, pix_per_s: float = 20e6, overhead_s: float = 0.0,
                 alpha: float = 0.2):
        if not pix_per_s > 0:
            raise ValueError(f"pix_per_s must be > 0; got {pix_per_s}")
        if overhead_s < 0:
            raise ValueError(f"overhead_s must be >= 0; got {overhead_s}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1]; got {alpha}")
        self.pix_per_s = float(pix_per_s)
        self.overhead_s = float(overhead_s)
        self.alpha = float(alpha)
        self.observations = 0

    def estimate(self, pixels: int) -> float:
        """Estimated service seconds for one dispatch of ``pixels``."""
        return self.overhead_s + max(int(pixels), 0) / self.pix_per_s

    def observe(self, pixels: int, seconds: float) -> None:
        """Fold one measured dispatch into the EWMA (ignored when the
        measurement is degenerate — zero pixels or non-positive time)."""
        if pixels <= 0 or seconds <= 0:
            return
        measured = pixels / seconds
        if self.observations == 0:
            # First real measurement replaces the prior outright.
            self.pix_per_s = measured
        else:
            self.pix_per_s += self.alpha * (measured - self.pix_per_s)
        self.observations += 1

    def calibrate(self, executor, image, pipeline: str, clock,
                  rounds: int = 3) -> float:
        """Measure ``executor`` on ``image`` (one warm-up + best-of
        ``rounds``) and seed the estimator from it; returns the
        measured pixels/second."""
        import numpy as np
        batch = np.asarray(image)[None]
        executor(batch, pipeline)                      # warm-up
        best = float("inf")
        for _ in range(max(rounds, 1)):
            t0 = clock.now()
            executor(batch, pipeline)
            best = min(best, clock.now() - t0)
        if best > 0:
            self.pix_per_s = batch.size / best
            self.observations += 1
        return self.pix_per_s

    def __repr__(self) -> str:
        return (f"CostEstimator({self.pix_per_s / 1e6:.2f} MPix/s, "
                f"overhead={self.overhead_s * 1e3:.3f} ms, "
                f"n={self.observations})")
