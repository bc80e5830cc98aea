"""Self-healing degradation: drift-triggered fallback down the Pareto
ladder (the port of ``repro.resilience.degrade``).

A pipeline is deployed on an approximate adder config chosen from the
exact energy/accuracy frontier.  A hardware defect (or a mis-budgeted
config) pushes its measured per-add error outside the config's exact
band — the :class:`~repro_torch.obs.drift.DriftMonitor` trips.  Instead
of serving garbage, :class:`DegradePolicy` swaps the compiled plan for
the NEXT-CHEAPEST config on the exact Pareto frontier that is strictly
more accurate than the current one — ultimately the exact adder —
re-budgets the monitor to the new config, and tells the streaming
executor to re-run the batch that tripped.

Fallback plans compile WITHOUT the fault (the defective block is swapped
for a healthy operating point) and keep the base plan's backend and
device: a plan on the card falls back to a plan on the card.  The drift
evidence comes from a shadow of the current plan on the ``"torch"``
backend on the CPU (the counterpart of the reference's ``"numpy"``
twin), run on a small corner crop of each batch, so the card's plan
never syncs for drift.

Everything here is deterministic: the ladder is a pure function of the
spec (closed-form analytics and the seeded toggle model) and the
monitor's verdict a pure function of the observations.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.hwcost import switching_energy_fj
from repro_torch.core.metrics import analysis_device
from repro_torch.core.specs import AdderSpec
from repro_torch.obs import drift as _drift
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs

__all__ = ["DegradePolicy", "pareto_ladder"]


def pareto_ladder(spec: AdderSpec, device=None) -> Tuple[AdderSpec, ...]:
    """Fallback sequence for ``spec``: the exact energy/NMED Pareto
    frontier at ``spec.n_bits``, restricted to configs strictly more
    accurate than ``spec``, cheapest first, ending at the exact adder.

    Built from the closed-form analytics (reduced on the host) and the
    switching-energy model (its toggle simulation on ``device``; ``None``
    is the card) — no sampling, so the ladder is deterministic, and
    cached per (spec, device).  The frontier rule: sort by switching
    energy ascending, keep points whose NMED strictly improves.
    Candidates are capped at ``m <= spec.lsm_bits``: a fallback must be
    strictly MORE accurate than ``spec``, and widening the approximate
    section only moves the other way."""
    return _pareto_ladder(spec, analysis_device(device))


@functools.lru_cache(maxsize=None)
def _pareto_ladder(spec: AdderSpec,
                   device: torch.device) -> Tuple[AdderSpec, ...]:
    from repro_torch.ax.analytics import design_space, \
        exact_error_metrics, exact_error_metrics_sweep
    from repro_torch.ax.registry import get_adder

    max_lsm = None if get_adder(spec.kind).is_exact else spec.lsm_bits
    candidates = design_space(n_bits=(spec.n_bits,), max_lsm=max_lsm)
    reports = exact_error_metrics_sweep(candidates, backend="numpy",
                                        cache_tables=False)
    rows = sorted(((switching_energy_fj(r.spec, device), r.nmed, r.spec)
                   for r in reports), key=lambda t: (t[0], t[1]))
    frontier: List[Tuple[float, float, AdderSpec]] = []
    best = float("inf")
    for energy, nmed, s in rows:
        if nmed < best:
            frontier.append((energy, nmed, s))
            best = nmed
    own = exact_error_metrics(spec, backend="numpy",
                              cache_tables=False).nmed
    ladder = tuple(s for _, nmed, s in frontier
                   if nmed < own and s != spec)
    if not ladder:
        raise ValueError(
            f"no fallback exists for {spec.short_name}: nothing on the "
            f"N={spec.n_bits} Pareto frontier beats its NMED ({own:.3e})"
            " — it is already exact (or exact-equivalent)")
    return ladder


class DegradePolicy:
    """Drift-triggered plan degradation for a compiled pipeline.

    Args:
      pipe: the deployed :class:`~repro_torch.imgproc.plan.CompiledPipeline`
        (possibly fault-injected — that is the scenario this exists
        for).
      band / z / min_samples: forwarded to the
        :class:`~repro_torch.obs.drift.DriftMonitor` budgeted against the
        CURRENT plan's spec (re-budgeted on every fallback).
      observe_crop: side of the square corner crop shadow-run per
        observation — keeps the CPU shadow cheap while feeding the
        monitor thousands of per-add error samples per batch.
      ladder: override the fallback sequence (default
        :func:`pareto_ladder` of the pipe's spec, on the pipe's device).

    Usage: pass as ``degrade=`` to
    :func:`repro_torch.imgproc.corpus.run_streaming`, or drive it
    manually — ``observe(batch)`` returns True the moment a fallback swap
    happened (the caller must then re-run the batch via :meth:`run`).
    Requires live telemetry (:func:`repro_torch.obs.enable`): drift
    capture is compiled out otherwise, and silently observing nothing
    would defeat the whole point, so :meth:`observe` refuses to run
    blind.
    """

    def __init__(self, pipe, *, band: float = 1.25, z: float = 4.0,
                 min_samples: int = 1024, observe_crop: int = 32,
                 ladder: Optional[Tuple[AdderSpec, ...]] = None):
        self.base = pipe
        self.pipe = pipe
        self.band = float(band)
        self.z = float(z)
        self.min_samples = int(min_samples)
        self.observe_crop = int(observe_crop)
        if self.observe_crop < 4:
            raise ValueError(
                f"observe_crop must be >= 4 pixels; got {observe_crop}")
        self.ladder = tuple(ladder) if ladder is not None \
            else pareto_ladder(pipe.engine.spec, pipe.engine.device)
        self.level = 0
        self.trips = 0
        self.monitor = self._budget(pipe.engine.spec)
        self._shadow = self._cpu_twin(pipe, keep_fault=True)

    # ------------------------------------------------------- internals --

    def _budget(self, spec: AdderSpec) -> _drift.DriftMonitor:
        return _drift.DriftMonitor(spec, band=self.band, z=self.z,
                                   min_samples=self.min_samples)

    def _cpu_twin(self, pipe, keep_fault: bool):
        """The shadow of ``pipe`` on the ``"torch"`` backend on the CPU —
        same stages, requant, spec and (optionally) fault — whose engine
        calls the drift capture sees."""
        from repro_torch.imgproc.plan import compile_pipeline
        stages = [(name, dict(kw)) for name, kw in pipe.stages]
        return compile_pipeline(
            stages, kind=pipe.engine.spec, backend="torch", device="cpu",
            strategy=pipe.engine.strategy, requant=pipe.requant,
            fault=pipe.engine.fault if keep_fault else None)

    def _fallback(self) -> None:
        """Swap to the next ladder rung: recompile the plan at the new
        spec WITHOUT the fault, on the base plan's backend and device,
        re-budget the monitor, re-shadow."""
        from repro_torch.imgproc.plan import compile_pipeline
        spec = self.ladder[self.level]
        self.level += 1
        stages = [(name, dict(kw)) for name, kw in self.base.stages]
        self.pipe = compile_pipeline(
            stages, kind=spec, backend=self.base.engine.backend.name,
            device=self.base.engine.device,
            strategy=self.base.engine.strategy, requant=self.base.requant,
            fault=None)
        self.monitor = self._budget(spec)
        self._shadow = self._cpu_twin(self.pipe, keep_fault=False)

    def _trip(self) -> None:
        """One recorded trip + fallback swap + metrics (shared by the
        drift path and the externally-commanded path)."""
        self.trips += 1
        _metrics.counter("degrade.trips").inc()
        self._fallback()
        _metrics.counter("degrade.fallbacks").inc()
        _metrics.gauge("degrade.level").set(self.level)

    # ------------------------------------------------------------- API --

    @property
    def exhausted(self) -> bool:
        """No rungs left — the policy is already at its most accurate
        (normally exact) config."""
        return self.level >= len(self.ladder)

    def force_fallback(self) -> bool:
        """Externally-commanded degradation: step one rung down the
        ladder WITHOUT a drift observation — the serving circuit
        breaker's trip action (consecutive executor failures are
        evidence of a sick operating point even when no drift sample
        exists).  Returns False (and does nothing) when the ladder is
        exhausted.  Unlike :meth:`observe`, needs no live telemetry:
        there is no shadow capture involved."""
        if self.exhausted:
            return False
        self._trip()
        return True

    def on_integrity_alarm(self, report=None) -> bool:
        """An integrity detection (LUT scrub hit, failed canary, ABFT
        flag): observed corruption in the datapath is at least as damning
        as measured drift, so step one rung down the ladder.  ``report``
        (a scrub or canary report) is accepted for the alarm-feed
        signature and recorded in metrics only.  Needs no live telemetry,
        like :meth:`force_fallback`."""
        if _obs._ENABLED:
            _metrics.counter("degrade.integrity_alarms").inc()
        return self.force_fallback()

    def observe(self, batch) -> bool:
        """Feed one batch's evidence to the drift monitor; returns True
        when this observation TRIPPED it and a fallback swap just
        happened (the caller should re-run the batch through
        :meth:`run`).

        Evidence comes from shadow-running a corner crop of the batch
        on the CPU twin of the CURRENT plan (fault included) with the
        monitor installed — the capture hooks then compare every
        approximate add against its exact integer twin.  A batch on the
        card sends only its crop to the host."""
        if not _obs._ENABLED:
            raise RuntimeError(
                "DegradePolicy.observe needs live telemetry — call "
                "repro_torch.obs.enable() (drift capture is compiled "
                "out when tracing is off, so observing would be blind)")
        c = self.observe_crop
        crop = batch[..., :c, :c]
        crop = crop.cpu().numpy() if isinstance(crop, torch.Tensor) \
            else np.asarray(crop)
        with _drift.installed(self.monitor):
            self._shadow(crop)
        if self.monitor.ok() or self.exhausted:
            return False
        self._trip()
        _metrics.counter("degrade.retries").inc()
        return True

    @property
    def device(self) -> torch.device:
        """Where the CURRENT plan runs."""
        return self.pipe.engine.device

    def run(self, batch):
        """Execute the CURRENT plan (base, or fallback after a trip)."""
        return self.pipe(batch)

    def __repr__(self) -> str:
        cur = self.pipe.engine.spec.short_name
        return (f"DegradePolicy(level={self.level}/{len(self.ladder)}, "
                f"current={cur}, trips={self.trips})")
