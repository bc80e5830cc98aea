"""Executors: how a formed batch actually runs (the port of
``repro.serving.executor``).

The scheduler is executor-agnostic: anything callable as
``executor(images, pipeline) -> outputs`` serves, where ``images`` is
the stacked ``(B, H, W)`` uint8 host batch and ``outputs`` the
per-request results on the host (leading batch axis preserved).  Two
implementations:

- :class:`PlanExecutor` — production: resolves ``pipeline`` keys to
  compiled plans (:func:`repro_torch.imgproc.plan.compile_pipeline`, on
  the card by default) or
  :class:`~repro_torch.resilience.degrade.DegradePolicy` wrappers (so a
  breaker-driven Pareto-rung fallback is picked up on the very next
  batch).  It uploads the stacked batch to the plan's device and copies
  the outputs back to the host once a batch: that copy is the serving
  sync, the counterpart of
  :func:`repro_torch.imgproc.corpus.run_streaming`'s drain.
- :class:`SimExecutor` — deterministic simulation for tests and
  capacity planning: consumes VIRTUAL time on a
  :class:`~repro_torch.serving.clock.VirtualClock` at a configured
  pixels/second, with scriptable failures.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.serving.clock import VirtualClock


def _plan_device(target) -> Optional[torch.device]:
    """Where ``target`` runs: a compiled plan's device or a policy's
    current plan's, or ``None`` for a plain callable (which gets the
    host batch)."""
    dev = getattr(target, "device", None)
    return None if dev is None else torch.device(dev)


class PlanExecutor:
    """Map pipeline keys to runnable plans.

    ``plans`` values may be compiled pipelines (callable), degrade
    policies (``.run``), or any callable.  The stacked uint8 batch is
    uploaded to the plan's device and the outputs come back as one host
    array a batch."""

    def __init__(self, plans: Dict[str, object]):
        if not plans:
            raise ValueError("PlanExecutor needs at least one plan")
        self._plans = dict(plans)

    @classmethod
    def compile(cls, pipelines=None, *, kind="haloc_axa",
                backend: Optional[str] = None,
                strategy: Optional[str] = None, requant: str = "stage",
                fault=None, device=None) -> "PlanExecutor":
        """Compile the named stock pipelines (default: every entry of
        :data:`repro_torch.imgproc.plan.PIPELINES`) into one executor,
        on the card unless ``backend``/``device`` say otherwise."""
        from repro_torch.imgproc.plan import PIPELINES, compile_pipeline
        names = tuple(pipelines) if pipelines is not None \
            else tuple(PIPELINES)
        return cls({name: compile_pipeline(
            PIPELINES[name], kind=kind, backend=backend,
            strategy=strategy, requant=requant, fault=fault, device=device)
            for name in names})

    def plan(self, pipeline: str):
        try:
            return self._plans[pipeline]
        except KeyError:
            raise KeyError(
                f"unknown pipeline {pipeline!r}; executor serves "
                f"{sorted(self._plans)}") from None

    def __call__(self, images: np.ndarray, pipeline: str) -> np.ndarray:
        target = self.plan(pipeline)
        fn = target if callable(target) else target.run
        dev = _plan_device(target)
        batch = np.ascontiguousarray(images)
        if dev is not None:
            batch = torch.from_numpy(batch).to(dev)
        out = fn(batch)
        if isinstance(out, torch.Tensor):
            return out.cpu().numpy()
        return np.asarray(out)


class SimExecutor:
    """Deterministic simulated executor on a :class:`VirtualClock`.

    Service time is ``overhead_s + pixels / pix_per_s`` of virtual
    time, advanced on the shared clock — so scheduler timing tests are
    pure functions of their inputs.  Failures are scripted with
    ``fail_when`` (a predicate on the stacked batch; raise while it
    returns True) or ``fail_first`` (fail the first N calls outright —
    the breaker-trip script).  The output echoes the input (identity
    pipeline), which lets tests assert per-request routing."""

    def __init__(self, clock: VirtualClock, *, pix_per_s: float = 1e6,
                 overhead_s: float = 0.0,
                 fail_when: Optional[Callable[[np.ndarray], bool]] = None,
                 fail_first: int = 0):
        self.clock = clock
        self.pix_per_s = float(pix_per_s)
        self.overhead_s = float(overhead_s)
        self.fail_when = fail_when
        self.fail_first = int(fail_first)
        self.calls = 0
        self.failures = 0
        self.dispatched: list = []        # (t_start, batch_shape, pipeline)

    def service_s(self, pixels: int) -> float:
        return self.overhead_s + pixels / self.pix_per_s

    def __call__(self, images: np.ndarray, pipeline: str) -> np.ndarray:
        images = np.asarray(images)
        self.calls += 1
        self.dispatched.append((self.clock.now(), images.shape, pipeline))
        self.clock.advance(self.service_s(images.size))
        if self.calls <= self.fail_first or \
                (self.fail_when is not None and self.fail_when(images)):
            self.failures += 1
            raise RuntimeError(
                f"SimExecutor scripted failure (call {self.calls})")
        return images
