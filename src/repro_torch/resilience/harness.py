"""Fault-injection campaign harness (the port of
``repro.resilience.harness``): quality-vs-defect curves,
degradation-recovery cells and the integrity detection campaign.

- :func:`run_campaign` sweeps fault kind x bit position x transient
  rate x adder config over the stock pipelines and scores each cell's
  PSNR/SSIM against the float golden — the curves committed to
  ``BENCH_faults.json`` as ``fault_curve`` records.
- :func:`recovery_cell` runs the full self-healing loop — faulted plan,
  :class:`~repro_torch.resilience.degrade.DegradePolicy`, hardened
  :func:`~repro_torch.imgproc.corpus.run_streaming` — and reports the dB
  the fallback ladder claws back versus serving the fault unmitigated
  (the ``fault_recovery`` record).
- :func:`detection_campaign` burns faults into the live tables the
  kernels gather from and onto the adder's output bus, and reports how
  the scrubber and the canary catch them (``fault_detection`` records).

Both run on the card unless ``backend``/``device`` say otherwise, and
everything is seeded (synthetic batches, transient-flip hashes, the
deterministic ladder), so a campaign replays bit-identically, on the
card as on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.imgproc import ops as ops_lib
from repro_torch.obs import trace as _obs
from repro_torch.resilience.faults import FaultSpec

__all__ = ["CampaignCell", "default_campaign_faults", "run_campaign",
           "recovery_cell", "detection_campaign"]


@dataclasses.dataclass(frozen=True)
class CampaignCell:
    """One (workload, adder kind, fault) point of a campaign sweep."""

    workload: str
    kind: str
    backend: str
    fault: Optional[FaultSpec]   # None = the clean baseline cell
    psnr: float                  # mean over the batch, dB, vs float golden
    ssim: float                  # mean over the batch, vs float golden

    def record(self) -> Dict[str, object]:
        """Trajectory record: identity = the injected defect and where
        it ran; metrics = the quality it left behind."""
        f = self.fault
        return {
            "op": "fault_curve",
            "workload": self.workload,
            "kind": self.kind,
            "backend": self.backend,
            "fault": "none" if f is None else f.kind,
            "bits": "" if f is None else ",".join(map(str, f.bits)),
            "rate": 0.0 if f is None else f.rate,
            "seed": 0 if f is None else f.seed,
            "psnr": self.psnr,
            "ssim": self.ssim,
        }


def default_campaign_faults(n_bits: int = ops_lib.IMAGE_N_BITS,
                            seed: int = 0,
                            quick: bool = False) -> Tuple[FaultSpec, ...]:
    """The stock defect grid: permanent stuck-ats at a low and an
    upper-middle sum bit, plus a transient bit-flip rate sweep (the
    PSNR-vs-rate curve).  ``quick`` keeps one stuck-at and two rates —
    the CI smoke grid."""
    hi = min(11, n_bits - 1)
    lo = min(3, n_bits - 1)
    stuck = (FaultSpec("stuck_at_1", bits=(hi,), seed=seed),)
    if not quick:
        stuck += (FaultSpec("stuck_at_0", bits=(hi,), seed=seed),
                  FaultSpec("stuck_at_1", bits=(lo,), seed=seed))
    rates = (2 ** -5, 2 ** -2) if quick else (2 ** -8, 2 ** -5, 2 ** -2)
    flips = tuple(FaultSpec("bit_flip", bits=(lo, hi), rate=r, seed=seed)
                  for r in rates)
    return stuck + flips


def _pipeline_stages(workload: str):
    from repro_torch.imgproc.plan import PIPELINES
    try:
        return PIPELINES[workload]
    except KeyError:
        raise ValueError(
            f"fault campaigns run the plan-compiled pipelines; "
            f"{workload!r} is not one of {sorted(PIPELINES)}") from None


def run_campaign(kinds: Sequence[str] = ("haloc_axa",),
                 workloads: Sequence[str] = ("pipe_blur_sharpen_down",),
                 faults: Optional[Sequence[Optional[FaultSpec]]] = None,
                 backend: Optional[str] = None,
                 n_images: int = 2, size: int = 64, seed: int = 0,
                 requant: str = "stage",
                 quick: bool = False, device=None) -> List[CampaignCell]:
    """Sweep ``kinds`` x ``workloads`` x ``faults`` and score every cell
    against the float golden of the same batch.

    ``faults`` defaults to :func:`default_campaign_faults` with a
    ``None`` entry prepended — the clean baseline every curve is read
    against.  Workloads must be plan-compiled pipelines (the fault
    enters through :func:`~repro_torch.imgproc.plan.compile_pipeline`).
    ``backend=None`` is the ``"cuda"`` backend on the card (the cells
    record ``"auto"``, as the reference's do)."""
    from repro_torch.image.quality import psnr as _psnr, ssim as _ssim
    from repro_torch.imgproc.corpus import _golden, synthetic_batch
    from repro_torch.imgproc.plan import run_pipeline
    from repro_torch.imgproc.workloads import get_workload

    if faults is None:
        faults = (None,) + default_campaign_faults(seed=seed, quick=quick)
    batch = synthetic_batch(n_images, size, seed)
    cells: List[CampaignCell] = []
    for name in workloads:
        stages = _pipeline_stages(name)
        ref = _golden(get_workload(name), batch, {})
        for kind in kinds:
            for fault in faults:
                out = run_pipeline(stages, batch, kind=kind,
                                   backend=backend, device=device,
                                   requant=requant, fault=fault)
                cells.append(CampaignCell(
                    workload=name, kind=kind,
                    backend=backend or "auto", fault=fault,
                    psnr=float(np.mean([_psnr(r, o)
                                        for r, o in zip(ref, out)])),
                    ssim=float(np.mean([_ssim(r, o)
                                        for r, o in zip(ref, out)]))))
    return cells


def detection_campaign(kinds: Sequence[str] = ("haloc_axa",),
                       backend: str = "torch",
                       seed: int = 0, quick: bool = False,
                       interval_s: float = 10.0, device=None
                       ) -> List[Dict[str, object]]:
    """Seeded fault-kind x site detection-coverage campaign for the
    integrity layer, as trajectory records.

    Two detectors are exercised against the same defect grid the
    quality campaigns use, on a lut-strategy engine of ``backend`` on
    ``device`` (``"torch"`` on the CPU by default; ``"cuda"`` on the
    card):

    - **scrub**: every cell burns one fault (via
      :func:`~repro_torch.resilience.faults.corrupt_lut`) in place into
      the LIVE device table the engine's lut add gathers from (and into
      the cached host table it was uploaded from), then a
      :class:`~repro_torch.integrity.scrub.LutScrubber` that walks the
      device tables (``"ax.lut.device"``), on a
      :class:`~repro_torch.serving.clock.VirtualClock`, runs its cadence
      until it fires.  Detection latency is ``report.at - t_inject`` —
      deterministic on the virtual clock, with injections phased across
      the scrub period so the mean latency is meaningful.  Each
      detection repairs the device table; the campaign restores both
      tables after each cell, so cells are independent.
    - **canary**: every cell builds an engine with the fault installed
      on its output bus (``make_engine(..., fault=...)`` — corruption
      PAST the tables, invisible to any scrub) and checks that the
      known-answer probes flag it at their first cadence tick.

    Cells whose corruption is a no-op (the stuck-at already matches
    every affected site) are skipped — there is nothing observable to
    detect.  A healthy pass of both detectors runs first and its alarm
    rate is committed as ``false_positive_rate`` (the acceptance
    criterion pins it to zero).  Returns one record per detector x
    adder kind x fault kind, equal to the reference's apart from
    ``backend``::

        {"op": "fault_detection", "detector": ..., "kind": ...,
         "backend": ..., "fault": ..., "grid": "quick"|"full",
         "detected": d, "cells": c, "coverage": d / c,
         "detection_latency_s": mean, "false_positive_rate": fp}
    """
    from repro_torch.ax.engine import make_engine
    from repro_torch.ax.lut import _canonical, compile_lut, device_table
    from repro_torch.integrity.canary import CanarySuite
    from repro_torch.integrity.scrub import LutScrubber
    from repro_torch.resilience.faults import corrupt_lut
    from repro_torch.serving.clock import VirtualClock

    if device is None and backend == "torch":
        device = "cpu"
    records: List[Dict[str, object]] = []
    grid = "quick" if quick else "full"
    fault_kinds = ("stuck_at_1", "bit_flip") if quick \
        else ("stuck_at_0", "stuck_at_1", "bit_flip")
    rates = (2 ** -5,) if quick else (2 ** -8, 2 ** -5, 2 ** -2)

    for kind in kinds:
        eng = make_engine(kind, backend=backend, strategy="lut",
                          device=device)
        spec = _canonical(eng.spec)
        table = compile_lut(eng.spec)
        live = device_table(eng.spec, eng.device)
        golden = table.copy()
        m = spec.lsm_bits

        # Healthy pass: full-registry scrub + known-answer canary on the
        # clean engine.  Any alarm here is a false positive.
        fp_checks, fp_alarms = 0, 0
        healthy_scrub = LutScrubber(clock=VirtualClock()).scrub_once(0.0)
        fp_checks += healthy_scrub.checked
        fp_alarms += len(healthy_scrub.corrupted)
        healthy_canary = CanarySuite(eng, seed=seed).run_once(0.0)
        fp_checks += healthy_canary.checked
        fp_alarms += (healthy_canary.add_mismatches
                      + healthy_canary.mul_mismatches)
        fp_rate = fp_alarms / fp_checks if fp_checks else 0.0

        table_bits = (0, m // 2, m) if quick else tuple(range(m + 1))
        bus_bits = (0, eng.spec.n_bits // 2, eng.spec.n_bits - 1) \
            if quick else tuple(range(0, eng.spec.n_bits, 2))

        def _faults(bits) -> List[FaultSpec]:
            out = []
            for fk in fault_kinds:
                if fk == "bit_flip":
                    out += [FaultSpec(fk, bits=(b,), rate=r, seed=seed)
                            for b in bits for r in rates]
                else:
                    out += [FaultSpec(fk, bits=(b,), seed=seed)
                            for b in bits]
            return out

        # ------------------------------------------------- scrub cells --
        results: Dict[str, List[Tuple[bool, float]]] = {}
        clock = VirtualClock()
        scrubber = LutScrubber(interval_s=interval_s, clock=clock,
                               cache="ax.lut.device")
        for i, fault in enumerate(_faults(table_bits)):
            corrupted = corrupt_lut(spec, fault)
            if np.array_equal(corrupted, golden):
                continue
            clock.advance(interval_s * ((i % 4) / 4.0 + 0.01))
            t_inject = clock.now()
            _burn(table, live, corrupted)
            report = None
            for _ in range(3):
                report = scrubber.maybe_run()
                if report is not None:
                    break
                clock.advance(interval_s / 2.0)
            detected = (report is not None and not report.ok)
            latency = (report.at - t_inject) if detected else float("nan")
            results.setdefault(fault.kind, []).append((detected, latency))
            _burn(table, live, golden)
        records += _detection_records(results, "scrub", kind, backend,
                                      grid, fp_rate)

        # ------------------------------------------------ canary cells --
        results = {}
        for i, fault in enumerate(_faults(bus_bits)):
            faulted = make_engine(kind, backend=backend, strategy="lut",
                                  fault=fault, device=device)
            if not _bus_fault_observable(eng.spec, fault, seed):
                # e.g. stuck-at-1 on a constant-speculated low bit the
                # adder already forces to 1: no output ever changes.
                continue
            clock = VirtualClock()
            # 1029 probes: a rate-2^-8 transient expects ~4 flipped
            # sites per cell, so P(invisible) is ~2% instead of ~37%.
            suite = CanarySuite(faulted, n=1024, seed=seed,
                                interval_s=interval_s, clock=clock)
            clock.advance(interval_s * ((i % 4) / 4.0 + 0.01))
            t_inject = clock.now()
            report = None
            for _ in range(3):
                report = suite.maybe_run()
                if report is not None:
                    break
                clock.advance(interval_s / 2.0)
            detected = (report is not None and not report.ok)
            latency = (report.at - t_inject) if detected else float("nan")
            results.setdefault(fault.kind, []).append((detected, latency))
        records += _detection_records(results, "canary", kind, backend,
                                      grid, fp_rate)
    return records


def _burn(table: np.ndarray, live: torch.Tensor,
          contents: np.ndarray) -> None:
    """Write ``contents`` (a packed uint16 table) in place into the cached
    host ``table`` and its live device copy ``live`` (where differing:
    a scrub may have repaired the copy already)."""
    if not np.array_equal(table, contents):
        table.flags.writeable = True
        np.copyto(table, contents)
        table.flags.writeable = False
    live.copy_(torch.from_numpy(contents.view(np.int16).copy()))


def _bus_fault_observable(spec, fault: FaultSpec, seed: int,
                          n: int = 1024) -> bool:
    """Whether ``fault`` on the add output bus changes ANY canary probe
    output — the faulted twin of the scrub campaign's table-identity
    skip (a stuck-at that matches what the approximate adder emits
    anyway has no behavior to detect)."""
    from repro_torch.integrity.canary import expected_add_outputs, \
        make_probe
    from repro_torch.resilience.faults import apply_fault
    a, b = make_probe(spec.n_bits, n=n, seed=seed)
    exp = torch.from_numpy(expected_add_outputs(spec, a, b)
                           .astype(np.int64))
    mask = (1 << spec.n_bits) - 1
    faulted = apply_fault(exp.clone(), fault, spec.n_bits) & mask
    return not torch.equal(faulted, exp)


def _detection_records(results, detector: str, kind: str, backend: str,
                       grid: str, fp_rate: float) -> List[Dict[str, object]]:
    records = []
    for fk, cells in sorted(results.items()):
        detected = sum(1 for d, _ in cells if d)
        latencies = [lat for d, lat in cells if d]
        records.append({
            "op": "fault_detection",
            "detector": detector,
            "kind": kind,
            "backend": backend,
            "fault": fk,
            "grid": grid,
            "detected": detected,
            "cells": len(cells),
            "coverage": detected / len(cells),
            "detection_latency_s": float(np.mean(latencies))
            if latencies else float("nan"),
            "false_positive_rate": fp_rate,
        })
    return records


def recovery_cell(workload: str = "pipe_blur_sharpen_down",
                  kind: str = "haloc_axa",
                  fault: Optional[FaultSpec] = None,
                  backend: Optional[str] = None,
                  n_batches: int = 3, n_images: int = 2, size: int = 64,
                  seed: int = 0, min_samples: int = 512,
                  requant: str = "stage", device=None) -> Dict[str, object]:
    """The end-to-end self-healing demonstration, as one trajectory
    record.

    A stream of seeded batches runs through a fault-injected plan twice:
    unmitigated, and under the hardened streamer with a
    :class:`DegradePolicy` watching (its drift monitor trips within the
    first batch's sample budget, the tripping batch re-runs on the
    recovered plan, and the rest of the stream serves from it).  The
    headline metric is ``recovery_db`` — mean PSNR with the fallback
    minus mean PSNR without.

    Telemetry is force-enabled for the duration (the policy's shadow
    capture needs it) and restored on exit, so the cell is callable from
    a cold benchmark process.  ``backend=None`` is the ``"cuda"`` backend
    on the card; the record's ``backend`` names the plan's resolved
    backend."""
    from repro_torch.image.quality import psnr as _psnr
    from repro_torch.imgproc.corpus import _golden, run_streaming, \
        synthetic_batch
    from repro_torch.imgproc.plan import compile_pipeline
    from repro_torch.imgproc.workloads import get_workload
    from repro_torch.resilience.degrade import DegradePolicy

    if fault is None:
        fault = FaultSpec("stuck_at_1", bits=(11,), seed=seed)
    stages = _pipeline_stages(workload)
    wl = get_workload(workload)
    batches = [synthetic_batch(n_images, size, seed + 1000 * i)
               for i in range(n_batches)]
    goldens = [_golden(wl, b, {}) for b in batches]

    pipe = compile_pipeline(stages, kind=kind, backend=backend,
                            device=device, requant=requant, fault=fault)

    def _mean_psnr(outs) -> float:
        vals = [_psnr(r, o) for ref, out in zip(goldens, outs)
                for r, o in zip(ref, np.asarray(out))]
        return float(np.mean(vals))

    was_enabled = _obs.enabled()
    _obs.enable()
    try:
        policy = DegradePolicy(pipe, min_samples=min_samples)
        nofallback = [pipe(b).cpu().numpy() for b in batches]
        res = run_streaming(pipe, batches, depth=2, degrade=policy)
    finally:
        if not was_enabled:
            _obs.disable()

    psnr_nofallback = _mean_psnr(nofallback)
    psnr_fallback = _mean_psnr(res.outputs)
    return {
        "op": "fault_recovery",
        "workload": workload,
        "kind": kind,
        "backend": pipe.engine.backend.name,
        "fault": fault.kind,
        "bits": ",".join(map(str, fault.bits)),
        "rate": fault.rate,
        "seed": fault.seed,
        "fallback_to": policy.pipe.engine.spec.short_name,
        "psnr_nofallback": psnr_nofallback,
        "psnr_fallback": psnr_fallback,
        "recovery_db": psnr_fallback - psnr_nofallback,
        "degrade_level": policy.level,
        "trips": policy.trips,
        "batches_degraded": len(res.degraded),
    }
