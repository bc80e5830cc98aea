"""Fault-injection campaign harness (the port of
``repro.resilience.harness``, without the integrity detectors):
quality-vs-defect curves and degradation-recovery cells.

- :func:`run_campaign` sweeps fault kind x bit position x transient
  rate x adder config over the stock pipelines and scores each cell's
  PSNR/SSIM against the float golden — the curves committed to
  ``BENCH_faults.json`` as ``fault_curve`` records.
- :func:`recovery_cell` runs the full self-healing loop — faulted plan,
  :class:`~repro_torch.resilience.degrade.DegradePolicy`, hardened
  :func:`~repro_torch.imgproc.corpus.run_streaming` — and reports the dB
  the fallback ladder claws back versus serving the fault unmitigated
  (the ``fault_recovery`` record).

Both run on the card unless ``backend``/``device`` say otherwise, and
everything is seeded (synthetic batches, transient-flip hashes, the
deterministic ladder), so a campaign replays bit-identically, on the
card as on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.imgproc import ops as ops_lib
from repro_torch.obs import trace as _obs
from repro_torch.resilience.faults import FaultSpec

__all__ = ["CampaignCell", "default_campaign_faults", "run_campaign",
           "recovery_cell"]


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
