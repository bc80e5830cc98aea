"""Corpus runner: sweep {adder kinds} x {workloads} x {image batch} (the
port of ``repro.imgproc.corpus``; ``run_streaming`` is not ported yet).

Every workload is applied to a batch of synthetic images for every
requested adder kind in one batched pass per (kind, workload) cell, and
scored against the ideal float reference with PSNR/SSIM plus measured
throughput.

    from repro_torch.imgproc import run_corpus, format_table
    rows = run_corpus()            # TABLE1_KINDS x workloads, on the card
    print(format_table(rows))
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.image.pipeline import synthetic_image
from repro_torch.image.quality import psnr, quality_band, ssim
from repro_torch.imgproc.workloads import get_workload, workload_names


@dataclasses.dataclass(frozen=True)
class CorpusResult:
    """One (adder kind, workload) cell of the sweep."""

    kind: str
    workload: str
    psnr: float          # mean over the batch, dB (inf when lossless)
    ssim: float          # mean over the batch
    band: str            # the paper's SSIM quality band
    mpix_per_s: float    # warm-call throughput, input megapixels / s
    seconds: float       # warm-call wall time for the whole batch


def synthetic_batch(n_images: int = 4, size: int = 64,
                    seed: int = 0) -> np.ndarray:
    """(B, H, W) uint8 batch of distinct deterministic synthetic images
    (different seeds per image)."""
    return np.stack([synthetic_image(size, seed=seed + 7 * i)
                     for i in range(n_images)])


def _score(ref: np.ndarray, out: np.ndarray) -> Tuple[float, float]:
    ps = [psnr(r, o) for r, o in zip(ref, out)]
    ss = [ssim(r, o) for r, o in zip(ref, out)]
    return float(np.mean(ps)), float(np.mean(ss))


def run_corpus(kinds: Optional[Sequence[str]] = None,
               workloads: Optional[Sequence[str]] = None,
               batch: Optional[np.ndarray] = None,
               n_images: int = 4, size: int = 64, seed: int = 0,
               backend: Optional[str] = None, device=None,
               fast: bool = False, strategy: Optional[str] = None,
               include_fft: bool = False,
               workload_kw: Optional[dict] = None) -> List[CorpusResult]:
    """Sweep ``kinds`` x ``workloads`` over one image batch.

    Defaults: the paper's Table-I kinds, every batched (operator,
    pipeline and ``conv3x3``) workload, a 4-image 64x64 synthetic batch,
    the ``"cuda"`` backend on the card.  The FFT reconstruction workload joins only
    with ``include_fft=True`` (or when named in ``workloads``).
    Every cell runs an untimed warm-up call first (kernel build, engine
    caches), then the timed call; workloads return host arrays, so the
    device work is finished inside the timed region.  ``workload_kw``
    maps a workload name to extra kwargs for that workload only.
    """
    from repro_torch.core.specs import TABLE1_KINDS
    kinds = tuple(kinds) if kinds is not None else tuple(TABLE1_KINDS)
    if workloads is None:
        workloads = workload_names(batched_only=not include_fft)
    if batch is None:
        batch = synthetic_batch(n_images, size, seed)
    workload_kw = workload_kw or {}
    unknown = set(workload_kw) - set(workloads)
    if unknown:
        raise ValueError(f"workload_kw for workloads not in this sweep: "
                         f"{sorted(unknown)}")
    rows: List[CorpusResult] = []
    pixels = batch.size
    run_kw = dict(backend=backend, device=device, fast=fast,
                  strategy=strategy)
    for name in workloads:
        wl = get_workload(name)
        kw = workload_kw.get(name, {})
        # requant is an execution knob: both modes score against one golden.
        ref = wl.reference(batch, **{k: v for k, v in kw.items()
                                     if k != "requant"})
        for kind in kinds:
            wl.run(batch[:1], kind=kind, **run_kw, **kw)
            t0 = time.perf_counter()
            out = wl.run(batch, kind=kind, **run_kw, **kw)
            dt = time.perf_counter() - t0
            p, s = _score(ref, np.asarray(out))
            rows.append(CorpusResult(
                kind=kind, workload=name, psnr=p, ssim=s,
                band=quality_band(s), mpix_per_s=pixels / dt / 1e6,
                seconds=dt))
    return rows


def _psnr_cell(psnr_db: float) -> str:
    """Render a PSNR for the table: lossless cells say so (" inf"), and
    anything >= 99 dB is marked ">=99" rather than clamped."""
    if not np.isfinite(psnr_db):
        return "  inf"
    if psnr_db >= 99.0:
        return " >=99"
    return f"{psnr_db:5.1f}"


def format_table(rows: Sequence[CorpusResult]) -> str:
    """Human-readable kind x workload table (PSNR dB / SSIM)."""
    kinds = list(dict.fromkeys(r.kind for r in rows))
    names = list(dict.fromkeys(r.workload for r in rows))
    cell = {(r.kind, r.workload): r for r in rows}
    width = max(12, max(len(n) for n in names) + 1)
    lines = ["".join([f"{'adder':12s}"]
                     + [f"{n:>{width}s}" for n in names])]
    for k in kinds:
        row = [f"{k:12s}"]
        for n in names:
            r = cell.get((k, n))
            row.append(" " * width if r is None else
                       f"{_psnr_cell(r.psnr)}/{r.ssim:.3f}".rjust(width))
        lines.append("".join(row))
    return "\n".join(lines)
