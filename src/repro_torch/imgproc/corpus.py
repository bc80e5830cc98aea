"""Corpus runner and stream executor (the port of
``repro.imgproc.corpus``).

:func:`run_corpus` applies every workload to a batch of synthetic images
for every requested adder kind in one batched pass per (kind, workload)
cell, and scores it against the ideal float reference with PSNR/SSIM
plus measured throughput.  :func:`run_streaming` is the hardened
double-buffered stream executor: up to ``depth`` batches in flight on
the card, with per-batch deadlines, isolation, retries and a
drift-triggered :class:`~repro_torch.resilience.degrade.DegradePolicy`.

    from repro_torch.imgproc import run_corpus, format_table
    rows = run_corpus()            # TABLE1_KINDS x workloads, on the card
    print(format_table(rows))
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.image.pipeline import synthetic_image
from repro_torch.image.quality import psnr, quality_band, ssim
from repro_torch.imgproc.workloads import get_workload, workload_names
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs


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


# The float-reference goldens are pure functions of (workload, batch,
# kwargs), and the quality columns only ever compare adder kinds against
# the SAME golden, so they are cached across calls (megapixel float64
# references are the expensive part).
_GOLDEN_CACHE: dict = {}


def _golden(wl, batch: np.ndarray, kw: dict) -> np.ndarray:
    key = (wl.name, batch.shape, str(batch.dtype),
           hashlib.sha1(np.ascontiguousarray(batch)).hexdigest(),
           tuple(sorted(kw.items())))
    ref = _GOLDEN_CACHE.get(key)
    if ref is None:
        ref = _GOLDEN_CACHE[key] = wl.reference(batch, **kw)
    return ref


def clear_golden_cache() -> None:
    """Drop the cached float-reference goldens (frees megapixel-sized
    float64 arrays after a large sweep)."""
    _GOLDEN_CACHE.clear()


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
    Float-reference goldens are cached across calls (see
    :func:`clear_golden_cache`).
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
        ref = _golden(wl, batch,
                      {k: v for k, v in kw.items() if k != "requant"})
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


# ------------------------------------------------ throughput runner --

@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Steady-state throughput of a streamed run.

    ``seconds`` covers the whole stream wall-clock (first dispatch to
    last result on the host); ``mpix_per_s`` is input megapixels over
    that window — transfers and host round-trips included.

    ``batch_seconds`` holds each accepted batch's observed latency
    (dispatch to drained-on-host, so with ``depth > 1`` in-flight waiting
    counts).  The ``p50/p95/p99`` properties summarize it; they are
    ``nan`` for an empty stream.

    The hardened-runner fields record what went wrong and what the
    runner did about it (all empty on a clean run):

    - ``failed``: indices of batches that raised under ``isolate=True``
      — their ``outputs`` slot holds ``None``.
    - ``retried``: indices re-dispatched at least once (late, or raising
      under ``retry_failures``).
    - ``degraded``: indices that ran on a
      :class:`~repro_torch.resilience.degrade.DegradePolicy` fallback
      plan (the batch that tripped the policy is re-run and included)."""

    outputs: List[Optional[np.ndarray]]
    seconds: float
    pixels: int
    batch_seconds: Tuple[float, ...] = ()
    failed: Tuple[int, ...] = ()
    retried: Tuple[int, ...] = ()
    degraded: Tuple[int, ...] = ()

    @property
    def mpix_per_s(self) -> float:
        # An empty (or instantaneously-timed) stream is a well-formed
        # zero-throughput result, never a division error or a nan.
        if self.pixels == 0 or self.seconds <= 0.0:
            return 0.0
        return self.pixels / self.seconds / 1e6

    @property
    def p50_s(self) -> float:
        return _metrics.quantile(self.batch_seconds, 50.0)

    @property
    def p95_s(self) -> float:
        return _metrics.quantile(self.batch_seconds, 95.0)

    @property
    def p99_s(self) -> float:
        return _metrics.quantile(self.batch_seconds, 99.0)


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-not-drained batch."""

    t: float                   # dispatch wall-clock (perf_counter)
    fut: object                # the callable's result (tensor or array)
    index: int                 # position in the input stream
    batch: object              # host copy, kept for re-dispatch on retry
    attempt: int               # 0 = first dispatch
    host: Optional[torch.Tensor] = None     # pinned copy of a card result
    event: Optional[object] = None          # recorded after that copy


def _cuda_target(fn) -> Optional[torch.device]:
    """The CUDA device ``fn`` runs on, if it says (a compiled pipeline, a
    tiled executor, a degrade policy's ``run``), else ``None``."""
    dev = getattr(fn, "device", None)
    if dev is None:
        dev = getattr(getattr(fn, "__self__", None), "device", None)
    if dev is None:
        return None
    dev = torch.device(dev)
    return dev if dev.type == "cuda" else None


def _stage_in(batch, dev: Optional[torch.device]):
    """A host batch for a card callable, copied through pinned memory
    with ``non_blocking=True`` (a pageable copy would wait for every
    launch queued before it); anything else passes as it is."""
    if dev is None or (isinstance(batch, torch.Tensor)
                       and batch.device.type == "cuda"):
        return batch
    src = batch if isinstance(batch, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(batch))
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(dev, non_blocking=True)


def _stage_out(out):
    """A card result's copy into pinned host memory, enqueued behind its
    launches, and the event recorded after it; ``(None, None)`` for any
    other result."""
    if not (isinstance(out, torch.Tensor) and out.device.type == "cuda"):
        return None, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    return host, event


def _materialize(ent: _InFlight) -> np.ndarray:
    """THE sync point of the stream: wait for the batch's event and take
    its host copy, or materialize a host result."""
    if ent.event is not None:
        ent.event.synchronize()
        return ent.host.numpy().copy()
    return np.asarray(ent.fut)


def _settle(ent: _InFlight) -> None:
    """Wait for (or discard) an abandoned batch without propagating: a
    result we will not use must still be settled so that the device queue
    drains and no error escapes after the runner returns.  A CUDA error
    raised here poisons the context: no retry recovers from it."""
    try:
        _materialize(ent)
    except Exception:
        pass


def run_streaming(fn: Callable, batches: Iterable[np.ndarray], *,
                  depth: int = 2,
                  deadline_s: Optional[float] = None,
                  max_retries: int = 2,
                  backoff_s: float = 0.05,
                  isolate: bool = False,
                  retry_failures: bool = False,
                  straggler=None,
                  degrade=None) -> StreamResult:
    """Double-buffered executor: dispatch batch ``i+1`` BEFORE blocking on
    batch ``i``'s result.

    CUDA launches are asynchronous: ``fn(batch)`` returns a device tensor
    almost at once, and the host blocks only when it reads the value.
    This runner keeps up to ``depth`` batches in flight, so that the card
    starts batch ``i+1`` while the host drains batch ``i``.  For a
    callable that runs on the card (a
    :class:`~repro_torch.imgproc.plan.CompiledPipeline`, a tiled executor
    from :func:`repro_torch.imgproc.tiles.compile_tiled`, or a degrade
    policy's plan) each host batch goes to the card through pinned memory
    with ``non_blocking=True``, each result comes back the same way, and
    one CUDA event a batch marks its copy; draining waits on that event.
    ``depth=1`` is the blocking loop, the baseline.  Outputs are returned
    in input order, as host arrays.  A batch never leaves the card's
    plan for the CPU.

    Hardening (all off by default):

    - ``deadline_s`` / ``straggler``: per-batch latency SLO.  Lateness is
      judged by :meth:`repro_torch.runtime.straggler.StragglerMonitor.late`
      against the explicit deadline and, when a ``StragglerConfig`` is
      passed, the stream's own median/MAD history.  A late batch is
      re-dispatched from its host copy up to ``max_retries`` times with
      exponential backoff (``backoff_s * 2**attempt``); its index lands
      in ``retried``.
    - ``isolate=True``: a batch that raises (dispatch or drain) is a
      recorded failure — ``None`` in ``outputs``, index in ``failed`` —
      instead of killing the stream.  With ``isolate=False`` the error
      re-raises as ``RuntimeError`` naming the failing batch index, and
      every still-pending batch is settled first.
    - ``retry_failures=True``: a RAISING batch is also re-dispatched up to
      ``max_retries`` times with the same backoff; a batch that fails
      every attempt then takes the ``isolate`` path.
    - ``degrade``: a :class:`~repro_torch.resilience.degrade.DegradePolicy`.
      Each batch is shown to the policy after dispatch; when its drift
      monitor trips, the in-flight batch is settled and re-run on the
      recovered plan, which also serves every later batch.  Affected
      indices land in ``degraded``.

    Isolation and retries cover Python exceptions raised at dispatch or
    drain.  A fault inside a kernel poisons the CUDA context: every later
    call raises, so no retry can recover from it.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1; got {depth}")
    if deadline_s is not None and not deadline_s > 0:
        raise ValueError(f"deadline_s must be > 0; got {deadline_s}")
    if max_retries < 0:
        raise ValueError(f"max_retries must be >= 0; got {max_retries}")
    if backoff_s < 0:
        raise ValueError(f"backoff_s must be >= 0; got {backoff_s}")

    watch = None
    if deadline_s is not None or straggler is not None:
        from repro_torch.runtime.straggler import (StragglerConfig,
                                                   StragglerMonitor)
        # Deadline-only callers get a monitor whose outlier filter can
        # never fire (min_samples unreachable): late() then reduces to
        # the explicit-deadline check, routed through the one shared
        # lateness definition.
        cfg = straggler if straggler is not None else StragglerConfig(
            min_samples=1 << 30)
        watch = StragglerMonitor(cfg)

    pending: collections.deque = collections.deque()
    results: dict = {}
    latencies: List[float] = []
    failed: List[int] = []
    retried: List[int] = []
    degraded: List[int] = []
    pixels = 0
    count = 0
    instrumented = _obs._ENABLED
    if instrumented:
        in_flight = _metrics.gauge("stream.batches_in_flight")
        lat_hist = _metrics.histogram("stream.batch_seconds")
        n_batches = _metrics.counter("stream.batches")
        n_pixels = _metrics.counter("stream.pixels")
        n_failed = _metrics.counter("stream.failed_batches")
        n_retried = _metrics.counter("stream.retries")

    # The active callable and the device it runs on: degradation swaps
    # them mid-stream, and a retry must pick up the swapped plan.
    active = [fn, _cuda_target(fn)]

    def launch(batch):
        fut = active[0](_stage_in(batch, active[1]))
        host, event = _stage_out(fut)
        return fut, host, event

    def dispatch(batch, index: int, attempt: int) -> None:
        t = time.perf_counter()
        if instrumented:
            with _obs.span("stream:dispatch", batch=index,
                           attempt=attempt):
                fut, host, event = launch(batch)
            in_flight.inc()
        else:
            fut, host, event = launch(batch)
        pending.append(_InFlight(t, fut, index, batch, attempt, host,
                                 event))

    def drain() -> None:
        ent = pending.popleft()
        try:
            if instrumented:
                with _obs.span("stream:drain", batch=ent.index):
                    out = _materialize(ent)
            else:
                out = _materialize(ent)
        except Exception as exc:
            if instrumented:
                in_flight.dec()
            attempt = ent.attempt
            if retry_failures:
                # A re-dispatch that itself raises consumes the next
                # attempt, so a hard-poisoned batch exhausts its budget
                # here instead of looping forever.
                while attempt < max_retries:
                    if instrumented:
                        n_retried.inc()
                    retried.append(ent.index)
                    time.sleep(backoff_s * (2 ** attempt))
                    attempt += 1
                    try:
                        dispatch(ent.batch, ent.index, attempt)
                        return
                    except Exception as nxt:
                        exc = nxt
            if instrumented:
                n_failed.inc()
            if isolate:
                failed.append(ent.index)
                return
            raise RuntimeError(
                f"run_streaming: batch {ent.index} failed while draining"
                f" (attempt {attempt + 1}): {exc}") from exc
        if instrumented:
            in_flight.dec()
        lat = time.perf_counter() - ent.t
        if (watch is not None and ent.attempt < max_retries
                and watch.late(ent.index, lat, deadline_s)):
            if instrumented:
                n_retried.inc()
            retried.append(ent.index)
            time.sleep(backoff_s * (2 ** ent.attempt))
            dispatch(ent.batch, ent.index, ent.attempt + 1)
            return
        results[ent.index] = out
        latencies.append(lat)
        if instrumented:
            lat_hist.record(lat)

    t0 = time.perf_counter()
    try:
        for i, batch in enumerate(batches):
            count = i + 1
            n = int(np.prod(np.shape(batch)))
            pixels += n
            if instrumented:
                n_batches.inc()
                n_pixels.inc(n)
            dispatched = True
            try:
                dispatch(batch, i, 0)
            except Exception as exc:
                dispatched = False
                attempt = 0
                if retry_failures:
                    while attempt < max_retries:
                        if instrumented:
                            n_retried.inc()
                        retried.append(i)
                        time.sleep(backoff_s * (2 ** attempt))
                        attempt += 1
                        try:
                            dispatch(batch, i, attempt)
                            dispatched = True
                            break
                        except Exception as nxt:
                            exc = nxt
                if not dispatched:
                    if not isolate:
                        raise RuntimeError(
                            f"run_streaming: batch {i} failed during "
                            f"dispatch (attempt {attempt + 1}): {exc}"
                        ) from exc
                    if instrumented:
                        n_failed.inc()
                    failed.append(i)
            if dispatched:
                if degrade is not None:
                    if degrade.observe(batch):
                        # Tripped on THIS batch: settle the suspect
                        # in-flight batch and re-run it on the recovered
                        # plan (which serves the rest of the stream too).
                        stale = pending.pop()
                        _settle(stale)
                        if instrumented:
                            in_flight.dec()
                        active[:] = [degrade.run, _cuda_target(degrade.run)]
                        dispatch(batch, i, stale.attempt)
                    if degrade.level:
                        degraded.append(i)
            while len(pending) >= depth:
                drain()
        while pending:
            drain()
    finally:
        # Error-path guarantee: no in-flight batch outlives the call.
        while pending:
            _settle(pending.popleft())
            if instrumented:
                in_flight.dec()
    outputs: List[Optional[np.ndarray]] = [results.get(i)
                                           for i in range(count)]
    return StreamResult(outputs=outputs,
                        seconds=time.perf_counter() - t0, pixels=pixels,
                        batch_seconds=tuple(latencies),
                        failed=tuple(failed),
                        retried=tuple(dict.fromkeys(retried)),
                        degraded=tuple(degraded))


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
