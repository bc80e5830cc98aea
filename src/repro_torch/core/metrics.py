"""Error metrics for approximate adders and multipliers (the port of
``repro.core.metrics``; paper Section IV).

MED  = mean error distance,        (1/n) * sum |ED_i|
MRED = mean relative error dist.,  (1/n) * sum |ED_i / S_i,accurate|
NMED = MED / max_output            (normalized; standard in the AxA field)
ER   = error rate, fraction of inputs with ED != 0
WCE  = worst-case error distance

The paper evaluates MED and MRED over 10^7 uniform random 32-bit pairs;
:func:`simulate_error_metrics` reproduces that experiment on the card:
the operands are drawn on the host from numpy's ``default_rng(seed)``
exactly as the reference draws them, chunk by chunk with the reference's
chunking (:func:`_auto_chunk`), and each chunk goes to the device through
a pinned staging buffer, where the adders run on int64 lanes and the
reductions happen.  For LUT-compilable specs the same metrics are
available EXACTLY via :func:`exact_error_metrics` /
:func:`exact_error_metrics_sweep` (implemented in
:mod:`repro_torch.ax.analytics`; reports carry ``exact=True`` and
``n_samples = 4^N``, the full population).

Every entry takes ``device=None``, which is the card; without a CUDA
device that default raises and names ``device="cpu"``.

What equals the reference bit for bit: MED, ER and WCE are integer
totals (int64 on the device, exact, so they equal the reference's float
sums of integers), NMED follows MED, and the exhaustive and population
reports group integer numerators by exact sum before an exactly-rounded
:func:`math.fsum`.  The Monte-Carlo MRED is a float64 sum of ``ed /
exact`` whose value depends on the order of the sum, so it is summed in
numpy's own order (:func:`numpy_order_sum`): every report, MRED included,
equals the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.specs import AdderSpec

if TYPE_CHECKING:  # core loads before repro_torch.ax; runtime imports lazy
    from repro_torch.ax.mul.specs import MulSpec


@dataclasses.dataclass(frozen=True)
class ErrorReport:
    spec: AdderSpec
    n_samples: int
    med: float
    mred: float
    nmed: float
    error_rate: float
    wce: int
    #: True when the row is a closed-form population value (exhaustive
    #: enumeration or repro_torch.ax.analytics), not a Monte-Carlo
    #: estimate.
    exact: bool = False

    def row(self) -> Dict[str, object]:
        return {
            "adder": self.spec.kind,
            "N": self.spec.n_bits,
            "m": self.spec.lsm_bits,
            "k": self.spec.effective_const_bits,
            "samples": self.n_samples,
            "MED": self.med,
            "MRED": self.mred,
            "NMED": self.nmed,
            "ER": self.error_rate,
            "WCE": self.wce,
            "exact": self.exact,
        }


def analysis_device(device=None) -> torch.device:
    """Where the error analysis runs: ``None`` is the card, and raises
    without one, naming ``device="cpu"`` (the engines' rule)."""
    from repro_torch.ax.backends import get_backend
    from repro_torch.ax.engine import resolve_device
    return resolve_device(get_backend("torch"), device)


def _random_operands(rng: np.random.Generator, n: int, n_bits: int):
    # uint64 containers hold the (N+1)-bit sum exactly for N <= 63.
    if n_bits > 63:
        raise ValueError("n_bits > 63 not supported by the uint64 simulator")
    if n_bits <= 32:
        a = rng.integers(0, 1 << n_bits, size=n, dtype=np.uint64)
        b = rng.integers(0, 1 << n_bits, size=n, dtype=np.uint64)
    else:
        lo = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64)
        hi = rng.integers(0, 1 << (n_bits - 32), size=(2, n), dtype=np.uint64)
        a = (hi[0] << np.uint64(32)) | lo[0]
        b = (hi[1] << np.uint64(32)) | lo[1]
    return a, b


def operand_stream(rng: np.random.Generator, n_samples: int, chunk: int,
                   n_bits: int, device: torch.device):
    """The simulator's operand pairs, chunk by chunk, as int64 lanes on
    ``device``: drawn by :func:`_random_operands` (the reference's stream
    and chunking) and, on a CUDA device, copied through two pinned
    staging buffers in turn, so that drawing the next chunk overlaps the
    copy and the device work of this one."""
    staging = [None, None]
    copied = [None, None]
    done = 0
    turn = 0
    while done < n_samples:
        n = min(chunk, n_samples - done)
        a, b = _random_operands(rng, n, n_bits)
        if device.type != "cuda":
            yield (torch.from_numpy(a.view(np.int64)).to(device),
                   torch.from_numpy(b.view(np.int64)).to(device))
        else:
            if staging[turn] is None:
                staging[turn] = torch.empty(2 * chunk, dtype=torch.int64,
                                            pin_memory=True)
            if copied[turn] is not None:
                copied[turn].synchronize()
            host = staging[turn][:2 * n]
            view = host.numpy()
            view[:n] = a.view(np.int64)
            view[n:] = b.view(np.int64)
            lanes = host.to(device, non_blocking=True)
            copied[turn] = torch.cuda.Event()
            copied[turn].record()
            yield lanes[:n], lanes[n:]
        done += n
        turn ^= 1


def _lanes(x, device: torch.device) -> torch.Tensor:
    """Operands (numpy uint64 containers or tensors) as int64 lanes on
    ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int64)
                             if x.dtype == np.uint64 else x)
    from repro_torch.ax.backends import full_lanes
    return full_lanes(x.to(device))


def _ed_lanes(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec,
              strategy: str) -> torch.Tensor:
    """|approx(a, b) - (a + b)| on int64 lanes (N <= 62)."""
    from repro_torch.ax import get_adder
    if strategy == "lut" and not get_adder(spec.kind).is_exact:
        from repro_torch.ax.lut import device_abs_error_table, lut_index
        table = device_abs_error_table(spec, a.device)
        return torch.take(table, lut_index(a, b, spec)).to(torch.int64)
    from repro_torch.ax import make_engine
    approx = make_engine(spec, backend="torch", strategy=strategy,
                         device=a.device).add_full(a, b)
    return (approx - (a + b)).abs()


def error_distances(a, b, spec: AdderSpec, strategy: str = "reference",
                    device=None) -> torch.Tensor:
    """|approx(a,b) - (a+b)| as an int64 tensor on ``device`` (exact for
    N <= 62).

    With ``strategy="lut"`` the error is gathered straight from the
    compiled delta table (the full-sum error is a pure function of the
    low LSM bits — see :func:`repro_torch.ax.lut.error_delta_table`): one
    gather instead of re-deriving the whole approximate sum.
    """
    dev = analysis_device(device)
    return _ed_lanes(_lanes(a, dev), _lanes(b, dev), spec, strategy)


def simulate_error_metrics(
    spec: AdderSpec,
    n_samples: int = 10_000_000,
    seed: int = 2025,
    chunk: int = 2_000_000,
    rng: Optional[np.random.Generator] = None,
    strategy: str = "reference",
    device=None,
) -> ErrorReport:
    """Monte-Carlo MED/MRED/NMED/ER/WCE over uniform random operand pairs.

    ``strategy`` picks the adder evaluation path (all bit-identical):
    ``"lut"`` replaces the per-sample bit-level emulation with one
    delta-table gather.  Every metric equals the reference's bit for bit
    (module docstring).
    """
    rng = rng or np.random.default_rng(seed)
    return _simulate([spec], n_samples, rng, chunk, strategy,
                     analysis_device(device))[0]


#: Peak-memory budget for one Monte-Carlo sweep chunk's working set (the
#: reference's; kept so that the chunking, and so the operand pairing,
#: is the reference's).
SWEEP_MEMORY_BUDGET = 192 * 2 ** 20

_SWEEP_CHUNK_CAP = 2_000_000     # the historical fixed chunk
_SWEEP_CHUNK_FLOOR = 131_072


def _auto_chunk(n_specs: int, n_distinct_m: int, any_reference: bool,
                n_bits: int) -> int:
    """Chunk length sized from what a sweep chunk keeps live (the
    reference's rule, so that a sweep draws the reference's stream).

    Retained per sample across the whole chunk: the operand pair, the
    exact float64 sums, and one gather index per distinct LSM width.
    Transient peaks per sample: the |ED| int64 + relative float64 pass
    (always), the reference-strategy approximate sum and its int64 casts
    (when any spec bypasses the LUT), and the wide two-word operand
    generation for N > 32.  Capped at the historical fixed chunk and
    floored so degenerate spec counts still vectorize well.
    """
    per_sample = 2 * 8 + 8            # a, b, exact
    per_sample += 8 * max(n_distinct_m, 1 if n_specs else 0)
    per_sample += 8 + 8               # ed + ed/exact transient
    if any_reference:
        per_sample += 3 * 8           # approx + two int64 casts
    if n_bits > 32:
        per_sample += 4 * 8           # hi/lo generation words
    chunk = SWEEP_MEMORY_BUDGET // per_sample
    return int(max(min(chunk, _SWEEP_CHUNK_CAP), _SWEEP_CHUNK_FLOOR))


#: The reduction block of numpy's float64 ``sum``: its iterator hands the
#: add loop at most this many elements at a time (the ufunc buffer size),
#: the loop sums each block pairwise, and the block totals are added left
#: to right, starting from 0.0.
NUMPY_SUM_BLOCK = 8192


def pairwise_blocks(x: torch.Tensor):
    """The pairwise totals of ``x``'s full 8192-element blocks, on its
    device, in numpy's order, and the tail of ``x`` after them.

    numpy's pairwise sum of a block halves it (at multiples of 8) down to
    leaves of 128 elements; a leaf runs 8 accumulators left to right over
    its 16 rows of 8 and combines them as ``((r0 + r1) + (r2 + r3)) +
    ((r4 + r5) + (r6 + r7))``.  A full block is 64 leaves, so the leaves
    are a ``(blocks, 64, 16, 8)`` view folded one row at a time, and the
    halving is six levels of adjacent pairs.  Adds only, each rounded as
    numpy rounds it: the totals are numpy's to the last bit."""
    x = x.contiguous()
    full = x.numel() // NUMPY_SUM_BLOCK
    v = x[:full * NUMPY_SUM_BLOCK].view(full, 64, 16, 8)
    acc = v[:, :, 0]
    for i in range(1, 16):
        acc = acc + v[:, :, i]
    r = acc.unbind(-1)
    t = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    while t.shape[1] > 1:
        t = t[:, 0::2] + t[:, 1::2]
    return t[:, 0], x[full * NUMPY_SUM_BLOCK:]


def _fold_blocks(blocks, tail: np.ndarray) -> float:
    """numpy's block fold: the block totals left to right from 0.0, then
    the tail (under one block, so ``numpy.sum`` of it is its pairwise
    total)."""
    total = 0.0
    for b in blocks:
        total += b
    if tail.size:
        total += float(np.sum(tail))
    return total


def numpy_order_sum(x: torch.Tensor) -> float:
    """``float(numpy.sum(x))`` for a 1-D float64 tensor, bit for bit: the
    full blocks reduced on ``x``'s device, the tail summed by numpy on
    the host (:func:`pairwise_blocks`)."""
    blocks, tail = pairwise_blocks(x)
    return _fold_blocks(blocks.cpu().tolist(), tail.cpu().numpy())


def _simulate(specs, n_samples: int, rng: np.random.Generator, chunk: int,
              strategy: str, dev: torch.device) -> List[ErrorReport]:
    """THE Monte-Carlo loop: every spec on one operand stream.  The totals
    stay on the device (int64 sums, counts and maxima; a chunk's MRED as
    its compacted ratios' block totals and tail, :func:`pairwise_blocks`)
    and come back once; each chunk's MRED is folded as numpy folds it and
    the chunks are added on the host in order, as the reference adds
    them."""
    from repro_torch.ax import get_adder
    from repro_torch.ax.lut import device_abs_error_table, lut_index
    n_bits = specs[0].n_bits
    use_lut = {s: strategy == "lut" and not get_adder(s.kind).is_exact
               for s in specs}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    acc = {s: [zero, [], zero, zero] for s in specs}  # ed, red, err, wce
    for a, b in operand_stream(rng, n_samples, chunk, n_bits, dev):
        exact = a + b
        # P(exact == 0) is ~2^-2N; MRED skips those pairs, and sums the
        # others compacted, as the reference's ed[nz] / exact[nz] does.
        pos = torch.nonzero(exact > 0).squeeze(1)
        exact_f = exact.index_select(0, pos).to(torch.float64)
        idx_by_m: Dict[int, torch.Tensor] = {}
        for s in specs:
            if use_lut[s]:
                m = s.lsm_bits
                if m not in idx_by_m:
                    idx_by_m[m] = lut_index(a, b, s)
                ed = torch.take(device_abs_error_table(s, dev),
                                idx_by_m[m]).to(torch.int64)
            else:
                ed = _ed_lanes(a, b, s, strategy)
            st = acc[s]
            st[0] = st[0] + ed.sum()
            st[1].append(pairwise_blocks(
                ed.index_select(0, pos).to(torch.float64) / exact_f))
            st[2] = st[2] + torch.count_nonzero(ed)
            st[3] = torch.maximum(st[3], ed.max())
    out = []
    max_out = float((1 << (n_bits + 1)) - 2)
    for s in specs:
        ed, reds, err, wce = acc[s]
        ints = torch.stack([ed, err, wce]).cpu().tolist()
        total_ed = float(ints[0])
        total_red = 0.0
        for blocks, tail in reds:
            total_red += _fold_blocks(blocks.cpu().tolist(),
                                      tail.cpu().numpy())
        out.append(ErrorReport(
            spec=s, n_samples=n_samples,
            med=total_ed / n_samples,
            mred=total_red / n_samples,
            nmed=(total_ed / n_samples) / max_out,
            error_rate=ints[1] / n_samples,
            wce=ints[2]))
    return out


def simulate_error_metrics_sweep(
    specs: Iterable[AdderSpec],
    n_samples: int = 10_000_000,
    seed: int = 2025,
    chunk: Optional[int] = None,
    strategy: str = "reference",
    device=None,
) -> "list[ErrorReport]":
    """Monte-Carlo error metrics for MANY specs over ONE operand stream.

    Every spec is evaluated on the same uniform random pairs, so the
    reports equal per-spec :func:`simulate_error_metrics` calls with the
    same ``seed``; the random generation, the staging copy, the exact sum
    and (under ``strategy="lut"``, per distinct LSM width) the table
    index are paid once per chunk.  All specs must share ``n_bits``.
    ``chunk=None`` sizes the chunk as the reference does
    (:func:`_auto_chunk`), so the stream is the reference's.
    """
    from repro_torch.ax import get_adder
    specs = list(specs)
    if not specs:
        return []
    n_bits = specs[0].n_bits
    if any(s.n_bits != n_bits for s in specs):
        raise ValueError("sweep specs must share n_bits (one stream)")
    dev = analysis_device(device)
    if chunk is None:
        use_lut = [strategy == "lut" and not get_adder(s.kind).is_exact
                   for s in specs]
        chunk = _auto_chunk(
            n_specs=len(specs),
            n_distinct_m=len({s.lsm_bits for s, u in zip(specs, use_lut)
                              if u}),
            any_reference=not all(use_lut),
            n_bits=n_bits)
    return _simulate(specs, n_samples, np.random.default_rng(seed), chunk,
                     strategy, dev)


def _ratio_fsum(ed: torch.Tensor, s: torch.Tensor, size: int) -> float:
    """``sum_{S>=1} T[S]/S`` with ``T[S]`` the integer sum of ``ed`` over
    the pairs whose exact result is ``S``: an int64 ``index_add_`` on the
    device (exact, as the reference's float ``bincount`` of integers
    is), the nonzero numerators copied back, and an exactly-rounded
    (order-independent) :func:`math.fsum` on the host."""
    t = torch.zeros(size, dtype=torch.int64, device=ed.device)
    t.index_add_(0, s, ed)
    nz = torch.nonzero(t[1:]).squeeze(1) + 1
    num = t[nz].cpu().numpy().astype(np.float64)
    den = nz.cpu().numpy().astype(np.float64)
    return math.fsum((num / den).tolist())


def _population_ints(ed: torch.Tensor):
    """(sum, nonzero count, max) of ``ed`` in one copy back."""
    return torch.stack([ed.sum(), torch.count_nonzero(ed),
                        ed.max()]).cpu().tolist()


def _operand_grid(n_bits: int, device: torch.device):
    """All (a, b) pairs as flat int64 lanes, row-major in ``a``."""
    vals = torch.arange(1 << n_bits, dtype=torch.int64, device=device)
    q = 1 << n_bits
    return vals.repeat_interleave(q), vals.repeat(q)


def exhaustive_error_metrics(spec: AdderSpec, strategy: str = "reference",
                             device=None) -> ErrorReport:
    """Exact metrics by full enumeration — feasible for N <= ~12.

    The reductions are canonical population values: MED/ER are exact
    integer totals with one correctly-rounded float division, and MRED
    groups the error mass by exact sum S (integer numerators) before an
    exactly-rounded :func:`math.fsum`, so it is BIT-IDENTICAL to the
    closed-form analytics (:mod:`repro_torch.ax.analytics`).
    """
    n_bits = spec.n_bits
    if n_bits > 12:
        raise ValueError("exhaustive enumeration is limited to N <= 12")
    dev = analysis_device(device)
    a, b = _operand_grid(n_bits, dev)
    ed = _ed_lanes(a, b, spec, strategy)
    n = a.numel()
    max_out = float((1 << (n_bits + 1)) - 2)
    total, n_err, wce = _population_ints(ed)
    med = float(total) / float(n)
    # The S = 0 pair (a = b = 0) is excluded from MRED, matching the
    # simulator's guard.
    mred = _ratio_fsum(ed, a + b, (1 << (n_bits + 1)) - 1) / float(n)
    return ErrorReport(
        spec=spec,
        n_samples=n,
        med=med,
        mred=mred,
        nmed=med / max_out,
        error_rate=float(n_err) / float(n),
        wce=wce,
        exact=True,
    )


def exact_error_metrics(spec: AdderSpec, backend: str = "torch",
                        method: str = "auto", device=None) -> ErrorReport:
    """Exact MED/MRED/NMED/ER/WCE in closed form — no sampling (see
    :mod:`repro_torch.ax.analytics` for the formulation and the
    ``backend``/``method`` knobs)."""
    from repro_torch.ax.analytics import exact_error_metrics as _exact
    return _exact(spec, backend=backend, method=method, device=device)


def exact_error_metrics_sweep(
    specs: Iterable[AdderSpec],
    backend: str = "torch",
    method: str = "auto",
    cache_tables: bool = True,
    device=None,
) -> List[ErrorReport]:
    """Exact reports for many specs (any mix of kinds and widths).

    Design-space sweeps should pass ``cache_tables=False``: each delta
    table is then built on the device, reduced to ``O(2^m)`` stats and
    dropped instead of being pinned in the LUT cache.
    """
    from repro_torch.ax.analytics import exact_error_metrics_sweep as _sweep
    return _sweep(specs, backend=backend, method=method,
                  cache_tables=cache_tables, device=device)


# ------------------------------------------------------ multipliers --

@dataclasses.dataclass(frozen=True)
class MulErrorReport:
    """Error metrics for one multiplier configuration.

    Same five paper metrics as :class:`ErrorReport`, but normalized to
    the multiplier's output range: the exact reference is the product
    ``a*b`` (max ``(2^N - 1)^2``), and MRED's relative errors divide by
    it, excluding zero-product pairs (``a = 0`` or ``b = 0`` — every
    registered kind is errorless there, so the exclusion only guards
    the 0/0 ratio, matching the adder convention for ``S = 0``).
    """

    spec: "MulSpec"
    n_samples: int
    med: float
    mred: float
    nmed: float
    error_rate: float
    wce: int
    exact: bool = False

    def row(self) -> Dict[str, object]:
        return {
            "mul": self.spec.kind,
            "N": self.spec.n_bits,
            "t": self.spec.effective_trunc_bits,
            "v": self.spec.effective_row_bits,
            "samples": self.n_samples,
            "MED": self.med,
            "MRED": self.mred,
            "NMED": self.nmed,
            "ER": self.error_rate,
            "WCE": self.wce,
            "exact": self.exact,
        }


def mul_population_report(spec: "MulSpec", ed: torch.Tensor,
                          s: torch.Tensor) -> MulErrorReport:
    """The canonical full-population reduction over per-pair error
    distances ``ed = |approx - a*b|`` and exact products ``s`` (int64
    tensors on one device).

    Shared by :func:`exhaustive_mul_error_metrics` and the table-driven
    ``method="compose"`` path of :mod:`repro_torch.ax.analytics`: MED/ER
    are exact integer totals with one correctly-rounded division, and
    MRED groups integer numerators by exact product (``index_add_`` on
    the device) before an exactly-rounded :func:`math.fsum` on the host,
    so the report is bit-identical to the reference's.
    """
    n_bits = spec.n_bits
    pop = ed.numel()
    max_out = float(((1 << n_bits) - 1) ** 2)
    total, n_err, wce = _population_ints(ed)
    med = float(total) / float(pop)
    mred = _ratio_fsum(ed, s, ((1 << n_bits) - 1) ** 2 + 1) / float(pop)
    return MulErrorReport(
        spec=spec,
        n_samples=pop,
        med=med,
        mred=mred,
        nmed=med / max_out,
        error_rate=float(n_err) / float(pop),
        wce=wce,
        exact=True,
    )


def exhaustive_mul_error_metrics(spec: "MulSpec",
                                 strategy: str = "reference",
                                 device=None) -> MulErrorReport:
    """Exact multiplier metrics by full 4^N enumeration (N <= 12).

    ``strategy`` picks the evaluation path (reference / fused / lut —
    all bit-identical); the closed-form analytics
    (:func:`exact_mul_error_metrics`) must match this bit-for-bit.
    """
    n_bits = spec.n_bits
    if n_bits > 12:
        raise ValueError("exhaustive enumeration is limited to N <= 12")
    from repro_torch.kernels.mul import mul_lanes
    dev = analysis_device(device)
    a, b = _operand_grid(n_bits, dev)
    approx = mul_lanes(a, b, spec, strategy)
    s = a * b
    return mul_population_report(spec, (approx - s).abs(), s)


def exact_mul_error_metrics(spec: "MulSpec", method: str = "auto",
                            device=None) -> MulErrorReport:
    """Exact closed-form multiplier metrics (see
    :mod:`repro_torch.ax.analytics` for the formulation)."""
    from repro_torch.ax.analytics import exact_mul_error_metrics as _exact
    return _exact(spec, method=method, device=device)


def exact_mul_error_metrics_sweep(
    specs: "Iterable[MulSpec]",
    method: str = "auto",
    cache_tables: bool = True,
    device=None,
) -> "List[MulErrorReport]":
    from repro_torch.ax.analytics import exact_mul_error_metrics_sweep as _s
    return _s(specs, method=method, cache_tables=cache_tables,
              device=device)


def summarize(reports: Iterable[ErrorReport]) -> str:
    rows = [r.row() for r in reports]
    header = f"{'adder':<10} {'MED':>12} {'MRED':>12} {'NMED':>12} {'ER':>8} {'WCE':>8}"
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r['adder']:<10} {r['MED']:>12.2f} {r['MRED']:>12.3e} "
            f"{r['NMED']:>12.3e} {r['ER']:>8.4f} {r['WCE']:>8d}"
        )
    return "\n".join(lines)
