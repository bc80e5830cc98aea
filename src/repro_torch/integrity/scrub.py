"""LUT scrubbing: periodic re-hash of live compiled tables against their
golden digests, with recompile-and-swap repair (the port of
``repro.integrity.scrub``).

The shared LUT caches are the most dangerous place for silent data
corruption in this stack: one table is aliased by every engine, plan
and kernel that gathers from it, so a single flipped cell poisons every
consumer — and because the datapath is *approximate by design*, the
poisoned outputs are statistically camouflaged.  Memory scrubbing is the
classic answer: walk the tables on a cadence, compare content hashes
against the golden digests recorded at compile time
(:mod:`repro_torch.integrity.digests`), and repair in place from a fresh
off-cache rebuild.

The kernels gather from the tables' copies on the card
(``ax.lut.device``, ``ax.mul.lut.device*``,
``kernels.conv2d_mac.signed_taps``), and those are golden entries too:
verifying one costs a device-to-host copy and a SHA-256 on the host.

:class:`LutScrubber` runs on the serving stack's injectable
:class:`~repro_torch.serving.clock.Clock`, so a
:class:`~repro_torch.serving.clock.VirtualClock` campaign replays
detection latencies bit-identically.  Detections feed the same alarm
paths the drift monitor uses: a
:class:`~repro_torch.serving.breaker.CircuitBreaker`
(:meth:`record_integrity`) and/or a
:class:`~repro_torch.resilience.degrade.DegradePolicy`
(:meth:`on_integrity_alarm`), plus ``integrity.*`` metrics (zero-cost
when telemetry is off).

Repair swaps the rebuilt contents INTO the live table (``np.copyto``
under a lifted ``writeable`` guard for a host array, ``Tensor.copy_``
for a device copy), so every alias — including engines and compiled
plans holding the table — sees the repaired data without recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.integrity.digests import (GoldenEntry, golden_entries,
                                           table_digest, verify_entry)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.serving.clock import Clock, WallClock

__all__ = ["ScrubReport", "LutScrubber", "scrub_entries",
           "verify_engine_tables"]


@dataclasses.dataclass(frozen=True)
class ScrubReport:
    """Outcome of one scrub pass.

    ``corrupted``/``repaired``/``unrepaired`` carry ``(cache, key)``
    labels; a healthy pass has all three empty."""

    checked: int
    corrupted: Tuple[Tuple[str, str], ...]
    repaired: Tuple[Tuple[str, str], ...]
    unrepaired: Tuple[Tuple[str, str], ...]
    at: float

    @property
    def ok(self) -> bool:
        return not self.corrupted

    def __repr__(self) -> str:
        return (f"ScrubReport(checked={self.checked}, "
                f"corrupted={len(self.corrupted)}, "
                f"repaired={len(self.repaired)}, at={self.at:.3f})")


def _nbytes(table) -> int:
    if isinstance(table, torch.Tensor):
        return table.numel() * table.element_size()
    return int(table.nbytes)


def _label(entry: GoldenEntry) -> Tuple[str, str]:
    return (entry.cache, repr(entry.key))


def _repair_entry(entry: GoldenEntry) -> bool:
    """Recompile-and-swap: rebuild off-cache (on the entry's device),
    check the rebuild hashes to the golden digest, and copy it into the
    live table in place.  Returns True when the live table verifies again
    afterwards."""
    fresh = entry.rebuild()
    if table_digest(fresh, entry.pattern) != entry.digest:
        # The rebuild itself disagrees with the golden — repairing from
        # it would just install different (possibly wrong) data under a
        # now-unverifiable digest.  Leave the corruption visible.
        return False
    live = entry.table
    if isinstance(live, torch.Tensor):
        live.copy_(fresh)
    else:
        was_writeable = live.flags.writeable
        try:
            live.flags.writeable = True
            np.copyto(live, np.asarray(fresh))
        finally:
            live.flags.writeable = was_writeable
    return verify_entry(entry)


def scrub_entries(entries, *, repair: bool = True,
                  at: float = 0.0) -> ScrubReport:
    """Verify (and optionally repair) ``entries``; the core one-pass
    walk shared by the scrubber and the engine verify-on-load hook."""
    corrupted: List[Tuple[str, str]] = []
    repaired: List[Tuple[str, str]] = []
    unrepaired: List[Tuple[str, str]] = []
    checked = 0
    for entry in entries:
        checked += 1
        if verify_entry(entry):
            continue
        corrupted.append(_label(entry))
        if repair and _repair_entry(entry):
            repaired.append(_label(entry))
        else:
            unrepaired.append(_label(entry))
    if _obs._ENABLED:
        _metrics.counter("integrity.tables_checked").inc(checked)
        if corrupted:
            _metrics.counter("integrity.corruptions").inc(len(corrupted))
            _metrics.counter("integrity.repairs").inc(len(repaired))
    return ScrubReport(checked=checked, corrupted=tuple(corrupted),
                       repaired=tuple(repaired),
                       unrepaired=tuple(unrepaired), at=at)


class LutScrubber:
    """Cadenced digest verification over the golden registry.

    Args:
      interval_s: scrub cadence in clock seconds.
      clock: injectable time source (default wall; campaigns pass a
        :class:`~repro_torch.serving.clock.VirtualClock`).
      repair: recompile-and-swap corrupted tables in place (default).
      cache: restrict scrubbing to one cache facade name (default: the
        whole registry, device copies included).
      breaker: optional :class:`~repro_torch.serving.breaker.CircuitBreaker`
        — any detection calls ``record_integrity(now)``.
      policy: optional :class:`~repro_torch.resilience.degrade.DegradePolicy`
        — any detection calls ``on_integrity_alarm(report)``.
      alarm: optional callable receiving the :class:`ScrubReport` of
        any pass that found corruption.
      slice_bytes: patrol scrubbing — each run verifies only the next
        entries of the walk, in registry order and wrapping around,
        until it has hashed at least this many bytes (at least one
        entry).  A run is one device-to-host copy and a host SHA-256 per
        table, on the caller's thread, so a whole-registry pass over
        hundreds of tables stalls a serving loop for as long as it
        hashes; a slice bounds that stall, and a corruption is found
        within ``ceil(registry bytes / slice_bytes)`` runs.  Default
        ``None``: every run walks the whole registry (or ``cache``).

    Drive it either from a scheduler tick (:meth:`maybe_run`, which
    self-limits to the cadence) or directly (:meth:`scrub_once`).
    """

    def __init__(self, *, interval_s: float = 60.0,
                 clock: Optional[Clock] = None, repair: bool = True,
                 cache: Optional[str] = None, breaker=None, policy=None,
                 alarm: Optional[Callable[[ScrubReport], None]] = None,
                 slice_bytes: Optional[int] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0; got {interval_s}")
        if slice_bytes is not None and slice_bytes <= 0:
            raise ValueError(f"slice_bytes must be > 0; got {slice_bytes}")
        self.slice_bytes = slice_bytes
        self._cursor = 0
        self.interval_s = float(interval_s)
        self.clock = clock if clock is not None else WallClock()
        self.repair = repair
        self.cache = cache
        self.breaker = breaker
        self.policy = policy
        self.alarm = alarm
        self.runs = 0
        self.corruptions = 0
        self.repairs = 0
        self.last_report: Optional[ScrubReport] = None
        self._next_due = self.clock.now() + self.interval_s

    def due(self, now: Optional[float] = None) -> bool:
        now = self.clock.now() if now is None else now
        return now >= self._next_due

    def maybe_run(self, now: Optional[float] = None
                  ) -> Optional[ScrubReport]:
        """One cadence tick: scrub if the interval elapsed, else no-op
        (the scheduler calls this every pump)."""
        now = self.clock.now() if now is None else now
        if not self.due(now):
            return None
        return self.scrub_once(now)

    def scrub_once(self, now: Optional[float] = None) -> ScrubReport:
        """Walk the registry immediately (cadence state advances)."""
        now = self.clock.now() if now is None else now
        self._next_due = now + self.interval_s
        entries = self._walk()
        if _obs._ENABLED:
            with _obs.span("integrity:scrub", cache=self.cache or "all"):
                report = scrub_entries(entries, repair=self.repair, at=now)
            _metrics.counter("integrity.scrub_runs").inc()
        else:
            report = scrub_entries(entries, repair=self.repair, at=now)
        self.runs += 1
        self.corruptions += len(report.corrupted)
        self.repairs += len(report.repaired)
        self.last_report = report
        if not report.ok:
            self._raise_alarm(report, now)
        return report

    def _walk(self) -> Tuple[GoldenEntry, ...]:
        """The entries this run verifies: all of them, or the next slice
        of at least ``slice_bytes`` from the cursor."""
        entries = golden_entries(self.cache)
        if self.slice_bytes is None or not entries:
            return entries
        start = self._cursor % len(entries)
        picked, nbytes = [], 0
        for i in range(len(entries)):
            entry = entries[(start + i) % len(entries)]
            picked.append(entry)
            nbytes += _nbytes(entry.table)
            if nbytes >= self.slice_bytes:
                break
        self._cursor = (start + len(picked)) % len(entries)
        return tuple(picked)

    def _raise_alarm(self, report: ScrubReport, now: float) -> None:
        if self.breaker is not None:
            self.breaker.record_integrity(now)
        if self.policy is not None:
            self.policy.on_integrity_alarm(report)
        if self.alarm is not None:
            self.alarm(report)

    def __repr__(self) -> str:
        return (f"LutScrubber(interval_s={self.interval_s}, "
                f"slice_bytes={self.slice_bytes}, runs={self.runs}, "
                f"corruptions={self.corruptions}, repairs={self.repairs})")


def verify_engine_tables(spec, mul_spec=None, *, repair: bool = True,
                         device=None) -> ScrubReport:
    """The engine verify-on-load hook (``make_engine(...,
    integrity=True)``): compile-or-touch every shared table a
    LUT-strategy engine will gather from — the host tables and their
    copies on ``device`` (the engine's; ``None`` touches host tables
    only) — then verify (and by default repair) exactly those registry
    entries before the engine serves.

    Raises ``IOError`` if a corrupted table cannot be restored to its
    golden digest — serving from it would emit silently-wrong sums.
    """
    from repro_torch.ax.lut import (_canonical, compile_lut, device_table,
                                    lut_supported)
    from repro_torch.ax.mul.lut import (_canonical as _mul_canonical,
                                        _mul_lut_cached,
                                        _signed_table_cached,
                                        device_mul_table,
                                        mul_lut_supported)
    from repro_torch.ax.registry import get_adder

    keys = []
    if not get_adder(spec.kind).is_exact and lut_supported(spec):
        compile_lut(spec)
        if device is not None:
            device_table(spec, device)
        keys.append(_canonical(spec))
    if (mul_spec is not None and not mul_spec.is_exact
            and mul_lut_supported(mul_spec)):
        canon = _mul_canonical(mul_spec)
        _mul_lut_cached(canon)
        _signed_table_cached(canon)
        if device is not None:
            device_mul_table(canon, device)
        keys.append(canon)
    entries = [e for e in golden_entries() if e.key[0] in keys]
    report = scrub_entries(entries, repair=repair)
    if report.unrepaired:
        raise IOError(
            f"unrepairable LUT corruption detected at engine load: "
            f"{report.unrepaired}")
    return report
