"""Injectable time source for the serving stack (the port's copy of
``repro.serving.clock``).

Every serving component (admission queue, batcher, circuit breaker,
scheduler, traffic harness) reads time through a :class:`Clock` handle
instead of calling ``time.perf_counter`` directly.  Production uses
:class:`WallClock`; the tests and any deterministic replay use
:class:`VirtualClock`, where time only moves when the harness (or a
simulated executor) advances it — so an overload scenario with
deadlines, backoff sleeps and breaker cooldowns replays bit-identically
with zero real sleeping.
"""

from __future__ import annotations

import math
import time


class Clock:
    """Minimal time-source protocol: ``now()`` seconds + ``sleep()``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Real time: ``perf_counter`` + ``time.sleep``."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic manual time: ``now()`` returns the accumulated
    virtual seconds; ``sleep``/``advance`` move it forward instantly.

    Time never moves on its own, so a test that submits requests at
    scripted arrival instants, runs a simulated executor that
    ``advance()``s by its service time, and lets retry backoff ``sleep``
    through the same clock is a pure function of its seed."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        """Move time forward by ``seconds`` (negative is rejected — a
        serving timeline never rewinds); returns the new ``now()``.

        A POSITIVE advance always strictly moves time: below one ulp of
        ``now()`` the float addition would be absorbed (e.g. sleeping
        the 1e-17 residue of a breaker cooldown), and a discrete-event
        loop that sleeps such a residue would freeze forever — so the
        absorbed case rounds up to the next representable instant."""
        if seconds < 0:
            raise ValueError(f"cannot advance a clock by {seconds}")
        t = self._t + float(seconds)
        if seconds > 0 and t == self._t:
            t = math.nextafter(t, math.inf)
        self._t = t
        return self._t

    def advance_to(self, t: float) -> float:
        """Move time forward to absolute instant ``t`` (no-op if ``t``
        is already in the past — open-loop arrivals behind schedule)."""
        if t > self._t:
            self._t = float(t)
        return self._t
