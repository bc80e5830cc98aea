"""Straggler detection: robust per-step wall-time outlier monitor (the
port's copy of ``repro.runtime.straggler``).

At fleet scale the common mitigation stack is (a) detect the slow worker,
(b) alert/evict, (c) keep the optimizer state intact via elastic restart.
This module implements (a) host-side with a median/MAD filter and exposes
a callback hook for (b).

:meth:`StragglerMonitor.late` is the single source of truth for "this
work item is late" across the port: the streaming executor's per-batch
deadline path (:func:`repro_torch.imgproc.corpus.run_streaming`) routes
through it —
an explicit deadline when the caller has an SLO, the median/MAD outlier
filter when it only has the stream's own history.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class StragglerConfig:
    window: int = 32           # trailing steps for the baseline
    threshold: float = 3.0     # flag if dt > median + threshold * MAD
    min_samples: int = 8


class StragglerMonitor:
    def __init__(self, cfg: Optional[StragglerConfig] = None,
                 on_flag: Optional[Callable[[int, float], None]] = None):
        # cfg defaults PER INSTANCE: a `cfg=StragglerConfig()` default
        # argument is evaluated once at def time and the one (mutable)
        # config object would be shared by every monitor in the process.
        self.cfg = cfg if cfg is not None else StragglerConfig()
        self.on_flag = on_flag
        self.times: List[float] = []
        self.flagged: List[Tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        window = self.times[-self.cfg.window:]
        self.times.append(dt)
        if len(window) < self.cfg.min_samples:
            return False
        srt = sorted(window)
        med = srt[len(srt) // 2]
        mad = sorted(abs(t - med) for t in window)[len(window) // 2]
        limit = med + self.cfg.threshold * max(mad, 0.05 * med, 1e-9)
        if dt > limit:
            self.flagged.append((step, dt))
            if self.on_flag is not None:
                self.on_flag(step, dt)
            return True
        return False

    def late(self, step: int, dt: float,
             deadline: Optional[float] = None) -> bool:
        """Deadline-or-outlier lateness verdict for one work item.

        Records ``dt`` into the trailing window either way.  The item
        is late when it exceeds an explicit ``deadline`` (the caller's
        SLO) OR when the median/MAD filter flags it as an outlier
        against the stream's own recent history — the one definition
        the streaming executor's retry path uses."""
        flagged = self.record(step, dt)
        return flagged or (deadline is not None and dt > deadline)
