"""Fault-tolerant training loop (the port of
``repro.runtime.train_loop``).

- runs the train step eagerly (no jit, no donation: the step updates the
  state's tensors in place);
- checkpoints every ``ckpt_every`` steps (async), restores on start;
- straggler watchdog (per-step wall-time outlier detection,
  :class:`repro_torch.runtime.straggler.StragglerMonitor`);
- recovers from a :class:`SimulatedFault` by restoring the last
  checkpoint (nothing else is caught: a CUDA error propagates);
- deterministic resumable data (the step-indexed synthetic stream).

A mesh (several cards) is not ported yet: ROADMAP Queue A item 5.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch.steps import init_state, make_train_step, \
    state_shapes
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    max_failures: int = 3
    seed: int = 0


class SimulatedFault(RuntimeError):
    pass


_RECOVERABLE = (SimulatedFault,)


def run(model_cfg: ModelConfig, opt_cfg: AdamWConfig, data_cfg: DataConfig,
        loop_cfg: TrainLoopConfig, mesh=None,
        fault_hook: Optional[Callable[[int], None]] = None,
        device=None) -> Dict[str, Any]:
    """Returns {"state", "history": [metrics...], "stragglers",
    "failures"}; the state on ``device`` (``None``: the card)."""
    if mesh is not None:
        raise NotImplementedError(
            f"a mesh is not ported to repro_torch yet: ROADMAP.md Queue A "
            f"item {T._UNPORTED['sharding']}")
    dev = T.resolve_device(device)
    step_fn = make_train_step(model_cfg, opt_cfg)
    ckpt = Checkpointer(loop_cfg.ckpt_dir) if loop_cfg.ckpt_dir else None

    def restore_or_init():
        if ckpt is not None and ckpt.latest_step() is not None:
            return ckpt.restore(state_shapes(model_cfg, opt_cfg,
                                             seed=loop_cfg.seed), device=dev)
        return init_state(loop_cfg.seed, model_cfg, opt_cfg, device=dev)

    state = restore_or_init()
    step = int(state["step"])
    monitor = StragglerMonitor()
    history: List[Dict[str, float]] = []
    failures = 0
    while step < loop_cfg.total_steps:
        batch = synthetic_batch(model_cfg, data_cfg, step)
        t0 = time.time()
        try:
            if fault_hook is not None:
                fault_hook(step)  # test hook: may raise to simulate loss
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])   # waits for the step
        except _RECOVERABLE:
            failures += 1
            if ckpt is None or failures > loop_cfg.max_failures:
                raise
            state = restore_or_init()
            step = int(state["step"])
            continue
        dt = time.time() - t0
        monitor.record(step, dt)
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            history.append({"step": step, "loss": loss,
                            "ce": float(metrics["ce"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "dt": dt})
        step += 1
        if ckpt is not None and step % loop_cfg.ckpt_every == 0:
            ckpt.async_save(step, state)
    if ckpt is not None:
        ckpt.save(loop_cfg.total_steps, state)
    return {"state": state, "history": history,
            "stragglers": monitor.flagged, "failures": failures}
