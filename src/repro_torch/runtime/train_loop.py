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

With a mesh (a ``DeviceMesh`` over the process group; every rank runs
the loop) the state is sharded (``state_shardings``' placements,
:func:`repro_torch.sharding.rules.place_state`), each rank takes its
rows of the step's batch (``data_sharding``) and runs the sharded step;
checkpoints hold full leaves (rank 0 writes) and are restored onto the
mesh's placements.
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
from repro_torch.sharding import rules as R


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
    "failures"}; the state on ``device`` (``None``: the card), or
    sharded on ``mesh`` (its ranks' device)."""
    if mesh is None:
        dev = T.resolve_device(device)
        step_fn = make_train_step(model_cfg, opt_cfg)
    else:
        dev = R.mesh_device(R.device_mesh(mesh))
        step_fn = make_train_step(model_cfg, opt_cfg,
                                  batch_axes=R.batch_axes(mesh), mesh=mesh)
    ckpt = Checkpointer(loop_cfg.ckpt_dir) if loop_cfg.ckpt_dir else None

    def latest():
        if mesh is not None:   # rank 0's saves are published to every rank
            ckpt.wait()
            R.barrier(mesh)
        return ckpt.latest_step()

    def restore_or_init():
        if ckpt is not None and latest() is not None:
            like = state_shapes(model_cfg, opt_cfg, seed=loop_cfg.seed)
            if mesh is None:
                return ckpt.restore(like, device=dev)
            return ckpt.restore(like, shardings=R.placed_state_specs(
                like, mesh), mesh=mesh)
        state = init_state(loop_cfg.seed, model_cfg, opt_cfg, device=dev)
        return state if mesh is None else R.place_state(state, mesh)

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
