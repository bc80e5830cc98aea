"""Training launcher (the port of ``repro.launch.train``), on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-4b --smoke --steps 20 --device cpu --adder haloc_axa
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --adder haloc_axa --steps 4 \
        --batch 4 --seq 128

Full-size configs run at their published widths.  Several cards, or
CPU ranks, train sharded on a mesh: start the launcher under
``torch.distributed.run`` (NCCL on the card, gloo with ``--device cpu``)

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 4 \
        --device cpu --model-parallel 2

A mesh is built (:func:`repro_torch.runtime.elastic.make_elastic_mesh`)
when the process group has more than one rank or ``--model-parallel``
is above 1, as the reference's ``len(jax.devices()) > 1`` does; with
``--model-parallel`` above 1 the train step computes its attention
mixers, dense MLPs, embedding, head and CE tensor-parallel over the
mesh's "model" axis (``models.transformer``).  On the
card the residual adds run in the ``approx_add`` kernel (``--adder``),
on the CPU in its plain version.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import transformer as T
from repro_torch.numerics.approx_ops import make_numerics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.runtime.train_loop import TrainLoopConfig, run
from repro_torch.sharding import rules as R


def join_process_group(dev: torch.device) -> bool:
    """Joins the process group ``torch.distributed.run`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, the master's
    address): NCCL on the card (this rank's card ``LOCAL_RANK``), gloo on
    the CPU.  False when the launcher was not started so."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=arch_names())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--adder", default="off",
                    help="off | haloc_axa | loa | ... (residual numerics)")
    ap.add_argument("--fast-emul", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's \"model\" axis (tensor-"
                         "parallel compute over it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = T.resolve_device(args.device)
    grouped = join_process_group(dev)
    mesh = None
    if args.model_parallel > 1 or (grouped and dist.get_world_size() > 1):
        if not grouped:
            ap.error(f"--model-parallel {args.model_parallel} needs ranks: "
                     f"start the launcher under python -m "
                     f"torch.distributed.run")
        mesh = make_elastic_mesh(args.model_parallel)
        dev = R.mesh_device(mesh)
    backend = "cuda" if dev.type == "cuda" else "torch"
    if args.adder != "off":
        cfg = cfg.with_approx(make_numerics(args.adder, "residual",
                                            fast=args.fast_emul,
                                            backend=backend, device=dev))
    data = DataConfig(seq_len=args.seq, global_batch=args.batch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                      total_steps=args.steps)
    loop = TrainLoopConfig(total_steps=args.steps,
                           ckpt_every=max(20, args.steps // 4),
                           ckpt_dir=args.ckpt_dir or None,
                           log_every=max(1, args.steps // 20))
    try:
        out = run(cfg, opt, data, loop, mesh=mesh, device=dev)
    finally:
        if grouped:
            dist.destroy_process_group()
    h = out["history"]
    where = "" if mesh is None else \
        f" on a {dict(R.mesh_shape(mesh))} mesh"
    print(f"\n{cfg.name}: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
          f"over {args.steps} steps{where}; stragglers flagged: "
          f"{len(out['stragglers'])}; failures recovered: {out['failures']}")


if __name__ == "__main__":
    main()
