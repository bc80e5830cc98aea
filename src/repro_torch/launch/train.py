"""Training launcher (the port of ``repro.launch.train``), on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-4b --smoke --steps 20 --device cpu --adder haloc_axa
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --adder haloc_axa --steps 4 \
        --batch 4 --seq 128

Full-size configs run at their published widths on one card; several
cards (``--model-parallel``, a mesh) are not ported yet (ROADMAP Queue A
item 5).  On the card the residual adds run in the ``approx_add`` kernel
(``--adder``), on the CPU in its plain version.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import transformer as T
from repro_torch.numerics.approx_ops import make_numerics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, run


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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} needs a mesh, which is "
            f"not ported to repro_torch yet: ROADMAP.md Queue A item "
            f"{T._UNPORTED['sharding']}")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = T.resolve_device(args.device)
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
    out = run(cfg, opt, data, loop, device=dev)
    h = out["history"]
    print(f"\n{cfg.name}: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
          f"over {args.steps} steps; stragglers flagged: "
          f"{len(out['stragglers'])}; failures recovered: {out['failures']}")


if __name__ == "__main__":
    main()
