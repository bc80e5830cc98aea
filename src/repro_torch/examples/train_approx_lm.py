"""End-to-end training (the port of ``examples/train_approx_lm.py``): train
a ~60M-parameter LM for a few hundred steps with the paper's HALOC-AxA
adder in the residual stream (the ``approx_add`` kernel on the card),
with checkpointing and fault tolerance, and compare against the
exact-adder run.

    PYTHONPATH=src python -m repro_torch.examples.train_approx_lm \\
        [--steps 300] [--adder haloc_axa] [--d-model 512] [--layers 8]
    PYTHONPATH=src python -m repro_torch.examples.train_approx_lm \\
        --device cpu --d-model 64 --layers 2 --batch 2 --seq 32 --steps 3

The loop (:func:`repro_torch.runtime.train_loop.run`) restores the
latest checkpoint under ``--ckpt-dir``_<adder> when there is one; the
default directory is ``approx_lm_ckpt_torch`` under the system's
temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

from repro_torch.data.pipeline import DataConfig
from repro_torch.examples._cli import add_device_args, backend_and_device
from repro_torch.launch.steps import state_shapes
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.numerics.approx_ops import make_numerics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, run
from repro_torch.tree import leaves

CKPT_DIR = os.path.join(tempfile.gettempdir(), "approx_lm_ckpt_torch")


def build_model(d_model: int, layers: int, adder: str, backend: str = "cuda",
                device=None) -> ModelConfig:
    cfg = ModelConfig(
        name=f"approx-lm-{d_model}x{layers}",
        family="dense",
        d_model=d_model,
        num_heads=8,
        num_kv_heads=4,
        head_dim=d_model // 8,
        d_ff=d_model * 3,
        vocab_size=32768,
        pattern=(BlockSpec(),),
        repeats=layers,
    )
    if adder != "off":
        cfg = cfg.with_approx(make_numerics(adder, "residual",
                                            backend=backend, device=device))
    return cfg.validate()


def param_count(cfg: ModelConfig, opt: AdamWConfig) -> int:
    """The parameters of the port's own state (meta tensors: no
    allocation)."""
    return sum(math.prod(p.shape)
               for p in leaves(state_shapes(cfg, opt)["params"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--adder", default="haloc_axa")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    args = ap.parse_args(argv)
    backend, dev = backend_and_device(args)

    data = DataConfig(seq_len=args.seq, global_batch=args.batch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir, log_every=args.log_every)

    results = {}
    for adder in dict.fromkeys((args.adder, "off")):
        cfg = build_model(args.d_model, args.layers, adder, backend, dev)
        n_params = param_count(cfg, opt)
        print(f"\n=== adder={adder}  params={n_params / 1e6:.1f}M ===")
        t0 = time.time()
        out = run(cfg, opt, data,
                  dataclasses.replace(loop,
                                      ckpt_dir=f"{args.ckpt_dir}_{adder}"),
                  device=dev)
        dt = time.time() - t0
        hist = out["history"]
        tok_s = args.steps * args.batch * args.seq / dt
        if not hist:
            print(f"restored the step-{args.steps} checkpoint from "
                  f"{args.ckpt_dir}_{adder}: nothing left to train")
        else:
            print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
                  f"in {dt:.0f}s ({tok_s:,.0f} tok/s)")
        for h in hist[:: max(1, len(hist) // 6)]:
            print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
                  f"gnorm {h['grad_norm']:.2f}")
        results[adder] = {"history": hist, "seconds": dt,
                          "tokens_per_s": tok_s, "n_params": n_params,
                          "state": out["state"]}
    return results


if __name__ == "__main__":
    main()
