"""Batched serving (the port of ``examples/serve_decode.py``): prefill a
prompt batch, decode new tokens with KV caches, through the
approximate-adder residual path (the ``approx_add`` kernel on the card).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--arch qwen3-4b]
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --device cpu --temperature 0

The model is the arch's smoke config, as in the reference's script.
Parameters (fp32) and the prompt are drawn from ``--seed``; sampling
draws from a ``torch.Generator`` seeded by it (no claim is made to equal
jax's sampled tokens; at ``--temperature 0`` the decode is greedy).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import arch_names, get_smoke_config
from repro_torch.examples._cli import add_device_args, backend_and_device
from repro_torch.models import transformer as T
from repro_torch.models.serving import generate, throughput_report
from repro_torch.numerics.approx_ops import make_numerics


def build_config(arch: str, adder: str, backend: str, device):
    """The reference script's config: the smoke config, the adder in the
    residual stream, an SSD's chunk cut to 8."""
    cfg = get_smoke_config(arch)
    if not cfg.causal:
        raise SystemExit(f"{arch} is encoder-only; pick a causal arch "
                         f"from {arch_names()}")
    if adder != "off":
        cfg = cfg.with_approx(make_numerics(adder, "residual",
                                            backend=backend, device=device))
    if cfg.ssd is not None:
        cfg = dataclasses.replace(cfg, ssd=dataclasses.replace(cfg.ssd,
                                                               chunk=8))
    return cfg


def main(argv=None, params=None):
    """``params``: a parameter tree to serve in place of the one drawn
    from ``--seed`` (on the chosen device)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    ap.add_argument("--arch", default="qwen3-4b", choices=arch_names())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--adder", default="haloc_axa")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    backend, dev = backend_and_device(args)

    cfg = build_config(args.arch, args.adder, backend, dev)
    if params is None:
        params = T.init_params(args.seed, cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.vision is not None:
        batch["vision"] = torch.randn(
            (args.batch, cfg.vision.seq_len, cfg.vision.embed_dim),
            generator=gen, device=dev).to(torch.bfloat16)

    t0 = time.time()
    out = generate(params, cfg, batch, args.new_tokens,
                   temperature=args.temperature, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} adder={args.adder}")
    print(f"generated: {tuple(out.shape)} (prompt {args.prompt_len} + "
          f"{args.new_tokens} new)")
    print(throughput_report(args.new_tokens, dt, args.batch))
    print("first sequence tail:", out[0, -8:].tolist())
    return {"prompt": batch, "tokens": out.cpu(), "seconds": dt}


if __name__ == "__main__":
    main()
