"""Serving launcher: batched prefill + decode with KV caches (the port of
``repro.launch.serve``), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-4b --adder haloc_axa --batch 4 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-4b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --adder haloc_axa     # or mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-11b --adder haloc_axa --batch 4 \
        --prompt-len 32 --new-tokens 16

Every arch of the registry serves but hubert-xlarge, which is
encoder-only and exits (as the reference's launcher does).

Parameters are drawn from a seeded generator on the device, held in bf16
(the norm scales and the fp32 leaves of ``weights.FP32_LEAVES`` in fp32);
the prompt is random tokens from the same seed, and a vision model's
input (B, seq_len, embed_dim) bf16 embeddings, N(0, 1), drawn after them.
On the card the residual adds run in the ``approx_add`` kernel
(``--adder``), on the CPU in its plain version.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.serving import generate, throughput_report
from repro_torch.numerics.approx_ops import make_numerics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=arch_names())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--adder", default="off")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only (no decode)")
    dev = T.resolve_device(args.device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    if args.adder != "off":
        cfg = cfg.with_approx(make_numerics(args.adder, "residual",
                                            backend=backend, device=dev))
    params = T.init_params(0, cfg, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.vision is not None:
        batch["vision"] = torch.randn(
            (args.batch, cfg.vision.seq_len, cfg.vision.embed_dim),
            generator=gen, device=dev).to(torch.bfloat16)
    t0 = time.time()
    out = generate(params, cfg, batch, args.new_tokens,
                   temperature=args.temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"{cfg.name}: {tuple(out.shape)}; "
          f"{throughput_report(args.new_tokens, time.time() - t0, args.batch)}")


if __name__ == "__main__":
    main()
