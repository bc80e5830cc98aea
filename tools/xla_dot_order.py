"""Classify the order in which XLA:CPU's fp32 ``dot`` adds its products.

The reference (``repro``) takes a bf16 product on the CPU as convert, an
fp32 ``dot``, convert.  A product of two bf16 values is exact in fp32, so
the dot's fp32 result depends only on the order of its adds; this script
finds that order per (M, K, N) slice and operand layout by running the
dot on bf16-valued operands and comparing it, bit for bit, with candidate
orders computed in numpy:

  S      one chain over k from zero;
  Tc     c chains (chain j adds k = j, j + c, ... below the last multiple
         of c), summed as ((c0 + c1) + (c2 + c3)) + ..., and the last
         K mod c products summed on their own and added last;
  x/kc   the same over K blocks of kc products, the blocks' sums added in
         turn (kc from floor(32768 / N));
  MIXED  no candidate fits every element.

Layouts: ``normal`` (lhs [M, K], rhs [K, N]), ``lhs_t`` (lhs held as
[K, M]), ``rhs_t`` (rhs held as [N, K]).  The port's
``repro_torch.models.layers.xla_cpu_dot_order`` is the table this prints;
``tests/test_torch_moe_mla.py`` holds the port's ``cpu_dot_f32`` against
XLA over the same grid.

``--check`` holds that table against each point (``!`` where the rule's
order does not fit, or where it gives none for the M > 50 chains past
one column tile though the last tile's width's order fits); with
``--random COUNT`` it checks COUNT random normal and ``rhs_t`` shapes up
to K = 130 and N = 1300 (``--seed``) in place of the grid.

``--hlo ARCH`` prints every ``dot`` of the reference's compiled full,
prefill, train and decode steps of a smoke config, with its operands'
shapes: the layouts the model's products take, the backward's included
(which the port's callers follow).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_dot_order.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_dot_order.py \\
        --layout rhs_t --m 4 64 --k 16 31 --n 16 31 80
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_dot_order.py \\
        --check --m 124 --k $(seq 3 73) --n 97 161 289
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_dot_order.py \\
        --check --random 50 --seed 1
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_dot_order.py \\
        --hlo deepseek-v2-236b

The order depends on the jax/XLA build and the host (the grid was read
with jax 0.9.0 on x86-64 with AVX-512); for few rows with K >= 128 and
N > 508 it also depends on the number of cores (XLA splits N between
threads).
"""

from __future__ import annotations

import argparse
import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

F32 = np.float32

#: The (M, K, N) slices of the smoke configs' 2-D products (tokens or
#: frames 4 x 31 full, 4 x 20 prefill, 4 decode, 2 x 24 and 2 x 23 in the
#: parity test; llama-3.2-vision-11b's 17 vision positions, 68 rows), the
#: default grid.
SMOKE_M = (1, 2, 4, 46, 48, 68, 80, 124)
SMOKE_K = (16, 17, 24, 31, 32, 48, 64, 96, 128, 160, 192, 256)
SMOKE_N = (4, 8, 16, 17, 24, 31, 32, 48, 64, 96, 97, 128, 160, 192, 256,
           419, 503, 509, 515, 601, 640)


def bf16_values(rng, shape):
    a = rng.standard_normal(shape).astype(F32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def xla_dot(a, b, layout):
    lhs = a.T.copy() if layout == "lhs_t" else a
    rhs = b.T.copy() if layout == "rhs_t" else b
    dims = (((0,) if layout == "lhs_t" else (1,),
             (1,) if layout == "rhs_t" else (0,)), ((), ()))
    return np.asarray(jax.jit(lambda x, y: lax.dot_general(
        x, y, dims, preferred_element_type=jnp.float32))(
        jnp.asarray(lhs), jnp.asarray(rhs)))


def chain_sum(a, b, lo, hi, c):
    body = hi - (hi - lo) % c
    zero = np.zeros((a.shape[0], b.shape[1]), F32)

    def chain(start, stop, step):
        acc = zero
        for j in range(start, stop, step):
            acc = (acc + np.outer(a[:, j], b[j]).astype(F32)).astype(F32)
        return acc

    accs = [chain(j, body, c) for j in range(lo, lo + c)]
    while len(accs) > 1:
        accs = [(accs[i] + accs[i + 1]).astype(F32)
                for i in range(0, len(accs), 2)]
    return (accs[0] + chain(body, hi, 1)).astype(F32) if body < hi \
        else accs[0]


def candidate(a, b, c, kc):
    k = a.shape[1]
    out = None
    for lo in range(0, k, kc):
        part = chain_sum(a, b, lo, min(k, lo + kc), c)
        out = part if out is None else (out + part).astype(F32)
    return out


def classify(m, k, n, layout="normal", seeds=(0, 1)):
    """The candidates that match XLA on every element, over ``seeds``."""
    names = None
    for seed in seeds:
        rng = np.random.default_rng(seed)
        a, b = bf16_values(rng, (m, k)), bf16_values(rng, (k, n))
        want = xla_dot(a, b, layout)
        hits = set()
        for c in (1, 2, 4, 8):
            for kc in sorted({k, max(1, 32768 // n)}):
                if kc > k:
                    continue
                if np.array_equal(candidate(a, b, c, kc), want):
                    hits.add(("S" if c == 1 else f"T{c}")
                             + ("" if kc >= k else f"/{kc}"))
        names = hits if names is None else names & hits
    return sorted(names) or ["MIXED"]


def sweep(ms, ks, ns, layout):
    for m in ms:
        for k in ks:
            row = [f"{n}:{'|'.join(classify(m, k, n, layout))}" for n in ns]
            print(f"{layout} M={m} K={k}  " + " ".join(row), flush=True)


def order_name(chains, block, k):
    return ("S" if chains == 1 else f"T{chains}") + (
        "" if block >= k else f"/{block}")


def width_chains(n):
    """The M > 50 chains past one column tile by the last tile's width."""
    r = (n - 1) % 64 + 1
    return 1 if r > 48 else 2 if 16 < r <= 32 else 4


def check_point(m, k, n, layout):
    """(classification, the rule's order or "none", whether it misses)."""
    from repro_torch.models.layers import xla_cpu_dot_order
    got = classify(m, k, n, layout)
    rule = xla_cpu_dot_order(m, k, n, lhs_t=layout == "lhs_t",
                             rhs_t=layout == "rhs_t")
    if rule is None:
        past_tile = n > 64 and (layout == "rhs_t" or m > 50)
        return got, "none", past_tile and order_name(
            width_chains(n), k, k) in got
    name = order_name(*rule, k)
    return got, name, name not in got


def check(ms, ks, ns, layout):
    misses = 0
    for m in ms:
        for k in ks:
            row = []
            for n in ns:
                got, name, miss = check_point(m, k, n, layout)
                misses += miss
                row.append(f"{n}:{'|'.join(got)}={name}"
                           + ("!" if miss else ""))
            print(f"{layout} M={m} K={k}  " + " ".join(row), flush=True)
    print(f"{misses} misses")


def check_random(count, seed):
    rng = np.random.default_rng(seed)
    misses = 0
    for _ in range(count):
        layout = "rhs_t" if rng.random() < 0.4 else "normal"
        m = int(rng.integers(2, 100) if layout == "rhs_t"
                else rng.integers(51, 200))
        n, k = int(rng.integers(17, 1300)), int(rng.integers(3, 131))
        if k % 4 == 0 and rng.random() < 0.7:
            k += 1
        got, name, miss = check_point(m, k, n, layout)
        misses += miss
        print(f"{layout} M={m} K={k} N={n}  {'|'.join(got)}={name}"
              + ("!" if miss else ""), flush=True)
    print(f"{misses} misses")


def smoke_batch(cfg, b, s):
    """The input of a step on ``b`` x ``s`` positions: tokens, or an audio
    model's frames; a vision model's embeddings beside them."""
    batch = {}
    if cfg.audio is not None:
        batch["frames"] = jnp.zeros((b, s, cfg.audio.feat_dim), jnp.bfloat16)
    else:
        batch["tokens"] = jnp.zeros((b, s), jnp.int32)
    if cfg.vision is not None:
        batch["vision"] = jnp.zeros((b, cfg.vision.seq_len,
                                     cfg.vision.embed_dim), jnp.bfloat16)
    return batch


def hlo_dots(arch):
    """Every dot of the reference's compiled steps of ``arch``'s smoke
    config (haloc_axa residual adds), with its operands' shapes: the full
    forward, prefill, the train step on 2 x 32 tokens (forward, backward
    and update) and decode.  An encoder-only config (no decode) lists no
    decode step."""
    from repro.configs import get_smoke_config
    from repro.launch import steps
    from repro.models import transformer as T
    from repro.numerics.approx_ops import make_numerics
    from repro.optim.adamw import AdamWConfig
    cfg = get_smoke_config(arch).with_approx(
        make_numerics("haloc_axa", "residual"))
    params = jax.jit(T.init_params, static_argnums=1)(jax.random.key(1), cfg)
    runs = {
        "full": (jax.jit(lambda p, b: T.forward(p, cfg, b)[0]),
                 (params, smoke_batch(cfg, 4, 31))),
        "prefill": (jax.jit(steps.make_prefill_step(cfg, 32)),
                    (params, smoke_batch(cfg, 4, 20))),
    }
    batch = dict(smoke_batch(cfg, 2, 32),
                 labels=jnp.zeros((2, 32), jnp.int32))
    runs["train"] = (jax.jit(steps.make_train_step(cfg, AdamWConfig())),
                     (steps.init_state(jax.random.key(1), cfg,
                                       AdamWConfig()), batch))
    if cfg.causal:
        runs["decode"] = (jax.jit(steps.make_decode_step(cfg)),
                          (params, {"tokens": jnp.zeros((4, 1), jnp.int32)},
                           jnp.int32(20), T.init_cache(cfg, 4, 32)))
    dot = re.compile(r"(%\S+) = (f32\[[^\]]*\])\S* dot\((%[^,]+), "
                     r"(%[^)]+)\), (.*?)(, metadata|$)")
    for mode, (fn, args) in runs.items():
        text = fn.lower(*args).compile().as_text()
        shapes = dict(re.findall(r"(%\S+) = (\w+\[[^\]]*\])", text))
        print(f"== {arch} {mode}")
        for line in text.splitlines():
            hit = dot.search(line)
            if hit:
                out, shape, lhs, rhs, dims = hit.groups()[:5]
                print(f"  {shape} = dot({shapes.get(lhs)}, "
                      f"{shapes.get(rhs)}) {dims}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layout", choices=("normal", "lhs_t", "rhs_t"),
                    default="normal")
    ap.add_argument("--m", type=int, nargs="+", default=SMOKE_M)
    ap.add_argument("--k", type=int, nargs="+", default=SMOKE_K)
    ap.add_argument("--n", type=int, nargs="+", default=SMOKE_N)
    ap.add_argument("--check", action="store_true",
                    help="hold the port's xla_cpu_dot_order against each "
                         "point")
    ap.add_argument("--random", type=int, metavar="COUNT",
                    help="with --check: COUNT random shapes, not the grid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hlo", metavar="ARCH",
                    help="print the dots of ARCH's compiled smoke steps")
    args = ap.parse_args(argv)
    if args.hlo:
        hlo_dots(args.hlo)
        return
    print(f"jax {jax.__version__}, {os.cpu_count()} cores")
    if args.check and args.random:
        check_random(args.random, args.seed)
    elif args.check:
        check(args.m, args.k, args.n, args.layout)
    else:
        sweep(args.m, args.k, args.n, args.layout)


if __name__ == "__main__":
    main()
