"""Hold the port's sum of squares (``repro_torch.optim.adamw.
xla_sum_of_squares``) against XLA:CPU's, bit for bit.

The reference takes ``jnp.sum(g.astype(f32) ** 2)`` of each leaf inside
its jitted AdamW update (``repro.optim.adamw.global_norm``).  XLA:CPU
splits a leaf with a dim longer than 32 into windows of 32 (reduce-window
passes, the squares rounded first) and reduces a short leaf in one fusion
(each square an FMA into the running sum); LLVM then vectorizes some of
those reductions, over the next-to-last dim when the last is 2-8 long (a
pass's window, or the last array).  This script runs the jitted
reference norm of one leaf of each shape and the port's, and prints each
shape's verdict: ``=`` equal, ``!`` differs, ``v`` differs where LLVM
vectorizes (not followed, ROADMAP Queue C 20).  It exits 1 if a shape
outside that class differs.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_reduce_order.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_reduce_order.py \\
        --shapes 16x40 40 3x5x7 512x1536 --trials 4

The order depends on the jax/XLA build and the host (read with jax 0.9.0
on x86-64 with AVX-512).
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.optim.adamw import global_norm as ref_norm  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402

SHAPES = ("1", "7", "32", "33", "40", "100", "1000", "4097", "3x5x7",
          "16x40", "5x32", "31x31", "64x64", "33x65", "128x96", "300x7",
          "1000x40", "512x1536", "4x33x65", "40x33x65", "2x256x64",
          "3x128x100", "32768x64")


def _vector_loop(dims) -> bool:
    dims = [n for n in dims if n > 1]
    return len(dims) >= 2 and 2 <= dims[-1] <= 8 and (
        dims[-2] in (2, 4, 8) or 16 <= dims[-2] <= 32)


def vectorized(shape) -> bool:
    """Whether a reduction of the leaf is one LLVM may vectorize: a
    window pass's window, or the last (windowed or short) array, whose
    last dim is 2-8 long and its next 2, 4, 8 or 16-32."""
    w = 32
    dims = list(shape)
    while max(dims) > w:
        if _vector_loop([min(n, w) for n in dims]):
            return True
        dims = [-(-n // w) if n > w else 1 for n in dims]
    return _vector_loop(dims)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=SHAPES)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    fn = jax.jit(ref_norm)
    bad = 0
    for text in args.shapes:
        shape = tuple(int(v) for v in text.split("x"))
        ok = True
        for _ in range(args.trials):
            g = (rng.standard_normal(shape) * rng.uniform(0.1, 10)).astype(
                np.float32)
            want = float(fn({"g": jnp.asarray(g)}))
            ok &= float(global_norm({"g": torch.tensor(g)})) == want
        mark = "=" if ok else ("v" if vectorized(shape) else "!")
        bad += mark == "!"
        print(f"{mark} {text}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
