"""Quickstart: the paper's adder in a few lines (the port of
``examples/quickstart.py``), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The full-width adds (``add_full``) and the error analysis run the
``"torch"`` backend on the chosen device (the ``"cuda"`` backend has no
full-width add); the residual add of step 5 runs the ``approx_add``
kernel on the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.ax import available_backends, make_engine
from repro_torch.core.hwcost import report
from repro_torch.core.metrics import simulate_error_metrics, summarize
from repro_torch.core.specs import paper_spec
from repro_torch.examples._cli import add_device_args, backend_and_device
from repro_torch.numerics.fixed_point import FixedPointFormat

KINDS = ("loa", "herloa", "m_herloa", "haloc_axa")
HW_KINDS = ("accurate", "herloa", "haloc_axa")
N_SAMPLES = 200_000


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    args = ap.parse_args(argv)
    backend, dev = backend_and_device(args)

    # 1. the spec-first engine: one handle per (adder, format, backend).
    #    paper's adder: 32-bit, 10-bit approximate LSM, 5 constant-one bits.
    spec = paper_spec("haloc_axa")
    ax = make_engine(spec, backend="torch", device=dev)
    a, b = np.uint64(53_000), np.uint64(12_345)
    total = int(ax.add_full(np.array([a]), np.array([b]))[0])
    print(f"HALOC-AxA: {int(a)} + {int(b)} = {total} (exact {int(a + b)})")
    print(f"backends on this host: {available_backends()}")

    # 2. error metrics vs the baselines (paper Table I, right half)
    reports = [simulate_error_metrics(paper_spec(k), n_samples=N_SAMPLES,
                                      device=dev) for k in KINDS]
    print()
    print(summarize(reports))

    # 3. hardware cost (paper Table I, left half)
    print()
    hw = {}
    for k in HW_KINDS:
        r = report(paper_spec(k), device=dev)
        hw[k] = (r.transistors, r.energy_fj, r.delay_ns)
        print(f"{k:10s} {r.transistors} transistors, "
              f"{r.energy_fj:.1f} fJ/op, {r.delay_ns:.2f} ns")

    # 4. vectorized over tensors (the form the LM integration uses)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
    full = ax.add_full(x, y).cpu().numpy()
    ed = np.abs(full - (x + y).astype(np.int64))
    print(f"\nbatch of 8 adds, error distances: {ed.tolist()} (all < 2^11)")

    # 5. the model path: a 16-bit fixed-point engine with the fused
    #    implementation, trainable through the straight-through estimator
    #    (the approx_add kernel on the card).
    lm = make_engine("haloc_axa", fmt=FixedPointFormat(16, 8),
                     backend=backend, fast=True, device=dev)
    xs = torch.linspace(-1.0, 1.0, 8, device=dev)
    ys = torch.linspace(1.0, -1.0, 8, device=dev)
    res = lm.residual_add(xs, ys).cpu()
    print(f"\nresidual_add (float STE path): "
          f"{np.asarray(res).round(3).tolist()}")
    return {"add_full": total, "reports": reports, "hw": hw,
            "error_distances": ed.tolist(), "residual_inputs": (
                xs.cpu().numpy(), ys.cpu().numpy()),
            "residual_add": res.numpy()}


if __name__ == "__main__":
    main()
