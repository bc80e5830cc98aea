#!/usr/bin/env python3
"""Wall time of the Monte-Carlo error sweep on the card, for the
``repro_torch`` of one checkout.

    python3 tools/mc_times.py [--src DIR] [--label NAME] [--samples N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so running it on two checkouts in one chip call, in turns (A, B, B, A),
compares them on one card.  Times
``simulate_error_metrics_sweep(table1_specs(), n_samples=N)`` (the seven
Table-1 kinds at N=32, 10^7 samples by default), reference and lut
strategies: one untimed call, then the median and the spread of three.
Prints the card's name and power limit and one JSON line of the numbers,
the reports' MRED among them.  Needs a CUDA device.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--samples", type=int, default=10_000_000)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        sys.exit("tools/mc_times.py needs a CUDA device")
    from repro_torch.core import metrics
    from repro_torch.core.specs import table1_specs
    specs = list(table1_specs())
    dev = torch.device("cuda", 0)
    out = {"label": args.label, "src": args.src, "samples": args.samples}
    for strategy in ("reference", "lut"):
        def sweep():
            reps = metrics.simulate_error_metrics_sweep(
                specs, n_samples=args.samples, strategy=strategy,
                device=dev)
            torch.cuda.synchronize()
            return reps

        sweep()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            reps = sweep()
            times.append(time.perf_counter() - t0)
        times.sort()
        out[strategy] = {"ms": times[1] * 1e3,
                         "spread_ms": (times[-1] - times[0]) * 1e3,
                         "mred": {r.spec.kind: r.mred for r in reps}}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
