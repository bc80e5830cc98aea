"""Design-space exploration beyond the paper (the port of
``examples/adder_design_space.py``): sweep (m, k) for HALOC-AxA and map
the accuracy/energy Pareto frontier.  Every point is exact (closed-form
analytics, :mod:`repro_torch.ax.analytics`, its tables built and reduced
on the device).

    PYTHONPATH=src python -m repro_torch.examples.adder_design_space
    PYTHONPATH=src python -m repro_torch.examples.adder_design_space \\
        --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.ax import MAX_LUT_LSM_BITS
from repro_torch.core.hwcost import switching_energy_fj
from repro_torch.core.metrics import exact_error_metrics
from repro_torch.core.specs import AdderSpec, paper_spec
from repro_torch.examples._cli import add_device_args, backend_and_device

LSM_BITS = (6, 8, 10, 12)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    args = ap.parse_args(argv)
    _, dev = backend_and_device(args)

    print(f"{'m':>3s} {'k':>3s} {'MED':>10s} {'NMED':>11s} {'E fJ':>7s} "
          f"{'E/Eacc':>7s}")
    e_acc = switching_energy_fj(AdderSpec(kind="accurate"), device=dev)
    rows = []
    for m in LSM_BITS:   # MAX_LUT_LSM_BITS caps the exact engine
        assert m <= MAX_LUT_LSM_BITS
        for k in (0, m // 4, m // 2):
            if k > m - 2:
                continue
            spec = AdderSpec(kind="haloc_axa", n_bits=32, lsm_bits=m,
                             const_bits=k)
            rep = exact_error_metrics(spec, device=dev)
            e = switching_energy_fj(spec, device=dev)
            rows.append((m, k, rep.med, rep.nmed, e, e / e_acc))
            print(f"{m:3d} {k:3d} {rep.med:10.1f} {rep.nmed:11.3e} "
                  f"{e:7.2f} {e / e_acc:7.3f}")
    # Pareto: lowest energy at each accuracy level
    best_nmed = float("inf")
    frontier = []
    print("\nPareto frontier (energy ascending, NMED improving):")
    for m, k, med, nmed, e, rel in sorted(rows, key=lambda r: r[4]):
        if nmed < best_nmed:
            best_nmed = nmed
            frontier.append((m, k))
            print(f"  m={m:2d} k={k:2d}  E={e:.2f}fJ ({rel:.3f}x)  "
                  f"NMED={nmed:.3e}")
    p = paper_spec("haloc_axa")
    print(f"\npaper's point: m={p.lsm_bits}, k={p.const_bits}")
    return {"rows": rows, "frontier": frontier}


if __name__ == "__main__":
    main()
