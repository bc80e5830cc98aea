"""Approximate 2-layer conv inference through the MAC engine (the port of
``examples/approx_mac.py``).

A miniature inference pipeline -- smooth (3x3, shift-normalised) then
sharpen (3x3 with negative taps) -- where each layer carries its own
(adder, multiplier) configuration via ``MacSpec``.  Products route
through the approximate multiplier, accumulations through the
approximate adder (``engine.conv2d``: one ``conv2d_mac`` launch a layer
on the card); the script reports the PSNR and pixel agreement of every
mixed-precision configuration against the exact MAC pipeline.

    PYTHONPATH=src python -m repro_torch.examples.approx_mac [--size 256]
    PYTHONPATH=src python -m repro_torch.examples.approx_mac --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.ax import make_engine
from repro_torch.ax.mul import MacSpec, MulSpec
from repro_torch.core.specs import AdderSpec
from repro_torch.examples._cli import add_device_args, backend_and_device
from repro_torch.image.pipeline import synthetic_image
from repro_torch.image.quality import psnr
from repro_torch.numerics.fixed_point import FixedPointFormat

# 3x3 taps: smoothing (sum 16 -> shift=4) then sharpening (sum 1).
SMOOTH = ((1, 2, 1), (2, 4, 2), (1, 2, 1))
SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))

FMT16 = FixedPointFormat(16, 0)

# Two accumulator aggressiveness levels (both N=16 haloc_axa).  The
# smoothing layer re-normalises by >>4, so its accumulation errors are
# attenuated 16x; the sharpening layer emits raw sums (shift=0), so
# every LSB of adder error lands in the output -- it needs the mild one.
AD_MILD = AdderSpec(kind="haloc_axa", n_bits=16, lsm_bits=4, const_bits=2)
AD_AGGR = AdderSpec(kind="haloc_axa", n_bits=16, lsm_bits=8, const_bits=4)
EXACT = MacSpec(AdderSpec(kind="accurate", n_bits=16),
                MulSpec("accurate", 8))


def mac(adder: AdderSpec, kind: str, *knobs) -> MacSpec:
    return MacSpec(adder, MulSpec(kind, 8, *knobs))


#: Per-layer (layer-1 MacSpec, layer-2 MacSpec) menu, from lossless to
#: aggressive -- including the swapped pair showing which layer gets the
#: aggressive config is what matters.
CONFIGS = [
    ("exact / exact", EXACT, EXACT),
    ("mild+t2 / exact", mac(AD_MILD, "truncated", 2), EXACT),
    ("mild+t2 / mild+t2",
     mac(AD_MILD, "truncated", 2), mac(AD_MILD, "truncated", 2)),
    ("aggr+t6 / mild+t2",
     mac(AD_AGGR, "truncated", 6), mac(AD_MILD, "truncated", 2)),
    ("mild+t2 / aggr+t6  (swapped)",
     mac(AD_MILD, "truncated", 2), mac(AD_AGGR, "truncated", 6)),
    ("aggr+bam(4,2) / mild+mitchell",
     mac(AD_AGGR, "broken_array", 4, 2), mac(AD_MILD, "mitchell")),
]


def infer(img: np.ndarray, mac1: MacSpec, mac2: MacSpec,
          backend: str = "cuda", device=None) -> np.ndarray:
    """Two conv layers, each on its own MAC engine."""
    l1 = make_engine(mac1, fmt=FMT16, backend=backend, device=device)
    l2 = make_engine(mac2, fmt=FMT16, backend=backend, device=device)
    q = img.astype(np.int32)
    h1 = l1.conv2d(q, SMOOTH, shift=4).cpu().numpy()
    h1 = np.clip(h1, 0, 255).astype(np.int32)          # requant + ReLU
    h2 = l2.conv2d(h1, SHARPEN, shift=0).cpu().numpy()
    return np.clip(h2, 0, 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args(argv)
    backend, dev = backend_and_device(args)

    img = synthetic_image(args.size)
    golden = infer(img, EXACT, EXACT, backend=backend, device=dev)

    print(f"2-layer conv inference, {args.size}x{args.size}, backend="
          f"{backend} on {dev}")
    print(f"{'layer1 / layer2':30s} {'PSNR':>8s} {'agree%':>7s} "
          f"{'mean|d|':>8s}")
    rows, outputs = {}, {}
    for name, mac1, mac2 in CONFIGS:
        out = infer(img, mac1, mac2, backend=backend, device=dev)
        d = out.astype(np.int64) - golden.astype(np.int64)
        p = psnr(golden, out)
        agree = 100.0 * float(np.mean(np.abs(d) <= 1))
        rows[name] = (p, agree, float(np.abs(d).mean()))
        outputs[name] = out
        print(f"{name:30s} {p:8.2f} {agree:7.2f} "
              f"{float(np.abs(d).mean()):8.3f}")
    print("\nPSNR is vs the exact-MAC pipeline; agree% counts pixels "
          "within +-1 LSB.")
    return {"rows": rows, "outputs": outputs}


if __name__ == "__main__":
    main()
