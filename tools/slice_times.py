#!/usr/bin/env python3
"""Times of the redesigned kernels (``accumulate``, ``conv2d_mac``, the FFT
butterflies, ``mac_matmul``) and of the paths they carry, for the
``repro_torch`` of one checkout.

    python3 tools/slice_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``;
its kernels build into that checkout's ``build/``), so running it on two
checkouts in one chip call, in turns (A, B, B, A), compares them on one
card.  Measures, at the shapes of ``PERF.md`` §6 (haloc_axa n16m8k4,
reference form):

- ``accumulate`` on K=2 (2, 4, 1024, 1024), w = (2, -1), and on K=4
  (4, 4, 512, 512): CUDA-event medians of the wrapper (inputs rotated
  past the L2) and the kernel's device time from ``torch.profiler``;
- ``conv2d_mac`` with the conv3x3 kernel and truncated n8t3 on
  (4, 1024, 1024) random 8-bit images: the wrapper's event median (its
  range check waits for the card) and the kernel's device time;
- ``mac_matmul`` at 1024^3, bk 128, haloc_axa n32m10k5 with truncated
  n8t3 products: the event median (eight operand pairs rotated) and the
  kernel's device time a launch;
- the stage-mode megapixel chain (gaussian_blur -> sharpen ->
  downsample2x on ``synthetic_batch(4, 1024)`` on the card), the
  ``conv3x3`` workload on the host batch, ``reconstruct`` of
  ``synthetic_image(512)`` on the card at block 16, n32m10k5, and the
  ``fft_reconstruct`` workload on the host batch: wall medians, device
  busy, kernel launches per call and the FFT kernels' share (every kernel
  whose name holds ``butterfly``).

Device times come from ``torch.profiler``, which can lose events: a
kernel's time a launch is its total over its recorded launches.

Prints the card's name and power limit and one JSON line of the
numbers.  Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    """``chip_smoke.py`` of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_profile(torch, fn, calls=10):
    """(device us per call by kernel name, kernel launches per call) from
    ``torch.profiler`` over ``calls`` calls (both short when the profiler
    lost events; :func:`launch_us` is not)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return ({ev.key: ev.self_device_time_total / calls for ev in rows},
            sum(ev.count for ev in rows) / calls)


def kernel_us(by_kernel, name):
    return sum(us for key, us in by_kernel.items() if name in key)


def launch_us(torch, fn, name, calls=10):
    """Device us of one launch of the kernels whose name holds ``name``:
    their total over the launches the profiler recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and name in ev.key]
    n = sum(ev.count for ev in rows)
    return sum(ev.self_device_time_total for ev in rows) / n if n else 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("slice_times: needs a CUDA device")
    from repro_torch.ax.mul import MulSpec
    from repro_torch.core.specs import AdderSpec, paper_spec
    from repro_torch.image.pipeline import reconstruct, synthetic_image
    from repro_torch.imgproc import (PIPELINES, compile_pipeline,
                                     get_workload, synthetic_batch)
    from repro_torch.imgproc.workloads import CONV3X3_KERNEL
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import conv2d_mac as conv_k
    from repro_torch.kernels import mac_matmul as mac_k

    smoke = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    trunc = MulSpec("truncated", 8, 3)
    out = {"label": args.label, "src": args.src, "card": card}

    def ints(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32),
                               device=dev)

    cases = {
        "accumulate K=2": ([ints(0, 1 << 16, (2, 4, 1024, 1024))
                            for _ in range(4)], (2, -1)),
        "accumulate K=4": ([ints(0, 1 << 16, (4, 4, 512, 512))
                            for _ in range(4)], None)}
    for label, (stacks, ws) in cases.items():
        fns = [lambda t=t: acc_k.accumulate(t, spec, weights=ws)
               for t in stacks]
        by_kernel, _ = device_profile(torch, fns[0])
        out[label] = {"ms": smoke.time_launches(torch, fns, 40),
                      "kernel_us": kernel_us(by_kernel, "accumulate")}
    images = [ints(0, 256, (4, 1024, 1024)) for _ in range(4)]
    fns = [lambda q=q: conv_k.conv2d_mac(q, spec, trunc, CONV3X3_KERNEL)
           for q in images]
    by_kernel, _ = device_profile(torch, fns[0])
    out["conv2d_mac"] = {"wrapper_ms": smoke.time_launches(torch, fns, 40),
                         "kernel_us": kernel_us(by_kernel, "conv2d_mac")}

    spec32 = paper_spec("haloc_axa")
    gemms = [(ints(-128, 128, (1024, 1024)), ints(-128, 128, (1024, 1024)))
             for _ in range(8)]
    fns = [lambda a=a, b=b: mac_k.mac_matmul(a, b, spec32, trunc, bk=128)
           for a, b in gemms]
    out["mac_matmul"] = {"ms": smoke.time_launches(torch, fns, 20),
                         "launch_us": launch_us(torch, fns[0],
                                                "mac_matmul")}

    batch = synthetic_batch(4, 1024)
    gbatch = torch.as_tensor(batch, device=dev)
    gimg = torch.as_tensor(synthetic_image(512), device=dev)
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa")
    wl = get_workload("conv3x3")
    fft_wl = get_workload("fft_reconstruct")
    for label, fn, reps in (
            ("chain stage", lambda: pipe(gbatch), 20),
            ("conv3x3 workload", lambda: wl.run(batch, kind="haloc_axa"), 5),
            ("reconstruct 512", lambda: reconstruct(gimg, spec32), 20),
            ("fft_reconstruct workload",
             lambda: fft_wl.run(batch, kind="haloc_axa"), 5)):
        wall = smoke.time_wall(torch, fn, reps)
        by_kernel, launches = device_profile(torch, fn, calls=3)
        out[label] = {"wall_ms": wall * 1e3,
                      "busy_us": sum(by_kernel.values()),
                      "launches": launches,
                      "accumulate_us": kernel_us(by_kernel, "accumulate"),
                      "conv2d_mac_us": kernel_us(by_kernel, "conv2d_mac"),
                      "fft_us": kernel_us(by_kernel, "butterfly"),
                      "fft_launch_us": launch_us(torch, fn, "butterfly",
                                                 calls=3)}
    print(card)
    for key, val in out.items():
        if isinstance(val, dict):
            print(f"{args.label} {key}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in val.items()))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
