#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one ``nvcc`` per source, all at once);
3. kernels: each kernel against its plain PyTorch version on the card,
   exact (``torch.equal``), every registered adder kind, reference and
   fused forms, at the main path's shapes and on edge shapes;
4. the slice at full size, ``synthetic_batch(4, 1024)``: both stock
   pipelines x both requant modes x the seven Table-1 kinds through
   ``compile_pipeline``, the eight operators, ``engine.add_signed``,
   ``compile_tiled`` at (256, 256), and ``run_corpus(backend="cuda")``.
   The kernels' launch counters are set to 0 just before and read just
   after; every kernel must have launched.  Every uint8 output must
   equal the port's CPU path on the same batch, and tiled must equal
   untiled.  The corpus table of the four images is range-checked;
   ``run_corpus`` on the first image must give every (kind, workload)
   row of the CPU path's ``run_corpus`` on it, PSNR and SSIM equal;
5. times: each kernel at the main path's shapes (CUDA events, queued
   behind a sleep so host overhead is excluded, inputs rotated so they
   do not sit in the 50 MB L2), its plain version's time, and its bound
   (the larger of its bytes over 3.35 TB/s and the least int32
   operations its function needs over the card's int32 rate);
   then the megapixel chain's MPix/s, and a ``torch.profiler`` breakdown
   of the stage-mode chain by kernel with the device's idle share.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
run from a directory without ``src/repro_torch``, it exits non-zero and
prints no result.
"""

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM device-memory rate (bytes/s), from the data sheet.
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per SM on Hopper (an SM issues 64 INT32 operations a clock).
INT32_LANES_PER_SM = 64
#: The least integer operations of the timed functions, counted from the
#: C source of csrc/adders.cuh, one per operator on data, with every
#: constant (the masks) hoisted out of the per-element work.  One
#: haloc_axa add mod 2^N: the fused form haloc_axa_add_fast, which is
#: bit-identical to the reference form the kernels are timed in, has 16,
#: plus the N-bit mask.  Three-input instructions (LOP3, IADD3) could
#: fuse some further, so the operations bound may be lower still.
OPS_PER_ADD = 17
#: One tap's N-bit mask; one exact scale by a weight other than 1
#: (multiply and mask; a weight of 1 passes the term through); a
#: stage's sign extension; its rounding shift (when it has one).
OPS_PER_MASK, OPS_PER_SCALE, OPS_SIGN_EXTEND, OPS_ROUND_SHIFT = 1, 2, 2, 2

FULL_SIZE = 1024
N_IMAGES = 4


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi(fields):
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase 3 --

def check_kernels(torch, np, dev, errs):
    """Every kernel against its plain version on the card, exact."""
    from repro_torch.ax import FilterStage
    from repro_torch.core import specs
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import conv_chain as chain_k

    rng = np.random.default_rng(0)

    def rand_containers(shape, n_bits):
        u = rng.integers(0, 1 << n_bits, shape, dtype=np.uint64)
        return torch.as_tensor(u.astype(np.uint32).view(np.int32),
                               device=dev)

    def compare(name, got, want, what):
        d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        errs[name] = max(errs[name], d)
        check(got.shape == want.shape and torch.equal(got, want),
              f"{name} kernel != plain version on {what} (max |d| {d})")

    def spec(kind, n_bits):
        m, k = (8, 4) if n_bits == 16 else (10, 5)
        return specs.AdderSpec(kind, n_bits, m, k)

    t0 = time.perf_counter()
    kinds = specs.ALL_KINDS
    # approx_add: every kind x both forms on a 4096 x 4096 pair at N=16
    # and N=32, then every valid (m, k) at N=8 exhaustively.
    for n_bits in (16, 32):
        a = rand_containers((4096, 4096), n_bits)
        b = rand_containers((4096, 4096), n_bits)
        for kind in kinds:
            for fast in (False, True):
                s = spec(kind, n_bits)
                compare("approx_add", add_k.approx_add(a, b, s, fast=fast),
                        add_k.approx_add_plain(a, b, s, fast),
                        f"{s.short_name} fast={fast} 4096x4096")
    a8, b8 = torch.meshgrid(torch.arange(256, device=dev, dtype=torch.int32),
                            torch.arange(256, device=dev, dtype=torch.int32),
                            indexing="ij")
    a8, b8 = a8.contiguous(), b8.contiguous()
    cells = 0
    for kind in kinds:
        for m in range(1, 9):
            for k in range(0, m + 1):
                try:
                    s = specs.AdderSpec(kind, 8, m, k)
                except ValueError:
                    continue
                for fast in (False, True):
                    compare("approx_add", add_k.approx_add(a8, b8, s,
                                                           fast=fast),
                            add_k.approx_add_plain(a8, b8, s, fast),
                            f"{s.short_name} fast={fast} exhaustive")
                cells += 1
    log(f"  approx_add: {len(kinds)} kinds x 2 forms at N=16/32 on "
        f"4096x4096, {cells} (kind, m, k) cells exhaustive at N=8: equal")

    # accumulate at the main path's shapes.
    cases = [((2, N_IMAGES, 1024, 1024), (2, -1)),
             ((2, N_IMAGES, 1024, 1024), (32, 32)),
             ((2, N_IMAGES, 1024, 1024), (1, 1)),
             ((4, N_IMAGES, 512, 512), (1, 1, 1, 1)),
             ((9, 3, 37, 41), (1, 2, 1, -2, 4, -2, 1, 2, -1))]
    for shape, ws in cases:
        terms = rand_containers(shape, 16)
        for kind in kinds:
            for fast in (False, True):
                s = spec(kind, 16)
                compare("accumulate",
                        acc_k.accumulate(terms, s, weights=ws, fast=fast),
                        acc_k.accumulate_plain(terms, s, ws, fast),
                        f"{s.short_name} fast={fast} {shape} w={ws}")
    log(f"  accumulate: {len(kinds)} kinds x 2 forms x {len(cases)} "
        f"shape/weight cases: equal")

    # filter_chain: the operators' chains at full size, then edge shapes.
    chains = {
        "box": (FilterStage(-1, (-1, 0, 1), (1, 1, 1)),
                FilterStage(-2, (-1, 0, 1), (1, 1, 1))),
        "gauss": (FilterStage(-1, (-1, 0, 1), (1, 2, 1), 2),
                  FilterStage(-2, (-1, 0, 1), (1, 2, 1), 2)),
        "sobel_gx": (FilterStage(-2, (-1, 0, 1), (1, 2, 1)),
                     FilterStage(-1, (1, -1), (1, -1))),
        "sobel_gy": (FilterStage(-1, (-1, 0, 1), (1, 2, 1)),
                     FilterStage(-2, (1, -1), (1, -1))),
    }
    edge_chains = dict(chains)
    edge_chains["same_axis"] = (FilterStage(-1, (-2, 0, 3), (1, -3, 2), 1),
                                FilterStage(-1, (-1, 1), (2, 1)),
                                FilterStage(-2, (0, 2), (1, 1), 1))
    edge_chains["wide"] = (FilterStage(-2, tuple(range(-4, 5)),
                                       (1, 2, 3, 4, 5, 4, 3, 2, 1), 3),)
    q = torch.as_tensor(rng.integers(-2040, 2040, (N_IMAGES, 1024, 1024))
                        .astype(np.int32), device=dev)
    for name, stages in chains.items():
        for kind in kinds:
            for fast in (False, True):
                s = spec(kind, 16)
                compare("filter_chain",
                        chain_k.filter_chain(q, s, stages, fast=fast),
                        chain_k.filter_chain_plain(q, s, stages, fast),
                        f"{name} {s.short_name} fast={fast} full size")
    edge_shapes = [(1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (2, 37, 70),
                   (3, 1000, 1030), (1, 33, 65)]
    for shape in edge_shapes:
        qe = torch.as_tensor(rng.integers(-1500, 1500, shape)
                             .astype(np.int32), device=dev)
        for name, stages in edge_chains.items():
            for kind in ("haloc_axa", "eta", "loa"):
                s = spec(kind, 16)
                compare("filter_chain",
                        chain_k.filter_chain(qe, s, stages, fast=True),
                        chain_k.filter_chain_plain(qe, s, stages, True),
                        f"{name} {s.short_name} {shape}")
    torch.cuda.synchronize()
    log(f"  filter_chain: 4 chains x {len(kinds)} kinds x 2 forms at "
        f"{tuple(q.shape)}, {len(edge_chains)} chains x "
        f"{len(edge_shapes)} edge shapes: equal")
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- phase 4 --

def run_main_path(torch, np, batch, backend=None, device=None, corpus=True):
    """The slice through the entry points a user calls; returns the
    outputs (tensors on the engine's device) and the corpus rows (None
    without ``corpus``)."""
    from repro_torch.core.specs import TABLE1_KINDS
    from repro_torch.imgproc import (OPERATORS, PIPELINES, compile_pipeline,
                                     compile_tiled, make_image_engine,
                                     run_corpus)
    from repro_torch.numerics.fixed_point import FixedPointFormat
    from repro_torch.ax import make_engine

    where = dict(backend=backend, device=device)
    outs = {}
    for pname, stages in PIPELINES.items():
        for requant in ("stage", "fused"):
            for kind in TABLE1_KINDS:
                pipe = compile_pipeline(stages, kind=kind, requant=requant,
                                        **where)
                outs[("pipe", pname, requant, kind)] = pipe(batch)
    ax = make_image_engine("haloc_axa", **where)
    x = ax.tensor(batch)
    pair = torch.roll(x, 1, dims=0)
    for name, op in sorted(OPERATORS.items()):
        args = (x, pair) if op.n_inputs == 2 else (x,)
        outs[("op", name)] = op.fn(*args, ax)
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa", requant="fused", **where)
    outs[("tiled",)] = compile_tiled(pipe, tuple(x.shape), (256, 256))(x)
    eng = make_engine("haloc_axa", fmt=FixedPointFormat(16, 6), **where)
    outs[("add_signed",)] = eng.add_signed(x.to(torch.int32) << 6,
                                           pair.to(torch.int32) << 6)
    rows = run_corpus(batch=np.asarray(batch.cpu()), **where) \
        if corpus else None
    return outs, rows


def counters():
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import conv_chain as chain_k
    return {"approx_add": add_k.approx_add, "accumulate": acc_k.accumulate,
            "filter_chain": chain_k.filter_chain}


def check_outputs(torch, np, outs, cpu_outs, rows, size):
    """GPU outputs equal the CPU path's; tiled equals untiled; the corpus
    scores are well formed and the accurate adder is lossless on the
    exact operators."""
    for key, got in outs.items():
        want = cpu_outs[key]
        check(got.device.type == "cuda", f"{key} did not run on the card")
        check(tuple(got.shape) == tuple(want.shape)
              and torch.equal(got.cpu(), want),
              f"{key}: the card's output differs from the CPU path")
    check(torch.equal(outs[("tiled",)],
                      outs[("pipe", "pipe_blur_sharpen_down", "fused",
                             "haloc_axa")]),
          "tiled (256, 256) != untiled")
    half = size // 2
    check(tuple(outs[("tiled",)].shape) == (N_IMAGES, half, half),
          "megapixel chain output shape")
    for r in rows:
        check(np.isfinite(r.ssim) and 0.0 < r.ssim <= 1.0 + 1e-12,
              f"ssim out of range: {r}")
        check(np.isfinite(r.psnr) or r.psnr == float("inf"), f"psnr: {r}")
    for r in rows:
        if r.kind == "accurate" and r.workload in ("add", "blend",
                                                   "brightness"):
            check(r.psnr == float("inf"),
                  f"accurate adder not lossless on {r.workload}: {r.psnr}")


def check_corpus(np, head):
    """run_corpus on the card equals run_corpus on the CPU path, row for
    row, on the images ``head`` (the scores are the same numpy code on
    uint8 outputs that must be identical, so they must be equal)."""
    from repro_torch.imgproc import run_corpus
    card = run_corpus(batch=head)
    cpu = run_corpus(batch=head, backend="torch", device="cpu")
    check(len(card) == len(cpu) > 0, "run_corpus row counts differ")
    for g, c in zip(card, cpu):
        same = (g.kind, g.workload) == (c.kind, c.workload) and all(
            x == y or (np.isnan(x) and np.isnan(y))
            for x, y in ((g.psnr, c.psnr), (g.ssim, c.ssim)))
        check(same, f"run_corpus on the card != CPU path: {g} vs {c}")


# ------------------------------------------------------------- phase 5 --

def fold_ops(weights):
    """Least operations of one weighted fold of len(weights) terms."""
    return (OPS_PER_SCALE * sum(w != 1 for w in weights)
            + OPS_PER_ADD * (len(weights) - 1))


def chain_ops(stages):
    """Least operations per pixel of a filter chain."""
    return sum(OPS_PER_MASK * len(st.weights) + fold_ops(st.weights)
               + OPS_SIGN_EXTEND + (OPS_ROUND_SHIFT if st.shift else 0)
               for st in stages)


def time_launches(torch, fns, reps):
    """Median device milliseconds of one call: ``reps`` calls queued
    behind a sleep (so the host's launch overhead is hidden), each
    bracketed by CUDA events; ``fns`` rotates the inputs."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for i in range(reps):
        fns[i % len(fns)]()
        events[i + 1].record()
    torch.cuda.synchronize()
    ts = sorted(events[i].elapsed_time(events[i + 1]) for i in range(reps))
    return ts[len(ts) // 2]


def measure(torch, np, dev, launches, errs):
    from repro_torch.ax import FilterStage
    from repro_torch.core.specs import AdderSpec
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import conv_chain as chain_k

    props = torch.cuda.get_device_properties(dev)
    clock = nvidia_smi("clocks.max.sm").split()[0]
    int32_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM \
        * float(clock) * 1e6
    log(f"  int32 rate for the bound: {props.multi_processor_count} SMs x "
        f"{INT32_LANES_PER_SM} lanes x {clock} MHz = "
        f"{int32_ops_per_s / 1e12:.2f} Tops/s")
    rng = np.random.default_rng(1)
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    shape = (N_IMAGES, FULL_SIZE, FULL_SIZE)
    n = N_IMAGES * FULL_SIZE * FULL_SIZE
    copies = 4  # 4 input sets of >= 33 MB each: more than the L2 holds

    def cont(s):
        return torch.as_tensor(rng.integers(0, 1 << 16, s).astype(np.int32),
                               device=dev)

    adds = [(cont(shape), cont(shape)) for _ in range(copies)]
    stacks = [cont((2,) + shape) for _ in range(copies)]
    planes = [torch.as_tensor(rng.integers(-2040, 2040, shape)
                              .astype(np.int32), device=dev)
              for _ in range(copies)]
    gauss = (FilterStage(-1, (-1, 0, 1), (1, 2, 1), 2),
             FilterStage(-2, (-1, 0, 1), (1, 2, 1), 2))
    ws = (2, -1)
    work = {
        "approx_add": dict(
            source="src/repro_torch/csrc/approx_add.cu",
            replaces="src/repro/kernels/approx_add.py:35",
            what=f"haloc_axa N=16 reference, int32 pair {shape}",
            kernel=[lambda a=a, b=b: add_k.approx_add(a, b, spec)
                    for a, b in adds],
            plain=[lambda a=a, b=b: add_k.approx_add_plain(a, b, spec)
                   for a, b in adds],
            bytes=3 * 4 * n, ops=OPS_PER_ADD * n),
        "accumulate": dict(
            source="src/repro_torch/csrc/accumulate.cu",
            replaces="src/repro/kernels/accumulate.py:51",
            what=f"haloc_axa N=16 reference, K=2 w={ws}, int32 "
                 f"{(2,) + shape}",
            kernel=[lambda t=t: acc_k.accumulate(t, spec, weights=ws)
                    for t in stacks],
            plain=[lambda t=t: acc_k.accumulate_plain(t, spec, ws)
                   for t in stacks],
            bytes=3 * 4 * n, ops=fold_ops(ws) * n),
        "filter_chain": dict(
            source="src/repro_torch/csrc/conv_chain.cu",
            replaces="src/repro/kernels/conv_chain.py:57",
            what=f"haloc_axa N=16 reference, gaussian chain, int32 {shape}",
            kernel=[lambda q=q: chain_k.filter_chain(q, spec, gauss)
                    for q in planes],
            plain=[lambda q=q: chain_k.filter_chain_plain(q, spec, gauss)
                   for q in planes],
            bytes=2 * 4 * n, ops=chain_ops(gauss) * n),
    }
    entries = []
    for name, w in work.items():
        ms = time_launches(torch, w["kernel"], 40)
        plain_ms = time_launches(torch, w["plain"], 20)
        bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = w["ops"] / int32_ops_per_s * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  {name:12s} {w['what']}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
            f"{bytes_ms:.4f} ms, ops {ops_ms:.4f} ms at {w['ops'] // n} "
            f"per element) = "
            f"{bound_ms / ms * 100:.1f}% of bound")
        entries.append({
            "name": name, "route": "cuda", "source": w["source"],
            "replaces": w["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": w["what"]})
    return entries


def time_chain(torch, gbatch):
    """Wall-clock MPix/s of the megapixel chain (host overhead included,
    output left on the card), median of 10 calls."""
    from repro_torch.imgproc import PIPELINES, compile_pipeline
    out = {}
    for requant in ("stage", "fused"):
        pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                                kind="haloc_axa", requant=requant)
        pipe(gbatch)
        torch.cuda.synchronize()
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            pipe(gbatch)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        sec = sorted(ts)[len(ts) // 2]
        out[requant] = (sec, gbatch.numel() / sec / 1e6)
    return out


def profile_chain(torch, gbatch, wall_s, calls=5):
    """Device time by kernel for the stage-mode megapixel chain, from
    ``torch.profiler`` over ``calls`` calls (kernel events only, so no
    kernel is counted twice through the op that launched it), and the
    device's idle share against the chain's unprofiled wall time
    ``wall_s`` (the profiler's own overhead stretches its window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.imgproc import PIPELINES, compile_pipeline
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa")
    pipe(gbatch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            pipe(gbatch)
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    busy_us = sum(r[0] for r in rows) / calls
    log(f"  profile of {calls} stage-mode chain calls: device busy "
        f"{busy_us:.1f} us per call in {sum(r[1] for r in rows) // calls} "
        f"kernel launches; idle share against the unprofiled "
        f"{wall_s * 1e6:.1f} us per call: {1 - busy_us / (wall_s * 1e6):.3f}")
    for dev_us, count, key in rows[:10]:
        log(f"    {dev_us / calls:9.1f} us/call  {count // calls:3d} "
            f"launches/call  {key[:90]}")


def main():
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    log(f"phase 1: device {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi name, power.limit: {card}")

    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"phase 2: built {len(_build.SOURCES)} kernels in {secs:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 3: kernels against their plain versions on the card")
    errs = {"approx_add": 0, "accumulate": 0, "filter_chain": 0}
    check_kernels(torch, np, dev, errs)

    log("phase 4: the slice at full size")
    from repro_torch.imgproc import (PIPELINES, compile_pipeline,
                                     format_table, synthetic_batch)
    batch = synthetic_batch(N_IMAGES, FULL_SIZE)
    gbatch = torch.as_tensor(batch, device=dev)
    counts = counters()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs, rows = run_main_path(torch, np, gbatch)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counts.items()}
    log(f"  main path on the card: {time.perf_counter() - t0:.1f} s, "
        f"launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    t0 = time.perf_counter()
    cpu_outs, _ = run_main_path(torch, np, torch.as_tensor(batch),
                                backend="torch", device="cpu",
                                corpus=False)
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_outputs(torch, np, outs, cpu_outs, rows, FULL_SIZE)
    log(f"  {len(outs)} outputs equal the CPU path; tiled == untiled")
    t0 = time.perf_counter()
    check_corpus(np, batch[:1])
    log(f"  run_corpus on image 0: every (kind, workload) PSNR and SSIM "
        f"of the card equal the CPU path's ({time.perf_counter() - t0:.1f}"
        f" s)")
    log("  run_corpus(backend='cuda') on synthetic_batch(4, 1024), "
        "PSNR dB / SSIM:")
    for line in format_table(rows).splitlines():
        log("    " + line)
    for fn in counts.values():
        fn.launches = 0
    compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                     kind="haloc_axa")(gbatch)
    per_call = {name: fn.launches for name, fn in counts.items()}
    log(f"  launches per stage-mode megapixel chain call: {per_call}")

    log("phase 5: times (CUDA events, median)")
    entries = measure(torch, np, dev, launches, errs)
    chain = time_chain(torch, gbatch)
    for requant, (sec, mpix) in chain.items():
        log(f"  megapixel chain gaussian_blur -> sharpen -> downsample2x, "
            f"haloc_axa, requant={requant}: {sec * 1e3:.3f} ms per "
            f"{tuple(gbatch.shape)} batch = {mpix:.1f} MPix/s")
    profile_chain(torch, gbatch, chain["stage"][0])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
