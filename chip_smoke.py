#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one ``nvcc`` per source, all at once); each source's
   nvcc seconds and its kernels' ``-Xptxas -v`` in sum (registers, and
   any stack frame or spills: none allowed in ``accumulate``,
   ``conv2d_mac``, ``butterfly`` and ``mac_matmul``);
3. kernels: each kernel against its plain PyTorch version on the card,
   exact (``torch.equal``), every registered adder kind, reference and
   fused forms, at the main path's shapes and on edge shapes
   (``accumulate``: its K = 2 and K = 4 instances and the general one,
   16-byte and one-element routes, an unaligned stack, and its signed
   entry on scaled_add's planes and downsample2x's strided phases;
   ``filter_chain``: both of its routes, the operators' chains on the
   sep2 route and the ``same_axis`` and ``wide`` chains on the general
   one, on 1 x 1 and 1 x 7 planes and planes whose W is not a multiple
   of 4);
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
   ``scaled_add`` and ``accumulate_signed`` must run one kernel each
   (``torch.profiler``);
5. times: each kernel at the main path's shapes (CUDA events, queued
   behind a sleep so host overhead is excluded, inputs rotated so they
   do not sit in the 50 MB L2), its plain version's time, and its bound
   (the larger of its bytes over 3.35 TB/s and the fewest int32
   instructions known for its function, LOP3 and IADD3 counting one,
   over the card's int32 rate);
   ``accumulate`` at K = 4 and its signed entry on sharpen's planes and
   downsample2x's phases, beside the composition that entry replaced;
   ``filter_chain``'s fused form, its vertical-first sobel_gx and its
   general route (the gaussian, and same_axis) on the same planes, each
   checked against its plain version first; then the megapixel
   chain's MPix/s, and a ``torch.profiler`` breakdown of the stage-mode
   chain by kernel with the device's idle share.

The Fig-5 FFT and lut slice adds to phases 3-5:

3b. ``butterfly`` against its plain version at every stage shape of the
   512 x 512 reconstruction (block 16 and whole image), full-range and
   +-2^24 values, every kind, both forms, forward and inverse, at N=32
   and N=16; ``fft_axis`` (every stage of an axis in one launch) against
   the per-stage path (``butterfly`` chained) and its plain version: the
   last axis at n = 2 ... 4096, the rows and columns of 512^2 whole and
   in block-16 tiles read in place and of 4 x 1024^2 in tiles, every
   kind, both forms, forward and inverse, full-range, in place; and
   ``fft_fixed`` at n = 8192 through the per-stage route; ``lut_add``
   against its plain version and the ``approx_add`` kernel on 4096 x
   4096 at n16m8k4 and n32m10k5, and exhaustively at N=8 for every valid
   (m, k);
4b. the slice's own path, with the counts set to 0 just before and read
   just after: ``reconstruct(synthetic_image(512), paper_spec(kind))``
   for the seven Table-1 kinds (block 16), once at block 0 and once at
   N=16 (the six-add route), ``fft_fixed`` on a (4, 8192) signal (the
   per-stage route), ``run_corpus(include_fft=True,
   workloads=("fft_reconstruct",))`` on the 4 x 1024 x 1024 batch, and
   ``strategy="lut"`` adds through ``engine.add_signed`` (N=16) and
   ``engine.add`` (N=32).  Every output must equal the port's CPU path;
   the paper's quality ordering must hold on ``synthetic_image(128)``,
   reconstructed on the card (the size ``tests/test_image.py`` asserts
   it at); one reconstruct at 512, block 16, must be four ``fft_axis``
   launches by the counters and at most 16 kernels by the profiler;
5b. the kernels' times and bounds, ``fft_axis`` on every axis of the
   path with its device time, ``lut_add`` beside ``approx_add`` on the
   same inputs, and the wall time, launches, busy and idle time and the
   FFT kernels / glue split of ``reconstruct`` and of the
   ``fft_reconstruct`` workload.

The MAC slice adds to phases 3-5:

3c. ``mul`` against its plain version for every multiplier kind in all
   three forms at the path's (4, 1024, 1024) shape and exhaustively at
   N=8 (and at N=10, the uint32 table); ``mac_matmul``'s two table
   routes (the int16 table in shared memory for every 8-bit multiplier
   kind, the int32 one in global memory at w = 10) on ragged K with bk 1,
   33 and 128 and at 1024^3, every adder kind, both forms; ``mac_matmul``
   and ``approx_matmul`` at 1024^3 (bk 128), on the ragged (16, 300) @
   (300, 24) and on a single K tile, every adder kind at n32m10k5 and
   n16m8k4, on both of ``approx_matmul``'s staging routes (bk 100, 200,
   32 and 96 and K = 257 and 300 on the general one; bk > K and bk 192
   on the 16-byte one; 1024^3 with A one byte off 16), and an all -128
   GEMM whose int32 dots pass 2^31 and must wrap (K = bk = 131073 and
   131104); ``conv2d_mac`` with 3 x 3 and 5 x 5 kernels holding negative
   weights, signed inputs, shift 0 and 2, tap tables in shared memory
   past 48 KB, and on the general instance (1 x 1, 3 x 5, tables in
   global memory at 5 x 5 w = 11 and 7 x 7 w = 10), a constant image and
   an unaligned input;
4c. the slice's path at full size, with the counts set to 0 just before
   and read just after: ``run_corpus(workloads=("conv3x3",))`` on the
   4 x 1024 x 1024 batch for the seven Table-1 kinds, ``engine.mul`` and
   ``engine.mul_signed`` on (4, 1024, 1024) at truncated n8t3 and at each
   kind's default 8-bit spec, and both ``engine.matmul`` paths at 1024^3
   (n32m10k5 and n16m8k4).  Every output equals the port's CPU path (the
   GEMMs on their first 64 rows);
5c. the four kernels' times, plain times and bounds (``mac_matmul``'s
   the larger of its operations and its gathers at 32 shared-memory lanes
   an SM), one ``mac_matmul`` call's profile and its global route's time,
   ``conv2d_mac``'s spread over five timings and its time on constant
   images (every gather a broadcast), ``torch._int_mm`` on the same int8
   operands beside ``approx_matmul``, one ``approx_matmul`` call's device
   time by kernel (the B transpose and the GEMM), and ``approx_matmul``
   through its general staging route.

The Table-1 and Fig-6 slice adds phase 4d, at full size:

4d. Table 1: ``exact_error_metrics_sweep(table1_specs())`` (N=32, m=10,
   k=5) on the card, the six approximate rows equal to
   ``BENCH_table1.json``'s ``table1/<kind>`` rows bit for bit, the
   accurate row zero, the reports and ``exact_error_moments`` equal to the
   CPU path, and ``hwcost.report`` printed beside the paper's Table I; the
   Fig-6 design space: the 672 adder specs of ``design_space((8, 16,
   32))`` (``cache_tables=False``: every table built on the card) and the
   61 multiplier specs of ``mul_design_space((8,))``, exact reports and
   hardware reports, each row equal to its ``pareto`` / ``pareto_mul`` row
   of ``BENCH_table1.json`` / ``BENCH_mac.json`` on all eight fields, and
   to the CPU path on the specs with m <= 8; the sweep's wall time and
   device busy share (``torch.profiler``); the Monte-Carlo cross-check at
   10^7 samples for the seven kinds, reference and lut strategies, every
   |z| against the exact moments <= 4 and WCE <= the exact WCE, the
   card's reports equal to the CPU path's at 10^6 samples (MRED
   included), Msamples/s and the host's share (drawing and copying
   the operands); and, with the counts set to 0 just before and read just
   after, ``engine.sum`` over the last axis of a (4, 1024, 1024) signed
   N=16 batch (10 ``approx_add`` launches, or ``lut_add`` under the lut
   strategy) and ``residual_add``, both equal to the CPU path, the
   gradients all ones.  Those launches are added to ``approx_add``'s and
   ``lut_add``'s in the ``kernels`` line.

The telemetry, fault-injection and streaming slice adds phase 4e, at
full size, with the counts set to 0 just before its path and read just
after (its ``accumulate``, ``filter_chain``, ``approx_add`` and
``lut_add`` launches join the ``kernels`` line):

4e. ``run_streaming`` of 8 ``synthetic_batch(4, 1024, i)`` batches
   through ``compile_pipeline(("gaussian_blur", "sharpen",
   "downsample2x"))``, requant stage and fused, depths 1 and 2: outputs
   in order equal to one call a batch on the card, the first image equal
   to the CPU path; MPix/s, p50/p95/p99 and the device's idle share
   (``torch.profiler``) per depth.  ``run_campaign(quick=True,
   backend="cuda")`` and ``recovery_cell(backend="cuda")`` equal
   ``BENCH_faults.json``'s ``fault_curve`` and ``fault_recovery``
   records.  The seven faults of ``default_campaign_faults()`` on the
   full batch, both requant modes and ``add_signed`` (reference and lut
   strategies): each output's first image equal to the CPU path on that
   image; a faulted chain call's wall time beside a healthy one.  A
   3-batch stream under sa1[11] with a ``DegradePolicy`` (32 x 32 CPU
   shadow): trips, fallback spec, recovery dB, MPix/s beside the healthy
   stream's.  The tiled executor at (256, 256) timed as ``run.raw``, with
   telemetry off and on: fails when the disabled overhead less the
   rounds' jitter exceeds 2 % (``benchmarks/check_overhead.py``'s rule);
   a traced stream's Chrome trace and metrics JSON go to ``build/`` and
   must name ``plan:call``, ``stage:*``, ``tiles:dispatch``,
   ``stream:dispatch`` and ``stream:drain``.

The integrity and serving slice adds phase 4f, at full width, with the
counts set to 0 just before its path and read just after (its launches
of every kernel but ``butterfly`` join the ``kernels`` line):

4f. (a) ``benchmarks/bench_serve.py``'s three simulated cells rebuilt
   from ``repro_torch.serving`` equal ``BENCH_serve.json``'s ``sim``
   records field for field; (b) ``Scheduler`` -> ``PlanExecutor`` of
   ``pipe_blur_sharpen_down`` on the card, wall clock, 32 requests of
   1024 x 1024 at 0.25x the calibrated capacity, guarded by a
   ``LutScrubber`` patrolling the registry (host tables and device
   copies) 4 MiB a run and ``CanarySuite``s on a lut engine with a
   multiplier and on a reference engine: every request completes, each
   output equals the plan called on the card, the first the CPU path,
   no alarm; p50/p99, goodput, the device's idle share and the host ms
   of one scrub run and one canary run; the same arrivals once more
   under the default scrubber (a whole pass a run), its shed requests
   printed; (c) a
   stuck-at-1 burned into the live n16m8k4 device table: the canary
   flags it at its first tick and trips a breaker that steps its
   ``DegradePolicy``, the scrubber repairs the device entry in place,
   the canary passes again; (d) ``detection_campaign(backend="cuda")``,
   quick and full grids, equal to ``BENCH_faults.json``'s ten
   ``fault_detection`` records; (e) ``AbftChecker`` over the 1024^3 GEMMs
   (``approx_matmul`` n32m10k5, ``mac_matmul`` with n8t3 products) and
   conv3x3 (n8t3, shift 2) on 4 x 1024^2, healthy and with a stuck bus
   bit in one column or image, which alone is flagged and repaired
   exactly; every verdict at a CPU-sized shape equal to the CPU path's;
   each check's wall ms beside the unchecked call's; (f)
   ``make_engine(..., strategy="lut", integrity=True)`` repairs a
   flipped device-table cell before serving and raises ``IOError`` when
   the rebuild disagrees with the golden.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
run from a directory without ``src/repro_torch``, it exits non-zero and
prints no result.
"""

import contextlib
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
#: One haloc_axa add mod 2^N in the fewest Hopper instructions known: a
#: LOP3 (any function of three registers), an IADD3 (a sum of three) and
#: a LEA ((x << s) + y) count one each.  Every step reads at most three
#: registers; the masks are hoisted and ANDed with ones(N) on the host,
#: so the operands' N-bit masks fold into the first four steps.  With
#: ``hic`` = ~ones(m - 1) the two masked operands' sum carries the
#: speculated carry-in G1 into bit m and leaves P1 at bit m-1; the rest
#: is the low section: (a | b) & (bit m-2 | the OR-ed bits), bit m-2's
#: generate cleared from it (X2 = (a | b) ^ G2) and moved up to bit m-1,
#: and the constant ones(k).  ``tests/test_torch_bounds.py`` runs the
#: steps against the reference adder; the kernels' folds may take more.
HALOC_AXA_ADD = (
    ("ah", "LOP3", ("a", "hic"), lambda a, h: a & h),
    ("bh", "LOP3", ("b", "hic"), lambda b, h: b & h),
    ("g2", "LOP3", ("a", "b", "bit2"), lambda a, b, c: a & b & c),
    ("o", "LOP3", ("a", "b", "mid"), lambda a, b, c: (a | b) & c),
    ("low", "LOP3", ("o", "g2", "ones_k"), lambda o, g, c: (o ^ g) | c),
    ("low", "LEA", ("g2", "low"), lambda g, lo: (g << 1) + lo),
    ("s", "IADD3", ("ah", "bh"), lambda x, y: x + y),
    ("out", "LOP3", ("s", "n_mask", "low"), lambda s, n, lo: (s & n) | lo),
)
OPS_PER_ADD = len(HALOC_AXA_ADD)


def haloc_axa_masks(n_bits, m, k):
    """The hoisted masks ``HALOC_AXA_ADD`` reads, for haloc_axa n{N}m{m}k{k}."""
    n_mask = (1 << n_bits) - 1
    bit2 = 1 << (m - 2)
    return {"hic": ~((1 << (m - 1)) - 1) & n_mask, "bit2": bit2,
            "mid": bit2 | ((1 << (m - 2)) - (1 << k)),
            "ones_k": (1 << k) - 1, "n_mask": n_mask}


#: Per tap of a fold, in instructions as above: its N-bit mask (none: it
#: folds into the add's masks); an exact scale by a weight other than 1
#: (one IMAD, or a shift for a power of two; a weight of 1 passes the term
#: through); a stage's sign extension from N bits (one SGXT); its
#: rounding shift, when it has one (add the half, shift).
OPS_PER_MASK, OPS_PER_SCALE, OPS_SIGN_EXTEND, OPS_ROUND_SHIFT = 0, 1, 1, 2


def s32(x):
    """A 32-bit register pattern read as a signed value."""
    return x - (((x >> 31) & 1) << 32)


def _renamed(steps, names, prefix):
    """``steps`` on other registers: ``names`` maps inputs and the result
    ``out``; every other temporary gets ``prefix``; the masks stay."""
    masks = set(haloc_axa_masks(32, 10, 5))

    def ren(r):
        return names.get(r, r if r in masks else prefix + r)

    return tuple((ren(d), op, tuple(ren(x) for x in srcs), fn)
                 for d, op, srcs, fn in steps)


def butterfly_masks(n_bits, m, k):
    """The hoisted constants ``BUTTERFLY_PAIR`` reads: the adder's masks
    and the products' rounding constant 2^13."""
    return {**haloc_axa_masks(n_bits, m, k), "round14": 1 << 13}


def add_steps(a, b, out):
    """``HALOC_AXA_ADD`` of registers ``a`` and ``b`` into ``out``."""
    return _renamed(HALOC_AXA_ADD, {"a": a, "b": b, "out": out}, out + ".")


def q14_steps(x, w, out):
    """One Q1.14 twiddle product, the low word of ``(x * w + 2^13) >>
    14``: a 32 x 32 -> 64 multiply-add of the hoisted rounding constant
    (IMAD.WIDE, into a register pair) and the pair's funnel shift (SHF)."""
    return ((out + ".wide", "IMAD.WIDE", (x, w, "round14"),
             lambda x, w, c: s32(x) * s32(w) + c),
            (out, "SHF", (out + ".wide",), lambda p: p >> 14))


def negate_steps(x, out):
    """The exact two's-complement negate ``0 - x`` (one IADD3)."""
    return ((out, "IADD3", (x,), lambda v: -v),)


def halve_steps(x, out):
    """An inverse stage's ``(x + 1) >> 1`` on the int32 value, the +1
    wrapping in 32 bits (IADD3, then an arithmetic SHF)."""
    return ((out + ".p1", "IADD3", (x,), lambda v: v + 1),
            (out, "SHF", (out + ".p1",), lambda v: s32(v) >> 1))


#: One butterfly pair of the FFT (both entries of ``csrc/butterfly.cu``),
#: haloc_axa, in instructions as ``HALOC_AXA_ADD``: the four Q1.14
#: products of the odd element (br, bi) by the twiddle (wr, wi), then the
#: six adds of the per-stage order, with the three exact negates of the
#: subtractions: 4 x 2 + 3 + 6 x 8 = 59.  An inverse stage halves each
#: output (``BUTTERFLY_INVERSE``, 67).  ``tests/test_torch_bounds.py`` runs
#: both against ``butterfly_plain``.
BUTTERFLY_PAIR = (
    q14_steps("br", "wr", "rr") + q14_steps("br", "wi", "ri")
    + q14_steps("bi", "wr", "ir") + q14_steps("bi", "wi", "ii")
    + negate_steps("ii", "nii") + add_steps("rr", "nii", "t_re")
    + add_steps("ri", "ir", "t_im")
    + add_steps("ar", "t_re", "top_re") + add_steps("ai", "t_im", "top_im")
    + negate_steps("t_re", "nt_re") + add_steps("ar", "nt_re", "bot_re")
    + negate_steps("t_im", "nt_im") + add_steps("ai", "nt_im", "bot_im"))
BUTTERFLY_INVERSE = BUTTERFLY_PAIR + sum(
    (halve_steps(x, x + ".h") for x in ("top_re", "top_im", "bot_re",
                                        "bot_im")), ())
def lut_add_masks(n_bits, m):
    """The hoisted constants ``LUT_ADD`` reads, for an n{N}m{m} lut add."""
    n_mask = (1 << n_bits) - 1
    low = (1 << m) - 1
    return {"low": low, "hi": n_mask & ~low, "pow_m": 1 << m,
            "n_mask": n_mask}


#: One lut add mod 2^N (``csrc/lut_add.cu``) in instructions as
#: ``HALOC_AXA_ADD``: the two low masks (LOP3), the table index
#: ``a_low * 2^m + b_low`` (one IMAD, m being a run-time value), the
#: gather (LDG, counted in bytes: the table is read once), the two high
#: masks (LOP3), the high parts' and the entry's sum (IADD3) and the N-bit
#: mask (LOP3): 7 instructions.  ``tests/test_torch_bounds.py`` runs the
#: steps against the reference adder and the plain lut add.
LUT_ADD = (
    ("al", "LOP3", ("a", "low"), lambda a, lo: a & lo),
    ("bl", "LOP3", ("b", "low"), lambda b, lo: b & lo),
    ("idx", "IMAD", ("al", "pow_m", "bl"), lambda x, p, y: x * p + y),
    ("entry", "LDG", ("table", "idx"), lambda t, i: t[i]),
    ("ah", "LOP3", ("a", "hi"), lambda a, h: a & h),
    ("bh", "LOP3", ("b", "hi"), lambda b, h: b & h),
    ("s", "IADD3", ("ah", "bh", "entry"), lambda x, y, e: x + y + e),
    ("out", "LOP3", ("s", "n_mask"), lambda v, n: v & n),
)
OPS_PER_LUT_ADD = sum(op != "LDG" for _, op, _, _ in LUT_ADD)

#: Two MAC products of mac_matmul's inner loop, one A row by two B
#: columns, in instructions as above: each table offset one LOP3 of the
#: staged byte offsets (A's (a & mask) << (w + 1), B's (b & mask) << 1),
#: each product one gather from the int16 table in shared memory (LDS,
#: sign-extending), and one IADD3 adding both into the tile's partial.  So
#: 1.5 int32 instructions and one gather a product; no route avoids the
#: gather, and shared memory serves 32 lanes a clock an SM
#: (``LDS_LANES_PER_SM``).  ``tests/test_torch_bounds.py`` runs the steps
#: against the plain GEMM's partial.
MAC_PRODUCT_PAIR = (
    ("i0", "LOP3", ("a", "b0"), lambda a, b: a | b),
    ("i1", "LOP3", ("a", "b1"), lambda a, b: a | b),
    ("p0", "LDS", ("table", "i0"), lambda t, i: t[i >> 1]),
    ("p1", "LDS", ("table", "i1"), lambda t, i: t[i >> 1]),
    ("part", "IADD3", ("part", "p0", "p1"), lambda s, x, y: s + x + y),
)
OPS_PER_MAC_PRODUCT = sum(op != "LDS" for _, op, _, _ in MAC_PRODUCT_PAIR) / 2
GATHERS_PER_MAC_PRODUCT = sum(op == "LDS"
                              for _, op, _, _ in MAC_PRODUCT_PAIR) / 2
#: Shared-memory lanes an SM serves a clock (32 banks of 4 bytes): the
#: rate of the gathers, one lane each.
LDS_LANES_PER_SM = 32
#: One input value of conv2d_mac, in instructions as above: its row of the
#: signed tap tables (``kernels/conv2d_mac.py``, signed_tap_tables), one
#: IMAD.  Each of its taps is then one gather at row + t (counted in
#: neither bytes nor operations, as a MAC product's gather), the product's
#: sign and N-bit mask being in the table: no magnitude, sign restore or
#: mask per tap.  ``tests/test_torch_bounds.py`` runs the step and the
#: gathers against the plain conv.
CONV_INDEX = (
    ("idx", "IMAD", ("v", "taps", "zero"), lambda v, t, z: v * t + z),
)
OPS_PER_CONV_VALUE = len(CONV_INDEX)
#: Sources whose every kernel must build with no stack frame and no
#: spills (their parameters are read at compile-time indices).
NO_STACK_SOURCES = ("accumulate", "conv2d_mac", "butterfly", "mac_matmul")
#: H100 SXM dense int8 tensor-core rate (ops/s), from the data sheet: the
#: exact-product GEMM's int8 dot.
INT8_TENSOR_OPS_PER_S = 1979e12

FULL_SIZE = 1024
N_IMAGES = 4
#: The MAC GEMM and exact-product GEMM cell: 1024^3 (granite_moe_1b's
#: d_model), K tiles of 128, so 8 tiles and 7 approximate folds per output.
GEMM_SIZE, GEMM_BK = 1024, 128
#: Rows of a GEMM output that the CPU path recomputes (rows are
#: independent; a whole 1024^3 on the CPU would take minutes).
GEMM_CPU_ROWS = 64
#: The paper's Fig-5 image size, and the size ``tests/test_image.py``
#: asserts the quality ordering at.
FFT_SIZE, ORDERING_SIZE = 512, 128


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


def report_ptxas(_build):
    """Each source's nvcc seconds and its kernels' ``-Xptxas -v`` in sum:
    instances, registers, and every instance with a stack frame or
    spills (none allowed in :data:`NO_STACK_SOURCES`)."""
    for name in _build.SOURCES:
        ks = _build.ptxas_kernels(_build.BUILD_LOGS.get(name, ""))
        if not ks:
            log(f"  {name}: no ptxas report (its library was built before)")
            continue
        regs = [k[1] for k in ks]
        framed = [k for k in ks if k[2] or k[3]]
        log(f"  {name}: nvcc {_build.BUILD_SECONDS.get(name, 0.0):.1f} s, "
            f"{len(ks)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{len(ks) - len(framed)} with 0 bytes stack frame and 0 bytes "
            f"spilled")
        for kname, kregs, stack, spill in framed:
            log(f"    {kname}: {kregs} registers, {stack} bytes stack frame, "
                f"{spill} bytes spilled")
        check(name not in NO_STACK_SOURCES or not framed,
              f"{name}: {len(framed)} kernels with a stack frame or spills")


# ------------------------------------------------------------- phase 3 --

def offset_copy(torch, x, offset=1):
    """``x`` at an address ``offset`` elements past a 16-byte boundary,
    where 16-byte loads do not fit."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def phases(q):
    """downsample2x's four phase views of ``q``, cropped to even H, W."""
    q = q[..., :q.shape[-2] & ~1, :q.shape[-1] & ~1]
    return (q[..., 0::2, 0::2], q[..., 0::2, 1::2], q[..., 1::2, 0::2],
            q[..., 1::2, 1::2])


def signed_route(acc_k, terms):
    """The route accumulate_signed takes for ``terms``."""
    _, _, width, views, strides = acc_k.term_layout(terms)
    return acc_k.accumulate_route(len(terms), width, acc_k.vec_aligned(
        [v.data_ptr() for v in views], strides))


def compare_into(torch, errs, name, got, want, what):
    """Fail unless ``got`` equals ``want``; keep the largest |difference|
    of ``name`` in ``errs``."""
    d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() and got.shape == want.shape else 0
    errs[name] = max(errs[name], d)
    check(got.shape == want.shape and torch.equal(got, want),
          f"{name} kernel != plain version on {what} (max |d| {d})")


def containers(torch, np, rng, shape, n_bits, dev):
    """Random N-bit patterns in int32 containers on ``dev``."""
    u = rng.integers(0, 1 << n_bits, shape, dtype=np.uint64)
    return torch.as_tensor(u.astype(np.uint32).view(np.int32), device=dev)


def spec_at(kind, n_bits):
    """The kind at n16m8k4 or the paper's n32m10k5."""
    from repro_torch.core import specs
    m, k = (8, 4) if n_bits == 16 else (10, 5)
    return specs.AdderSpec(kind, n_bits, m, k)


def check_kernels(torch, np, dev, errs):
    """Every kernel against its plain version on the card, exact."""
    from repro_torch.ax import FilterStage
    from repro_torch.core import specs
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import conv_chain as chain_k

    rng = np.random.default_rng(0)

    def rand_containers(shape, n_bits):
        return containers(torch, np, rng, shape, n_bits, dev)

    def compare(name, got, want, what):
        compare_into(torch, errs, name, got, want, what)

    spec = spec_at

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

    # accumulate, the stacked entry: the main path's shapes and every
    # route (the K = 2 and K = 4 instances, the general one; 16-byte loads,
    # and one element a thread on a ragged M or an unaligned stack).
    cases = [((2, N_IMAGES, 1024, 1024), (2, -1)),
             ((2, N_IMAGES, 1024, 1024), (32, 32)),
             ((2, N_IMAGES, 1024, 1024), (1, 1)),
             ((4, N_IMAGES, 512, 512), (1, 1, 1, 1)),
             ((9, 3, 37, 41), (1, 2, 1, -2, 4, -2, 1, 2, -1)),
             ((2, 3, 37, 41), (2, -1)), ((4, 3, 37, 41), (1, 2, 3, 4)),
             ((3, 2, 64, 64), (1, -1, 3)), ((1, 2, 64, 64), (5,))]
    routes = set()
    for shape, ws in cases:
        terms = rand_containers(shape, 16)
        small = terms.numel() < 1 << 20
        layouts = (terms, offset_copy(torch, terms)) if small else (terms,)
        routes.update(acc_k.accumulate_route(len(ws), terms[0].numel(), al)
                      for al in ((True, False) if small else (True,)))
        for kind in kinds:
            for fast in (False, True):
                s = spec(kind, 16)
                want = acc_k.accumulate_plain(terms, s, ws, fast)
                for t in layouts:
                    compare("accumulate",
                            acc_k.accumulate(t, s, weights=ws, fast=fast),
                            want, f"{s.short_name} fast={fast} {shape} "
                                  f"w={ws} at {t.data_ptr() % 16}")
    log(f"  accumulate: {len(kinds)} kinds x 2 forms x {len(cases)} "
        f"shape/weight cases (routes (K instance, outputs a thread) "
        f"{sorted(routes)}), small ones also unaligned: equal")

    # accumulate_signed, the same kernel on signed terms read in place:
    # scaled_add's planes (sharpen, blend with shift 6), downsample2x's
    # strided phases at full size and on odd sizes, a ragged W, K = 9.
    def signed(shape, lim=2040):
        return torch.as_tensor(rng.integers(-lim, lim, shape)
                               .astype(np.int32), device=dev)

    qa, qb = signed((N_IMAGES, 1024, 1024)), signed((N_IMAGES, 1024, 1024))
    signed_cases = [("sharpen", (qa, qb), (2, -1), 0),
                    ("blend", (qa, qb), (40, 24), 6),
                    ("downsample", phases(qa), None, 2),
                    ("ragged W", (signed((2, 37, 41)), signed((2, 37, 41))),
                     (2, -1), 0),
                    ("K=9", tuple(signed((2, 33, 64)) for _ in range(9)),
                     (1, 2, 1, -2, 4, -2, 1, 2, -1), 3)]
    for shape in ((3, 1001, 999), (2, 37, 70), (1, 1)):
        signed_cases.append((f"downsample {shape}", phases(signed(shape)),
                             None, 2))
    for name, terms, ws, shift in signed_cases:
        for kind in kinds:
            for fast in (False, True):
                s = spec(kind, 16)
                compare("accumulate",
                        acc_k.accumulate_signed(terms, s, 16, weights=ws,
                                                shift=shift, fast=fast),
                        acc_k.accumulate_signed_plain(terms, s, 16, ws,
                                                      shift, fast),
                        f"signed {name} {s.short_name} fast={fast}")
    log("  accumulate_signed: " + ", ".join(
        f"{name} {signed_route(acc_k, terms)}"
        for name, terms, _, _ in signed_cases)
        + f" x {len(kinds)} kinds x 2 forms: equal")

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
    # Edge shapes: 1 x 1 and 1 x 7 planes, W not a multiple of 4 (no
    # 16-byte loads), tiles inside the image and on its border; the
    # operators' chains take the sep2 route, same_axis and wide the
    # general one.
    edge_shapes = [(1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (2, 37, 70),
                   (3, 1000, 1030), (1, 33, 65), (2, 66, 258),
                   (1, 100, 384), (1, 97, 390)]
    routes = {name: chain_k.chain_route(chain_k.norm_stages(st, 2))
              for name, st in edge_chains.items()}
    check(routes == {"box": "sep2", "gauss": "sep2", "sobel_gx": "sep2",
                     "sobel_gy": "sep2", "same_axis": "general",
                     "wide": "general"}, f"filter_chain routes {routes}")
    for shape in edge_shapes:
        qe = torch.as_tensor(rng.integers(-1500, 1500, shape)
                             .astype(np.int32), device=dev)
        for name, stages in edge_chains.items():
            for kind in kinds:
                for fast in (False, True):
                    s = spec(kind, 16)
                    compare("filter_chain",
                            chain_k.filter_chain(qe, s, stages, fast=fast),
                            chain_k.filter_chain_plain(qe, s, stages, fast),
                            f"{name} {s.short_name} {shape} fast={fast}")
    torch.cuda.synchronize()
    log(f"  filter_chain: 4 chains x {len(kinds)} kinds x 2 forms at "
        f"{tuple(q.shape)}, {len(edge_chains)} chains (routes {routes}) x "
        f"{len(edge_shapes)} edge shapes x {len(kinds)} kinds x 2 forms: "
        f"equal")
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")


def stage_planes(torch, np, rng, rows, half, lim, dev):
    """A stage's four (rows, half) input planes as the FFT hands them to
    the butterfly: the even and odd halves, strided views of two
    (rows, 2 * half) buffers; full-range int32 values unless ``lim``."""
    lo, hi = (-(1 << 31), 1 << 31) if lim is None else (-lim, lim)
    x_re, x_im = (torch.as_tensor(rng.integers(lo, hi, (rows, 2 * half))
                                  .astype(np.int32), device=dev)
                  for _ in range(2))
    return (x_re[:, :half], x_im[:, :half], x_re[:, half:], x_im[:, half:])


def check_fft_lut_kernels(torch, np, dev, errs):
    """butterfly and lut_add against their plain versions on the card,
    exact (and lut_add against the approx_add kernel too)."""
    from repro_torch.core import specs
    from repro_torch.kernels.butterfly import stage_twiddles
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import butterfly as bf_k
    from repro_torch.kernels import lut_add as lut_k

    rng = np.random.default_rng(3)
    kinds = specs.ALL_KINDS
    t0 = time.perf_counter()

    def stage(planes, half, s, what):
        for inverse in (False, True):
            w_re, w_im = stage_twiddles(half, inverse, dev)
            for fast in (False, True):
                got = bf_k.butterfly(*planes, w_re, w_im, s,
                                     inverse=inverse, fast=fast)
                want = bf_k.butterfly_plain(*planes, w_re, w_im, s,
                                            inverse=inverse, fast=fast)
                for g, w in zip(got, want):
                    compare_into(torch, errs, "butterfly", g, w,
                                 f"{s.short_name} {what} half={half} "
                                 f"inverse={inverse} fast={fast}")

    # Every stage of the 512 x 512 reconstruction moves 131072 pairs:
    # halves 1..8 at block 16, 1..256 for the whole image.
    pairs = FFT_SIZE * FFT_SIZE // 2
    halves = tuple(1 << i for i in range(9))
    for lim, what in ((None, "full-range"), (1 << 24, "+-2^24")):
        for half in halves:
            planes = stage_planes(torch, np, rng, pairs // half, half, lim,
                                  dev)
            for kind in kinds:
                stage(planes, half, spec_at(kind, 32), what)
    for half in (7, 1, 8):
        planes = stage_planes(torch, np, rng, 1001, half, None, dev)
        for kind in kinds:
            stage(planes, half, spec_at(kind, 32), "ragged 1001 rows")
            stage(planes, half, spec_at(kind, 16), "ragged 1001 rows")
    for half in (1, 8):
        planes = stage_planes(torch, np, rng, pairs // half, half, None, dev)
        for kind in kinds:
            stage(planes, half, spec_at(kind, 16), "N=16 residues")
    log(f"  butterfly: {len(kinds)} kinds x 2 forms x forward/inverse at "
        f"the {len(halves)} stage shapes (131072 pairs, strided halves), "
        f"full-range and +-2^24 at N=32, N=16 residues, 1001 ragged rows: "
        f"equal")
    check_fft_axis(torch, np, dev, errs, rng)

    def lut_case(a, b, s, what):
        got = lut_k.lut_add(a, b, s)
        compare_into(torch, errs, "lut_add", got, lut_k.lut_add_plain(a, b, s),
                     f"{s.short_name} {what}")
        compare_into(torch, errs, "lut_add", got,
                     add_k.approx_add(a, b, s, fast=False),
                     f"{s.short_name} {what} (against approx_add)")

    approx = [k for k in kinds if k != "accurate"]
    for n_bits in (16, 32):
        a = containers(torch, np, rng, (4096, 4096), n_bits, dev)
        b = containers(torch, np, rng, (4096, 4096), n_bits, dev)
        for kind in approx:
            lut_case(a, b, spec_at(kind, n_bits), "4096x4096")
    a8, b8 = torch.meshgrid(torch.arange(256, device=dev, dtype=torch.int32),
                            torch.arange(256, device=dev, dtype=torch.int32),
                            indexing="ij")
    a8, b8 = a8.contiguous(), b8.contiguous()
    cells = 0
    for kind in approx:
        for m in range(1, 9):
            for k in range(0, m + 1):
                try:
                    s = specs.AdderSpec(kind, 8, m, k)
                except ValueError:
                    continue
                lut_case(a8, b8, s, "exhaustive")
                cells += 1
    torch.cuda.synchronize()
    log(f"  lut_add: {len(approx)} kinds at n16m8k4 and n32m10k5 on "
        f"4096x4096, {cells} (kind, m, k) cells exhaustive at N=8: equal to "
        f"the plain version and to the approx_add kernel")
    log(f"  phase 3b took {time.perf_counter() - t0:.1f} s")


def check_fft_axis(torch, np, dev, errs, rng):
    """fft_axis (every stage of an axis in one launch) against the
    per-stage path, ``butterfly`` chained stage by stage on the same
    transforms (what the FFT ran before), and against its plain version:
    the last axis at n = 2 ... 4096, the row and column axes of the 512 x
    512 image whole and in 16 x 16 tiles read in place and of the 4 x
    1024^2 batch in tiles, every kind, both forms, forward and inverse,
    full-range values; in place; and the per-stage route past 4096."""
    from repro_torch.core.specs import paper_spec
    from repro_torch.image.fft import (FixedFFTConfig, fft_fixed, fft_route,
                                       image_layouts, to_fixed)
    from repro_torch.core import specs
    from repro_torch.kernels import butterfly as bf_k
    kinds = specs.ALL_KINDS
    t0 = time.perf_counter()
    layouts = []
    for log_n in range(1, 13):
        n = 1 << log_n
        shape = (max(2, (1 << 16) // n), n)
        layouts.append((f"last axis n={n}", shape,
                        bf_k.last_axis_layout(shape)))
    for shape, block in (((FFT_SIZE, FFT_SIZE), 16), ((FFT_SIZE, FFT_SIZE),
                                                      None),
                         ((N_IMAGES, FULL_SIZE, FULL_SIZE), 16)):
        rows, cols = image_layouts(shape, block)
        for name, lay in (("rows", rows), ("cols", cols)):
            layouts.append((f"{name} of {shape} block {block}", shape, lay))
    plans = set()
    for what, shape, lay in layouts:
        plans.add((lay.n, bf_k.axis_plan(lay).log_per_block,
                   bf_k.axis_plan(lay).t_fast))
        re, im = (containers(torch, np, rng, shape, 32, dev)
                  for _ in range(2))
        rows = [lay.view(x).reshape(-1, lay.n) for x in (re, im)]
        plain_kinds = kinds if lay.transforms * lay.n <= 1 << 16 \
            else ("haloc_axa",)
        for kind in kinds:
            s = spec_at(kind, 32)
            for inverse in (False, True):
                for fast in (False, True):
                    got = bf_k.fft_axis(re, im, lay, s, inverse=inverse,
                                        fast=fast)
                    staged = bf_k.fft_stages(
                        *rows, inverse, lambda *p: bf_k.butterfly(
                            *p, s, inverse=inverse, fast=fast))
                    for g, w in zip(got, staged):
                        compare_into(torch, errs, "fft_axis",
                                     lay.view(g).reshape(-1, lay.n), w,
                                     f"{s.short_name} {what} inverse="
                                     f"{inverse} fast={fast} (per-stage)")
                    if kind in plain_kinds:
                        want = bf_k.fft_axis_plain(re, im, lay, s,
                                                   inverse=inverse,
                                                   fast=fast)
                        for g, w in zip(got, want):
                            compare_into(torch, errs, "fft_axis", g, w,
                                         f"{s.short_name} {what} inverse="
                                         f"{inverse} fast={fast}")
    # In place: the column pass of fft2 writes over its input.
    shape = (FFT_SIZE, FFT_SIZE)
    rows, cols = image_layouts(shape, 16)
    s = paper_spec("haloc_axa")
    re, im = (containers(torch, np, rng, shape, 32, dev) for _ in range(2))
    want = bf_k.fft_axis(re, im, cols, s, fast=True)
    bf_k.fft_axis(re, im, cols, s, fast=True, out=(re, im))
    compare_into(torch, errs, "fft_axis", re, want[0], "in place")
    compare_into(torch, errs, "fft_axis", im, want[1], "in place")
    # Past the axis kernel's 4096: the per-stage kernel, one launch a
    # stage, equal to the CPU path.
    check(fft_route(8192, 32) == "stages" and fft_route(4096, 32) == "axis"
          and fft_route(16, 16) == "adds", "fft_route")
    x = rng.uniform(-200, 200, (4, 8192))
    cfg = FixedFFTConfig(spec=s)
    cpu = FixedFFTConfig(spec=s, backend="torch", device="cpu")
    for inverse in (False, True):
        bf_k.fft_axis.launches = bf_k.butterfly.launches = 0
        got = fft_fixed(to_fixed(x, cfg), to_fixed(-x, cfg), cfg, inverse)
        check((bf_k.fft_axis.launches, bf_k.butterfly.launches) == (0, 13),
              "fft_fixed at n = 8192 must take the per-stage route")
        want = fft_fixed(to_fixed(x, cpu), to_fixed(-x, cpu), cpu, inverse)
        for g, w in zip(got, want):
            check(torch.equal(g.cpu(), w), "fft_fixed n = 8192 on the card "
                  "differs from the CPU path")
    torch.cuda.synchronize()
    log(f"  fft_axis: {len(layouts)} layouts (last axis n = 2 ... 4096; "
        f"rows and columns of 512^2 whole and block 16 and of 4 x 1024^2 "
        f"block 16, in place) x {len(kinds)} kinds x 2 forms x "
        f"forward/inverse, full-range: equal to the per-stage path and the "
        f"plain version; plans (n, log2 T, t_fast) {sorted(plans)}; in "
        f"place equal; n = 8192 through the per-stage route (13 launches) "
        f"equal to the CPU path ({time.perf_counter() - t0:.1f} s)")


def mul_specs():
    """The multipliers of the MAC path: truncated n8t3 (the conv3x3
    default) and each kind's default 8-bit spec."""
    from repro_torch.ax.mul import (MulSpec, default_mul_spec,
                                    registered_multipliers)
    return [MulSpec("truncated", 8, 3)] + [default_mul_spec(k, 8)
                                           for k in registered_multipliers()]


def int8_operands(torch, np, rng, shape, dev):
    return torch.as_tensor(rng.integers(-128, 128, shape, dtype=np.int8),
                           device=dev)


def check_mac_kernels(torch, np, dev, errs):
    """mul, mac_matmul, conv2d_mac and approx_matmul against their plain
    versions on the card, exact."""
    from repro_torch.ax.mul import MulSpec, registered_multipliers
    from repro_torch.core import specs
    from repro_torch.kernels import approx_matmul as mm_k
    from repro_torch.kernels import conv2d_mac as conv_k
    from repro_torch.kernels import mac_matmul as mac_k
    from repro_torch.kernels import mul as mul_k

    rng = np.random.default_rng(6)
    kinds = specs.ALL_KINDS
    forms = ("reference", "fused", "lut")
    t0 = time.perf_counter()

    def compare(name, got, want, what):
        compare_into(torch, errs, name, got, want, what)

    # mul: the path shape, every kind and form; then exhaustive at N=8 and
    # N=10 (the uint32 table).
    shape = (N_IMAGES, FULL_SIZE, FULL_SIZE)
    a, b = (containers(torch, np, rng, shape, 8, dev) for _ in range(2))
    for ms in mul_specs():
        for form in forms:
            compare("mul", mul_k.mul(a, b, ms, strategy=form),
                    mul_k.mul_plain(a, b, ms, form),
                    f"{ms.short_name} {form} {shape}")
    cells = 0
    for n in (8, 10):
        a8, b8 = (x.reshape(-1).contiguous() for x in torch.meshgrid(
            torch.arange(1 << n, device=dev, dtype=torch.int32),
            torch.arange(1 << n, device=dev, dtype=torch.int32),
            indexing="ij"))
        for kind in registered_multipliers():
            for t in ((0, n // 2, n - 1) if kind != "accurate" else (0,)):
                ms = MulSpec(kind, n, t, n // 4 if kind == "broken_array"
                             else 0)
                for form in forms:
                    compare("mul", mul_k.mul(a8, b8, ms, strategy=form),
                            mul_k.mul_plain(a8, b8, ms, form),
                            f"{ms.short_name} {form} exhaustive")
                cells += 1
    log(f"  mul: {len(mul_specs())} specs x 3 forms at {shape}, {cells} "
        f"specs x 3 forms exhaustive at N=8/10: equal")

    # The GEMMs: the path shape, test_mul's ragged operands, a single
    # K tile (K <= bk), a ragged M/N edge, every adder kind at both widths.
    # approx_matmul's general staging route: bk 100, 200, 32 and 96, K =
    # 257 and 300, M and N off the 64 grid; its 16-byte route: bk > K
    # (K % 64 == 32), bk 192.
    g = GEMM_SIZE
    cases = [((g, g), (g, g), GEMM_BK), ((16, 300), (300, 24), 128),
             ((100, 128), (128, 72), 128), ((70, 96), (96, 130), 200),
             ((33, 257), (257, 65), 100), ((70, 257), (257, 130), 100),
             ((33, 300), (300, 65), 200), ((65, 80), (80, 63), 32),
             ((96, 256), (256, 40), 512), ((128, 208), (208, 128), 96),
             ((70, 320), (320, 136), 192)]
    operands = [(int8_operands(torch, np, rng, sa, dev),
                 int8_operands(torch, np, rng, sb, dev), bk)
                for sa, sb, bk in cases]
    trunc = MulSpec("truncated", 8, 3)
    for n_bits in (32, 16):
        for kind in kinds:
            spec = spec_at(kind, n_bits)
            for a8, b8, bk in operands:
                what = f"{spec.short_name} {tuple(a8.shape)} @ " \
                       f"{tuple(b8.shape)} bk {bk}"
                a32, b32 = a8.to(torch.int32), b8.to(torch.int32)
                for fast in (False, True):
                    compare("approx_matmul",
                            mm_k.approx_matmul(a8, b8, spec, bk=bk,
                                               fast=fast),
                            mm_k.approx_matmul_plain(a8, b8, spec, bk, fast),
                            f"{what} fast={fast}")
                    compare("mac_matmul",
                            mac_k.mac_matmul(a32, b32, spec, trunc, bk=bk,
                                             fast=fast),
                            mac_k.mac_matmul_plain(a32, b32, spec, trunc, bk,
                                                   fast),
                            f"{what} {trunc.short_name} fast={fast}")
        spec = spec_at("haloc_axa", n_bits)
        for ms in mul_specs()[1:] + [MulSpec("mitchell", 10, 2)]:
            for a8, b8, bk in operands[:2]:
                a32, b32 = a8.to(torch.int32), b8.to(torch.int32)
                compare("mac_matmul",
                        mac_k.mac_matmul(a32, b32, spec, ms, bk=bk),
                        mac_k.mac_matmul_plain(a32, b32, spec, ms, bk),
                        f"{spec.short_name} {ms.short_name} "
                        f"{tuple(a8.shape)}")
    routes = sorted({(tuple(a8.shape), tuple(b8.shape), bk,
                      mm_k.staging_route(a8.shape[1], bk, a8.data_ptr()))
                     for a8, b8, bk in operands})
    log(f"  approx_matmul staging routes: {routes}")
    # The 1024^3 cell through the general route (A one byte off 16).
    a8, b8, _ = operands[0]
    buf = torch.empty(a8.numel() + 1, dtype=torch.int8, device=dev)
    a_off = buf[1:].view(a8.shape)
    a_off.copy_(a8)
    check(mm_k.staging_route(g, GEMM_BK, a_off.data_ptr()) == "general",
          "approx_matmul: a one-byte-offset A must take the general route")
    for n_bits in (32, 16):
        spec = spec_at("haloc_axa", n_bits)
        compare("approx_matmul",
                mm_k.approx_matmul(a_off, b8, spec, bk=GEMM_BK),
                mm_k.approx_matmul(a8, b8, spec, bk=GEMM_BK),
                f"{spec.short_name} 1024^3 general route vs 16-byte route")
        compare("approx_matmul",
                mm_k.approx_matmul(a_off[:GEMM_CPU_ROWS], b8, spec,
                                   bk=GEMM_BK),
                mm_k.approx_matmul_plain(a8[:GEMM_CPU_ROWS], b8, spec,
                                         GEMM_BK),
                f"{spec.short_name} 1024^3 general route, first rows")
    # Every dot passes 2^31 and must wrap mod 2^32: all -128, one K tile
    # of 2^17 + 1 (general route) and 2^17 + 32 (16-byte route).
    for k_len in (131073, 131104):
        a_w = torch.full((16, k_len), -128, dtype=torch.int8, device=dev)
        b_w = torch.full((k_len, 16), -128, dtype=torch.int8, device=dev)
        spec = spec_at("haloc_axa", 32)
        got = mm_k.approx_matmul(a_w, b_w, spec, bk=k_len)
        wrapped = (k_len * 16384 + 2 ** 31) % 2 ** 32 - 2 ** 31
        check(wrapped < 0 and bool((got == wrapped).all()),
              f"approx_matmul K={k_len} all -128: the int32 dot must wrap "
              f"to {wrapped}")
        compare("approx_matmul", got,
                mm_k.approx_matmul_plain(a_w, b_w, spec, k_len),
                f"wrap case K = bk = {k_len}")
    torch.cuda.synchronize()
    log(f"  approx_matmul and mac_matmul: {len(kinds)} kinds x 2 forms x "
        f"{len(cases)} shapes (1024^3, ragged, single tile, edges, both "
        f"staging routes) at n32m10k5 and n16m8k4, and every multiplier "
        f"kind at 1024^3; approx_matmul's general route at 1024^3 and the "
        f"2^31 wrap on both routes: equal")

    # mac_matmul's two table routes: the int16 table in shared memory for
    # every 8-bit multiplier kind, the int32 one in global memory at w =
    # 10; ragged K, bk 1, 33 and 128, every adder kind at both widths.
    from repro_torch.ax.mul import lut as mul_lut
    mac_muls = mul_specs() + [MulSpec("truncated", 10, 4),
                              MulSpec("mitchell", 10)]
    mac_cases = [((70, 300), (300, 130), 128), ((70, 300), (300, 130), 33),
                 ((33, 97), (97, 65), 1), ((g, g), (g, g), GEMM_BK)]
    mac_routes = {}
    for ms in mac_muls:
        route = mac_k.mac_route(ms.n_bits, mul_lut.signed_table_fits_int16(ms))
        mac_routes[ms.short_name] = route
        check(route == ("shared" if ms.n_bits <= 8 else "global"),
              f"mac_matmul route of {ms.short_name}: {route}")
        lim = 1 << (ms.n_bits - 1)
        for sa, sb, bk in mac_cases:
            if sa[0] == g and ms.n_bits > 8:
                continue
            a32 = torch.as_tensor(rng.integers(-lim, lim, sa)
                                  .astype(np.int32), device=dev)
            b32 = torch.as_tensor(rng.integers(-lim, lim, sb)
                                  .astype(np.int32), device=dev)
            rows = slice(0, GEMM_CPU_ROWS) if sa[0] == g else slice(None)
            for n_bits in (32, 16):
                for kind in (kinds if sa[0] != g else ("haloc_axa",)):
                    spec = spec_at(kind, n_bits)
                    for fast in (False, True):
                        compare("mac_matmul",
                                mac_k.mac_matmul(a32, b32, spec, ms, bk=bk,
                                                 fast=fast)[rows],
                                mac_k.mac_matmul_plain(a32[rows], b32, spec,
                                                       ms, bk, fast),
                                f"{spec.short_name} {ms.short_name} {sa} @ "
                                f"{sb} bk {bk} fast={fast} ({route})")
    torch.cuda.synchronize()
    log(f"  mac_matmul routes {mac_routes}: {len(mac_cases)} shapes (ragged "
        f"K, bk 1, 33, 128, 1024^3 on its first rows) x {len(kinds)} kinds "
        f"x 2 forms at n32 and n16: equal")

    # conv2d_mac: the path shape, every kind (the 3 x 3 instance); negative
    # weights; 3 x 3 and 5 x 5; shift 0 and 2; w = 8 and w = 10, the tables
    # staged in shared memory (5 x 5 at w = 8 is 50 KiB, past the 48 KB of
    # a launch without the attribute; 5 x 5 at w = 10 is 200 KiB).
    k3 = ((1, 3, 1), (3, -5, 3), (1, 3, 1))
    k5 = tuple(tuple(int(x) for x in row)
               for row in rng.integers(-9, 10, (5, 5)))
    q = torch.as_tensor(rng.integers(-255, 256, shape).astype(np.int32),
                        device=dev)
    for kind in kinds:
        spec = spec_at(kind, 16)
        for fast in (False, True):
            compare("conv2d_mac",
                    conv_k.conv2d_mac(q, spec, trunc, k3, shift=2, fast=fast),
                    conv_k.conv2d_mac_plain(q, spec, trunc, k3, 2, fast),
                    f"{spec.short_name} 3x3 {shape} fast={fast}")
    q10 = torch.as_tensor(rng.integers(-1023, 1024, (3, 300, 257))
                          .astype(np.int32), device=dev)
    conv_routes = set()
    for ms, x in ((trunc, q[:2, :300, :257].contiguous()),
                  (MulSpec("mitchell", 10), q10),
                  (MulSpec("broken_array", 10, 4, 2), q10)):
        for kernel in (k3, k5):
            conv_routes.add((f"{len(kernel)}x{len(kernel)} w={ms.n_bits}",
                             conv_k.conv_route(len(kernel), len(kernel),
                                               1 << ms.n_bits)))
            for shift in (0, 2):
                for n_bits in (16, 32):
                    spec = spec_at("haloc_axa", n_bits)
                    compare("conv2d_mac",
                            conv_k.conv2d_mac(x, spec, ms, kernel,
                                              shift=shift),
                            conv_k.conv2d_mac_plain(x, spec, ms, kernel,
                                                    shift),
                            f"{spec.short_name} {ms.short_name} "
                            f"{len(kernel)}x{len(kernel)} shift {shift}")
    # The general instance: 1 x 1 and 3 x 5 with staged tables, 5 x 5 at
    # w = 11 and 7 x 7 at w = 10 with tables in global memory; a constant
    # image (every gather a broadcast), an unaligned input and W % 4 != 0,
    # every kind.
    k7 = tuple(tuple(int(x) for x in row)
               for row in rng.integers(-9, 10, (7, 7)))
    q11 = torch.as_tensor(rng.integers(-2047, 2048, (2, 150, 131))
                          .astype(np.int32), device=dev)
    general = [("1x1", trunc, ((7,),), q[:2, :200, :100].contiguous()),
               ("3x5", trunc, tuple(row[:5] for row in k5[:3]), q[:2]),
               ("5x5 w=11", MulSpec("mitchell", 11), k5, q11),
               ("7x7 w=10", MulSpec("mitchell", 10), k7, q10),
               ("3x3 constant", trunc, k3, torch.full_like(q[:1], 200)),
               ("3x3 unaligned", trunc, k3, offset_copy(torch, q[:1])),
               ("3x3 W=131", trunc, k3, q[:2, :150, :131].contiguous())]
    for name, ms, kernel, x in general:
        conv_routes.add((name, conv_k.conv_route(len(kernel), len(kernel[0]),
                                                 1 << ms.n_bits)))
        for kind in kinds:
            spec = spec_at(kind, 16)
            compare("conv2d_mac",
                    conv_k.conv2d_mac(x, spec, ms, kernel, shift=2),
                    conv_k.conv2d_mac_plain(x, spec, ms, kernel, 2),
                    f"{spec.short_name} {ms.short_name} {name}")
    torch.cuda.synchronize()
    log(f"  conv2d_mac: {len(kinds)} kinds x 2 forms at {shape} (3x3, "
        f"shift 2); 3x3 and 5x5, shift 0 and 2, w=8 and w=10, n16 and n32; "
        f"{len(general)} cases of the other routes x {len(kinds)} kinds; "
        f"routes (instance, tables) {sorted(conv_routes)}: equal")
    log(f"  phase 3c took {time.perf_counter() - t0:.1f} s")


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


#: The kernels each path must launch: the 16-bit image path's, and the
#: Fig-5 FFT and lut path's (fft_axis runs every N=32 axis, butterfly the
#: per-stage route past 4096, approx_add the N=16 six-add route).
MAIN_PATH_KERNELS = ("approx_add", "accumulate", "filter_chain")
FFT_PATH_KERNELS = ("fft_axis", "butterfly", "lut_add", "approx_add")
#: Most kernel launches (every kernel, by the profiler) one reconstruct
#: of 512 x 512 at block 16, N = 32, may make: the four axes and the
#: containers' glue.
RECONSTRUCT_MAX_LAUNCHES = 16


MAC_PATH_KERNELS = ("mul", "mac_matmul", "conv2d_mac", "approx_matmul")


def counters():
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import approx_matmul as mm_k
    from repro_torch.kernels import butterfly as bf_k
    from repro_torch.kernels import conv2d_mac as conv_k
    from repro_torch.kernels import conv_chain as chain_k
    from repro_torch.kernels import lut_add as lut_k
    from repro_torch.kernels import mac_matmul as mac_k
    from repro_torch.kernels import mul as mul_k
    return {"approx_add": add_k.approx_add, "accumulate": acc_k.accumulate,
            "filter_chain": chain_k.filter_chain, "lut_add": lut_k.lut_add,
            "butterfly": bf_k.butterfly, "fft_axis": bf_k.fft_axis,
            "mul": mul_k.mul,
            "mac_matmul": mac_k.mac_matmul, "conv2d_mac": conv_k.conv2d_mac,
            "approx_matmul": mm_k.approx_matmul}


def run_counted(torch, counts, kernels, fn, what):
    """Set every count to 0, run ``fn``, read the counts; fail unless each
    of ``kernels`` launched.  Returns (fn's result, the counts)."""
    for f in counts.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in counts.items()}
    log(f"  {what} on the card: {time.perf_counter() - t0:.1f} s, "
        f"launches {launches}")
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {what}")
    return out, launches


def kernel_events(torch, fn):
    """CUDA kernels one call of ``fn`` runs, counted by ``torch.profiler``
    (None when the profiler saw no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA)
    return n or None


def check_one_launch(torch, gbatch):
    """On the card the signed fold is one kernel, with no stack, mask,
    sign-extension or rounding kernel around it: sharpen's scaled_add on
    two (4, 1024, 1024) planes and downsample2x's accumulate_signed on
    the strided phases of one."""
    from repro_torch.ax import make_engine
    from repro_torch.numerics.fixed_point import FixedPointFormat
    eng = make_engine("haloc_axa", fmt=FixedPointFormat(16, 3))
    x = gbatch.to(torch.int32) << 3
    y = torch.roll(x, 1, dims=0)
    n_add = kernel_events(torch, lambda: eng.scaled_add(x, y, 2, -1))
    n_acc = kernel_events(torch, lambda: eng.accumulate_signed(phases(x),
                                                               shift=2))
    log(f"  kernels run by one scaled_add (sharpen's): {n_add}; by one "
        f"accumulate_signed (downsample2x's phases): {n_acc}")
    check(n_add in (1, None) and n_acc in (1, None),
          "scaled_add and accumulate_signed must be one launch each")


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


def run_fft_lut_path(torch, np, img, batch, backend=None, device=None,
                     corpus=True, fft_images=None):
    """The Fig-5 and lut slice through the entry points a user calls;
    returns the outputs and the corpus rows (None without ``corpus``).
    The fft_reconstruct workload runs on the first ``fft_images`` images
    of ``batch`` (all by default)."""
    from repro_torch.ax import make_engine
    from repro_torch.core.specs import TABLE1_KINDS, AdderSpec, paper_spec
    from repro_torch.image.fft import FixedFFTConfig, fft_fixed, to_fixed
    from repro_torch.image.pipeline import reconstruct
    from repro_torch.imgproc import get_workload, run_corpus
    from repro_torch.numerics.fixed_point import FixedPointFormat

    where = dict(backend=backend, device=device)
    outs = {}
    for kind in TABLE1_KINDS:
        outs[("reconstruct", kind, 16)] = reconstruct(img, paper_spec(kind),
                                                      block=16, **where)
    outs[("reconstruct", "haloc_axa", 0)] = reconstruct(
        img, paper_spec("haloc_axa"), block=0, **where)
    outs[("reconstruct n16m8k4", "haloc_axa", 16)] = reconstruct(
        img, AdderSpec("haloc_axa", 16, 8, 4), frac_bits=0, **where)
    # A transform past one block of the axis kernel: the per-stage route.
    cfg = FixedFFTConfig(spec=paper_spec("haloc_axa"), **where)
    x = np.random.default_rng(9).uniform(-255, 255, (N_IMAGES, 8192))
    outs[("fft_fixed n8192", "haloc_axa")] = torch.stack(fft_fixed(
        to_fixed(x, cfg), to_fixed(0 * x, cfg), cfg))
    outs[("fft_reconstruct", "haloc_axa")] = torch.as_tensor(
        get_workload("fft_reconstruct").run(batch[:fft_images],
                                            kind="haloc_axa", **where))
    eng16 = make_engine("haloc_axa", fmt=FixedPointFormat(16, 6),
                        strategy="lut", **where)
    x = eng16.tensor(batch).to(torch.int32)
    pair = torch.roll(x, 1, dims=0)
    outs[("lut add_signed n16",)] = eng16.add_signed(x << 6, pair << 6)
    eng32 = make_engine(paper_spec("haloc_axa"), strategy="lut", **where)
    rng = np.random.default_rng(5)
    a32, b32 = (rng.integers(0, 1 << 32, batch.shape, dtype=np.uint64)
                .astype(np.uint32).view(np.int32) for _ in range(2))
    outs[("lut add n32",)] = eng32.add(a32, b32)
    rows = run_corpus(batch=batch, include_fft=True,
                      workloads=("fft_reconstruct",), **where) \
        if corpus else None
    return outs, rows


def check_reconstruct_launches(torch, img, counts):
    """One reconstruct of the 512 x 512 image at block 16, N = 32: four
    fft_axis launches by the counters and no per-stage one, and at most
    RECONSTRUCT_MAX_LAUNCHES kernels in all by the profiler."""
    from repro_torch.core.specs import paper_spec
    from repro_torch.image.pipeline import reconstruct
    gimg = torch.as_tensor(img, device="cuda")
    spec = paper_spec("haloc_axa")
    reconstruct(gimg, spec)
    for f in counts.values():
        f.launches = 0
    reconstruct(gimg, spec)
    torch.cuda.synchronize()
    ours = {name: f.launches for name, f in counts.items() if f.launches}
    n_all = kernel_events(torch, lambda: reconstruct(gimg, spec))
    log(f"  launches per reconstruct({FFT_SIZE} x {FFT_SIZE}, block 16, "
        f"n32m10k5): the counters {ours}; every kernel, by the profiler: "
        f"{n_all if n_all is not None else 'not measured'}")
    check(ours == {"fft_axis": 4},
          f"reconstruct must run four fft_axis launches and no other "
          f"kernel of the port: {ours}")
    check(n_all is None or n_all <= RECONSTRUCT_MAX_LAUNCHES,
          f"reconstruct ran {n_all} kernels, more than "
          f"{RECONSTRUCT_MAX_LAUNCHES}")


def check_fft_outputs(torch, np, outs, cpu_outs):
    """The card's outputs equal the CPU path's (the fft_reconstruct batch
    on the image the CPU path ran: image 0)."""
    for key, want in cpu_outs.items():
        got = outs[key]
        check(got.device.type == "cuda" or key[0] == "fft_reconstruct",
              f"{key} did not run on the card")
        if key[0] == "fft_reconstruct":
            got = got[:want.shape[0]]
        check(tuple(got.shape) == tuple(want.shape)
              and torch.equal(got.cpu(), want),
              f"{key}: the card's output differs from the CPU path")


def check_ordering(np, img, recs, what):
    """PSNR/SSIM per kind; fail unless the paper's ordering holds (Fig 5/6,
    as ``tests/test_image.py`` asserts it)."""
    from repro_torch.image.quality import psnr, ssim
    s = {}
    for kind, rec in recs.items():
        s[kind] = ssim(img, rec)
        log(f"    {kind:10s} PSNR {psnr(img, rec):8.4f} dB  SSIM {s[kind]:.6f}")
    held = (s["herloa"] > s["haloc_axa"] > s["loa"]
            and s["m_herloa"] > s["haloc_axa"] and s["loa"] > s["loawa"]
            and abs(s["loa"] - s["oloca"]) < 0.08 and s["haloc_axa"] > 0.7)
    log(f"    paper ordering HERLOA ~ M-HERLOA > HALOC-AxA > LOA ~ OLOCA > "
        f"LOAWA {'holds' if held else 'does NOT hold'} ({what})")
    return held


def gemm_operands(torch, np):
    """The GEMM cell's int8 operands, (1024, 1024) each, from a seed."""
    rng = np.random.default_rng(8)
    return tuple(torch.as_tensor(rng.integers(-128, 128,
                                              (GEMM_SIZE, GEMM_SIZE),
                                              dtype=np.int8))
                 for _ in range(2))


def run_mac_path(torch, np, batch, a8, b8, backend=None, device=None,
                 corpus=True):
    """The MAC slice through the entry points a user calls; returns the
    outputs (tensors on the engine's device, the conv3x3 batches as host
    arrays) and the corpus rows (None without ``corpus``).  The GEMMs run
    on ``a8``'s rows, whichever they are."""
    from repro_torch.ax import make_engine
    from repro_torch.core.specs import TABLE1_KINDS
    from repro_torch.imgproc import get_workload, run_corpus
    from repro_torch.numerics.fixed_point import FixedPointFormat

    where = dict(backend=backend, device=device)
    outs = {}
    wl = get_workload("conv3x3")
    for kind in TABLE1_KINDS:
        outs[("conv3x3", kind)] = torch.as_tensor(wl.run(batch, kind=kind,
                                                         **where))
    fmt = FixedPointFormat(16, 0)
    for ms in mul_specs():
        eng = make_engine(spec_at("haloc_axa", 16), fmt=fmt, mul=ms, **where)
        x = eng.tensor(batch).to(torch.int32)
        pair = torch.roll(x, 1, dims=0)
        outs[("mul", ms.short_name)] = eng.mul(x, pair)
        outs[("mul_signed", ms.short_name)] = eng.mul_signed(x - 128,
                                                             128 - pair)
    for n_bits in (32, 16):
        spec = spec_at("haloc_axa", n_bits)
        for ms in (None, mul_specs()[0]):
            eng = make_engine(spec, mul=ms, **where)
            outs[("matmul", spec.short_name, str(ms))] = eng.matmul(
                a8, b8, block=(GEMM_BK, GEMM_BK, GEMM_BK))
    rows = run_corpus(batch=batch, workloads=("conv3x3",), **where) \
        if corpus else None
    return outs, rows


def check_mac_outputs(torch, outs, cpu_outs):
    """The card's outputs equal the CPU path's (the GEMMs on the rows the
    CPU path ran)."""
    for key, want in cpu_outs.items():
        got = outs[key]
        if key[0] == "conv3x3":
            got = got.cpu()
        else:
            check(got.device.type == "cuda", f"{key} did not run on the card")
            got = got[:want.shape[0]].cpu()
        check(tuple(got.shape) == tuple(want.shape)
              and torch.equal(got, want),
              f"{key}: the card's output differs from the CPU path")


# ------------------------------------------------------------ phase 4d --

#: Monte-Carlo samples of the cross-check on the card (the paper's), and of
#: the card-against-CPU comparison; the |z| the cross-check allows.
MC_SAMPLES, MC_CPU_SAMPLES, MC_Z_BOUND = 10_000_000, 1_000_000, 4.0
#: The Fig-6 specs whose exact reports and hardware reports phase 4d also
#: computes on the CPU (the card runs all of them).
FIG6_CPU_MAX_LSM = 8
#: engine.sum's cell: the last axis of a (4, 1024, 1024) signed N=16 batch.
SUM_SHAPE = (N_IMAGES, FULL_SIZE, FULL_SIZE)
SUM_LEVELS = (SUM_SHAPE[-1] - 1).bit_length()
TABLE1_PATH_KERNELS = ("approx_add", "lut_add")


def golden_rows():
    """``BENCH_table1.json``'s ``table1/<kind>`` rows, its ``pareto`` rows
    keyed by (N, kind, m, k), and ``BENCH_mac.json``'s ``pareto_mul`` rows
    keyed by (kind, N, t, v): the reference's results, committed."""
    t1 = json.loads((ROOT / "BENCH_table1.json").read_text())
    mac = json.loads((ROOT / "BENCH_mac.json").read_text())
    table1 = {r["op"].split("/", 1)[1]: r for r in t1
              if r["op"].startswith("table1/")}
    pareto = {(r["N"], r["kind"], r["m"], r["k"]): r for r in t1
              if r["op"] == "pareto"}
    pareto_mul = {(r["kind"], r["N"], r["t"], r["v"]): r for r in mac
                  if r["op"] == "pareto_mul"}
    return table1, pareto, pareto_mul


def error_row(rep):
    return {"med": rep.med, "mred": rep.mred, "nmed": rep.nmed,
            "er": rep.error_rate, "wce": rep.wce}


def hw_row(hw):
    return {"transistors": hw.transistors, "energy_fj": hw.energy_fj,
            "delay_ns": hw.delay_ns}


def check_rows(got, want, what):
    """Every (key, field) of ``got`` equals ``want``'s, exactly; fails on
    the first difference, naming it."""
    check(set(got) == set(want),
          f"{what}: {len(got)} rows on the card against {len(want)} in the "
          f"golden file; first missing: "
          f"{sorted(set(want) ^ set(got), key=str)[:1]}")
    for key in sorted(got, key=str):
        for field, value in got[key].items():
            check(value == want[key][field],
                  f"{what} {key} {field}: the card gives {value!r}, the "
                  f"golden file {want[key][field]!r}")
    return len(got)


def pareto_key(spec, get_adder):
    m = 0 if get_adder(spec.kind).is_exact else spec.lsm_bits
    return (spec.n_bits, spec.kind, m, spec.effective_const_bits)


def mul_key(spec):
    return (spec.kind, spec.n_bits, spec.effective_trunc_bits,
            spec.effective_row_bits)


def fig6_rows(specs, mul_specs, device, get_adder):
    """The Fig-6 adder rows (exact error, cache_tables=False, and hardware
    report) and multiplier rows on ``device``, keyed as the golden files."""
    from repro_torch.ax import analytics as an
    from repro_torch.core import hwcost
    reps = an.exact_error_metrics_sweep(specs, cache_tables=False,
                                        device=device)
    adders = {pareto_key(s, get_adder): {
        **error_row(r), **hw_row(hwcost.report(s, device=device))}
        for s, r in zip(specs, reps)}
    mreps = an.exact_mul_error_metrics_sweep(mul_specs, cache_tables=False,
                                             device=device)
    muls = {mul_key(s): {**error_row(r),
                         **hw_row(hwcost.mul_report(s, device=device))}
            for s, r in zip(mul_specs, mreps)}
    return adders, muls


def z_scores(mc, ex, mo):
    """(z MED, z MRED, z ER) of a Monte-Carlo report against the exact
    population values, in exact standard errors (as
    ``benchmarks/table1_error.py``'s ``_validate``)."""
    import math
    n = mc.n_samples
    er_var = ex.error_rate * (1.0 - ex.error_rate)
    return ((mc.med - ex.med) / math.sqrt(mo.var_ed / n),
            (mc.mred - ex.mred) / math.sqrt(mo.var_red / n),
            (mc.error_rate - ex.error_rate) / math.sqrt(er_var / n))


def check_monte_carlo(torch, np, dev, specs, exact, moments):
    """The cross-check at 10^7 samples on the card, both strategies: every
    |z| <= 4 and WCE <= the exact WCE (the accurate adder's report is
    zero); the card's reports equal the port's CPU path at 10^6 samples
    on the same seed, MRED included (summed in numpy's order).  Logs each
    strategy's Msamples/s and the share of its wall time spent drawing
    operands on the host and copying them to the card."""
    from repro_torch.core import metrics
    for strategy in ("reference", "lut"):
        metrics.simulate_error_metrics_sweep(specs, n_samples=1_000,
                                             strategy=strategy, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = metrics.simulate_error_metrics_sweep(
            specs, n_samples=MC_SAMPLES, strategy=strategy, device=dev)
        wall = time.perf_counter() - t0
        # the sweep's own chunk: one distinct m, and the accurate adder
        # (or every spec) off the table
        chunk = metrics._auto_chunk(len(specs), 1, True, specs[0].n_bits)
        t0 = time.perf_counter()
        for a, _ in metrics.operand_stream(np.random.default_rng(2025),
                                           MC_SAMPLES, chunk,
                                           specs[0].n_bits, dev):
            pass
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        log(f"  Monte Carlo, {strategy} strategy, {MC_SAMPLES:.0e} samples x "
            f"{len(specs)} kinds on the card: {wall * 1e3:.1f} ms = "
            f"{MC_SAMPLES / wall / 1e6:.1f} Msamples/s; drawing the operands "
            f"and copying them to the card alone: {host * 1e3:.1f} ms "
            f"({host / wall:.2f} of the wall time)")
        worst = 0.0
        for spec, mc in zip(specs, reports):
            ex, mo = exact[spec], moments[spec]
            if mo.var_ed == 0.0:
                check((mc.med, mc.error_rate, mc.wce) == (0.0, 0.0, 0),
                      f"Monte Carlo {strategy} {spec.kind}: an exact adder "
                      f"has error {mc}")
                continue
            zs = z_scores(mc, ex, mo)
            worst = max(worst, *(abs(z) for z in zs))
            log(f"    {spec.kind:10s} z(MED) {zs[0]:+6.2f} z(MRED) "
                f"{zs[1]:+6.2f} z(ER) {zs[2]:+6.2f}  WCE {mc.wce} <= "
                f"{ex.wce}")
            check(max(abs(z) for z in zs) <= MC_Z_BOUND and mc.wce <= ex.wce,
                  f"Monte Carlo {strategy} {spec.kind} deviates from the "
                  f"exact values: z {zs}, WCE {mc.wce} > {ex.wce}")
        log(f"    worst |z| = {worst:.2f} (bound {MC_Z_BOUND})")
        card = metrics.simulate_error_metrics_sweep(
            specs, n_samples=MC_CPU_SAMPLES, strategy=strategy, device=dev)
        cpu = metrics.simulate_error_metrics_sweep(
            specs, n_samples=MC_CPU_SAMPLES, strategy=strategy, device="cpu")
        for g, w in zip(card, cpu):
            check((g.med, g.mred, g.nmed, g.error_rate, g.wce) ==
                  (w.med, w.mred, w.nmed, w.error_rate, w.wce),
                  f"Monte Carlo {strategy} {g.spec.kind} at "
                  f"{MC_CPU_SAMPLES:.0e}: the card's report {g} differs "
                  f"from the CPU path's {w}")
        log(f"    at {MC_CPU_SAMPLES:.0e} samples the card's reports equal "
            f"the CPU path's (MED, MRED, NMED, ER, WCE)")


def run_table1_path(torch, np, dev):
    """The engine methods of this slice's path on the card, reference and
    lut strategies: ``engine.sum`` over the last axis of a (4, 1024,
    1024) signed N=16 batch and ``residual_add`` on float planes of that
    shape.  Returns {(what, strategy): output}."""
    from repro_torch.ax import make_engine
    from repro_torch.core.specs import AdderSpec
    from repro_torch.numerics.fixed_point import FixedPointFormat
    fmt = FixedPointFormat(16, 8)
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    rng = np.random.default_rng(17)
    q = torch.as_tensor(rng.integers(fmt.min_int, fmt.max_int + 1,
                                     SUM_SHAPE).astype(np.int32), device=dev)
    x = torch.as_tensor(rng.standard_normal(SUM_SHAPE, np.float32),
                        device=dev)
    y = torch.as_tensor(rng.standard_normal(SUM_SHAPE, np.float32),
                        device=dev)
    outs = {}
    for strategy in ("reference", "lut"):
        eng = make_engine(spec, fmt=fmt, strategy=strategy, device=dev)
        outs[("sum", strategy)] = eng.sum(q)
        outs[("residual_add", strategy)] = eng.residual_add(x, y)
    return outs, (q, x, y)


def check_table1_path(torch, outs, inputs):
    """The card's sum and residual_add equal the port's CPU path; the
    straight-through gradients are all ones."""
    from repro_torch.ax import make_engine
    from repro_torch.core.specs import AdderSpec
    from repro_torch.numerics.fixed_point import FixedPointFormat
    fmt = FixedPointFormat(16, 8)
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    q, x, y = (t.cpu() for t in inputs)
    for strategy in ("reference", "lut"):
        eng = make_engine(spec, fmt=fmt, backend="torch", device="cpu",
                          strategy=strategy)
        want = {"sum": eng.sum(q), "residual_add": eng.residual_add(x, y)}
        for what, w in want.items():
            check(torch.equal(outs[(what, strategy)].cpu(), w),
                  f"engine.{what} ({strategy}) on the card differs from the "
                  f"CPU path")
    gx = x.to(outs[("sum", "lut")].device).requires_grad_()
    gy = y.to(gx.device).requires_grad_()
    eng = make_engine(spec, fmt=fmt, device=gx.device)
    eng.residual_add(gx, gy).sum().backward()
    check(bool((gx.grad == 1).all()) and bool((gy.grad == 1).all()),
          "residual_add's gradients on the card are not all ones")


def table1_phase(torch, np, dev, counts, card):
    """Phase 4d: Table 1, the Fig-6 design space and the Monte-Carlo
    cross-check on the card, held against the golden files and the CPU
    path; returns the launches of this slice's path."""
    from repro_torch.ax import analytics as an
    from repro_torch.ax import get_adder
    from repro_torch.core import hwcost
    from repro_torch.core.specs import table1_specs
    table1, pareto, pareto_mul = golden_rows()
    specs = list(table1_specs())

    t0 = time.perf_counter()
    exact = dict(zip(specs, an.exact_error_metrics_sweep(specs, device=dev)))
    cold = time.perf_counter() - t0
    sweep_s = time_wall(torch, lambda: an.exact_error_metrics_sweep(
        specs, device=dev), 5)
    moments = {s: an.exact_error_moments(s, device=dev) for s in specs}
    got = {s.kind: error_row(exact[s]) for s in specs if s.kind != "accurate"}
    check_rows(got, {k: table1[k] for k in got}, "Table 1")
    check(error_row(exact[specs[0]]) == {"med": 0.0, "mred": 0.0,
                                         "nmed": 0.0, "er": 0.0, "wce": 0},
          f"Table 1 accurate: {exact[specs[0]]} is not the zero report")
    for s in specs:
        check(exact[s] == an.exact_error_metrics(s, device="cpu")
              and moments[s] == an.exact_error_moments(s, device="cpu"),
              f"Table 1 {s.kind}: the card's report or moments differ from "
              f"the CPU path's")
    log(f"  Table 1, exact (N=32, m=10, k=5), on the card: the 6 rows equal "
        f"BENCH_table1.json and the CPU path; sweep {cold * 1e3:.1f} ms cold"
        f", {sweep_s * 1e3:.2f} ms warm (median of 5), {card}")
    log(f"    {'adder':10s} {'MED':>9s} {'MRED':>10s} {'ER':>7s} {'WCE':>5s}"
        f" {'var ED':>10s} {'trans':>6s} {'E fJ':>7s} (paper) {'ns':>5s} "
        f"{'P uW':>7s} (paper)")
    for s in specs:
        r, mo = exact[s], moments[s]
        hw = hwcost.report(s, device=dev)
        p = hwcost.PAPER_TABLE1[s.kind]
        log(f"    {s.kind:10s} {r.med:9.3f} {r.mred:10.3e} "
            f"{r.error_rate:7.4f} {r.wce:5d} {mo.var_ed:10.1f} "
            f"{hw.transistors:6d} {hw.energy_fj:7.2f} ({p['energy_fj']:5.2f})"
            f" {hw.delay_ns:5.3f} {hw.power_uw:7.2f} ({p['power_uw']:6.2f})")

    design = an.design_space((8, 16, 32))
    mul_design = an.mul_design_space((8,))
    check(len(design) == 672 and len(mul_design) == 61,
          f"design spaces of {len(design)} and {len(mul_design)} specs")
    t0 = time.perf_counter()
    adders, muls = fig6_rows(design, mul_design, dev, get_adder)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    n = check_rows(adders, pareto, "Fig 6 adders")
    n_mul = check_rows(muls, pareto_mul, "Fig 6 multipliers")
    t0 = time.perf_counter()
    small = [s for s in design
             if get_adder(s.kind).is_exact or s.lsm_bits <= FIG6_CPU_MAX_LSM]
    cpu_adders, cpu_muls = fig6_rows(small, mul_design, "cpu", get_adder)
    check(all(adders[k] == v for k, v in cpu_adders.items())
          and cpu_muls == muls,
          "Fig 6: a row of the card differs from the CPU path's")
    log(f"  Fig 6 on the card: {n} adder rows (N = 8, 16, 32; m <= 12) and "
        f"{n_mul} multiplier rows (N = 8) equal BENCH_table1.json and "
        f"BENCH_mac.json on every field, exact and hardware: {cold:.2f} s "
        f"cold; the CPU path agrees on the {len(cpu_adders)} adder specs "
        f"with m <= {FIG6_CPU_MAX_LSM} and all multipliers "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")

    def sweep():
        an.exact_error_metrics_sweep(design, cache_tables=False, device=dev)

    wall = time_wall(torch, sweep, 3)
    log(f"  exact sweep of the {len(design)} adder specs (cache_tables=False) "
        f"on the card: {wall:.3f} s wall (median of 3), {card}")
    profile_calls(torch, sweep, wall, f"{len(design)}-spec exact sweep",
                  calls=1, top=8)
    for n_bits in (8, 16, 32):
        part = [s for s in design if s.n_bits == n_bits]
        sec = time_wall(torch, lambda: an.exact_error_metrics_sweep(
            part, cache_tables=False, device=dev), 1)
        log(f"    the {len(part)} specs at N={n_bits} alone "
            f"({'compose' if n_bits <= an.MAX_COMPOSE_BITS else 'closed'} "
            f"MRED): {sec:.3f} s")

    check_monte_carlo(torch, np, dev, specs, exact, moments)

    (outs, inputs), launches = run_counted(
        torch, counts, TABLE1_PATH_KERNELS,
        lambda: run_table1_path(torch, np, dev), "Table-1 engine path")
    for name in TABLE1_PATH_KERNELS:
        check(launches[name] == SUM_LEVELS + 1,
              f"engine.sum over {SUM_SHAPE[-1]} ({SUM_LEVELS} levels) and one "
              f"residual_add should be {SUM_LEVELS + 1} {name} launches; got "
              f"{launches[name]}")
    check_table1_path(torch, outs, inputs)
    log(f"  engine.sum over the last axis of {SUM_SHAPE} ({SUM_LEVELS} "
        f"levels) and "
        f"residual_add on the card equal the CPU path (reference and lut); "
        f"residual_add's gradients are all ones")
    return launches


# ------------------------------------------------------------ phase 4e --

#: The streamed, faulted and traced path: the stock three-stage chain on
#: 4 x 1024 x 1024 batches.
STREAM_STAGES = ("gaussian_blur", "sharpen", "downsample2x")
STREAM_BATCHES, STREAM_DEPTHS = 8, (1, 2)
#: The telemetry rule of ``benchmarks/check_overhead.py``: the disabled
#: overhead, less the rounds' jitter, at most 2 %.
OVERHEAD_BOUND_PCT, OVERHEAD_ROUNDS, OVERHEAD_REPS = 2.0, 12, 10
OVERHEAD_TILE = (256, 256)
#: The kernels the faulted and streamed path runs (lut_add: faulted
#: ``add_signed`` under the lut strategy).
FAULT_PATH_KERNELS = ("accumulate", "filter_chain", "approx_add", "lut_add")
#: The spans a traced stream must record.
TRACE_SPANS = ("plan:call", "stage:", "tiles:dispatch", "stream:dispatch",
               "stream:drain")
#: Provenance fields of a committed record (not results).
PROVENANCE = ("host_platform", "jax_version", "device_kind", "backend")


def committed_fault_records():
    """``BENCH_faults.json``'s ``fault_curve`` records keyed by (fault,
    bits, rate, seed), and its ``fault_recovery`` record."""
    recs = json.loads((ROOT / "BENCH_faults.json").read_text())
    curves = {(r["fault"], r["bits"], r["rate"], r["seed"]): r
              for r in recs if r["op"] == "fault_curve"}
    recovery = [r for r in recs if r["op"] == "fault_recovery"]
    check(len(curves) == 4 and len(recovery) == 1,
          f"BENCH_faults.json: {len(curves)} fault_curve and "
          f"{len(recovery)} fault_recovery records")
    return curves, recovery[0]


def drive_fault_path(torch, np, batches, gbatch, rec_batches):
    """Phase 4e's path through the entry points a user calls: streams of
    ``batches`` at each depth and requant mode, the committed quick
    campaign and recovery cell, the full fault grid on ``gbatch`` (both
    requant modes, and ``add_signed`` under the reference and lut
    strategies), and the full-width recovery stream with its healthy and
    unmitigated twins.  Returns what it produced."""
    from repro_torch import obs
    from repro_torch.ax import make_engine
    from repro_torch.imgproc import compile_pipeline, run_streaming
    from repro_torch.numerics.fixed_point import FixedPointFormat
    from repro_torch.resilience import (DegradePolicy, FaultSpec,
                                        default_campaign_faults,
                                        recovery_cell, run_campaign)
    out = {"streams": {}, "grid": {}}
    for requant in ("stage", "fused"):
        pipe = compile_pipeline(STREAM_STAGES, requant=requant)
        for depth in STREAM_DEPTHS:
            out["streams"][requant, depth] = run_streaming(pipe, batches,
                                                           depth=depth)
    out["campaign"] = run_campaign(quick=True, backend="cuda")
    out["recovery"] = recovery_cell(backend="cuda")
    x = gbatch.to(torch.int32) << 6
    pair = torch.roll(x, 1, dims=0)
    for fault in (None,) + default_campaign_faults():
        for requant in ("stage", "fused"):
            out["grid"]["pipe", requant, fault] = compile_pipeline(
                STREAM_STAGES, requant=requant, fault=fault)(gbatch)
        for strategy in ("reference", "lut"):
            eng = make_engine("haloc_axa", fmt=FixedPointFormat(16, 6),
                              strategy=strategy, fault=fault)
            out["grid"]["add_signed", strategy, fault] = \
                eng.add_signed(x, pair)
    sa1 = FaultSpec("stuck_at_1", (11,))
    faulted = compile_pipeline(STREAM_STAGES, fault=sa1)
    healthy = compile_pipeline(STREAM_STAGES)
    with obs.telemetry(True):
        policy = DegradePolicy(faulted, min_samples=512)
        out["degraded"] = run_streaming(faulted, rec_batches, depth=2,
                                        degrade=policy)
    out["policy"] = policy
    out["healthy"] = run_streaming(healthy, rec_batches, depth=2)
    out["unmitigated"] = [faulted(b).cpu().numpy() for b in rec_batches]
    return out


def check_streams(torch, np, streams, batches):
    """Every stream's outputs, in order, equal the pipeline called one
    batch at a time on the card; the first image of the first batch
    equals the CPU path."""
    from repro_torch.imgproc import compile_pipeline
    for requant in ("stage", "fused"):
        pipe = compile_pipeline(STREAM_STAGES, requant=requant)
        seq = [pipe(b).cpu().numpy() for b in batches]
        cpu = compile_pipeline(STREAM_STAGES, requant=requant,
                               backend="torch", device="cpu")
        check(np.array_equal(cpu(batches[0][:1]).numpy(), seq[0][:1]),
              f"the {requant} chain's first image differs from the CPU path")
        for depth in STREAM_DEPTHS:
            res = streams[requant, depth]
            check(res.failed == res.retried == res.degraded == ()
                  and len(res.outputs) == len(seq)
                  and all(np.array_equal(g, w)
                          for g, w in zip(res.outputs, seq)),
                  f"run_streaming {requant} depth {depth}: the outputs "
                  f"differ from the sequential calls")


def check_committed_faults(out):
    """The quick campaign's four cells and the recovery cell on the card
    equal ``BENCH_faults.json`` (psnr and ssim; every field of the
    recovery record but provenance)."""
    curves, recovery = committed_fault_records()
    cells = out["campaign"]
    check(len(cells) == len(curves), f"{len(cells)} campaign cells")
    for c in cells:
        r = c.record()
        want = curves[(r["fault"], r["bits"], r["rate"], r["seed"])]
        check((r["psnr"], r["ssim"]) == (want["psnr"], want["ssim"]),
              f"fault_curve {r['fault']} [{r['bits']}] r{r['rate']}: the "
              f"card gives psnr {r['psnr']!r} ssim {r['ssim']!r}, "
              f"BENCH_faults.json {want['psnr']!r} {want['ssim']!r}")
    got = {k: v for k, v in out["recovery"].items() if k not in PROVENANCE}
    want = {k: v for k, v in recovery.items() if k not in PROVENANCE}
    check(got == want, f"fault_recovery on the card {got} != "
          f"BENCH_faults.json {want}")
    return cells, got


def check_fault_grid(torch, np, grid, batch):
    """Every output of the campaign grid (the clean cell and the faults)
    has its first image equal to the CPU path on that image alone (the
    flip sites depend on the trailing two dims only), and each defect
    changes the chains' output."""
    from repro_torch.ax import make_engine
    from repro_torch.imgproc import compile_pipeline
    from repro_torch.numerics.fixed_point import FixedPointFormat
    x0 = torch.as_tensor(batch[:1]).to(torch.int32) << 6
    pair0 = torch.as_tensor(np.roll(batch, 1, axis=0)[:1]).to(
        torch.int32) << 6
    healthy = {}
    for key, got in grid.items():
        what, mode, fault = key
        check(got.device.type == "cuda", f"{key} did not run on the card")
        if what == "pipe":
            cpu = compile_pipeline(STREAM_STAGES, requant=mode, fault=fault,
                                   backend="torch", device="cpu")(batch[:1])
        else:
            cpu = make_engine("haloc_axa", fmt=FixedPointFormat(16, 6),
                              strategy=mode, fault=fault, backend="torch",
                              device="cpu").add_signed(x0, pair0)
        name = "clean" if fault is None else fault.short_name
        check(torch.equal(got[:1].cpu(), cpu),
              f"{what} {mode} {name}: the card's first image differs from "
              f"the CPU path on it")
        if fault is None:
            healthy[what, mode] = cpu
    # (a stuck-at on an add's constant-one bits, sa1[3] at k = 4, is a
    # no-op there, so only the chains are held to change)
    for (what, mode, fault), got in grid.items():
        if what == "pipe" and fault is not None:
            check(not torch.equal(got[:1].cpu(), healthy[what, mode]),
                  f"{what} {mode} {fault.short_name} changes nothing")


def check_recovery(torch, np, out, rec_batches):
    """The full-width recovery stream: the policy tripped, every degraded
    output is its fallback plan's on the card, and the fallback wins
    back at least 5 dB over serving the fault.  Returns (dB without, dB
    with)."""
    from repro_torch.image.quality import psnr
    from repro_torch.imgproc import get_workload
    res, policy = out["degraded"], out["policy"]
    check(policy.trips >= 1 and res.failed == () and res.degraded,
          f"the full-width recovery stream did not degrade: {policy}")
    for i in res.degraded:
        check(np.array_equal(res.outputs[i],
                             policy.pipe(rec_batches[i]).cpu().numpy()),
              f"degraded batch {i} is not its fallback plan's output")
    wl = get_workload("pipe_blur_sharpen_down")
    refs = [wl.reference(b) for b in rec_batches]

    def mean_psnr(outs):
        return float(np.mean([psnr(r, o) for ref, got in zip(refs, outs)
                              for r, o in zip(ref, got)]))

    without, with_fb = mean_psnr(out["unmitigated"]), mean_psnr(res.outputs)
    check(with_fb - without >= 5.0,
          f"the fallback recovers {with_fb - without:.2f} dB (< 5)")
    return without, with_fb


def stream_idle(torch, fn, wall_s):
    """The device's busy us over one call of ``fn`` (a whole stream) by
    ``torch.profiler``, kernels and copies, and its idle share against
    the unprofiled wall ``wall_s``; (None, None) when the profiler saw no
    device time."""
    times = device_times(torch, fn, 1)
    if not times:
        return None, None
    busy = sum(us for us, _ in times.values())
    return busy, 1.0 - busy / (wall_s * 1e6)


def time_overhead(torch, obs, tiled, gbatch):
    """``benchmarks/check_overhead.py``'s rule on the port, in one
    process: the tiled executor's ``raw`` loop, the executor with
    telemetry off and with it on, rounds interleaved; best-of-rounds
    seconds a call, the jitter (spread over best) and the overhead
    against ``raw``."""
    configs = (("baseline-raw", tiled.raw, False),
               ("telemetry-off", tiled, False),
               ("telemetry-on", tiled, True))
    rounds = {label: [] for label, _, _ in configs}
    for label, fn, flag in configs:
        with obs.telemetry(flag):
            fn(gbatch)
    torch.cuda.synchronize()
    for _ in range(OVERHEAD_ROUNDS):
        for label, fn, flag in configs:
            with obs.telemetry(flag):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(OVERHEAD_REPS):
                    fn(gbatch)
                torch.cuda.synchronize()
                rounds[label].append((time.perf_counter() - t0)
                                     / OVERHEAD_REPS)
    obs.reset_all()
    best = {k: min(v) for k, v in rounds.items()}
    return {k: (best[k], (max(v) - best[k]) / best[k] * 100,
                (best[k] / best["baseline-raw"] - 1.0) * 100)
            for k, v in rounds.items()}


def faults_phase(torch, np, dev, counts, card):
    """Phase 4e: streaming, telemetry and faults at full width on the card,
    held against sequential calls, the CPU path and ``BENCH_faults.json``;
    returns the launches of the path."""
    from repro_torch import obs
    from repro_torch.imgproc import (compile_pipeline, compile_tiled,
                                     run_streaming, synthetic_batch)
    from repro_torch.core.specs import AdderSpec
    from repro_torch.resilience import FaultSpec, pareto_ladder
    t0 = time.perf_counter()
    ladder = pareto_ladder(AdderSpec("haloc_axa", 16, 8, 4), dev)
    log(f"  pareto_ladder(haloc_axa n16m8k4) first use on the card: "
        f"{time.perf_counter() - t0:.3f} s, {len(ladder)} rungs "
        f"({ladder[0].short_name} first), {card}")
    batches = [synthetic_batch(N_IMAGES, FULL_SIZE, i)
               for i in range(STREAM_BATCHES)]
    rec_batches = [synthetic_batch(N_IMAGES, FULL_SIZE, 1000 * i)
                   for i in range(3)]
    gbatch = torch.as_tensor(batches[0], device=dev)
    for requant in ("stage", "fused"):   # pinned buffers and plans warm
        run_streaming(compile_pipeline(STREAM_STAGES, requant=requant),
                      batches[:2], depth=2)
    out, launches = run_counted(
        torch, counts, FAULT_PATH_KERNELS,
        lambda: drive_fault_path(torch, np, batches, gbatch, rec_batches),
        "streamed and faulted path")

    check_streams(torch, np, out["streams"], batches)
    mpix = batches[0].size * STREAM_BATCHES / 1e6
    log(f"  run_streaming, {STREAM_BATCHES} batches of {batches[0].shape} "
        f"({mpix:.1f} MPix), outputs in order equal to one call a batch on "
        f"the card, the first image equal to the CPU path; {card}:")
    for requant in ("stage", "fused"):
        pipe = compile_pipeline(STREAM_STAGES, requant=requant)
        for depth in STREAM_DEPTHS:
            res = out["streams"][requant, depth]
            busy, idle = stream_idle(
                torch, lambda: run_streaming(pipe, batches, depth=depth),
                res.seconds)
            log(f"    requant={requant} depth={depth}: {res.mpix_per_s:.1f} "
                f"MPix/s, {res.seconds * 1e3:.1f} ms; per batch p50 "
                f"{res.p50_s * 1e3:.3f} p95 {res.p95_s * 1e3:.3f} p99 "
                f"{res.p99_s * 1e3:.3f} ms; device busy "
                + ("not measured (the profiler saw no device time)"
                   if busy is None else
                   f"{busy / 1e3:.2f} ms, idle share {idle:.3f}"))

    cells, rec = check_committed_faults(out)
    log(f"  run_campaign(quick=True, backend='cuda') at 2 x 64 x 64: the "
        f"{len(cells)} cells equal BENCH_faults.json's fault_curve records "
        f"(psnr, ssim); recovery_cell(backend='cuda') equals its "
        f"fault_recovery record: fallback {rec['fallback_to']}, "
        f"{rec['trips']} trip, {rec['batches_degraded']} batches degraded, "
        f"{rec['psnr_nofallback']:.3f} -> {rec['psnr_fallback']:.3f} dB")

    batch = batches[0]
    check_fault_grid(torch, np, out["grid"], batch)
    log(f"  the full campaign grid at full width, {len(out['grid'])} "
        f"outputs (the clean cell and 6 faults x the stage and fused "
        f"chains and add_signed, reference and lut strategies), equal the "
        f"CPU path on their first image; every fault changes the chains")
    sa1 = FaultSpec("stuck_at_1", (11,))
    flip = FaultSpec("bit_flip", (3, 11), rate=2 ** -5)
    healthy = compile_pipeline(STREAM_STAGES)
    t_h = time_wall(torch, lambda: healthy(gbatch))
    for fault in (sa1, flip):
        pipe = compile_pipeline(STREAM_STAGES, fault=fault)
        t_f = time_wall(torch, lambda: pipe(gbatch))
        log(f"    stage-mode chain on {tuple(gbatch.shape)}: "
            f"{fault.short_name} {t_f * 1e3:.3f} ms against healthy "
            f"{t_h * 1e3:.3f} ms (wall, median of 10)")

    without, with_fb = check_recovery(torch, np, out, rec_batches)
    pol, res, ok = out["policy"], out["degraded"], out["healthy"]
    log(f"  recovery at full width, 3 batches of {batch.shape} under "
        f"{sa1.short_name}, depth 2, DegradePolicy on a 32 x 32 CPU shadow: "
        f"{pol.trips} trip, fell back to {pol.pipe.engine.spec.short_name}, "
        f"{without:.3f} -> {with_fb:.3f} dB (+{with_fb - without:.3f}); "
        f"stream {res.mpix_per_s:.1f} MPix/s against the healthy stream's "
        f"{ok.mpix_per_s:.1f}")

    pipe = compile_pipeline(STREAM_STAGES, requant="fused")
    tiled = compile_tiled(pipe, tuple(gbatch.shape), OVERHEAD_TILE)
    over = time_overhead(torch, obs, tiled, gbatch)
    for label, (best, jitter, pct) in over.items():
        log(f"  telemetry {label:14s} {best * 1e3:8.3f} ms a tiled "
            f"{OVERHEAD_TILE} call, jitter {jitter:.2f} %, overhead "
            f"{pct:+.2f} %")
    effective = over["telemetry-off"][2] - max(over["telemetry-off"][1],
                                                over["baseline-raw"][1])
    check(effective <= OVERHEAD_BOUND_PCT,
          f"disabled telemetry costs {effective:+.2f} % after jitter "
          f"(bound {OVERHEAD_BOUND_PCT} %)")
    log(f"    disabled overhead after jitter: {effective:+.2f} % (bound "
        f"{OVERHEAD_BOUND_PCT} %), {card}")

    obs.reset_all()
    with obs.telemetry(True):
        run_streaming(pipe, batches, depth=2)
        host = {name: [e.dur for e in obs.get_tracer().events
                       if e.name == name]
                for name in ("stream:dispatch", "stream:drain")}
        run_streaming(tiled, batches[:2], depth=2)
    log(f"  host time a batch in the traced fused stream at depth 2 "
        f"(spans, mean of {len(host['stream:dispatch'])}): dispatch "
        f"(staging and launches) "
        f"{np.mean(host['stream:dispatch']) * 1e3:.3f} ms, drain (the "
        f"event wait and the host copy) "
        f"{np.mean(host['stream:drain']) * 1e3:.3f} ms")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    trace = obs.export_chrome_trace(str(out_dir / "obs_trace.json"))
    metrics = obs.write_metrics(str(out_dir / "obs_metrics.json"))
    names = {e["name"] for e in json.loads(pathlib.Path(trace).read_text())
             ["traceEvents"]}
    for span in TRACE_SPANS:
        check(any(n.startswith(span) for n in names),
              f"the exported trace names no {span} span")
    snap = json.loads(pathlib.Path(metrics).read_text())
    check(snap["counters"].get("stream.batches") == STREAM_BATCHES + 2
          and snap["counters"].get("tiles.dispatches") == 2,
          f"the metrics JSON counts {snap['counters']}")
    log(f"  traced streams: {len(names)} span names in "
        f"{pathlib.Path(trace).relative_to(ROOT)} (plan:call, stage:*, "
        f"tiles:dispatch, stream:dispatch, stream:drain among them), "
        f"metrics in {pathlib.Path(metrics).relative_to(ROOT)}")
    obs.reset_all()
    return launches


# ------------------------------------------------------------ phase 4f --

#: The served cell: requests of one full-width ``synthetic_image``,
#: Poisson arrivals at this share of the calibrated capacity.
SERVE_PIPELINE = "pipe_blur_sharpen_down"
SERVE_REQUESTS, SERVE_LOAD, SERVE_DEADLINE_S = 32, 0.25, 2.0
#: The watchdogs' cadence on the served stream, wall seconds: short
#: enough to run several times in a stream of a few tenths of a second.
#: They run on the serving thread, so the scrubber patrols the whole
#: registry a slice of ``SERVE_SCRUB_SLICE`` bytes a run: a whole pass
#: (hundreds of tables by phase 4f, the Table-1 tables of phase 4d among
#: them) blocks the loop longer than the interval.  The default
#: scrubber, a whole pass a run, serves the same stream once more, and
#: its shed requests are printed.
WATCHDOG_INTERVAL_S = 0.03
SERVE_SCRUB_SLICE = 4 << 20
#: The kernels phase 4f's path runs: every one but ``butterfly``.
INTEGRITY_PATH_KERNELS = ("accumulate", "filter_chain", "approx_add",
                          "lut_add", "mul", "mac_matmul", "conv2d_mac",
                          "approx_matmul")
#: ``benchmarks/bench_serve.py``'s simulated cells at its quick
#: parameters: (mix, load_x, cell knobs).
SIM_CELLS = (("uncontended", 0.2, dict(n=120, seed=3)),
             ("overload", 2.0, dict(n=400, seed=4, depth=12,
                                    backlog_s=0.010)),
             ("breaker", 0.5, dict(n=60, seed=5, fail_first=2)))
#: A served record's provenance fields (not results).
SERVE_PROVENANCE = ("host_platform", "jax_version", "device_kind")
#: The ABFT cross-check against the CPU path, at shapes it runs in
#: seconds: (M, K) @ (K, N) and a (B, H, W) conv batch.
ABFT_CPU_GEMM = ((96, 512), (512, 80))
ABFT_CPU_IMAGES = (2, 96, 128)
#: The injected output faults ABFT must catch: a stuck bus bit in one
#: GEMM column, and one in every pixel of one conv image.
ABFT_COL, ABFT_COL_BIT = 3, 19
ABFT_IMAGE, ABFT_IMAGE_BIT, ABFT_SHIFT = 1, 12, 2


def sim_serve_cell(name, load_x, n, seed, depth=64, backlog_s=float("inf"),
                   fail_first=0):
    """``benchmarks/bench_serve.py``'s ``_sim_cell`` on the port: a
    seeded virtual-clock traffic cell at ``load_x`` times the simulated
    executor's capacity."""
    from repro_torch import serving as sv
    pix_per_s = 1e6
    mix = sv.TrafficMix(name, rate_rps=1.0, sizes=(32, 64),
                        size_weights=(0.8, 0.2), deadline_s=0.05)
    mix = sv.TrafficMix(name, rate_rps=load_x * pix_per_s / mix.mean_pixels,
                        sizes=mix.sizes, size_weights=mix.size_weights,
                        deadline_s=mix.deadline_s)
    clk = sv.VirtualClock()
    ex = sv.SimExecutor(clk, pix_per_s=pix_per_s, fail_first=fail_first)
    breaker = sv.CircuitBreaker(sv.BreakerConfig(
        failure_threshold=2, cooldown_s=0.005)) if fail_first else None
    sched = sv.Scheduler(
        ex, clock=clk, estimator=sv.CostEstimator(pix_per_s=pix_per_s),
        admission=sv.AdmissionConfig(max_depth=depth,
                                     max_backlog_s=backlog_s),
        batching=sv.BatcherConfig(max_batch=4, max_wait_s=0.002),
        config=sv.SchedulerConfig(max_retries=2, backoff_s=0.001),
        breaker=breaker)
    return sv.run_traffic(sched, sv.make_arrivals(mix, n=n, seed=seed),
                          name)


def committed_serve_records():
    """``BENCH_serve.json``'s simulated records by mix, provenance
    dropped."""
    recs = json.loads((ROOT / "BENCH_serve.json").read_text())
    sim = {r["mix"]: {k: v for k, v in r.items()
                      if k not in SERVE_PROVENANCE}
           for r in recs if r["backend"] == "sim"}
    check(set(sim) == {c[0] for c in SIM_CELLS},
          f"BENCH_serve.json's sim records: {sorted(sim)}")
    return sim


def committed_detection_records():
    """``BENCH_faults.json``'s ten ``fault_detection`` records by (grid,
    detector, kind, fault)."""
    recs = json.loads((ROOT / "BENCH_faults.json").read_text())
    det = {(r["grid"], r["detector"], r["kind"], r["fault"]): r
           for r in recs if r["op"] == "fault_detection"}
    check(len(det) == 10, f"BENCH_faults.json: {len(det)} fault_detection "
          f"records, 10 expected")
    return det


def serving_stack(torch, dev, ex, est, clk, slice_bytes=SERVE_SCRUB_SLICE):
    """A Scheduler over ``ex`` on the wall clock ``clk``, guarded by the
    integrity watchdogs on the card: a scrubber of the whole registry,
    host tables and the device copies the kernels gather from,
    ``slice_bytes`` a run (``None``: all of it), and canaries on a lut
    engine with the truncated n8t3 multiplier (``lut_add``, ``mul``) and
    on a reference-strategy engine (``approx_add``), every alarm feeding
    a breaker that steps a ``DegradePolicy``.  Returns (scheduler,
    watchdogs)."""
    from repro_torch import serving as sv
    from repro_torch.ax import make_engine
    from repro_torch.ax.mul import MulSpec
    from repro_torch.integrity import CanarySuite, LutScrubber
    from repro_torch.resilience import DegradePolicy
    spec = spec_at("haloc_axa", 16)
    breaker = sv.CircuitBreaker(
        policy=DegradePolicy(ex.plan(SERVE_PIPELINE)))
    kw = dict(interval_s=WATCHDOG_INTERVAL_S, clock=clk, breaker=breaker)
    watchdogs = (
        LutScrubber(slice_bytes=slice_bytes, **kw),
        CanarySuite(make_engine(spec, strategy="lut",
                                mul=MulSpec("truncated", 8, 3)), **kw),
        CanarySuite(make_engine(spec), **kw))
    sched = sv.Scheduler(
        ex, clock=clk, estimator=est,
        admission=sv.AdmissionConfig(max_depth=64, max_backlog_s=1.0),
        batching=sv.BatcherConfig(max_batch=4, max_wait_s=0.002),
        breaker=breaker, integrity=watchdogs)
    return sched, watchdogs


def serve_on_card(torch, np, dev):
    """(b): the compiled plan behind the Scheduler on the card, on the
    wall clock: capacity calibrated after a warm-up call, then
    ``SERVE_REQUESTS`` full-width requests at ``SERVE_LOAD`` of it."""
    from repro_torch import serving as sv
    from repro_torch.image.pipeline import synthetic_image
    ex = sv.PlanExecutor.compile((SERVE_PIPELINE,))
    clk = sv.WallClock()
    est = sv.CostEstimator()
    pix_per_s = est.calibrate(ex, synthetic_image(FULL_SIZE, seed=0),
                              SERVE_PIPELINE, clk)
    mix = sv.TrafficMix("card_lowload",
                        rate_rps=SERVE_LOAD * pix_per_s / FULL_SIZE ** 2,
                        sizes=(FULL_SIZE,), deadline_s=SERVE_DEADLINE_S)
    arrivals = sv.make_arrivals(mix, n=SERVE_REQUESTS, seed=0)
    sched, watchdogs = serving_stack(torch, dev, ex, est, clk)
    report = sv.run_traffic(sched, arrivals, mix.name)
    return dict(ex=ex, pix_per_s=pix_per_s, mix=mix, arrivals=arrivals,
                report=report, sched=sched, watchdogs=watchdogs)


def close_the_loop(torch, np, dev):
    """(c): a stuck-at-1 at bit m/2 burned into the live device table of
    a lut engine; its canary flags it at the first tick and trips a
    breaker (which steps its policy), the scrubber finds the device entry
    and repairs it in place, and the canary passes again."""
    from repro_torch import serving as sv
    from repro_torch.ax import make_engine
    from repro_torch.ax.lut import _canonical, device_table
    from repro_torch.imgproc import PIPELINES, compile_pipeline
    from repro_torch.integrity import CanarySuite, LutScrubber
    from repro_torch.resilience import DegradePolicy, FaultSpec, corrupt_lut
    spec = spec_at("haloc_axa", 16)
    eng = make_engine(spec, strategy="lut")
    clk = sv.VirtualClock()
    policy = DegradePolicy(compile_pipeline(PIPELINES[SERVE_PIPELINE]))
    breaker = sv.CircuitBreaker(policy=policy)
    canary = CanarySuite(eng, interval_s=1.0, clock=clk, breaker=breaker)
    live = device_table(spec, dev)
    golden, ptr = live.clone(), live.data_ptr()
    fault = FaultSpec("stuck_at_1", bits=(spec.lsm_bits // 2,))
    bad = corrupt_lut(spec, fault)
    live.copy_(torch.from_numpy(bad.view(np.int16).copy()))
    clk.advance(1.0)
    first = canary.maybe_run()
    scrub = LutScrubber(clock=clk, cache="ax.lut.device").scrub_once()
    label = ("ax.lut.device", repr((_canonical(spec), dev)))
    return dict(fault=fault, first=first, breaker=breaker, policy=policy,
                scrub=scrub, label=label, in_place=live.data_ptr() == ptr,
                repaired=torch.equal(live, golden),
                again=canary.run_once(), eng=eng)


def abft_cases():
    """(label, ``make_engine`` arguments, GEMM block or None for conv2d)
    of ABFT's checks: the two GEMM paths at n32m10k5 and conv3x3's engine
    (n16m8k4, truncated n8t3)."""
    from repro_torch.ax.mul import MulSpec
    from repro_torch.numerics.fixed_point import FixedPointFormat
    n8t3 = MulSpec("truncated", 8, 3)
    spec32 = spec_at("haloc_axa", 32)
    block = (GEMM_BK, GEMM_BK, GEMM_BK)
    return (("approx_matmul", dict(spec=spec32), block),
            ("mac_matmul", dict(spec=spec32, mul=n8t3), block),
            ("conv2d_mac", dict(spec=spec_at("haloc_axa", 16), mul=n8t3,
                                fmt=FixedPointFormat(16, 0)), None))


def abft_verdicts(torch, a, b, q, **where):
    """Healthy and faulted verdicts of ``AbftChecker`` on each engine of
    :func:`abft_cases`: (label, healthy, faulted, faulted output)."""
    from repro_torch.ax import make_engine
    from repro_torch.imgproc.workloads import CONV3X3_KERNEL
    from repro_torch.integrity import AbftChecker
    out = []
    for label, kw, block in abft_cases():
        eng = make_engine(**kw, **where)
        ck = AbftChecker(eng)
        if block is not None:
            healthy = ck.matmul(a, b, block=block)
            bad = eng.matmul(a, b, block=block).clone()
            bad[:, ABFT_COL] |= 1 << ABFT_COL_BIT
            faulted = ck.verify_matmul(bad, a, b, block=block)
        else:
            healthy = ck.conv2d(q, CONV3X3_KERNEL, shift=ABFT_SHIFT)
            bad = eng.conv2d(q, CONV3X3_KERNEL, shift=ABFT_SHIFT).clone()
            bad[ABFT_IMAGE] |= 1 << ABFT_IMAGE_BIT
            faulted = ck.verify_conv2d(bad, q, CONV3X3_KERNEL,
                                       shift=ABFT_SHIFT)
        out.append((label, healthy, faulted, bad))
    return out


def load_with_integrity(torch, np, dev):
    """(f): ``make_engine(..., strategy="lut", integrity=True)`` on the
    card repairs a corrupted device-table cell before the first add, and
    raises ``IOError`` when the rebuild disagrees with the golden."""
    from repro_torch.ax import make_engine
    from repro_torch.ax.lut import _canonical, device_table
    from repro_torch.integrity import golden_entries, verify_entry
    from repro_torch.integrity.digests import record_golden
    spec = spec_at("haloc_axa", 32)
    live = device_table(spec, dev)
    golden = live.clone()
    flat = live.view(-1)
    flat[12345] ^= 1 << 2
    eng = make_engine(spec, strategy="lut", integrity=True)
    repaired = torch.equal(live, golden)
    key = (_canonical(spec), dev)
    entry = next(e for e in golden_entries("ax.lut.device") if e.key == key)
    record_golden(entry.cache, key, live, lambda: torch.zeros_like(live),
                  pattern=entry.pattern, digest=entry.digest)
    flat[12345] ^= 1 << 2
    try:
        make_engine(spec, strategy="lut", integrity=True)
        refused = None
    except IOError as exc:
        refused = str(exc)
    finally:
        flat[12345] ^= 1 << 2
        record_golden(entry.cache, key, live, entry.rebuild,
                      pattern=entry.pattern, digest=entry.digest)
    healthy = verify_entry(next(e for e in golden_entries("ax.lut.device")
                                if e.key == key))
    return dict(eng=eng, repaired=repaired, refused=refused,
                healthy=healthy)


def drive_integrity_path(torch, np, dev, a8, b8, gbatch):
    """Phase 4f's path through the entry points a user calls: (a) the
    simulated serving cells, (b) the Scheduler serving the compiled plan
    on the card under its watchdogs, (c) the corrupt-detect-repair loop
    on a device table, (d) the detection campaign's quick and full grids
    on the card, (e) ABFT over the full-width GEMMs and conv3x3, healthy
    and faulted, and (f) an engine load with ``integrity=True``."""
    from repro_torch.resilience.harness import detection_campaign
    out = {"sim": {name: sim_serve_cell(name, load_x, **kw).record(
        load_x=load_x, backend="sim", kind="haloc_axa")
        for name, load_x, kw in SIM_CELLS}}
    out["serve"] = serve_on_card(torch, np, dev)
    out["loop"] = close_the_loop(torch, np, dev)
    out["detect"] = (detection_campaign(quick=True, backend="cuda")
                     + detection_campaign(quick=False, backend="cuda"))
    out["abft"] = abft_verdicts(torch, a8, b8, gbatch.to(torch.int32))
    out["load"] = load_with_integrity(torch, np, dev)
    return out


def check_served(torch, np, serve):
    """(b): every request completed, each output equals the plan called
    directly on the card on its image, the first equals the CPU path, and
    the watchdogs ran several times with no alarm."""
    from repro_torch import serving as sv
    from repro_torch.imgproc import PIPELINES, compile_pipeline
    rep = serve["report"]
    scrubber, *canaries = serve["watchdogs"]
    reasons = sorted({(type(o).__name__, getattr(o, "reason", ""))
                      for o in rep.outcomes if not o.ok})
    check(len(rep.completed) == SERVE_REQUESTS == rep.offered,
          f"served stream: {rep.summary()}; {rep.seconds:.3f} s makespan; "
          f"not completed: {reasons}; {scrubber}, {canaries}, "
          f"{serve['sched'].breaker}")
    pipe = serve["ex"].plan(SERVE_PIPELINE)
    for o in rep.completed:
        img = torch.from_numpy(o.request.image[None]).to(pipe.device)
        check(isinstance(o.output, np.ndarray) and np.array_equal(
            o.output, pipe(img).cpu().numpy()[0]),
            f"served request {o.rid}: the output differs from the plan "
            f"called on the card")
    first = min(rep.completed, key=lambda o: o.request.arrival)
    cpu = compile_pipeline(PIPELINES[SERVE_PIPELINE], backend="torch",
                           device="cpu")(first.request.image[None])
    check(np.array_equal(first.output, cpu.numpy()[0]),
          "served request: the first output differs from the CPU path")
    check(scrubber.runs >= 2 and all(c.runs >= 2 for c in canaries),
          f"watchdogs ran too rarely: {scrubber}, {canaries}")
    check(scrubber.corruptions == 0 and all(c.failures == 0
                                            for c in canaries)
          and serve["sched"].breaker.trips == 0,
          f"watchdog alarms on a healthy stream: {scrubber}, {canaries}, "
          f"{serve['sched'].breaker}")
    check(all(isinstance(o, sv.Completed) for o in rep.outcomes),
          f"served stream outcomes: {rep.summary()}")


def check_loop(torch, np, loop):
    """(c): flagged at the first tick, tripped, found on the card and
    repaired in place, then clean again and equal to the delta-table
    predictions."""
    from repro_torch import serving as sv
    from repro_torch.integrity import expected_add_outputs, make_probe
    first, scrub = loop["first"], loop["scrub"]
    check(first is not None and first.add_mismatches > 0,
          f"the canary missed {loop['fault'].short_name} burned into the "
          f"device table: {first}")
    check(loop["breaker"].state == sv.OPEN and loop["breaker"].trips == 1
          and loop["policy"].level == 1,
          f"the canary's alarm did not trip the breaker and step its "
          f"policy: {loop['breaker']}")
    check(loop["label"] in scrub.corrupted and loop["label"]
          in scrub.repaired and not scrub.unrepaired,
          f"the scrubber did not find and repair the device table: "
          f"{scrub.corrupted} / {scrub.repaired}")
    check(loop["in_place"] and loop["repaired"],
          "the device table was not repaired in place")
    check(loop["again"].ok, f"the canary fails after repair: "
          f"{loop['again']}")
    eng = loop["eng"]
    a, b = make_probe(eng.spec.n_bits, n=1 << 16, seed=9)
    got = eng.add(torch.from_numpy(a.astype(np.int32)).to(eng.device),
                  torch.from_numpy(b.astype(np.int32)).to(eng.device))
    check(np.array_equal(got.cpu().numpy().astype(np.uint64) & 0xFFFF,
                         expected_add_outputs(eng.spec, a, b)),
          "engine.add after the repair differs from the delta table")


def check_detection(records):
    """(d): the quick and full grids on the card equal
    ``BENCH_faults.json``'s ten records, ``backend`` aside."""
    want = committed_detection_records()
    fields = ("detected", "cells", "coverage", "detection_latency_s",
              "false_positive_rate")
    check(len(records) == len(want), f"{len(records)} detection records")
    for r in records:
        w = want[(r["grid"], r["detector"], r["kind"], r["fault"])]
        check(r["backend"] == "cuda"
              and all(r[f] == w[f] for f in fields),
              f"fault_detection {r['grid']}/{r['detector']}/{r['fault']}: "
              f"the card gives {[r[f] for f in fields]}, BENCH_faults.json "
              f"{[w[f] for f in fields]}")


def exact_conv(np, img, kernel, shift):
    """The exact integer conv of one image, edges replicated, rounded
    right by ``shift`` (numpy, int64)."""
    x = np.asarray(img).astype(np.int64)
    h, w = x.shape
    p = np.pad(x, 1, mode="edge")
    acc = np.zeros((h, w), dtype=np.int64)
    for r, row in enumerate(kernel):
        for c, wt in enumerate(row):
            acc += wt * p[r:r + h, c:c + w]
    return (acc + (1 << (shift - 1))) >> shift if shift else acc


def check_abft(torch, np, verdicts, a8, b8, batch):
    """(e): the healthy checks pass; the faulted column or image, and
    only it, is flagged and repaired to the exact result."""
    from repro_torch.imgproc.workloads import CONV3X3_KERNEL
    a64, b64 = a8.to(torch.int64), b8.to(torch.int64)
    for label, healthy, faulted, bad in verdicts:
        check(healthy.ok, f"ABFT flags the healthy {label}: {healthy}")
        if label == "conv2d_mac":
            check(faulted.flagged_rows == (ABFT_IMAGE,) and not faulted.ok,
                  f"ABFT {label}: flagged {faulted.flagged_rows}")
            want = exact_conv(np, batch[ABFT_IMAGE], CONV3X3_KERNEL,
                              ABFT_SHIFT)
            got = faulted.out[ABFT_IMAGE].cpu().numpy()
            others = [i for i in range(len(batch)) if i != ABFT_IMAGE]
            check(np.array_equal(got, want) and torch.equal(
                faulted.out[others], bad[others]),
                f"ABFT {label}: image {ABFT_IMAGE} not repaired exactly")
        else:
            check(faulted.flagged_cols == (ABFT_COL,) and not faulted.ok,
                  f"ABFT {label}: flagged columns {faulted.flagged_cols} "
                  f"rows {faulted.flagged_rows}")
            exact = (a64 * b64[:, ABFT_COL]).sum(1)
            check(torch.equal(faulted.out[:, ABFT_COL].to(torch.int64),
                              exact),
                  f"ABFT {label}: column {ABFT_COL} not repaired to the "
                  f"exact product")


def check_abft_cpu(torch, np):
    """(e): at a shape the CPU runs in seconds, every verdict on the card
    (out, flags, max_deviation, budget) equals the CPU path's."""
    rng = np.random.default_rng(21)
    (m, k), (_, n) = ABFT_CPU_GEMM
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    q = rng.integers(0, 256, ABFT_CPU_IMAGES).astype(np.int32)
    card = abft_verdicts(torch, a, b, q)
    cpu = abft_verdicts(torch, a, b, q, backend="torch", device="cpu")
    for (label, *gv), (_, *wv) in zip(card, cpu):
        for g, w in zip(gv[:2], wv[:2]):
            check(g.out.device.type == "cuda"
                  and torch.equal(g.out.cpu(), w.out)
                  and (g.ok, g.flagged_rows, g.flagged_cols,
                       g.max_deviation, g.budget)
                  == (w.ok, w.flagged_rows, w.flagged_cols,
                      w.max_deviation, w.budget),
                  f"ABFT {label} at {ABFT_CPU_GEMM} / {ABFT_CPU_IMAGES}: "
                  f"the card's verdict {g} differs from the CPU path's {w}")
    return len(card)


def time_abft(torch, a8, b8, q):
    """Wall ms (median of 10, synchronized) of each kernel call alone,
    its verify on that output, and the checked call."""
    from repro_torch.ax import make_engine
    from repro_torch.imgproc.workloads import CONV3X3_KERNEL
    from repro_torch.integrity import AbftChecker
    rows = []
    for label, kw, block in abft_cases():
        eng = make_engine(**kw)
        ck = AbftChecker(eng)
        if block is not None:
            args, kwargs = (a8, b8), dict(block=block)
            call, verify, checked = eng.matmul, ck.verify_matmul, ck.matmul
        else:
            args, kwargs = (q, CONV3X3_KERNEL), dict(shift=ABFT_SHIFT)
            call, verify, checked = eng.conv2d, ck.verify_conv2d, ck.conv2d
        out = call(*args, **kwargs)
        rows.append((label, *(time_wall(torch, lambda: fn(*a, **kwargs))
                              * 1e3 for fn, a in
                              ((call, args), (verify, (out,) + args),
                               (checked, args)))))
    return rows


def time_watchdogs(torch, serve):
    """Host ms (median of 5) of one run of the served stack's scrubber
    (one slice), of a scrub of the lut kernels' device tables and of the
    whole registry, and of one run of each canary; the registry's
    entries and their bytes."""
    from repro_torch.integrity import LutScrubber, golden_entries
    scrubber, *canaries = serve["watchdogs"]
    out = {}
    for name, fn in [
            (f"scrub a {SERVE_SCRUB_SLICE >> 20} MiB slice",
             scrubber.scrub_once),
            ("scrub ax.lut.device",
             LutScrubber(cache="ax.lut.device").scrub_once),
            ("scrub whole registry", LutScrubber().scrub_once)] + [
            (f"canary {c.engine.spec.short_name} {c.engine.strategy}"
             + (f" + {c.engine.mul_spec.short_name}"
                if c.engine.mul_spec is not None else ""), c.run_once)
            for c in canaries]:
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        out[name] = sorted(ts)[2] * 1e3
    entries = golden_entries()
    nbytes = sum(int(e.table.numel() * e.table.element_size())
                 if hasattr(e.table, "element_size") else e.table.nbytes
                 for e in entries)
    on_card = sum(1 for e in entries if getattr(e.table, "is_cuda", False))
    return out, len(entries), on_card, nbytes


def integrity_phase(torch, np, dev, counts, card, a8, b8, gbatch, batch):
    """Phase 4f: integrity and serving at full width on the card, held
    against ``BENCH_serve.json``, ``BENCH_faults.json``, the direct plan
    call and the CPU path; returns the launches of the path."""
    from repro_torch import serving as sv
    out, launches = run_counted(
        torch, counts, INTEGRITY_PATH_KERNELS,
        lambda: drive_integrity_path(torch, np, dev, a8, b8, gbatch),
        "integrity and serving path")

    want = committed_serve_records()
    for name, rec in out["sim"].items():
        check(rec == want[name], f"serve_traffic {name}: the port gives "
              f"{rec}, BENCH_serve.json {want[name]}")
    log(f"  (a) the {len(out['sim'])} simulated serving cells equal "
        f"BENCH_serve.json's sim records field for field: "
        + "; ".join(f"{n} p99 {r['p99_ms']:.3f} ms, goodput "
                    f"{r['goodput_mpix_per_s']:.4f}"
                    for n, r in out["sim"].items()))

    serve = out["serve"]
    check_served(torch, np, serve)
    rep = serve["report"]
    scrubber, *canaries = serve["watchdogs"]
    runs = (scrubber.runs, [c.runs for c in canaries])  # before the timing
    busy, idle = stream_idle(torch, lambda: sv.run_traffic(
        serving_stack(torch, dev, serve["ex"], sv.CostEstimator(
            pix_per_s=serve["pix_per_s"]), sv.WallClock())[0],
        serve["arrivals"], "card_lowload"), rep.seconds)
    host_ms, n_entries, n_card, nbytes = time_watchdogs(torch, serve)
    log(f"  (b) Scheduler -> PlanExecutor({SERVE_PIPELINE}) on the card, "
        f"haloc_axa n16m8k4 stage, wall clock; calibrated "
        f"{serve['pix_per_s'] / 1e6:.1f} MPix/s; {SERVE_REQUESTS} requests "
        f"of {FULL_SIZE}^2 at {SERVE_LOAD}x ({serve['mix'].rate_rps:.1f} "
        f"req/s), {card}:")
    log(f"    {rep.summary()}; {rep.seconds * 1e3:.1f} ms makespan; "
        f"p50 {rep.p50_s * 1e3:.3f} ms p99 {rep.p99_s * 1e3:.3f} ms; "
        f"goodput {rep.goodput_mpix_per_s:.2f} MPix/s; device "
        + ("not measured (the profiler saw no device time)" if busy is None
           else f"busy {busy / 1e3:.2f} ms, idle share {idle:.3f}"))
    log(f"    every output equals the plan called on the card, the first "
        f"the CPU path; watchdogs every {WATCHDOG_INTERVAL_S} s: scrub "
        f"of the registry {SERVE_SCRUB_SLICE >> 20} MiB a run "
        f"{runs[0]} runs, canaries {runs[1]} runs in the stream, no alarm")
    log(f"    host ms of one run (median of 5): "
        + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items())
        + f"; the registry holds {n_entries} tables ({n_card} on the card, "
        f"{nbytes / 2 ** 20:.1f} MiB)")
    whole_sched, (whole, *_) = serving_stack(
        torch, dev, serve["ex"], sv.CostEstimator(
            pix_per_s=serve["pix_per_s"]), sv.WallClock(), slice_bytes=None)
    whole_rep = sv.run_traffic(whole_sched, serve["arrivals"],
                               "card_lowload")
    check(whole.runs >= 1 and whole.corruptions == 0,
          f"the whole-registry scrubber on the served stream: {whole}")
    log(f"    the default LutScrubber (the whole registry a run) on the "
        f"same arrivals: {whole_rep.summary()}; "
        f"{whole_rep.seconds * 1e3:.1f} ms makespan; {whole.runs} scrub "
        f"runs")

    loop = out["loop"]
    check_loop(torch, np, loop)
    log(f"  (c) {loop['fault'].short_name} burned into the n16m8k4 device "
        f"table: canary {loop['first']}; breaker {loop['breaker']} "
        f"(policy now {loop['policy'].pipe.engine.spec.short_name}); scrub "
        f"{loop['scrub']} found and repaired {loop['label'][0]} in place; "
        f"canary again {loop['again']}; engine.add equals the delta table")

    check_detection(out["detect"])
    log(f"  (d) detection_campaign(backend='cuda'), quick and full: the "
        f"{len(out['detect'])} records equal BENCH_faults.json's "
        f"fault_detection records: "
        + "; ".join(f"{r['grid']} {r['detector']} {r['fault']} "
                    f"{r['detected']}/{r['cells']} at "
                    f"{r['detection_latency_s']:.3f} s"
                    for r in out["detect"]))

    check_abft(torch, np, out["abft"], a8, b8, batch)
    n_cpu = check_abft_cpu(torch, np)
    log(f"  (e) ABFT at full width: " + "; ".join(
        f"{label} healthy max dev {h.max_deviation:.0f} of budget "
        f"{h.budget:.0f}, faulted flags rows {f.flagged_rows} cols "
        f"{f.flagged_cols}, repaired exactly"
        for label, h, f, _ in out["abft"])
        + f"; the {2 * n_cpu} verdicts at {ABFT_CPU_GEMM} / "
        f"{ABFT_CPU_IMAGES} equal the CPU path's")
    for label, call, verify, checked in time_abft(
            torch, a8, b8, gbatch.to(torch.int32)):
        log(f"    {label}: kernel call {call:.3f} ms, verify {verify:.3f} "
            f"ms, checked call {checked:.3f} ms (wall, median of 10; "
            f"{card})")

    load = out["load"]
    check(load["repaired"] and load["healthy"]
          and load["refused"] is not None
          and "unrepairable" in load["refused"],
          f"make_engine(integrity=True) on the card: repaired "
          f"{load['repaired']}, refused {load['refused']!r}")
    log(f"  (f) make_engine('haloc_axa', strategy='lut', integrity=True) "
        f"repaired a flipped device-table cell before its first add, and "
        f"refused with IOError when the rebuild disagreed")
    return launches


# ------------------------------------------------------------- phase 5 --

def fold_ops(weights):
    """Least instructions of one weighted fold of len(weights) terms."""
    return (OPS_PER_SCALE * sum(w != 1 for w in weights)
            + OPS_PER_ADD * (len(weights) - 1))


def chain_ops(stages):
    """Least instructions per pixel of a filter chain."""
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


def butterfly_ops(inverse):
    """Least instructions of one butterfly pair (``BUTTERFLY_PAIR``, and
    the four halvings when inverse)."""
    return len(BUTTERFLY_INVERSE if inverse else BUTTERFLY_PAIR)


def int32_rate(torch, dev):
    """The card's int32 operations per second: SMs x lanes x max clock."""
    props = torch.cuda.get_device_properties(dev)
    clock = nvidia_smi("clocks.max.sm").split()[0]
    rate = props.multi_processor_count * INT32_LANES_PER_SM \
        * float(clock) * 1e6
    log(f"  int32 rate for the bound: {props.multi_processor_count} SMs x "
        f"{INT32_LANES_PER_SM} lanes x {clock} MHz = {rate / 1e12:.2f} "
        f"Tops/s; shared-memory gathers {LDS_LANES_PER_SM} lanes an SM: "
        f"{rate * LDS_LANES_PER_SM / INT32_LANES_PER_SM / 1e12:.2f} T/s")
    return rate


def bound(w, int32_ops_per_s):
    """(bound ms, bytes ms, operations ms) of one timed function: int32
    operations at the int32 rate, int8 tensor-core operations at theirs
    and table gathers at the shared-memory lanes' (the same SMs and clock
    as the int32 rate), on separate units, so the slowest bounds them."""
    bytes_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
    lds_per_s = int32_ops_per_s * LDS_LANES_PER_SM / INT32_LANES_PER_SM
    ops_ms = max(w["ops"] / int32_ops_per_s,
                 w.get("tensor_ops", 0) / INT8_TENSOR_OPS_PER_S,
                 w.get("gathers", 0) / lds_per_s) * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def measure(torch, np, dev, launches, errs, int32_ops_per_s):
    from repro_torch.ax import FilterStage
    from repro_torch.core.specs import AdderSpec, paper_spec
    from repro_torch.kernels import accumulate as acc_k
    from repro_torch.kernels import approx_add as add_k
    from repro_torch.kernels import butterfly as bf_k
    from repro_torch.kernels import conv_chain as chain_k
    from repro_torch.kernels import lut_add as lut_k

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
        "lut_add": dict(
            source="src/repro_torch/csrc/lut_add.cu",
            replaces="src/repro/kernels/lut_add.py:39",
            what=f"haloc_axa n16m8k4 lut, int32 pair {shape}",
            kernel=[lambda a=a, b=b: lut_k.lut_add(a, b, spec)
                    for a, b in adds],
            plain=[lambda a=a, b=b: lut_k.lut_add_plain(a, b, spec)
                   for a, b in adds],
            bytes=3 * 4 * n + 2 * (1 << 16), ops=OPS_PER_LUT_ADD * n),
    }
    work["butterfly"] = butterfly_work(torch, np, rng, dev, bf_k,
                                       FFT_SIZE * FFT_SIZE // 2, 8)
    work["fft_axis"] = fft_axis_work(torch, np, rng, dev, bf_k,
                                     (FFT_SIZE, FFT_SIZE), 16, "rows")
    entries = time_entries(torch, work, launches, errs, int32_ops_per_s, n)
    time_accumulate_routes(torch, np, rng, dev, spec, planes, int32_ops_per_s)
    # filter_chain's other routes and form on the same planes: the fused
    # gaussian, sobel_gx (the vertical stage first), the gaussian on the
    # general route (what the sep2 route saves on the main path) and the
    # general route's own case (same_axis: three stages, two on W).
    others = {
        "gaussian fused": (gauss, True, None),
        "sobel_gx reference": ((FilterStage(-2, (-1, 0, 1), (1, 2, 1)),
                                FilterStage(-1, (1, -1), (1, -1))), False,
                               None),
        "gaussian reference (general route)": (gauss, False, "general"),
        "same_axis reference (general route)": (
            (FilterStage(-1, (-2, 0, 3), (1, -3, 2), 1),
             FilterStage(-1, (-1, 1), (2, 1)),
             FilterStage(-2, (0, 2), (1, 1), 1)), False, None)}
    for label, (stages, fast, route) in others.items():
        with forced_chain_route(chain_k, route):
            check(torch.equal(chain_k.filter_chain(planes[0], spec, stages,
                                                   fast=fast),
                              chain_k.filter_chain_plain(planes[0], spec,
                                                         stages, fast)),
                  f"filter_chain {label}: kernel != plain version")
            ms = time_launches(torch, [lambda q=q: chain_k.filter_chain(
                q, spec, stages, fast=fast) for q in planes], 40)
        bound_ms, _, _ = bound(dict(bytes=2 * 4 * n,
                                    ops=chain_ops(stages) * n),
                               int32_ops_per_s)
        log(f"  filter_chain {label}, haloc_axa N=16, int32 {shape}: "
            f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms = "
            f"{bound_ms / ms * 100:.1f}% of bound")
    # lut_add beside approx_add at the paper's N=32 (the 2 MiB m=10
    # table), and the butterfly at the other stage shapes of the path.
    ms_of = {e["name"]: e["ms"] for e in entries}
    spec32 = paper_spec("haloc_axa")
    adds32 = [tuple(torch.as_tensor(
        rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        .view(np.int32), device=dev) for _ in range(2))
        for _ in range(copies)]
    lut_ms = time_launches(torch, [lambda a=a, b=b: lut_k.lut_add(a, b,
                                                                  spec32)
                                   for a, b in adds32], 40)
    add_ms = time_launches(torch, [lambda a=a, b=b: add_k.approx_add(
        a, b, spec32) for a, b in adds32], 40)
    add_fast_ms = time_launches(torch, [lambda a=a, b=b: add_k.approx_add(
        a, b, spec32, fast=True) for a, b in adds32], 40)
    log(f"  lut_add vs approx_add, haloc_axa n32m10k5, int32 pair {shape}: "
        f"lut {lut_ms:.4f} ms, approx_add reference {add_ms:.4f} ms, "
        f"fused {add_fast_ms:.4f} ms (and at n16m8k4 above: lut "
        f"{ms_of['lut_add']:.4f} ms, approx_add {ms_of['approx_add']:.4f} "
        f"ms)")
    for pairs, half, what in ((FFT_SIZE * FFT_SIZE // 2, 1, "512 block 16"),
                              (FFT_SIZE * FFT_SIZE // 2, 4, "512 block 16"),
                              (FFT_SIZE * FFT_SIZE // 2, 256, "512 whole"),
                              (N_IMAGES * FULL_SIZE * FULL_SIZE // 2, 8,
                               "4 x 1024 x 1024 block 16")):
        w = butterfly_work(torch, np, rng, dev, bf_k, pairs, half)
        ms = time_launches(torch, w["kernel"], 40)
        bound_ms, _, _ = bound(w, int32_ops_per_s)
        log(f"  butterfly stage {what}, {w['what']}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms = {bound_ms / ms * 100:.1f}% of bound")
    # fft_axis on every axis of the path: both axes of 512^2 in block-16
    # tiles and whole, and of the 4 x 1024^2 workload batch; the inverse
    # of the first; each with its device time (the profiler's).
    for shape, block, axis, inverse in (
            ((FFT_SIZE, FFT_SIZE), 16, "rows", True),
            ((FFT_SIZE, FFT_SIZE), 16, "cols", False),
            ((FFT_SIZE, FFT_SIZE), None, "rows", False),
            ((FFT_SIZE, FFT_SIZE), None, "cols", False),
            ((N_IMAGES, FULL_SIZE, FULL_SIZE), 16, "rows", False),
            ((N_IMAGES, FULL_SIZE, FULL_SIZE), 16, "cols", False)):
        w = fft_axis_work(torch, np, rng, dev, bf_k, shape, block, axis,
                          inverse)
        ms = time_launches(torch, w["kernel"], 40)
        times = device_times(torch, w["kernel"][0], 10).values()
        launches = sum(n for _, n in times)
        dev_txt = (f"{sum(us for us, _ in times) / launches:.1f} us a "
                   f"launch") if times else "not measured"
        bound_ms, _, _ = bound(w, int32_ops_per_s)
        log(f"  fft_axis {w['what']}: kernel {ms:.4f} ms (device "
            f"{dev_txt}), bound {bound_ms:.4f} ms = "
            f"{bound_ms / ms * 100:.1f}% of bound")
    return entries


def time_accumulate_routes(torch, np, rng, dev, spec, planes,
                           int32_ops_per_s):
    """accumulate beyond the kernels line's row: K = 4 at downsample2x's
    (4, 4, 512, 512), the signed entry on sharpen's two planes and on
    downsample2x's strided phases of one, and beside each the
    composition that entry replaced on the card (stack, mask, fold,
    sign extension, rounding: five and seven launches)."""
    from repro_torch.kernels import accumulate as acc_k
    n = planes[0].numel()
    mask, sign = 0xFFFF, 0x8000

    def composed(terms, ws, shift):
        s = acc_k.accumulate(torch.stack(terms) & mask, spec, weights=ws)
        s = (s ^ sign) - sign
        return (s + (1 << (shift - 1))) >> shift if shift else s

    stacks4 = [torch.as_tensor(rng.integers(0, 1 << 16, (4, N_IMAGES, 512,
                                                        512))
                               .astype(np.int32), device=dev)
               for _ in range(4)]
    pairs = [(planes[i], planes[(i + 1) % len(planes)])
             for i in range(len(planes))]
    cases = {
        "K=4 stacked (4, 4, 512, 512)": (
            [lambda t=t: acc_k.accumulate(t, spec) for t in stacks4], None,
            5 * n, fold_ops((1,) * 4) * n // 4),
        "signed K=2 sharpen (2, -1)": (
            [lambda a=a, b=b: acc_k.accumulate_signed((a, b), spec, 16,
                                                      weights=(2, -1))
             for a, b in pairs],
            [lambda a=a, b=b: composed((a, b), (2, -1), 0)
             for a, b in pairs],
            3 * 4 * n, (fold_ops((2, -1)) + OPS_SIGN_EXTEND) * n),
        "signed K=4 downsample phases": (
            [lambda q=q: acc_k.accumulate_signed(phases(q), spec, 16,
                                                 shift=2) for q in planes],
            [lambda q=q: composed(phases(q), None, 2) for q in planes],
            5 * n, (fold_ops((1,) * 4) + OPS_SIGN_EXTEND + OPS_ROUND_SHIFT)
            * n // 4),
    }
    for label, (kernel, before, nbytes, ops) in cases.items():
        ms = time_launches(torch, kernel, 40)
        bound_ms, _, _ = bound(dict(bytes=nbytes, ops=ops), int32_ops_per_s)
        line = (f"  accumulate {label}, haloc_axa N=16 reference: kernel "
                f"{ms:.5f} ms, bound {bound_ms:.5f} ms = "
                f"{bound_ms / ms * 100:.1f}% of bound")
        if before is not None:
            b_ms = time_launches(torch, before, 40)
            line += (f"; the composition it replaced (stack, mask, fold, "
                     f"sign extension, rounding) {b_ms:.5f} ms")
        log(line)


@contextlib.contextmanager
def forced_chain_route(chain_k, route):
    """Send every chain to ``route`` (``"general"``) while inside; None
    leaves the wrapper's own choice.  Times what one route saves over
    the other on the same chain."""
    if route is None:
        yield
        return
    chosen = chain_k.chain_route
    chain_k.chain_route = lambda stages: route
    try:
        yield
    finally:
        chain_k.chain_route = chosen


def time_entries(torch, work, launches, errs, int32_ops_per_s, n,
                 plain_reps=20):
    """Time each kernel of ``work`` and its plain version; the ``kernels``
    line's entries.  A work item may carry ``library`` (one PyTorch call
    computing the same function) and ``tensor_ops`` (int8 tensor-core
    operations, bounded at their own rate)."""
    entries = []
    for name, w in work.items():
        ms = time_launches(torch, w["kernel"], 40)
        plain_ms = time_launches(torch, w["plain"], plain_reps)
        lib_ms = time_launches(torch, w["library"], 40) \
            if "library" in w else None
        bound_ms, bytes_ms, ops_ms = bound(w, int32_ops_per_s)
        units = w.get("units", n)
        log(f"  {name:13s} {w['what']}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
            f"{bytes_ms:.4f} ms, ops {ops_ms:.4f} ms at {w['ops'] // units} "
            f"int32 per {w.get('unit', 'element')}) = "
            f"{bound_ms / ms * 100:.1f}% of bound"
            + (f"; library {lib_ms:.4f} ms" if lib_ms is not None else ""))
        entries.append({
            "name": name, "route": "cuda", "source": w["source"],
            "replaces": w["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "shape": w["what"]})
    return entries


def butterfly_work(torch, np, rng, dev, bf_k, pairs, half):
    """A forward butterfly stage of ``pairs`` pairs at ``half``, haloc_axa
    at the paper's spec, fused form (as the cuda backend runs it), on
    strided halves; enough input sets rotated to pass the 50 MB L2."""
    from repro_torch.core.specs import paper_spec
    from repro_torch.kernels.butterfly import stage_twiddles
    spec = paper_spec("haloc_axa")
    rows = pairs // half
    copies = max(2, -(-64 * 2 ** 20 // (pairs * 16)))
    sets = [stage_planes(torch, np, rng, rows, half, 1 << 24, dev)
            for _ in range(copies)]
    w_re, w_im = stage_twiddles(half, False, dev)
    return dict(
        source="src/repro_torch/csrc/butterfly.cu",
        replaces="src/repro/kernels/butterfly.py:86",
        what=f"haloc_axa n32m10k5 fused, forward, ({rows}, {half}) "
             f"strided halves",
        kernel=[lambda p=p: bf_k.butterfly(*p, w_re, w_im, spec, fast=True)
                for p in sets],
        plain=[lambda p=p: bf_k.butterfly_plain(*p, w_re, w_im, spec,
                                                fast=True) for p in sets],
        bytes=8 * 4 * pairs + 2 * 4 * half, ops=butterfly_ops(False) * pairs,
        units=pairs, unit="pair")


def fft_axis_work(torch, np, rng, dev, bf_k, shape, block, axis,
                  inverse=False):
    """One axis of a 2-D transform of ``shape`` (whole planes, or block
    tiles read in place), haloc_axa at the paper's spec, fused form (as
    the cuda backend runs it), +-2^24 values; enough input sets rotated
    to pass the 50 MB L2.  Bytes: each element of both planes read and
    written once, and the twiddle table; operations: every pair of every
    stage (``BUTTERFLY_PAIR``, ``BUTTERFLY_INVERSE``)."""
    from repro_torch.core.specs import paper_spec
    from repro_torch.image.fft import image_layouts
    spec = paper_spec("haloc_axa")
    lay = dict(zip(("rows", "cols"), image_layouts(shape, block)))[axis]
    numel = int(np.prod(shape))
    copies = max(2, -(-64 * 2 ** 20 // (numel * 8)))
    sets = [tuple(torch.as_tensor(rng.integers(-(1 << 24), 1 << 24, shape)
                                  .astype(np.int32), device=dev)
                  for _ in range(2)) for _ in range(copies)]
    pairs = numel // 2 * (lay.n.bit_length() - 1)
    return dict(
        source="src/repro_torch/csrc/butterfly.cu",
        replaces="src/repro/kernels/butterfly.py:86",
        what=f"haloc_axa n32m10k5 fused, {'inverse' if inverse else 'forward'}"
             f" {axis} of {shape} {f'block {block}' if block else 'whole'} "
             f"(n {lay.n}, every stage)",
        kernel=[lambda p=p: bf_k.fft_axis(*p, lay, spec, inverse=inverse,
                                          fast=True) for p in sets],
        plain=[lambda p=p: bf_k.fft_axis_plain(*p, lay, spec,
                                               inverse=inverse, fast=True)
               for p in sets[:2]],
        bytes=2 * 2 * 4 * numel + 2 * 4 * (lay.n - 1),
        ops=butterfly_ops(inverse) * pairs, units=pairs, unit="pair-stage")


def conv_ops(kernel, shift):
    """Least instructions per pixel of conv2d_mac: its input value's table
    row, T-1 approximate adds, the sign extension and the rounding shift
    (when there is one)."""
    taps = sum(len(row) for row in kernel)
    return (OPS_PER_CONV_VALUE + OPS_PER_ADD * (taps - 1)
            + OPS_SIGN_EXTEND + (OPS_ROUND_SHIFT if shift else 0))


def truncated_mul_masks(t):
    """The hoisted constants ``truncated_mul_steps(t)`` reads: each
    column's operand mask ones(t - i), its bit 2^i, and zero."""
    return {"zero": 0, **{f"ones{j}": (1 << j) - 1 for j in range(t + 1)},
            **{f"bit{i}": 1 << i for i in range(t)}}


def truncated_mul_steps(t):
    """One truncated product at t truncated columns in the fused form
    (``truncated_mul_fast``, ``csrc/muls.cuh``), in instructions as
    ``HALOC_AXA_ADD``: per column i < t the operand's mask a & ones(t - i)
    (LOP3), the bit picked in place b & 2^i (LOP3, so no shift) and a
    multiply-add of the two into the dropped mass (IMAD); then the full
    product less that mass (one IMAD, its addend negated): 3t + 1."""
    steps, mass = [], "zero"
    for i in range(t):
        steps += [(f"m{i}", "LOP3", ("a", f"ones{t - i}"),
                   lambda a, o: a & o),
                  (f"p{i}", "LOP3", ("b", f"bit{i}"), lambda b, c: b & c),
                  (f"d{i}", "IMAD", (f"m{i}", f"p{i}", mass),
                   lambda x, y, d: x * y + d)]
        mass = f"d{i}"
    steps.append(("out", "IMAD", ("a", "b", mass),
                  lambda a, b, d: a * b - d))
    return tuple(steps)


#: The n8t3 product of the MAC path's ``mul`` cell (10 instructions).
TRUNCATED_MUL_N8T3 = truncated_mul_steps(3)


def ops_truncated_mul(t):
    """Least instructions of one truncated product at t truncated columns
    (``truncated_mul_steps``)."""
    return len(truncated_mul_steps(t))


def measure_mac(torch, np, dev, launches, errs, int32_ops_per_s):
    """The MAC kernels at the slice's path shapes: times, plain times,
    bounds; torch._int_mm beside approx_matmul."""
    from repro_torch.ax.mul import MulSpec
    from repro_torch.imgproc.workloads import CONV3X3_KERNEL
    from repro_torch.kernels import approx_matmul as mm_k
    from repro_torch.kernels import conv2d_mac as conv_k
    from repro_torch.kernels import mac_matmul as mac_k
    from repro_torch.kernels import mul as mul_k

    rng = np.random.default_rng(7)
    shape = (N_IMAGES, FULL_SIZE, FULL_SIZE)
    n = N_IMAGES * FULL_SIZE * FULL_SIZE
    g = GEMM_SIZE
    trunc = MulSpec("truncated", 8, 3)
    spec16, spec32 = spec_at("haloc_axa", 16), spec_at("haloc_axa", 32)
    pairs = [tuple(containers(torch, np, rng, shape, 8, dev)
                   for _ in range(2)) for _ in range(4)]
    images = [torch.as_tensor(rng.integers(0, 256, shape).astype(np.int32),
                              device=dev) for _ in range(4)]
    # 32 int8 operand pairs of 2 MiB (and 8 int32 pairs of 8 MiB): more
    # than the 50 MB L2 holds.
    gemms = [(int8_operands(torch, np, rng, (g, g), dev),
              int8_operands(torch, np, rng, (g, g), dev)) for _ in range(32)]
    gemms32 = [(a.to(torch.int32), b.to(torch.int32)) for a, b in gemms[:8]]
    folds = -(-g // GEMM_BK) - 1
    work = {
        "mul": dict(
            source="src/repro_torch/csrc/mul.cu",
            replaces="src/repro/kernels/mac.py:67",
            what=f"truncated n8t3 reference, int32 pair {shape}",
            kernel=[lambda a=a, b=b: mul_k.mul(a, b, trunc) for a, b in pairs],
            plain=[lambda a=a, b=b: mul_k.mul_plain(a, b, trunc)
                   for a, b in pairs],
            bytes=3 * 4 * n, ops=ops_truncated_mul(3) * n),
        "mac_matmul": dict(
            source="src/repro_torch/csrc/mac_matmul.cu",
            replaces="src/repro/kernels/mac.py:134",
            what=f"haloc_axa n32m10k5 + truncated n8t3, int32 "
                 f"({g}, {g}) @ ({g}, {g}), bk {GEMM_BK}",
            kernel=[lambda a=a, b=b: mac_k.mac_matmul(a, b, spec32, trunc,
                                                      bk=GEMM_BK)
                    for a, b in gemms32],
            plain=[lambda a=a, b=b: mac_k.mac_matmul_plain(a, b, spec32,
                                                           trunc, GEMM_BK)
                   for a, b in gemms32[:2]],
            bytes=3 * 4 * g * g + 2 * (1 << 16),
            ops=(OPS_PER_MAC_PRODUCT * g + OPS_PER_ADD * folds) * g * g,
            gathers=GATHERS_PER_MAC_PRODUCT * g * g * g,
            units=g * g, unit="output"),
        "conv2d_mac": dict(
            source="src/repro_torch/csrc/conv2d_mac.cu",
            replaces="src/repro/kernels/mac.py:192",
            what=f"haloc_axa n16m8k4 + truncated n8t3, conv3x3 kernel, "
                 f"int32 {shape}",
            kernel=[lambda q=q: conv_k.launch_conv2d_mac(q, spec16, trunc,
                                                         CONV3X3_KERNEL)
                    for q in images],
            plain=[lambda q=q: conv_k.conv2d_mac_plain(q, spec16, trunc,
                                                       CONV3X3_KERNEL)
                   for q in images],
            bytes=2 * 4 * n + 4 * 9 * 256,
            ops=conv_ops(CONV3X3_KERNEL, 0) * n),
        "approx_matmul": dict(
            source="src/repro_torch/csrc/approx_matmul.cu",
            replaces="src/repro/kernels/approx_matmul.py:43",
            what=f"haloc_axa n32m10k5, int8 ({g}, {g}) @ ({g}, {g}), bk "
                 f"{GEMM_BK}",
            kernel=[lambda a=a, b=b: mm_k.approx_matmul(a, b, spec32,
                                                        bk=GEMM_BK)
                    for a, b in gemms],
            plain=[lambda a=a, b=b: mm_k.approx_matmul_plain(a, b, spec32,
                                                             GEMM_BK)
                   for a, b in gemms[:2]],
            bytes=2 * g * g + 4 * g * g, ops=OPS_PER_ADD * folds * g * g,
            tensor_ops=2 * g * g * g, units=g * g, unit="output"),
    }
    # torch._int_mm computes the accurate adder's function (an exact int8
    # GEMM mod 2^32); for approximate adders it is context only.
    accurate = spec_at("accurate", 32)
    a0, b0 = gemms[0]
    check(torch.equal(torch._int_mm(a0, b0),
                      mm_k.approx_matmul(a0, b0, accurate, bk=GEMM_BK)),
          "approx_matmul with the accurate adder != torch._int_mm")
    work["approx_matmul"]["library"] = [
        lambda a=a, b=b: torch._int_mm(a, b) for a, b in gemms]
    entries = time_entries(torch, work, launches, errs, int32_ops_per_s, n,
                           plain_reps=5)
    time_conv_gather(torch, dev, images, spec16, trunc, conv_k,
                     CONV3X3_KERNEL)
    for fast in (False, True):
        ms = time_launches(torch, [lambda a=a, b=b: mm_k.approx_matmul(
            a, b, accurate, bk=GEMM_BK, fast=fast) for a, b in gemms], 40)
        log(f"  approx_matmul with the accurate adder (fast={fast}): "
            f"{ms:.4f} ms, the same function as torch._int_mm")
    # One call's device time by kernel: the B transpose and the GEMM.
    call = (lambda: mm_k.approx_matmul(a0, b0, spec32, bk=GEMM_BK))
    profile_calls(torch, call, time_wall(torch, call, 20),
                  "approx_matmul 1024^3 wrapper", calls=10, top=4)
    for ms_spec in (MulSpec("truncated", 8, 3), MulSpec("mitchell", 8)):
        for form in ("fused", "lut"):
            ms = time_launches(torch, [lambda a=a, b=b: mul_k.mul(
                a, b, ms_spec, strategy=form) for a, b in pairs], 40)
            log(f"  mul {ms_spec.short_name} {form}: {ms:.4f} ms")
    # The general staging route at the same shape: A one byte off 16.
    offs = []
    for a, b in gemms[:8]:
        buf = torch.empty(a.numel() + 1, dtype=torch.int8, device=dev)
        offs.append((buf[1:].view(a.shape), b))
        offs[-1][0].copy_(a)
    ms_gen = time_launches(torch, [lambda a=a, b=b: mm_k.approx_matmul(
        a, b, spec32, bk=GEMM_BK) for a, b in offs], 40)
    log(f"  approx_matmul through the general staging route (A one byte "
        f"off 16), haloc_axa n32m10k5: {ms_gen:.4f} ms")
    # mac_matmul: one call's device time, and its global route (w = 10,
    # the int32 table gathered from L2) at the same shape.
    profile_calls(torch, lambda: mac_k.mac_matmul(
        *gemms32[0], spec32, trunc, bk=GEMM_BK), time_wall(
        torch, lambda: mac_k.mac_matmul(*gemms32[0], spec32, trunc,
                                        bk=GEMM_BK), 10),
        "mac_matmul 1024^3 wrapper", calls=10, top=2)
    w10 = MulSpec("mitchell", 10)
    gemms10 = [(a * 4, b * 4) for a, b in gemms32[:4]]
    check(torch.equal(mac_k.mac_matmul(gemms10[0][0][:GEMM_CPU_ROWS],
                                       gemms10[0][1], spec32, w10),
                      mac_k.mac_matmul_plain(gemms10[0][0][:GEMM_CPU_ROWS],
                                             gemms10[0][1], spec32, w10)),
          "mac_matmul global route != plain version")
    ms10 = time_launches(torch, [lambda a=a, b=b: mac_k.mac_matmul(
        a, b, spec32, w10, bk=GEMM_BK) for a, b in gemms10], 10)
    log(f"  mac_matmul route {mac_k.mac_route(10)} (w = 10, mitchell n10, "
        f"the int32 table in global memory), n32m10k5, 1024^3: "
        f"{ms10:.4f} ms")
    ms16 = time_launches(torch, [lambda a=a, b=b: mac_k.mac_matmul(
        a, b, spec16, trunc, bk=GEMM_BK) for a, b in gemms32], 20)
    mm16 = time_launches(torch, [lambda a=a, b=b: mm_k.approx_matmul(
        a, b, spec16, bk=GEMM_BK) for a, b in gemms], 40)
    log(f"  at n16m8k4: mac_matmul {ms16:.4f} ms, approx_matmul "
        f"{mm16:.4f} ms")
    return entries


def time_conv_gather(torch, dev, images, spec, mul_spec, conv_k, kernel):
    """conv2d_mac's spread over five timings of the random images of the
    kernels line, its time on constant images, where every lane's gather
    reads one word (a broadcast), and the wrapper's time with its
    ``|q| < 2^w`` check (a reduction read on the host, so each call waits
    for the card)."""
    const = [torch.full_like(images[0], v) for v in (200, 17, 255, 96)]
    check(torch.equal(conv_k.conv2d_mac(const[0], spec, mul_spec, kernel),
                      conv_k.conv2d_mac_plain(const[0], spec, mul_spec,
                                              kernel)),
          "conv2d_mac kernel != plain version on a constant image")

    def launches(qs):
        return [lambda q=q: conv_k.launch_conv2d_mac(q, spec, mul_spec,
                                                     kernel) for q in qs]

    runs = [time_launches(torch, launches(images), 40) for _ in range(5)]
    const_ms = time_launches(torch, launches(const), 40)
    checked = [time_launches(torch, [lambda q=q: conv_k.conv2d_mac(
        q, spec, mul_spec, kernel) for q in images], 40) for _ in range(3)]
    log(f"  conv2d_mac conv3x3 route {conv_k.conv_route(3, 3, 256)}, random "
        f"images: {', '.join(f'{ms:.5f}' for ms in runs)} ms over 5 "
        f"timings (spread {max(runs) - min(runs):.5f} ms); constant images "
        f"(every gather a broadcast): {const_ms:.5f} ms; through the "
        f"wrapper with its range check: "
        f"{', '.join(f'{ms:.5f}' for ms in checked)} ms")


def time_conv3x3(torch, batch):
    """The conv3x3 workload's wall time on the 4 x 1024 x 1024 host batch
    (host arrays in and out, what run_corpus times), haloc_axa, and its
    device time by kernel."""
    from repro_torch.imgproc import get_workload
    wl = get_workload("conv3x3")
    sec = time_wall(torch, lambda: wl.run(batch, kind="haloc_axa"), 5)
    log(f"  conv3x3 workload {tuple(batch.shape)}, haloc_axa: "
        f"{sec * 1e3:.3f} ms per call = {batch.size / sec / 1e6:.1f} MPix/s "
        f"(wall, median of 5)")
    profile_calls(torch, lambda: wl.run(batch, kind="haloc_axa"), sec,
                  "conv3x3 workload", calls=3, top=6)


def time_wall(torch, fn, reps=10):
    """Median wall seconds of ``fn()`` followed by a synchronize (host
    overhead included), after one untimed call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def time_chain(torch, gbatch):
    """Wall-clock MPix/s of the megapixel chain (host overhead included,
    output left on the card), median of 10 calls."""
    from repro_torch.imgproc import PIPELINES, compile_pipeline
    out = {}
    for requant in ("stage", "fused"):
        pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                                kind="haloc_axa", requant=requant)
        sec = time_wall(torch, lambda: pipe(gbatch))
        out[requant] = (sec, gbatch.numel() / sec / 1e6)
    return out


def device_times(torch, fn, calls):
    """{kernel: (device us, launches)} summed over ``calls`` calls of
    ``fn``, from ``torch.profiler`` (kernel events only, so no kernel is
    counted twice through the op that launched it); empty when the
    profiler saw no device time.  The profiler can lose events: a count
    that is not a multiple of ``calls`` shows it, and us / launches is
    then still a launch's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key: (ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def profile_calls(torch, fn, wall_s, label, calls=5, top=10):
    """Device time by kernel over ``calls`` calls of ``fn``
    (:func:`device_times`): each kernel's time a launch and launches a
    call, the device's busy time a call and its idle share against the
    unprofiled wall time ``wall_s`` per call (the profiler's own overhead
    stretches its window).  Returns {kernel: us per call}, empty when the
    profiler saw no device time."""
    times = device_times(torch, fn, calls)
    if not times:
        log(f"  profile of {label}: the profiler recorded no device time "
            f"(not measured)")
        return {}
    rows = sorted(((us / calls, n, key) for key, (us, n) in times.items()),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    lost = [key for _, n, key in rows if n % calls]
    log(f"  profile of {calls} {label} calls: device busy "
        f"{busy_us:.1f} us per call in {sum(r[1] for r in rows) / calls:.1f}"
        f" kernel launches; idle share against the unprofiled "
        f"{wall_s * 1e6:.1f} us per call: {1 - busy_us / (wall_s * 1e6):.3f}"
        + (f" (the profiler lost events of {len(lost)} kernels: busy is a "
           f"lower bound, idle an upper one)" if lost else ""))
    for us, count, key in rows[:top]:
        log(f"    {us:9.1f} us/call  {count / calls:5.1f} launches/call  "
            f"{us * calls / count:8.1f} us/launch  {key[:80]}")
    return {key: us for us, _, key in rows}


def profile_chain(torch, gbatch, wall_s):
    """The stage-mode megapixel chain's device time by kernel."""
    from repro_torch.imgproc import PIPELINES, compile_pipeline
    pipe = compile_pipeline(PIPELINES["pipe_blur_sharpen_down"],
                            kind="haloc_axa")
    profile_calls(torch, lambda: pipe(gbatch), wall_s,
                  "stage-mode chain")


def time_fft(torch, np, img, batch, dev):
    """The butterfly wrapper's wall time per call in a loop, then wall ms
    per image and the butterfly / glue / idle split of
    ``reconstruct`` (512 x 512, block 16, image on the card, output left
    there) and of the ``fft_reconstruct`` workload (4 x 1024 x 1024 host
    batch in, host batch out), haloc_axa."""
    from repro_torch.core.specs import paper_spec
    from repro_torch.image.pipeline import reconstruct
    from repro_torch.kernels.butterfly import stage_twiddles
    from repro_torch.imgproc import get_workload
    from repro_torch.kernels import butterfly as bf_k
    # The wrapper's own cost: a loop of calls at a 512 block-16 stage
    # shape, whose kernel takes some 7 us, is bound by the host.
    rng = np.random.default_rng(4)
    planes = stage_planes(torch, np, rng, FFT_SIZE * FFT_SIZE // 16, 8,
                          1 << 24, dev)
    w_re, w_im = stage_twiddles(8, False, dev)
    spec = paper_spec("haloc_axa")
    loop = 100
    sec = time_wall(torch, lambda: [bf_k.butterfly(*planes, w_re, w_im, spec,
                                                   fast=True)
                                    for _ in range(loop)], 5)
    log(f"  butterfly wrapper in a loop of {loop} calls at "
        f"{tuple(planes[0].shape)}: {sec / loop * 1e6:.1f} us wall per call")
    gimg = torch.as_tensor(img, device=dev)
    wl = get_workload("fft_reconstruct")
    cases = (
        (f"reconstruct {img.shape[0]}x{img.shape[1]} block 16", 1,
         lambda: reconstruct(gimg, paper_spec("haloc_axa")), 10),
        (f"fft_reconstruct workload {tuple(batch.shape)}", batch.shape[0],
         lambda: wl.run(batch, kind="haloc_axa"), 5))
    for label, images, fn, reps in cases:
        sec = time_wall(torch, fn, reps)
        log(f"  {label}, haloc_axa: {sec * 1e3:.3f} ms per call = "
            f"{sec * 1e3 / images:.3f} ms per image (wall, median of {reps})")
        by_kernel = profile_calls(torch, fn, sec, label, calls=3, top=6)
        if by_kernel:
            bf = sum(us for k, us in by_kernel.items() if "butterfly" in k)
            glue = sum(by_kernel.values()) - bf
            log(f"    split per call: the FFT kernels (fft_axis, "
                f"butterfly) {bf:.1f} us, glue (every other kernel) "
                f"{glue:.1f} us, idle {sec * 1e6 - bf - glue:.1f} us of "
                f"{sec * 1e6:.1f} us")


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
    report_ptxas(_build)

    log("phase 3: kernels against their plain versions on the card")
    errs = {name: 0 for name in MAIN_PATH_KERNELS + FFT_PATH_KERNELS
            + MAC_PATH_KERNELS}
    check_kernels(torch, np, dev, errs)
    log("phase 3b: butterfly and lut_add against their plain versions")
    check_fft_lut_kernels(torch, np, dev, errs)
    log("phase 3c: mul, mac_matmul, conv2d_mac and approx_matmul against "
        "their plain versions")
    check_mac_kernels(torch, np, dev, errs)

    log("phase 4: the slice at full size")
    from repro_torch.imgproc import (PIPELINES, compile_pipeline,
                                     format_table, synthetic_batch)
    batch = synthetic_batch(N_IMAGES, FULL_SIZE)
    gbatch = torch.as_tensor(batch, device=dev)
    counts = counters()
    (outs, rows), launches = run_counted(
        torch, counts, MAIN_PATH_KERNELS,
        lambda: run_main_path(torch, np, gbatch), "main path")
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
    check_one_launch(torch, gbatch)

    log("phase 4b: the Fig-5 FFT and lut path at full size")
    from repro_torch.core.specs import TABLE1_KINDS, paper_spec
    from repro_torch.image.pipeline import reconstruct, synthetic_image
    img = synthetic_image(FFT_SIZE)
    (f_outs, f_rows), f_launches = run_counted(
        torch, counts, FFT_PATH_KERNELS,
        lambda: run_fft_lut_path(torch, np, img, batch), "FFT and lut path")
    for name in FFT_PATH_KERNELS[:3]:
        launches[name] = f_launches[name]
    check_reconstruct_launches(torch, img, counts)
    t0 = time.perf_counter()
    cpu_f, _ = run_fft_lut_path(torch, np, img, batch, backend="torch",
                                device="cpu", corpus=False, fft_images=1)
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_fft_outputs(torch, np, f_outs, cpu_f)
    log(f"  {len(cpu_f)} outputs equal the CPU path (fft_reconstruct on "
        f"image 0)")
    log(f"  reconstruct(synthetic_image({FFT_SIZE}), paper_spec(kind)), "
        f"block 16, on the card:")
    check_ordering(np, img, {k: f_outs[("reconstruct", k, 16)].cpu().numpy()
                             for k in TABLE1_KINDS}, f"{FFT_SIZE} x {FFT_SIZE}")
    small = synthetic_image(ORDERING_SIZE)
    recs = {}
    for kind in TABLE1_KINDS:
        rec = reconstruct(small, paper_spec(kind))
        check(torch.equal(rec.cpu(), reconstruct(small, paper_spec(kind),
                                                 backend="torch",
                                                 device="cpu")),
              f"reconstruct {kind} at {ORDERING_SIZE}: the card's output "
              f"differs from the CPU path")
        recs[kind] = rec.cpu().numpy()
    log(f"  reconstruct(synthetic_image({ORDERING_SIZE}), paper_spec(kind)),"
        f" block 16, on the card (equal to the CPU path):")
    check(check_ordering(np, small, recs,
                         f"{ORDERING_SIZE} x {ORDERING_SIZE}"),
          f"the paper's quality ordering does not hold at {ORDERING_SIZE}")
    log("  run_corpus(include_fft=True, workloads=('fft_reconstruct',)) on "
        "synthetic_batch(4, 1024), PSNR dB / SSIM:")
    for line in format_table(f_rows).splitlines():
        log("    " + line)

    log("phase 4c: the MAC path at full size")
    a8, b8 = gemm_operands(torch, np)
    (m_outs, m_rows), m_launches = run_counted(
        torch, counts, MAC_PATH_KERNELS,
        lambda: run_mac_path(torch, np, batch, a8, b8), "MAC path")
    for name in MAC_PATH_KERNELS:
        launches[name] = m_launches[name]
    t0 = time.perf_counter()
    cpu_m, _ = run_mac_path(torch, np, batch, a8[:GEMM_CPU_ROWS], b8,
                            backend="torch", device="cpu", corpus=False)
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_mac_outputs(torch, m_outs, cpu_m)
    log(f"  {len(cpu_m)} outputs equal the CPU path (the four GEMMs on their "
        f"first {GEMM_CPU_ROWS} rows); run_corpus on image 0 with conv3x3 "
        f"among the default workloads was held against the CPU path in "
        f"phase 4")
    check(all(0 < r.ssim <= 1.0 + 1e-12 and (np.isfinite(r.psnr)
                                            or r.psnr == float("inf"))
              for r in m_rows),
          f"conv3x3 corpus scores out of range: {m_rows}")
    log("  run_corpus(workloads=('conv3x3',)) on synthetic_batch(4, 1024), "
        "PSNR dB / SSIM:")
    for line in format_table(m_rows).splitlines():
        log("    " + line)

    log("phase 4d: Table 1, the Fig-6 design space and the Monte-Carlo "
        "cross-check on the card")
    t0 = time.perf_counter()
    t_launches = table1_phase(torch, np, dev, counts, card)
    for name in TABLE1_PATH_KERNELS:
        launches[name] += t_launches[name]
    log(f"  phase 4d took {time.perf_counter() - t0:.1f} s")

    log("phase 4e: streaming, telemetry and faults at full width")
    t0 = time.perf_counter()
    e_launches = faults_phase(torch, np, dev, counts, card)
    for name in FAULT_PATH_KERNELS:
        launches[name] += e_launches[name]
    log(f"  phase 4e took {time.perf_counter() - t0:.1f} s")

    log("phase 4f: integrity and serving at full width")
    t0 = time.perf_counter()
    i_launches = integrity_phase(torch, np, dev, counts, card, a8.to(dev),
                                 b8.to(dev), gbatch, batch)
    for name in INTEGRITY_PATH_KERNELS:
        launches[name] += i_launches[name]
    log(f"  phase 4f took {time.perf_counter() - t0:.1f} s")

    log("phase 5: times (CUDA events, median)")
    int32_ops_per_s = int32_rate(torch, dev)
    entries = measure(torch, np, dev, launches, errs, int32_ops_per_s)
    chain = time_chain(torch, gbatch)
    for requant, (sec, mpix) in chain.items():
        log(f"  megapixel chain gaussian_blur -> sharpen -> downsample2x, "
            f"haloc_axa, requant={requant}: {sec * 1e3:.3f} ms per "
            f"{tuple(gbatch.shape)} batch = {mpix:.1f} MPix/s")
    profile_chain(torch, gbatch, chain["stage"][0])
    time_fft(torch, np, img, batch, dev)
    log("phase 5c: the MAC kernels' times")
    entries += measure_mac(torch, np, dev, launches, errs, int32_ops_per_s)
    time_conv3x3(torch, batch)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
