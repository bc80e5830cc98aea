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
   equal the port's CPU path on the batch's first image (its two-input
   operators given the card's partner, the last image), and tiled must
   equal untiled.  The corpus table of the four images is range-checked;
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

The LM serving slice adds phase 4g, at full width, with the counts set to
0 just before its path and read just after (its ``approx_add`` launches
join the ``kernels`` line):

4g. ``approx_add`` against its plain version at the residual adds' shapes;
   (a) the path: Qwen3-4B at full width and depth (36 layers, d_model
   2560, 32/8 heads, d_ff 9728, vocab 151936; bf16 matrices from a seeded
   generator on the card), ``make_numerics("haloc_axa", "residual")``,
   ``generate`` of 4 x (128 + 4) tokens, greedy: 72 ``approx_add``
   launches a forward step and no other kernel, tokens and every step's
   logits bit for bit those of the plain versions on the card; (b)
   prefill + decode against ``forward(mode="full")`` within the
   reference's rule (max |d| / max(1, max |logit|) < 0.04) with exact
   residual adds, and under haloc_axa the teacher-forced prefill and
   decode equal to ``generate``'s own logits (the parity against the full
   forward printed: the adder turns a GEMM's one-ulp difference into
   changes of up to 2^m units); (c) the model cut to its first two layers
   against the port's CPU path, teacher-forced on the card's tokens:
   exact logits within the rule, every haloc_axa residual add on the card
   equal to the CPU path's on its operands; (d) gemma3-27b at full width
   cut to 8 layers (one pattern repeat and the suffix), batch 2, an
   1100-token prompt past its 1024 window and 4 decode steps: exact
   parity within the rule, haloc_axa teacher-forced equal to
   ``generate``; (e) prefill ms, decode ms a step and tokens/s, exact and
   haloc_axa, and a ``torch.profiler`` breakdown of one decode step
   (``approx_add``, the matmuls, the rest; the residual adds' glue; the
   idle share) beside the card's name and power limit; (f)
   ``python -m repro_torch.launch.serve --arch qwen3-4b --adder haloc_axa
   --batch 4 --prompt-len 32 --new-tokens 16`` exits 0 and prints its
   report line.

The MoE slice adds phase 4h, at full width, its counts set to 0 just
before each of its two paths and read just after (their ``approx_add``
launches join the ``kernels`` line):

4h. (a) ``approx_add`` against its plain version at (4, 128, 1024) and
   (4, 1, 1024); granite-moe-1b-a400m at its full published config (24
   layers, d_model 1024, 16/8 heads, 32 experts top-8 with d_ff 512,
   vocab 49155 padded to 51200; bf16 weights from a seeded generator on
   the card), ``generate`` of 4 x (128 + 4) tokens under haloc_axa: 48
   ``approx_add`` launches a forward step (192) and no other kernel,
   tokens and every step's logits bit for bit those of the plain versions
   on the card; with exact adds at capacity factor 8 and one sequence
   chunk, prefill + decode against ``forward(mode="full")`` within the
   reference's MoE rule (< 0.08; the haloc_axa figure printed); prefill
   ms, decode ms a step, the decode step's launches and idle share, and
   its weight-bytes bound, exact and haloc_axa; (b) the same at
   (4, 128, 5120) and (4, 1, 5120) and for DeepSeek-V2 at full width
   (d_model 5120, 128 heads, MLA kv_lora 512 / q_lora 1536 / rope 64,
   160 routed experts top-6 + 2 shared, 8 sequence chunks), depth cut
   from 60 to 3 layers (the dense block and two MoE blocks), ``generate``
   of 4 x (128 + 4) tokens: 6 launches a step (24), bit for bit against
   the plain versions; ``mla_decode``'s absorbed mode against decompress
   with exact adds, teacher-forced, within 0.04; the times.

The RG-LRU and SSD slice adds phase 4i, at full width, its counts set to 0
just before each of its two paths and read just after (their
``approx_add`` launches join the ``kernels`` line):

4i. for recurrentgemma-9b at full width and depth (38 blocks, 26 RG-LRU
   and 12 windowed MQA, d_model 4096, window 2048, vocab 256000;
   9,627,095,040 parameters) and mamba2-1.3b at its full config (48 SSD
   layers, d_inner 4096, 64 heads x 64, d_state 128, chunk 256;
   1,446,714,368), bf16 weights from a seeded generator on the card with
   ``lam``, ``a_log`` and ``dt_bias`` fp32: ``approx_add`` against its
   plain version at (4, 128 | 600, d_model) and (4, 1, d_model); (a)
   ``generate`` of 4 x (128 + 4) and 4 x (600 + 4) tokens (600: two
   chunks and an 88-token tail, ``ssd_apply``'s remainder path) under
   haloc_axa: 76 and 48 ``approx_add`` launches a forward step and no
   other kernel, tokens and every step's logits bit for bit those of the
   plain versions on the card; (b) with exact adds prefill + decode
   against ``forward(mode="full")`` within 0.04 on the first blocks,
   under haloc_axa the teacher-forced logits equal to ``generate``'s (the
   parity printed);
   (c) each model cut to its first blocks (one rec/rec/attn repeat; two
   SSD layers) against the port's CPU path, teacher-forced on the card's
   tokens: exact logits within the rule, every haloc_axa residual add
   equal to the CPU path's on its operands; (d) prefill ms, decode ms a
   step and tokens/s, exact and haloc_axa, a decode step's launches,
   idle share and device time by kernel class and inside the mixers,
   the bytes bound, and the CPU path's ``exp`` emulation timed on the
   card; (e) recurrentgemma-9b at batch 2 with a 2100-token prompt past
   its window and 4 decode steps: exact parity within the rule,
   haloc_axa teacher-forced equal to ``generate``.

The cross attention and audio slice adds phase 4j, at full width, its
counts set to 0 just before each of its two paths and read just after
(their ``approx_add`` launches join the ``kernels`` line):

4j. bf16 weights from a seeded generator on the card (norm scales and the
   tanh gates fp32), every gate and bias set to seeded nonzero values
   (printed); ``approx_add`` against its plain version at (4, 128 | 1,
   4096) and (4, 1500 | 1, 1280); (a) llama-3.2-vision-11b at full width
   and depth (40 layers: 32 self, rope base 500000, 8 gated cross
   attention; d_model 4096, 32/8 heads x 128, d_ff 14336, vocab 128256;
   9,791,936,528 parameters), ``generate`` of 4 x (128 + 4) tokens with
   a (4, 1601, 4096) vision input under haloc_axa: 80 ``approx_add``
   launches a forward step and no other kernel, tokens and every step's
   logits bit for bit those of the plain versions on the card; (b) with
   exact adds prefill + decode against ``forward(mode="full")`` by depth
   (gated < 0.04 at full depth, 40 layers),
   under haloc_axa the teacher-forced logits equal to ``generate``'s (the
   parity printed); (c) the first pattern
   repeat (4 self + 1 cross) against the port's CPU path, teacher-forced
   on the card's tokens: exact logits within the rule, every haloc_axa
   residual add equal to the CPU path's on its operands; (d) hubert-xlarge
   at full width and depth (48 encoder layers, d_model 1280, 16 heads x
   80, d_ff 5120, 504 classes; 945,451,520 parameters) on 4 x 1500 frames
   of 512 features (two KV chunks, a 476-frame tail) under haloc_axa: 96
   launches a forward, logits bit for bit the plain versions', its first
   two layers against the CPU path as in (c); (e) llama's prefill ms
   (adapter and cross K/V included), decode ms a step, tokens/s, a step's
   launches and idle share, exact and haloc_axa, and its bytes bound;
   hubert's forward ms, frames/s, launches and idle share, and its FLOP
   bound; (f) ``python -m repro_torch.launch.serve --arch
   llama-3.2-vision-11b --adder haloc_axa --batch 4 --prompt-len 32
   --new-tokens 16`` exits 0.

The training slice adds phase 4k, at full width, its counts set to 0 just
before each of its three paths and read just after (their ``approx_add``
launches join the ``kernels`` line), under deterministic algorithms
(``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the first cuBLAS call):

4k. (a) ``approx_add`` against its plain version at (4, 128 | 1, 2560)
   and (4, 128 | 1, 1024); (b) Qwen3-4B at full width cut to 24 of its 36
   layers (3,200,254,464 fp32 parameters: 36 layers' parameters,
   gradients and AdamW states do not fit the card): ``init_state`` and 3
   steps of ``make_train_step`` on ``synthetic_batch(cfg,
   DataConfig(seq_len=128, global_batch=4), step)`` under haloc_axa: 48
   ``approx_add`` launches a step and no other kernel, a finite loss and
   ``grad_norm > 0`` at every step, the peak memory against the state's
   bytes; the same steps with the plain version on the card: every loss,
   ce, aux and grad_norm and the final parameters equal bit for bit;
   (c) Qwen3-4B cut to its first 2 layers (parameters drawn on the CPU
   from seed 1), one step's loss (within 1e-3) and gradients (every leaf
   within 0.05) on the card against the CPU path, exact adds; under
   haloc_axa each residual add of the card's forward equal to the CPU
   path's on its operands, the losses and the worst gradient leaf
   printed; (d) granite-moe-1b-a400m at its full config
   (1,389,151,232 parameters) as (b), ``aux > 0``; (e) the flash VJP at
   (1, 4096, 32/8 heads, 128), causal, against autograd through
   ``plain_attention``: output, dq, dk, dv within 0.02, both timed with
   their peak memory; (f) for (b) and (d), exact and haloc_axa: step ms
   split into forward, backward and update, tokens/s, a profiled step's
   launches and idle share, and the bound (the FLOP at 989 TFLOP/s plus
   AdamW's 28 B a parameter at 3.35 TB/s); (g) ``python -m
   repro_torch.launch.train --arch granite-moe-1b-a400m --adder haloc_axa
   --steps 4 --batch 4 --seq 128`` exits 0 and prints its line; (h) the
   qwen3-4b smoke config under haloc_axa trained 4 steps with a
   checkpoint every 2 (``build/train_restart``), restarted and run to
   step 6: steps 4 and 5's losses equal an uninterrupted run's.  (c)'s
   CPU half (``chip_smoke.py --train-cpu-half``, a process of its own)
   and (g) start after the build (phase 2b) and run beside phases 3-4c,
   which time nothing; they are joined before phase 4d.

The sharding slice adds phase 4l, its counts set to 0 just before each
of its paths and read just after (their ``approx_add`` launches join
the ``kernels`` line), (a) and (b) on a (1, 1) ("data", "model")
``DeviceMesh`` over one NCCL rank (a ``HashStore``), (d) on a (1, 2)
mesh of two gloo ranks on the card, under deterministic algorithms:

4l. (a) Qwen3-4B at full width cut to 4 layers (1,181,638,144 fp32
   parameters): the placed state's bytes on the card against the dry
   run's per-device state bytes (``launch.dryrun.state_bytes``, within
   the caching allocator's rounding); 3 steps of ``train_loop.run(mesh=
   ...)`` on 4 x 128 tokens under haloc_axa: 8 ``approx_add`` launches a
   step and no other kernel, the losses and every leaf of the state
   (parameters, m, v, count, step) equal to the plain version's on the
   sharded loop and, exact and haloc_axa, to the unsharded loop's, bit
   for bit; the sharded step's ms, launches and idle share; (b)
   granite-moe-1b-a400m at its full config, ``use_shard_map=True``: the
   prefill step on the mesh of 4 x 128 tokens under haloc_axa, counted
   (48 launches), its last logits against ``moe_apply``'s (haloc_axa and
   exact, the MoE rule 0.08), and cut to 2 layers the card against the
   CPU path (exact, 0.08); (c) ``python -m torch.distributed.run
   --standalone --nproc-per-node 1 -m repro_torch.launch.train --arch
   qwen3-4b --smoke --steps 2`` exits 0 and prints its line (started after the
   build, beside phases 3-4c, with phase 4k's (g)); (d) (a)'s loop with
   compute over "model" tensor-parallel, on a (1, 2) mesh of two ranks
   sharing the card (NCCL refuses two ranks on one device: a gloo group,
   each rank a process of its own, ``chip_smoke.py --tp-rank``, its
   counts set to 0 and read around its loop there): each rank's placed
   state's bytes against the dry run's on (1, 2); 8 ``approx_add``
   launches a step a rank and no other kernel; the two ranks' losses
   equal bit for bit; the kernel's loop equal to the plain version's,
   every leaf each rank holds, bit for bit; with exact adds the losses
   within 1e-3 of (a)'s unsharded loop's and step 1's gathered gradient
   leaves within 0.05 of the unsharded step's (the haloc_axa losses
   printed beside the unsharded loop's); the step's ms split forward /
   backward / update, a profiled step's launches and idle share and the
   peak memory a rank, printed beside a line saying that gloo stages the
   collectives through the host and the ranks share one card.  Then, in
   the same two processes, the train state freed, tensor-parallel
   serving: Qwen3-4B at full width cut to 4 layers, bf16 parameters from
   seed 0 placed by the rules on (1, 2), a prefill of 4 x 128 tokens and
   4 greedy decode steps with a cache of 4 x 132 positions, three times
   (haloc_axa with the kernel, counted: 8 ``approx_add`` launches a
   forward a rank; haloc_axa on the plain versions; exact): each rank's
   cache bytes (its 4 of the 8 kv heads) equal to the dry run's
   ``cache_bytes`` on (1, 2) exactly; the two ranks' logits and tokens
   equal bit for bit at the prefill and every decode step; the kernel's
   run equal to the plain version's (logits, tokens, every cache tensor)
   bit for bit; the exact logits within the reference's rule (0.04) of
   rank 0's unsharded pass on the whole parameters, teacher-forced with
   the sharded run's tokens (the haloc_axa logits against it printed);
   prefill ms, decode ms a step, a profiled decode step's launches and
   idle share printed.  A rank that cannot join or fails fails the
   phase.

The entry-point slice adds phase 4m, its counts set to 0 just before each
counted run and read just after (their launches join the ``kernels``
line):

4m. the six examples through their ``main`` on the card: quickstart (its
   residual add's ``approx_add``), adder_design_space, image_reconstruction
   at 512 (``fft_axis``), approx_mac at 256 (``conv2d_mac``), serve_decode
   (``--arch qwen3-4b --temperature 0 --new-tokens 4``, ``approx_add``)
   and train_approx_lm at its full default width for 10 steps, both
   adders (``approx_add``), and the three deprecated shims of
   ``kernels.ops`` (``approx_add``, ``approx_matmul``, ``butterfly``).
   The same calls with ``--backend torch`` on the card equal them bit for
   bit (quickstart's figures, the PSNR/SSIM, the MAC outputs, the greedy
   tokens, the shims' outputs, and under deterministic algorithms the
   train example's first 3 losses); image_reconstruction and approx_mac
   at 128 and quickstart equal the CPU path; each example's wall seconds
   and the train example's step ms, tokens/s and losses at steps 1 and 10
   are printed beside the card's name and power limit.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
run from a directory without ``src/repro_torch``, it exits non-zero and
prints no result.
"""

import contextlib
import io
import json
import os
import pathlib
import statistics
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

def run_main_path(torch, np, batch, backend=None, device=None, corpus=True,
                  pair=None):
    """The slice through the entry points a user calls; returns the
    outputs (tensors on the engine's device) and the corpus rows (None
    without ``corpus``).  The two-input operators take each image with
    the batch's previous one (``pair``: those second inputs, when
    ``batch`` is a head of the batch)."""
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
    pair = torch.roll(x, 1, dims=0) if pair is None else ax.tensor(pair)
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
        n = want.shape[0]           # the CPU path runs the batch's head
        check(got.device.type == "cuda", f"{key} did not run on the card")
        check(tuple(got.shape[1:]) == tuple(want.shape[1:])
              and torch.equal(got[:n].cpu(), want),
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


# ------------------------------------------------------------ phase 4g --

#: The LM slice's model: Qwen3-4B at full width and depth, bf16 weights
#: from a seeded generator on the card, the residual adds through
#: haloc_axa n16m8k4 (``make_numerics("haloc_axa", "residual")``).
LM_ARCH = "qwen3-4b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 128, 4
#: The card-against-CPU case: the same model cut to its first two layers.
LM_CPU_LAYERS, LM_CPU_NEW = 2, 2
#: The window case: gemma3-27b at full width cut to one pattern repeat
#: and the suffix (8 layers: 5 local, 1 global, 2 local), a prompt longer
#: than its 1024-token window.
LM_WINDOW_ARCH = "gemma3-27b"
LM_WINDOW_BATCH, LM_WINDOW_PROMPT, LM_WINDOW_NEW = 2, 1100, 4
#: The reference's parity rule (``tests/test_models_smoke.py``):
#: max |d| / max(1, max |logit|).
LM_TOL = 0.04
#: The kernels phase 4g's path runs: the residual adds.
LM_PATH_KERNELS = ("approx_add",)
#: Decode steps timed after a prefill, then steps profiled (the first
#: three of them timed unprofiled).
LM_TIMED_STEPS, LM_PROFILED_STEPS = 4, 6
#: cuBLAS kernels (bf16 GEMMs and their split-K reductions), by name.
MATMUL_KERNEL_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "splitK")


def lm_rel(torch, got, want):
    """max |got - want| / max(1, max |want|), in fp32."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def lm_numerics(kind, backend, device):
    from repro_torch.numerics.approx_ops import make_numerics
    return make_numerics(kind, "residual", backend=backend, device=device)


def lm_prompt(torch, cfg, batch, length, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, length),
                                    generator=gen, device=dev)}


def lm_parity(torch, T, params, cfg, toks, logits, prompt_len, extra=None):
    """Per decode step, the generated logits against ``forward(mode=
    "full")`` on the same tokens (the reference's parity rule); ``extra``:
    the prompt's other inputs (a vision model's ``vision``)."""
    full = T.forward(params, cfg, dict(extra or {}, tokens=toks[:, :-1]),
                     mode="full")[0]
    return [lm_rel(torch, logits[:, i], full[:, prompt_len - 1 + i])
            for i in range(logits.shape[1])]


def check_lm_kernel_shapes(torch, np, dev, errs, width=2560,
                           prompt=LM_PROMPT):
    """``approx_add`` at the residual adds' container shapes (prefill of
    ``prompt`` tokens and decode at batch 4 of a model of ``width``:
    Qwen3-4B's by default) against its plain version, every kind, both
    forms."""
    from repro_torch.core import specs
    from repro_torch.kernels import approx_add as add_k
    rng = np.random.default_rng(20)
    for shape in ((LM_BATCH, prompt, width), (LM_BATCH, 1, width)):
        a = containers(torch, np, rng, shape, 16, dev)
        b = containers(torch, np, rng, shape, 16, dev)
        for kind in specs.ALL_KINDS:
            for fast in (False, True):
                s = spec_at(kind, 16)
                compare_into(torch, errs, "approx_add",
                             add_k.approx_add(a, b, s, fast=fast),
                             add_k.approx_add_plain(a, b, s, fast),
                             f"{s.short_name} fast={fast} {shape}")


def tree_bytes(tree):
    """Bytes of the tensors in a tree of dicts and lists (None: 0)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class ResidualRecorder:
    """Stands for ``cfg.approx``: runs its residual add and keeps each
    call's operands and result."""

    def __init__(self, approx):
        self.approx, self.calls = approx, []
        self.enabled = approx.enabled

    def residual_add(self, x, y):
        out = self.approx.residual_add(x, y)
        self.calls.append((x, y, out))
        return out


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def check_adds_on_cpu(torch, rec, cpu_approx, what):
    """Every residual add the card ran (``rec``'s calls) equals the CPU
    path's add on the same operands, bit for bit (the card's operands
    suffice: no CPU forward is needed for it)."""
    for x, y, out in rec.calls:
        check(torch.equal(out.cpu(), cpu_approx.residual_add(x.cpu(),
                                                             y.cpu())),
              f"{what}: a residual add on the card differs from the CPU "
              f"path's on the same operands")


def lm_times(torch, steps, params, cfg, prompt, reps=3):
    """Median wall ms of a prefill of ``prompt`` and of one of the
    LM_TIMED_STEPS greedy decode steps after it, synchronized, over
    ``reps`` runs after an untimed one; the last run's cache and logits."""
    plen = prompt["tokens"].shape[1]
    pre_ms, dec_ms = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = steps.make_prefill_step(
            cfg, plen + LM_TIMED_STEPS + LM_PROFILED_STEPS)(params, prompt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode = steps.make_decode_step(cfg)
        for i in range(LM_TIMED_STEPS):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, cache = decode(params, {"tokens": nxt}, plen + i, cache)
        torch.cuda.synchronize()
        pre_ms.append((t1 - t0) * 1e3)
        dec_ms.append((time.perf_counter() - t1) / LM_TIMED_STEPS * 1e3)
    return (statistics.median(pre_ms[1:]), statistics.median(dec_ms[1:]),
            cache, logits)


def lm_decode_profile(torch, steps, params, cfg, cache, logits,
                      plen=LM_PROMPT):
    """One decode step's device time by kernel class, {class: (us,
    launches)}, averaged over LM_PROFILED_STEPS profiled steps after the
    timed ones of a prompt of ``plen`` tokens (empty when the profiler saw
    no device time), and the median wall ms of three unprofiled steps
    before them."""
    decode = steps.make_decode_step(cfg)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = plen + LM_TIMED_STEPS
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(params, {"tokens": nxt}, pos + i, cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    times = device_times(torch, lambda: [
        decode(params, {"tokens": nxt}, pos + 3 + i, cache)
        for i in range(LM_PROFILED_STEPS - 3)], 1)
    return (kernel_classes(times, LM_PROFILED_STEPS - 3),
            statistics.median(walls))


def lm_phase(torch, np, dev, counts, card, errs):
    """Phase 4g: the LM serving path on the card (the port's ``generate``
    at Qwen3-4B full width and depth, the residual adds in the
    ``approx_add`` kernel), held against the plain versions on the card,
    ``forward(mode="full")``, the CPU path and the launcher; returns the
    launches of the path."""
    import dataclasses
    import os
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.serving import generate, teacher_forced_logits
    from repro_torch.kernels import approx_add as add_k

    check_lm_kernel_shapes(torch, np, dev, errs)
    log(f"  approx_add equals its plain version at the residual adds' "
        f"shapes ({LM_BATCH}, {LM_PROMPT}, 2560) and ({LM_BATCH}, 1, 2560),"
        f" every kind, both forms")

    base = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = T.init_params(0, base, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    log(f"  {LM_ARCH}: {base.num_layers} layers, d_model {base.d_model}, "
        f"{base.num_heads}/{base.num_kv_heads} heads, d_ff {base.d_ff}, "
        f"vocab {base.vocab_size}: {n_params} parameters drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB (bf16 matrices)")
    hal = base.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    plain = base.with_approx(lm_numerics("haloc_axa", "torch", dev))
    prompt = lm_prompt(torch, base, LM_BATCH, LM_PROMPT, dev, 1)

    # (a) the path, counted; then the plain versions on the card
    (toks, logits), launches = run_counted(
        torch, counts, LM_PATH_KERNELS,
        lambda: generate(params, hal, prompt, LM_NEW, return_logits=True),
        "LM serving path (generate)")
    per_step = 2 * base.num_layers
    check(launches["approx_add"] == per_step * LM_NEW,
          f"approx_add launched {launches['approx_add']} times in "
          f"{LM_NEW} forward steps, not {per_step} a step")
    check(all(n == 0 for k, n in launches.items() if k != "approx_add"),
          f"the LM path launched other kernels: {launches}")
    ptoks, plogits = generate(params, plain, prompt, LM_NEW,
                              return_logits=True)
    check(torch.equal(toks, ptoks),
          "generate: the approx_add kernel's tokens differ from the plain "
          "version's on the card")
    check(torch.equal(logits, plogits),
          "generate: the approx_add kernel's logits differ from the plain "
          "version's on the card")
    log(f"  (a) generate(batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_NEW} "
        f"new, greedy), haloc_axa n16m8k4: {per_step} approx_add launches "
        f"a forward step ({launches['approx_add']} in {LM_NEW} steps); "
        f"tokens and every step's logits equal the plain version's on the "
        f"card, bit for bit")

    # (b) prefill/decode parity at full width and depth
    check(torch.equal(teacher_forced_logits(params, hal, toks, LM_PROMPT),
                      logits),
          "haloc_axa: prefill and decode on the generated tokens differ "
          "from generate's own logits")
    etoks, elogits = generate(params, base, prompt, LM_NEW,
                              return_logits=True)
    exact_par = lm_parity(torch, T, params, base, etoks, elogits, LM_PROMPT)
    check(max(exact_par) < LM_TOL,
          f"{LM_ARCH} exact: prefill/decode logits against the full forward "
          f"{max(exact_par):.4f} >= {LM_TOL}")
    hal_par = lm_parity(torch, T, params, hal, toks, logits, LM_PROMPT)
    log(f"  (b) prefill/decode against forward(mode='full'), {LM_ARCH}, "
        f"{LM_NEW} steps: exact max {max(exact_par):.4f} (< {LM_TOL}); "
        f"haloc_axa: teacher-forced prefill and decode equal generate's "
        f"logits bit for bit, against the full forward "
        f"{min(hal_par):.4f}-{max(hal_par):.4f} (printed, not gated: the "
        f"two modes run cuBLAS's products at other shapes, which round some "
        f"sums differently, and an approximate add turns a one-unit "
        f"difference of an operand into up to 2^m units)")

    # (e) times, before the CPU case frees the card
    rows = {}
    for label, cfg in (("exact", base), ("haloc_axa", hal)):
        pre, dec, cache, last = lm_times(torch, steps, params, cfg,
                                         prompt)
        prof, step_ms = lm_decode_profile(torch, steps, params, cfg, cache,
                                          last)
        rows[label] = (pre, dec, prof, step_ms)
        log(f"  (e) {label}: prefill of {LM_BATCH} x {LM_PROMPT} "
            f"{pre:.3f} ms; decode {dec:.3f} ms a step = "
            f"{LM_BATCH * 1e3 / dec:.1f} tokens/s at batch {LM_BATCH} "
            f"(wall, median of 3; {card})")
    step_bytes = tree_bytes(dict(params, embed=None)) + tree_bytes(
        cache)
    log(f"      a decode step reads every weight but the embedding table "
        f"and the whole KV cache at least once, {step_bytes / 1e9:.3f} GB: "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    for label, (pre, dec, prof, step_ms) in rows.items():
        if not prof:
            log(f"      {label} decode step profile: the profiler recorded "
                f"no device time (not measured)")
            continue
        busy = sum(us for us, _ in prof.values())
        parts = ", ".join(f"{cls} {us:.1f} us in {n:.0f} launches"
                          for cls, (us, n) in sorted(prof.items()))
        log(f"      {label} decode step by kernel class: {parts}; busy "
            f"{busy / 1e3:.3f} ms of a {step_ms:.3f} ms step, idle share "
            f"{1 - busy / (step_ms * 1e3):.3f}")
    if rows["exact"][2] and rows["haloc_axa"][2]:
        hp, ep = rows["haloc_axa"][2], rows["exact"][2]
        glue = (sum(us for us, _ in hp.values()) - hp.get("approx_add",
                                                         (0, 0))[0]
                - sum(us for us, _ in ep.values()))
        glue_n = (sum(n for _, n in hp.values()) - hp.get("approx_add",
                                                        (0, 0))[1]
                  - sum(n for _, n in ep.values()))
        log(f"      the residual adds' quantize/dequantize glue (haloc_axa "
            f"busy less approx_add less exact busy): {glue:.1f} us in "
            f"{glue_n:.0f} launches a step")

    # (c) the card against the CPU at depth LM_CPU_LAYERS
    cut = dataclasses.replace(base, repeats=LM_CPU_LAYERS)
    small = dict(params, pattern=[params["pattern"][0][:LM_CPU_LAYERS]])
    rec = ResidualRecorder(lm_numerics("haloc_axa", "cuda", dev))
    ctoks, clogits = generate(small, dataclasses.replace(cut, approx=rec),
                              prompt, LM_CPU_NEW, return_logits=True)
    ctoks_e, clogits_e = generate(small, cut, prompt, LM_CPU_NEW,
                                  return_logits=True)
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpu_params = to_cpu(small)
    cpu_hal = dataclasses.replace(cut, approx=lm_numerics("haloc_axa",
                                                          "torch", "cpu"))
    cpu = teacher_forced_logits(cpu_params, cpu_hal, ctoks.cpu(), LM_PROMPT)
    cpu_e = teacher_forced_logits(cpu_params, cut, ctoks_e.cpu(), LM_PROMPT)
    cpu_s = time.perf_counter() - t0
    exact_cc = [lm_rel(torch, cpu_e[:, i], clogits_e[:, i].cpu())
                for i in range(LM_CPU_NEW)]
    check(max(exact_cc) < LM_TOL,
          f"{LM_ARCH} cut to {LM_CPU_LAYERS} layers, exact: the card's "
          f"logits against the CPU path's {max(exact_cc):.4f} >= {LM_TOL}")
    check_adds_on_cpu(torch, rec, cpu_hal.approx, LM_ARCH)
    hal_cc = [lm_rel(torch, cpu[:, i], clogits[:, i].cpu())
              for i in range(LM_CPU_NEW)]
    log(f"  (c) {LM_ARCH} cut to its first {LM_CPU_LAYERS} layers (full "
        f"width), {LM_CPU_NEW} new tokens, the CPU path teacher-forced on "
        f"the card's tokens ({cpu_s:.1f} s): exact logits max "
        f"{max(exact_cc):.4f} (< {LM_TOL}); haloc_axa: each of the card's "
        f"{len(rec.calls)} residual adds equals the CPU path's on the same "
        f"operands, bit for bit; logits {min(hal_cc):.4f}-{max(hal_cc):.4f}"
        f" (printed, not gated: cuBLAS and the CPU's fp32 products round "
        f"differently, and the adds amplify it)")
    del small, cpu_params
    torch.cuda.empty_cache()

    # (d) the window path past the window
    wcfg = dataclasses.replace(get_config(LM_WINDOW_ARCH), repeats=1)
    wparams = T.init_params(0, wcfg, device=dev, dtype=torch.bfloat16)
    wprompt = lm_prompt(torch, wcfg, LM_WINDOW_BATCH, LM_WINDOW_PROMPT, dev,
                        2)
    torch.cuda.reset_peak_memory_stats(dev)
    wtoks, wlogits = generate(wparams, wcfg, wprompt, LM_WINDOW_NEW,
                              return_logits=True)
    wpar = lm_parity(torch, T, wparams, wcfg, wtoks, wlogits,
                     LM_WINDOW_PROMPT)
    check(max(wpar) < LM_TOL,
          f"{LM_WINDOW_ARCH} ({wcfg.num_layers} layers) exact: prefill/"
          f"decode past the window against the full forward "
          f"{max(wpar):.4f} >= {LM_TOL}")
    whal = wcfg.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    htoks, hlogits = generate(wparams, whal, wprompt, LM_WINDOW_NEW,
                              return_logits=True)
    check(torch.equal(teacher_forced_logits(wparams, whal, htoks,
                                            LM_WINDOW_PROMPT), hlogits),
          f"{LM_WINDOW_ARCH} haloc_axa: prefill and decode on the generated "
          f"tokens differ from generate's own logits")
    whal_par = lm_parity(torch, T, wparams, whal, htoks, hlogits,
                         LM_WINDOW_PROMPT)
    log(f"  (d) {LM_WINDOW_ARCH} at full width cut to {wcfg.num_layers} "
        f"layers ({T.param_count(wparams)} parameters; windows "
        f"{[s.window for s in wcfg.all_blocks()]}), batch "
        f"{LM_WINDOW_BATCH}, prompt {LM_WINDOW_PROMPT}, {LM_WINDOW_NEW} "
        f"decode steps to position {LM_WINDOW_PROMPT + LM_WINDOW_NEW - 1}: "
        f"exact against the full forward max {max(wpar):.4f} (< {LM_TOL}); "
        f"haloc_axa teacher-forced equal to generate, against the full "
        f"forward {min(whal_par):.4f}-{max(whal_par):.4f} (printed); peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del wparams
    torch.cuda.empty_cache()

    # (f) the launcher
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           LM_ARCH, "--adder", "haloc_axa", "--batch", "4", "--prompt-len",
           "32", "--new-tokens", "16"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    out = res.stdout.strip().splitlines()
    check(res.returncode == 0 and out
          and out[-1].startswith(f"{LM_ARCH}: (4, 48); "),
          f"python -m repro_torch.launch.serve exited {res.returncode}: "
          f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    log(f"  (f) python -m repro_torch.launch.serve --arch {LM_ARCH} "
        f"--adder haloc_axa --batch 4 --prompt-len 32 --new-tokens 16: "
        f"exit 0 in {time.perf_counter() - t0:.1f} s: {out[-1]}")
    return launches


# ------------------------------------------------------------ phase 4h --

#: The MoE slice's models: granite-moe-1b-a400m at its full published
#: config, and DeepSeek-V2 at full width cut to its dense block and two
#: MoE blocks (60 layers do not fit one card).
MOE_ARCH, MOE_NEW = "granite-moe-1b-a400m", 4
MLA_ARCH, MLA_REPEATS, MLA_NEW = "deepseek-v2-236b", 2, 4
#: The reference's parity rule with MoE layers, at capacity factor 8 and
#: one sequence chunk (``tests/test_models_smoke.py``).
MOE_TOL = 0.08


def moe_weight_bytes(T, params, cfg, batch):
    """Bytes a decode step at ``batch`` must read of the weights: every
    matrix but the embedding table (one row a token), of each MoE layer
    only the experts the step's tokens can reach, E (1 - (1 - k/E)^B) of
    them with uniform routing (reckoned from the config)."""
    mc = cfg.moe
    share = 1 - (1 - mc.experts_per_token / mc.num_experts) ** batch
    total = 0
    for blk in T.blocks_in_order(cfg, params):
        for name, sub in blk.items():
            if name == "mlp" and "router" in sub:
                for key, leaf in sub.items():
                    b = tree_bytes(leaf)
                    total += b * share if key in ("wi", "wg", "wo") else b
            else:
                total += tree_bytes(sub)
    return total + tree_bytes(params["lm_head"]) + tree_bytes(
        params["final_norm"]), share * mc.num_experts


def moe_times(torch, steps, T, params, cfg, prompt, card, label):
    """Prefill and decode ms, the decode step's launches and idle share,
    and the weight-bytes bound of a decode step, printed."""
    pre, dec, cache, last = lm_times(torch, steps, params, cfg, prompt)
    prof, step_ms = lm_decode_profile(torch, steps, params, cfg, cache, last)
    log(f"      {label}: prefill of {LM_BATCH} x {LM_PROMPT} {pre:.3f} ms; "
        f"decode {dec:.3f} ms a step = {LM_BATCH * 1e3 / dec:.1f} tokens/s "
        f"(wall, median of 3; {card})")
    if prof:
        busy = sum(us for us, _ in prof.values())
        n = sum(c for _, c in prof.values())
        parts = ", ".join(f"{cls} {us:.1f} us in {c:.0f} launches"
                          for cls, (us, c) in sorted(prof.items()))
        log(f"      {label} decode step by kernel class: {parts}; "
            f"{n:.0f} launches, busy {busy / 1e3:.3f} ms of a "
            f"{step_ms:.3f} ms step, idle share "
            f"{1 - busy / (step_ms * 1e3):.3f}")
        nxt = last[:, -1].argmax(-1).to(torch.int32)[:, None]
        times = device_times(torch, lambda: steps.make_decode_step(cfg)(
            params, {"tokens": nxt}, LM_PROMPT + LM_TIMED_STEPS
            + LM_PROFILED_STEPS - 1, cache), 1)
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"      {label} decode step's largest kernels: " + "; ".join(
            f"{k[:60]} {us:.1f} us x {c}" for k, (us, c) in top))
    else:
        log(f"      {label} decode step profile: the profiler recorded no "
            f"device time (not measured)")
    wbytes, experts = moe_weight_bytes(T, params, cfg, LM_BATCH)
    allb = tree_bytes(dict(params, embed=None))
    log(f"      {label} decode step bound: the weights it must read "
        f"({experts:.1f} of {cfg.moe.num_experts} experts a MoE layer at "
        f"batch {LM_BATCH}) {wbytes / 1e9:.3f} GB, "
        f"{wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s; every "
        f"weight but the embedding {allb / 1e9:.3f} GB, "
        f"{allb / HBM_BYTES_PER_S * 1e3:.3f} ms (the port's dispatch runs "
        f"every expert's FFN on its capacity slots)")
    return pre, dec


def residual_adds(cfg):
    """Residual adds of one forward step: two a block, one where the block
    has no MLP (mamba2's SSD blocks)."""
    return sum(1 if spec.mlp == "none" else 2 for spec in cfg.all_blocks())


def moe_generate_checked(torch, counts, T, params, cfg, prompt, new, dev,
                         what):
    """``generate`` under haloc_axa, counted: approx_add launched once for
    each residual add of a step and no other kernel; tokens and every
    step's logits equal the plain version's on the card.  Returns (tokens,
    logits, launches)."""
    from repro_torch.models.serving import generate
    hal = cfg.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    plain = cfg.with_approx(lm_numerics("haloc_axa", "torch", dev))
    (toks, logits), launches = run_counted(
        torch, counts, LM_PATH_KERNELS,
        lambda: generate(params, hal, prompt, new, return_logits=True),
        f"{what} path (generate)")
    per_step = residual_adds(cfg)
    check(launches["approx_add"] == per_step * new,
          f"{what}: approx_add launched {launches['approx_add']} times in "
          f"{new} forward steps, not {per_step} a step")
    check(all(n == 0 for k, n in launches.items() if k != "approx_add"),
          f"{what}: the path launched other kernels: {launches}")
    ptoks, plogits = generate(params, plain, prompt, new, return_logits=True)
    check(torch.equal(toks, ptoks),
          f"{what} generate: the approx_add kernel's tokens differ from the "
          f"plain version's on the card")
    check(torch.equal(logits, plogits),
          f"{what} generate: the approx_add kernel's logits differ from the "
          f"plain version's on the card")
    return toks, logits, launches


def mla_modes(torch, T, params, cfg, prompt, dev):
    """``mla_decode``'s absorbed mode against decompress with exact adds,
    as rel figures: each MLA block's decode output on the latent cache of
    a prefill (the same input and cache for both), the logits of the model
    cut to its dense block, and those of the whole cut model, teacher-
    forced on the decompress run's tokens."""
    import dataclasses
    from repro_torch.launch import steps
    from repro_torch.models import mla as MLA
    from repro_torch.models.serving import generate, teacher_forced_logits

    def absorbed(c):
        return dataclasses.replace(c, mla=dataclasses.replace(
            c.mla, decode_mode="absorbed"))

    _, cache = steps.make_prefill_step(cfg, LM_PROMPT + 1)(params, prompt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randn((LM_BATCH, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    mix = []
    for p, spec, c in zip(T.blocks_in_order(cfg, params), cfg.all_blocks(),
                          T.blocks_in_order(cfg, cache), strict=True):
        outs = [MLA.mla_decode(p["mixer"], mode_cfg, spec, x, LM_PROMPT,
                               {k: v.clone() for k, v in c.items()})[0]
                for mode_cfg in (cfg, absorbed(cfg))]
        mix.append(lm_rel(torch, outs[1], outs[0]))
    rel = []
    for c, p in ((dataclasses.replace(cfg, repeats=0),
                  dict(params, pattern=[[]])), (cfg, params)):
        toks, logits = generate(p, c, prompt, MLA_NEW, return_logits=True)
        alogits = teacher_forced_logits(p, absorbed(c), toks, LM_PROMPT)
        rel.append([lm_rel(torch, alogits[:, i], logits[:, i])
                    for i in range(MLA_NEW)])
    return mix, rel[0], rel[1]


def moe_phase(torch, np, dev, counts, card, errs):
    """Phase 4h: MoE and MLA serving on the card (the port's ``generate``
    at granite-moe-1b-a400m's full config and DeepSeek-V2 at full width
    and reduced depth, the residual adds in the ``approx_add`` kernel),
    held against the plain versions, the full forward and the other MLA
    decode mode; returns the launches of the two paths."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.serving import generate

    # (a) granite-moe-1b-a400m at its full published config
    base = get_config(MOE_ARCH)
    check_lm_kernel_shapes(torch, np, dev, errs, width=base.d_model)
    log(f"  approx_add equals its plain version at the residual adds' "
        f"shapes ({LM_BATCH}, {LM_PROMPT}, {base.d_model}) and "
        f"({LM_BATCH}, 1, {base.d_model}), every kind, both forms")
    t0 = time.perf_counter()
    params = T.init_params(0, base, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    mc = base.moe
    log(f"  {MOE_ARCH}: {base.num_layers} layers, d_model {base.d_model}, "
        f"{base.num_heads}/{base.num_kv_heads} heads, {mc.num_experts} "
        f"experts top-{mc.experts_per_token} (d_ff {mc.d_ff}, capacity "
        f"factor {mc.capacity_factor}), vocab {base.vocab_size} padded to "
        f"{base.padded_vocab}: {T.param_count(params)} parameters drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s, "
        f"{tree_bytes(params) / 1e9:.2f} GB (bf16 matrices)")
    prompt = lm_prompt(torch, base, LM_BATCH, LM_PROMPT, dev, 3)
    toks, logits, g_launches = moe_generate_checked(
        torch, counts, T, params, base, prompt, MOE_NEW, dev, MOE_ARCH)
    log(f"  (a) generate(batch {LM_BATCH}, prompt {LM_PROMPT}, {MOE_NEW} "
        f"new, greedy), haloc_axa n16m8k4: {2 * base.num_layers} approx_add "
        f"launches a forward step ({g_launches['approx_add']} in {MOE_NEW} "
        f"steps); tokens and every step's logits equal the plain version's "
        f"on the card, bit for bit")
    cap8 = dataclasses.replace(base, moe=dataclasses.replace(
        mc, capacity_factor=8.0, seq_chunks=1))
    etoks, elogits = generate(params, cap8, prompt, MOE_NEW,
                              return_logits=True)
    exact_par = lm_parity(torch, T, params, cap8, etoks, elogits,
                          LM_PROMPT)
    check(max(exact_par) < MOE_TOL,
          f"{MOE_ARCH} exact, capacity factor 8: prefill/decode logits "
          f"against the full forward {max(exact_par):.4f} >= {MOE_TOL}")
    hal8 = cap8.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    htoks, hlogits = generate(params, hal8, prompt, MOE_NEW,
                              return_logits=True)
    hal_par = lm_parity(torch, T, params, hal8, htoks, hlogits, LM_PROMPT)
    log(f"      prefill/decode against forward(mode='full'), capacity "
        f"factor 8, one sequence chunk, {MOE_NEW} steps: exact max "
        f"{max(exact_par):.4f} (< {MOE_TOL}); haloc_axa "
        f"{min(hal_par):.4f}-{max(hal_par):.4f} (printed, not gated: "
        f"ROADMAP Queue C 3)")
    hal = base.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    for label, cfg in (("exact", base), ("haloc_axa", hal)):
        moe_times(torch, steps, T, params, cfg, prompt, card,
                  f"{MOE_ARCH} {label}")
    del params
    torch.cuda.empty_cache()

    # (b) DeepSeek-V2 at full width, depth cut to the dense block and
    # MLA_REPEATS MoE blocks
    full = get_config(MLA_ARCH)
    cut = dataclasses.replace(full, repeats=MLA_REPEATS)
    check_lm_kernel_shapes(torch, np, dev, errs, width=cut.d_model)
    t0 = time.perf_counter()
    params = T.init_params(0, cut, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    m, mc = cut.mla, cut.moe
    log(f"  {MLA_ARCH}: reduced: depth {full.num_layers} -> "
        f"{cut.num_layers} (the dense block and {MLA_REPEATS} MoE blocks); "
        f"full width: d_model {cut.d_model}, {cut.num_heads} heads, MLA "
        f"kv_lora {m.kv_lora_rank} q_lora {m.q_lora_rank} rope "
        f"{m.rope_head_dim}, {mc.num_experts} routed experts top-"
        f"{mc.experts_per_token} + {mc.num_shared_experts} shared, "
        f"seq_chunks {mc.seq_chunks}: {T.param_count(params)} parameters "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
        f"{tree_bytes(params) / 1e9:.2f} GB")
    prompt = lm_prompt(torch, cut, LM_BATCH, LM_PROMPT, dev, 4)
    toks, logits, d_launches = moe_generate_checked(
        torch, counts, T, params, cut, prompt, MLA_NEW, dev, MLA_ARCH)
    log(f"  (b) generate(batch {LM_BATCH}, prompt {LM_PROMPT}, {MLA_NEW} "
        f"new, greedy), haloc_axa: {2 * cut.num_layers} approx_add launches"
        f" a forward step ({d_launches['approx_add']} in {MLA_NEW} steps); "
        f"tokens and every step's logits equal the plain version's on the "
        f"card, bit for bit")
    ab_mix, ab_one, ab_all = mla_modes(torch, T, params, cut, prompt, dev)
    check(max(ab_mix) < LM_TOL,
          f"{MLA_ARCH}: mla_decode absorbed against decompress "
          f"{max(ab_mix):.4f} >= {LM_TOL} (a block's output)")
    check(max(ab_one) < LM_TOL,
          f"{MLA_ARCH} cut to its dense block: logits, mla_decode absorbed "
          f"against decompress {max(ab_one):.4f} >= {LM_TOL}")
    log(f"      mla_decode absorbed against decompress, exact adds: each "
        f"block's decode output on the prefill's latent cache max "
        f"{max(ab_mix):.4f}, the logits of the model cut to its dense "
        f"block (teacher-forced, {MLA_NEW} steps) max {max(ab_one):.4f} "
        f"(both < {LM_TOL}); the 3-layer model's logits "
        f"{min(ab_all):.4f}-{max(ab_all):.4f} (printed: a one-ulp change "
        f"can move a token to another of 160 experts)")
    hal = cut.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    for label, cfg in (("exact", cut), ("haloc_axa", hal)):
        moe_times(torch, steps, T, params, cfg, prompt, card,
                  f"{MLA_ARCH} ({cut.num_layers} layers) {label}")
    del params
    torch.cuda.empty_cache()
    return {k: g_launches[k] + d_launches[k] for k in g_launches}


# ------------------------------------------------------------ phase 4i --

#: The recurrent slice's models: recurrentgemma-9b at full width and depth
#: (38 blocks: 26 RG-LRU, 12 windowed MQA) and mamba2-1.3b at its full
#: config (48 SSD layers), bf16 weights from a seeded generator on the card
#: (``lam``, ``a_log`` and ``dt_bias`` fp32), the residual adds through
#: haloc_axa n16m8k4.  Each prompt is LM_BATCH sequences: 128 tokens for
#: recurrentgemma; 600 for mamba2 (two 256-token chunks and an 88-token
#: tail: ``ssd_apply``'s remainder path at the published chunk).
REC_MODELS = (("recurrentgemma-9b", 128, 9_627_095_040),
              ("mamba2-1.3b", 600, 1_446_714_368))
REC_NEW = 4
#: recurrentgemma's window case: a prompt past the 2048 window.
REC_WINDOW_BATCH, REC_WINDOW_PROMPT, REC_WINDOW_NEW = 2, 2100, 4
#: The CPU case: the model cut to its first blocks (recurrentgemma one
#: pattern repeat, rec/rec/attn; mamba2 two layers), prompts of these
#: lengths (mamba2's: a 256-token chunk and a 44-token tail), 2 new
#: tokens.
REC_CPU_PROMPT = {"recurrentgemma-9b": 128, "mamba2-1.3b": 300}
REC_CPU_NEW = 2


def recurrent_cut(cfg, params, blocks=None):
    """(cfg, params) of the model cut to its first ``blocks`` blocks
    (default: one pattern repeat for the hybrid, rec/rec/attn; two layers
    for the SSM one), sharing the card's tensors."""
    import dataclasses
    n = len(cfg.pattern)
    if blocks is None:
        blocks = n if cfg.family == "hybrid" else 2
    reps = blocks // n
    cut = dataclasses.replace(cfg, repeats=reps, suffix=cfg.suffix[
        :blocks - reps * n] if blocks >= cfg.num_layers - len(
        cfg.suffix) else ())
    return cut, dict(params, pattern=[b[:reps] for b in params["pattern"]],
                     suffix=params["suffix"][:len(cut.suffix)])


#: The depths phase 4i's exact prefill/decode parity is read at: the cut
#: model (gated; the deeper printed figures, mamba2-1.3b's 12, 24 and 48
#: blocks and recurrentgemma-9b's 12 and 38, were cut when phase 4k joined
#: the run: PERF.md §6 has them).
REC_DEPTHS = {"recurrentgemma-9b": (3,), "mamba2-1.3b": (2,)}


def recurrent_parity(torch, T, base, params, prompt, new):
    """{blocks: the exact prefill/decode parity (max over the steps)} of
    the model cut to each of REC_DEPTHS' depths."""
    from repro_torch.models.serving import generate
    plen = prompt["tokens"].shape[1]
    out = {}
    for blocks in REC_DEPTHS[base.name]:
        cfg, p = recurrent_cut(base, params, blocks)
        toks, logits = generate(p, cfg, prompt, new, return_logits=True)
        out[cfg.num_layers] = max(lm_parity(torch, T, p, cfg, toks, logits,
                                            plen))
    return out


def recurrent_step_bytes(T, params, cache):
    """Bytes a decode step must move: every weight but the embedding table
    (one row a token) read once, and the cache read once and its
    recurrent states (fp32 ``h``/``state``, the conv states) written once
    (a window cache writes one slot a step: not counted)."""
    written = 0
    for c in cache["prefix"] + cache["suffix"] + [
            b for blocks in cache["pattern"] for b in blocks]:
        written += sum(tree_bytes(v) for k, v in c.items()
                       if k in ("h", "state", "conv", "conv_x", "conv_bc"))
    return (tree_bytes(dict(params, embed=None)) + tree_bytes(cache)
            + written)


def kernel_classes(times, calls=1):
    """{class: (us, launches)} a call from :func:`device_times`' kernels:
    ``approx_add``, the matmuls (cuBLAS's, by name) and the rest."""
    out = {}
    for key, (us, n) in times.items():
        cls = ("approx_add" if "approx_add" in key else
               "matmul" if any(m in key for m in MATMUL_KERNEL_MARKS) else
               "other")
        u, c = out.get(cls, (0.0, 0.0))
        out[cls] = (u + us / calls, c + n / calls)
    return out


def recurrent_mixer_split(torch, T, params, cfg, cache, dev):
    """Device time of one decode step's RG-LRU / SSD mixer calls alone
    (a random bf16 input at the step's shape, the step's caches), by
    kernel class; {} when the profiler saw no device time."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    x = torch.randn((LM_BATCH, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    calls = [(T._MIXERS[spec.mixer][3], blk["mixer"], spec, c)
             for spec, blk, c in zip(cfg.all_blocks(),
                                     T.blocks_in_order(cfg, params),
                                     T.blocks_in_order(cfg, cache))
             if spec.mixer in T._RECURRENT]

    def run():      # the decode steps return new caches: nothing written
        for decode, p, spec, c in calls:
            decode(p, cfg, spec, x, c)

    return kernel_classes(device_times(torch, run, 1))


def time_xla_math(torch, dev, width):
    """The card's cost of the XLA:CPU emulation the CPU path takes
    (``layers.xla_exp32``) against torch's ``exp`` (what the card takes),
    at a decode step's (4, 1, width) and a prefill's (4, 128, width):
    median ms of five calls after one, and the launches of a call."""
    from repro_torch.models import layers as L
    rows = []
    for shape in ((LM_BATCH, 1, width), (LM_BATCH, LM_PROMPT, width)):
        x = torch.randn(shape, device=dev)
        times = {}
        for name, fn in (("xla_exp32", L.xla_exp32), ("torch.exp",
                                                       torch.exp)):
            fn(x)
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            times[name] = statistics.median(ms)
        n = kernel_events(torch, lambda: L.xla_exp32(x))
        rows.append((shape, times["xla_exp32"], times["torch.exp"], n))
    return rows


def recurrent_model(torch, np, dev, counts, card, errs, arch, plen,
                    n_expected):
    """Phase 4i for one model: (a) the counted haloc_axa path, (b) parity,
    (e) times; then the window case and (c) the CPU path.  Returns the
    path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.serving import generate, teacher_forced_logits

    base = get_config(arch)
    check_lm_kernel_shapes(torch, np, dev, errs, width=base.d_model,
                           prompt=plen)
    log(f"  approx_add equals its plain version at the residual adds' "
        f"shapes ({LM_BATCH}, {plen}, {base.d_model}) and "
        f"({LM_BATCH}, 1, {base.d_model}), every kind, both forms")
    t0 = time.perf_counter()
    params = T.init_params(0, base, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    check(n_params == n_expected,
          f"{arch}: {n_params} parameters, not {n_expected}")
    fp32 = sorted({k for blk in T.blocks_in_order(base, params)
                   for k, v in blk["mixer"].items()
                   if isinstance(v, torch.Tensor)
                   and v.dtype == torch.float32})
    log(f"  {arch}: {base.num_layers} blocks "
        f"({[s.mixer for s in base.all_blocks()].count('attn')} windowed "
        f"attention), d_model {base.d_model}, vocab {base.vocab_size}: "
        f"{n_params} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s, {tree_bytes(params) / 1e9:.2f} "
        f"GB (bf16; fp32 mixer leaves {fp32})")
    prompt = lm_prompt(torch, base, LM_BATCH, plen, dev, 7)

    # (a) the path, counted, against the plain versions on the card
    toks, logits, launches = moe_generate_checked(
        torch, counts, T, params, base, prompt, REC_NEW, dev, arch)
    per_step = residual_adds(base)
    log(f"  (a) generate(batch {LM_BATCH}, prompt {plen}, {REC_NEW} new, "
        f"greedy), haloc_axa n16m8k4: {per_step} approx_add launches a "
        f"forward step ({launches['approx_add']} in {REC_NEW} steps) and no "
        f"other kernel; tokens and every step's logits equal the plain "
        f"version's on the card, bit for bit")

    # (b) prefill/decode against the full forward
    hal = base.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    check(torch.equal(teacher_forced_logits(params, hal, toks, plen),
                      logits),
          f"{arch} haloc_axa: prefill and decode on the generated tokens "
          f"differ from generate's own logits")
    par = recurrent_parity(torch, T, base, params, prompt, REC_NEW)
    first = min(par)
    check(par[first] < LM_TOL,
          f"{arch} cut to {first} blocks, exact: prefill/decode logits "
          f"against the full forward {par[first]:.4f} >= {LM_TOL}")
    hal_par = lm_parity(torch, T, params, hal, toks, logits, plen)
    log(f"  (b) prefill/decode against forward(mode='full'), {REC_NEW} "
        f"steps, exact adds, by depth (blocks: max): "
        f"{', '.join(f'{k}: {v:.4f}' for k, v in par.items())} (gated < "
        f"{LM_TOL} at {first} blocks: the recurrent decode and the full "
        f"forward's chunked or scanned form round otherwise and the gap "
        f"grows with depth, ROADMAP Queue C 12); haloc_axa "
        f"teacher-forced equal to generate's logits bit for bit, against "
        f"the full forward {min(hal_par):.4f}-{max(hal_par):.4f} (printed, "
        f"not gated: Queue C 3)")

    # (d) times and the bound
    for label, cfg in (("exact", base), ("haloc_axa", hal)):
        pre, dec, cache, last = lm_times(torch, steps, params, cfg, prompt)
        log(f"  (d) {arch} {label}: prefill of {LM_BATCH} x {plen} "
            f"{pre:.3f} ms; decode {dec:.3f} ms a step = "
            f"{LM_BATCH * 1e3 / dec:.1f} tokens/s at batch {LM_BATCH} "
            f"(wall, median of 3; {card})")
        prof, step_ms = lm_decode_profile(torch, steps, params, cfg, cache,
                                          last, plen)
        if not prof:
            log(f"      {label} decode step profile: the profiler recorded "
                f"no device time (not measured)")
        else:
            busy = sum(us for us, _ in prof.values())
            n = sum(c for _, c in prof.values())
            parts = ", ".join(f"{cls} {us:.1f} us in {c:.0f} launches"
                              for cls, (us, c) in sorted(prof.items()))
            log(f"      {label} decode step by kernel class: {parts}; "
                f"{n:.0f} launches, busy {busy / 1e3:.3f} ms of a "
                f"{step_ms:.3f} ms step, idle share "
                f"{1 - busy / (step_ms * 1e3):.3f}")
        mix = recurrent_mixer_split(torch, T, params, cfg, cache, dev)
        if mix:
            log(f"      {label}: the step's "
                f"{'RG-LRU' if base.rglru else 'SSD'} mixer calls alone: "
                + ", ".join(f"{cls} {us:.1f} us in {c:.0f} launches"
                            for cls, (us, c) in sorted(mix.items()))
                + " (the scan / state glue is 'other')")
        if label == "exact":
            step_bytes = recurrent_step_bytes(T, params, cache)
            log(f"      a decode step must read every weight but the "
                f"embedding and the cache and write the recurrent states: "
                f"{step_bytes / 1e9:.3f} GB, "
                f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
        del cache
    if base.rglru is not None:
        for shape, xla_ms, torch_ms, n in time_xla_math(torch, dev,
                                                         base.rglru.width):
            log(f"      layers.xla_exp32 (the CPU path's exp) on the card at "
                f"{shape}: {xla_ms:.3f} ms in {n} launches, torch.exp "
                f"{torch_ms:.3f} ms: the card takes torch's")
    torch.cuda.empty_cache()

    # the window case (recurrentgemma): a prompt past the 2048 window
    if base.rglru is not None:
        wprompt = lm_prompt(torch, base, REC_WINDOW_BATCH, REC_WINDOW_PROMPT,
                            dev, 8)
        torch.cuda.reset_peak_memory_stats(dev)
        wpar = recurrent_parity(torch, T, base, params, wprompt,
                                REC_WINDOW_NEW)
        wfirst = min(wpar)
        check(wpar[wfirst] < LM_TOL,
              f"{arch} cut to {wfirst} blocks, exact: prefill/decode past "
              f"the window against the full forward {wpar[wfirst]:.4f} >= "
              f"{LM_TOL}")
        htoks, hlogits = generate(params, hal, wprompt, REC_WINDOW_NEW,
                                  return_logits=True)
        check(torch.equal(teacher_forced_logits(params, hal, htoks,
                                                REC_WINDOW_PROMPT), hlogits),
              f"{arch} haloc_axa past the window: prefill and decode on the "
              f"generated tokens differ from generate's own logits")
        whal = lm_parity(torch, T, params, hal, htoks, hlogits,
                         REC_WINDOW_PROMPT)
        depths = ", ".join(f"{k}: {v:.4f}" for k, v in wpar.items())
        log(f"  (e) window case: batch {REC_WINDOW_BATCH}, prompt "
            f"{REC_WINDOW_PROMPT} past the {base.all_blocks()[2].window} "
            f"window, {REC_WINDOW_NEW} decode steps: exact against the full "
            f"forward by depth {depths} "
            f"(gated < {LM_TOL} at {wfirst} blocks); haloc_axa at full depth "
            f"teacher-forced equal to generate, against the full forward "
            f"{min(whal):.4f}-{max(whal):.4f} (printed); peak "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        del htoks, hlogits
        torch.cuda.empty_cache()

    # (c) the card against the CPU path at reduced depth
    cut, small = recurrent_cut(base, params)
    cplen = REC_CPU_PROMPT[arch]
    cprompt = {"tokens": prompt["tokens"][:, :cplen]}
    rec = ResidualRecorder(lm_numerics("haloc_axa", "cuda", dev))
    import dataclasses
    ctoks, clogits = generate(small, dataclasses.replace(cut, approx=rec),
                              cprompt, REC_CPU_NEW, return_logits=True)
    ctoks_e, clogits_e = generate(small, cut, cprompt, REC_CPU_NEW,
                                  return_logits=True)

    t0 = time.perf_counter()
    cpu_params = to_cpu(small)
    del params, small
    torch.cuda.empty_cache()
    cpu_hal = dataclasses.replace(cut, approx=lm_numerics("haloc_axa",
                                                          "torch", "cpu"))
    cpu = teacher_forced_logits(cpu_params, cpu_hal, ctoks.cpu(), cplen)
    cpu_e = teacher_forced_logits(cpu_params, cut, ctoks_e.cpu(), cplen)
    cpu_s = time.perf_counter() - t0
    exact_cc = [lm_rel(torch, cpu_e[:, i], clogits_e[:, i].cpu())
                for i in range(REC_CPU_NEW)]
    check(max(exact_cc) < LM_TOL,
          f"{arch} cut to {cut.num_layers} blocks, exact: the card's logits "
          f"against the CPU path's {max(exact_cc):.4f} >= {LM_TOL}")
    check_adds_on_cpu(torch, rec, cpu_hal.approx, arch)
    hal_cc = [lm_rel(torch, cpu[:, i], clogits[:, i].cpu())
              for i in range(REC_CPU_NEW)]
    log(f"  (c) {arch} cut to its first {cut.num_layers} blocks (full "
        f"width), prompt {cplen}, {REC_CPU_NEW} new tokens, the CPU path "
        f"teacher-forced on the card's tokens ({cpu_s:.1f} s): exact logits "
        f"max {max(exact_cc):.4f} (< {LM_TOL}); haloc_axa: each of the "
        f"card's {len(rec.calls)} residual adds equals the CPU path's on the "
        f"same operands, bit for bit; logits {min(hal_cc):.4f}-"
        f"{max(hal_cc):.4f} (printed, not gated: ROADMAP Queue C 3)")
    del cpu_params
    return launches


def recurrent_phase(torch, np, dev, counts, card, errs):
    """Phase 4i: RG-LRU and SSD serving on the card (the port's
    ``generate`` at recurrentgemma-9b's full width and depth and
    mamba2-1.3b's full config, the residual adds in the ``approx_add``
    kernel), held against the plain versions, the full forward and the
    CPU path; returns the launches of the two paths."""
    total = {}
    for arch, plen, n_expected in REC_MODELS:
        t0 = time.perf_counter()
        launches = recurrent_model(torch, np, dev, counts, card, errs, arch,
                                   plen, n_expected)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s")
    return total


# ------------------------------------------------------------ phase 4j --

#: The cross attention and audio slice's models, bf16 weights from a seeded
#: generator on the card (norm scales and the tanh gates fp32), the gates
#: and biases set to seeded nonzero values, the residual adds through
#: haloc_axa n16m8k4.  llama-3.2-vision-11b at full width and depth (40
#: layers: 32 self, rope base 500000, and 8 gated cross attention; vision
#: input (4, 1601, 4096)), 4 x (128 + 32) tokens; hubert-xlarge at full
#: width and depth (48 encoder layers), 4 x 1500 frames of 512 features
#: (30 s of audio at 50 Hz: two KV chunks of 1024, the second a 476-frame
#: tail).
VIS_ARCH, VIS_PARAMS, VIS_NEW = "llama-3.2-vision-11b", 9_791_936_528, 4
AUD_ARCH, AUD_PARAMS, AUD_FRAMES = "hubert-xlarge", 945_451_520, 1500
#: Depths (layers) the exact prefill/decode parity is read at: full depth
#: (gated; the printed 5 and 20 were cut when phase 4k joined the run:
#: PERF.md §6 has their figures).
VIS_DEPTHS = (40,)
#: hubert's CPU case: its first two layers, one sequence of all the frames.
AUD_CPU_LAYERS, AUD_CPU_BATCH = 2, 1
#: Forwards timed (after one untimed) for hubert's times.
AUD_TIMED = 5
#: H100 SXM dense bf16 tensor-core peak (data sheet), hubert's FLOP bound.
BF16_FLOPS_PER_S = 989e12


def seed_gates_and_biases(torch, T, params, cfg, dev, seed):
    """Set every tanh gate (``gate``, ``gate_mlp``: N(0, 1)) and every bias
    (``b``: N(0, 0.1)) of a tree on the card to values from a seeded
    generator (the init leaves them zero, which makes a cross block the
    identity).  Returns (the gates in block order, the biases' count)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gates, n_bias = [], 0

    def walk(tree):
        nonlocal n_bias
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in ("gate", "gate_mlp"):
                val.copy_(torch.randn((), generator=gen, device=dev))
                gates.append(float(val))
            elif key == "b":
                val.copy_(torch.randn(val.shape, generator=gen, device=dev)
                          * 0.1)
                n_bias += val.numel()

    for top in ("frontend",):
        if top in params:
            walk({top: params[top]})
    for blk in T.blocks_in_order(cfg, params):
        walk(blk)
    return gates, n_bias


def vision_prompt(torch, cfg, batch, length, dev, seed):
    """Tokens and the vision embeddings (N(0, 1) in bf16) from one seeded
    generator on the card."""
    prompt = lm_prompt(torch, cfg, batch, length, dev, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    prompt["vision"] = torch.randn(
        (batch, cfg.vision.seq_len, cfg.vision.embed_dim), generator=gen,
        device=dev).to(torch.bfloat16)
    return prompt


def step_profile_line(prof, step_ms):
    busy = sum(us for us, _ in prof.values())
    n = sum(c for _, c in prof.values())
    parts = ", ".join(f"{cls} {us:.1f} us in {c:.0f} launches"
                      for cls, (us, c) in sorted(prof.items()))
    return (f"{parts}; {n:.0f} launches, busy {busy / 1e3:.3f} ms of a "
            f"{step_ms:.3f} ms step, idle share "
            f"{1 - busy / (step_ms * 1e3):.3f}")


def vision_model(torch, np, dev, counts, card, errs):
    """Phase 4j (a)-(c), (e) and (f) for llama-3.2-vision-11b; returns the
    counted path's launches."""
    import dataclasses
    import os
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.serving import generate, teacher_forced_logits

    base = get_config(VIS_ARCH)
    check_lm_kernel_shapes(torch, np, dev, errs, width=base.d_model)
    log(f"  approx_add equals its plain version at the residual adds' "
        f"shapes ({LM_BATCH}, {LM_PROMPT}, {base.d_model}) and "
        f"({LM_BATCH}, 1, {base.d_model}), every kind, both forms")
    t0 = time.perf_counter()
    params = T.init_params(0, base, device=dev, dtype=torch.bfloat16)
    gates, n_bias = seed_gates_and_biases(torch, T, params, base, dev, 11)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    check(n_params == VIS_PARAMS,
          f"{VIS_ARCH}: {n_params} parameters, not {VIS_PARAMS}")
    kinds = [s.mixer for s in base.all_blocks()]
    log(f"  {VIS_ARCH}: {base.num_layers} layers ({kinds.count('attn')} "
        f"self, rope base {base.pattern[0].rope_base:g}; "
        f"{kinds.count('cross')} cross), d_model {base.d_model}, "
        f"{base.num_heads}/{base.num_kv_heads} heads, d_ff {base.d_ff}, vocab "
        f"{base.vocab_size}, vision {base.vision.seq_len} x "
        f"{base.vision.embed_dim}: {n_params} parameters drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s, {tree_bytes(params) / 1e9:.2f}"
        f" GB (bf16; gates fp32); gates (gate, gate_mlp by cross block) "
        f"{[round(g, 4) for g in gates]}; {n_bias} biases")
    prompt = vision_prompt(torch, base, LM_BATCH, LM_PROMPT, dev, 13)
    vis = {"vision": prompt["vision"]}

    # (a) the path, counted, against the plain versions on the card
    toks, logits, launches = moe_generate_checked(
        torch, counts, T, params, base, prompt, VIS_NEW, dev, VIS_ARCH)
    per_step = residual_adds(base)
    log(f"  (a) generate(batch {LM_BATCH}, prompt {LM_PROMPT}, vision "
        f"{tuple(prompt['vision'].shape)}, {VIS_NEW} new, greedy), "
        f"haloc_axa n16m8k4: {per_step} approx_add launches a forward step "
        f"({launches['approx_add']} in {VIS_NEW} steps) and no other "
        f"kernel; tokens and every step's logits equal the plain version's "
        f"on the card, bit for bit")

    # (b) prefill/decode against the full forward
    hal = base.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    check(torch.equal(teacher_forced_logits(params, hal, toks, LM_PROMPT,
                                            vision=prompt["vision"]),
                      logits),
          f"{VIS_ARCH} haloc_axa: prefill and decode on the generated tokens "
          f"differ from generate's own logits")
    par = {}
    for layers in VIS_DEPTHS:
        cfg, p = recurrent_cut(base, params, layers)
        etoks, elogits = generate(p, cfg, prompt, VIS_NEW,
                                  return_logits=True)
        par[layers] = max(lm_parity(torch, T, p, cfg, etoks, elogits,
                                    LM_PROMPT, vis))
    full = base.num_layers
    check(par[full] < LM_TOL,
          f"{VIS_ARCH} at {full} layers, exact: prefill/decode logits "
          f"against the full forward {par[full]:.4f} >= {LM_TOL}")
    hal_par = lm_parity(torch, T, params, hal, toks, logits, LM_PROMPT, vis)
    log(f"  (b) prefill/decode against forward(mode='full'), {VIS_NEW} "
        f"steps, exact adds, by depth (layers: max): "
        f"{', '.join(f'{k}: {v:.4f}' for k, v in par.items())} (gated < "
        f"{LM_TOL} at {full} layers); haloc_axa teacher-forced equal to "
        f"generate's logits bit for bit, against the full forward "
        f"{min(hal_par):.4f}-{max(hal_par):.4f} (printed, not gated: ROADMAP "
        f"Queue C 3)")

    # (e) times and the bound
    for label, cfg in (("exact", base), ("haloc_axa", hal)):
        pre, dec, cache, last = lm_times(torch, steps, params, cfg, prompt)
        log(f"  (e) {VIS_ARCH} {label}: prefill of {LM_BATCH} x {LM_PROMPT} "
            f"with the vision adapter and the {kinds.count('cross')} cross "
            f"K/V projections {pre:.3f} ms; decode {dec:.3f} ms a step = "
            f"{LM_BATCH * 1e3 / dec:.1f} tokens/s at batch {LM_BATCH} (wall, "
            f"median of 3; {card})")
        prof, step_ms = lm_decode_profile(torch, steps, params, cfg, cache,
                                          last)
        log(f"      {label} decode step by kernel class: "
            + (step_profile_line(prof, step_ms) if prof else
               "the profiler recorded no device time (not measured)"))
        if label == "exact":
            blocks = zip(T.blocks_in_order(base, params), base.all_blocks())
            cross_kv = sum(tree_bytes(blk["mixer"][w])
                           for blk, spec in blocks if spec.mixer == "cross"
                           for w in ("wk", "wv"))
            step_bytes = tree_bytes(dict(params, embed=None,
                                         vis_adapter=None)) - cross_kv \
                + tree_bytes(cache)
            log(f"      a decode step must read every weight but the "
                f"embedding, the vision adapter and the cross blocks' K/V "
                f"projections, and the self and cross caches: "
                f"{step_bytes / 1e9:.3f} GB, "
                f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
        del cache
    torch.cuda.empty_cache()

    # (c) the first pattern repeat against the CPU path
    cut, small = recurrent_cut(base, params, len(base.pattern))
    rec = ResidualRecorder(lm_numerics("haloc_axa", "cuda", dev))
    generate(small, dataclasses.replace(cut, approx=rec), prompt,
             LM_CPU_NEW)
    ctoks_e, clogits_e = generate(small, cut, prompt, LM_CPU_NEW,
                                  return_logits=True)
    t0 = time.perf_counter()
    cpu_params = to_cpu(small)
    cvis = prompt["vision"].cpu()
    del params, small
    torch.cuda.empty_cache()
    cpu_e = teacher_forced_logits(cpu_params, cut, ctoks_e.cpu(), LM_PROMPT,
                                  vision=cvis)
    cpu_s = time.perf_counter() - t0
    exact_cc = [lm_rel(torch, cpu_e[:, i], clogits_e[:, i].cpu())
                for i in range(LM_CPU_NEW)]
    check(max(exact_cc) < LM_TOL,
          f"{VIS_ARCH} cut to {cut.num_layers} layers, exact: the card's "
          f"logits against the CPU path's {max(exact_cc):.4f} >= {LM_TOL}")
    check_adds_on_cpu(torch, rec, lm_numerics("haloc_axa", "torch", "cpu"),
                      VIS_ARCH)
    log(f"  (c) {VIS_ARCH} cut to its first pattern repeat ({cut.num_layers}"
        f" layers: {[s.mixer for s in cut.all_blocks()]}, full width), "
        f"{LM_CPU_NEW} new tokens, the CPU path teacher-forced on the card's "
        f"tokens ({cpu_s:.1f} s): exact logits max {max(exact_cc):.4f} (< "
        f"{LM_TOL}); haloc_axa: each of the card's {len(rec.calls)} residual "
        f"adds (the gated cross products among them) equals the CPU path's "
        f"add on the same operands, bit for bit")
    del cpu_params

    # (f) the launcher
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           VIS_ARCH, "--adder", "haloc_axa", "--batch", "4", "--prompt-len",
           "32", "--new-tokens", "16"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    out = res.stdout.strip().splitlines()
    check(res.returncode == 0 and out
          and out[-1].startswith(f"{VIS_ARCH}: (4, 48); "),
          f"python -m repro_torch.launch.serve --arch {VIS_ARCH} exited "
          f"{res.returncode}: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    log(f"  (f) python -m repro_torch.launch.serve --arch {VIS_ARCH} "
        f"--adder haloc_axa --batch 4 --prompt-len 32 --new-tokens 16: exit "
        f"0 in {time.perf_counter() - t0:.1f} s: {out[-1]}")
    return launches


def hubert_flops(cfg, batch, frames):
    """The multiply-adds (x 2) of hubert's forward on ``batch`` x
    ``frames``: the frontend, each layer's four projections, its scores
    and PV products over every frame and its MLP, the head."""
    d = cfg.d_model
    per_layer = 2 * (4 * d * d + 2 * d * cfg.d_ff) + 2 * 2 * frames * d
    per_frame = (2 * cfg.audio.feat_dim * d + cfg.num_layers * per_layer
                 + 2 * d * cfg.padded_vocab)
    return per_frame * batch * frames


def audio_model(torch, np, dev, counts, card, errs):
    """Phase 4j (d) and hubert's times in (e); returns the counted path's
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    base = get_config(AUD_ARCH)
    check_lm_kernel_shapes(torch, np, dev, errs, width=base.d_model,
                           prompt=AUD_FRAMES)
    log(f"  approx_add equals its plain version at the residual adds' "
        f"shapes ({LM_BATCH}, {AUD_FRAMES}, {base.d_model}) and "
        f"({LM_BATCH}, 1, {base.d_model}), every kind, both forms")
    t0 = time.perf_counter()
    params = T.init_params(0, base, device=dev, dtype=torch.bfloat16)
    _, n_bias = seed_gates_and_biases(torch, T, params, base, dev, 17)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    check(n_params == AUD_PARAMS,
          f"{AUD_ARCH}: {n_params} parameters, not {AUD_PARAMS}")
    log(f"  {AUD_ARCH}: {base.num_layers} encoder layers (non-causal), "
        f"d_model {base.d_model}, {base.num_heads} heads x {base.head_dim}, "
        f"d_ff {base.d_ff} (GELU, biases), {base.vocab_size} classes, "
        f"frontend {base.audio.feat_dim} -> {base.d_model}: {n_params} "
        f"parameters drawn on the card in {time.perf_counter() - t0:.2f} s, "
        f"{tree_bytes(params) / 1e9:.2f} GB (bf16); {n_bias} biases set to "
        f"N(0, 0.1) from seed 17")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    frames = {"frames": torch.randn((LM_BATCH, AUD_FRAMES,
                                     base.audio.feat_dim), generator=gen,
                                    device=dev).to(torch.bfloat16)}
    hal = base.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    plain = base.with_approx(lm_numerics("haloc_axa", "torch", dev))

    # (d) the forward, counted, against the plain versions on the card
    logits, launches = run_counted(
        torch, counts, LM_PATH_KERNELS,
        lambda: T.forward(params, hal, frames)[0],
        f"{AUD_ARCH} path (forward)")
    per_fwd = residual_adds(base)
    check(launches["approx_add"] == per_fwd,
          f"{AUD_ARCH}: approx_add launched {launches['approx_add']} times in "
          f"one forward, not {per_fwd}")
    check(all(n == 0 for k, n in launches.items() if k != "approx_add"),
          f"{AUD_ARCH}: the path launched other kernels: {launches}")
    check(torch.equal(logits, T.forward(params, plain, frames)[0]),
          f"{AUD_ARCH} forward: the approx_add kernel's logits differ from "
          f"the plain version's on the card")
    check(tuple(logits.shape) == (LM_BATCH, AUD_FRAMES, base.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"{AUD_ARCH}: logits of shape {tuple(logits.shape)}, or not finite")
    pre, _ = steps.make_prefill_step(hal, AUD_FRAMES)(params, frames)
    diff = int((pre != logits).sum())
    log(f"  (d) forward(mode='full') on {LM_BATCH} x {AUD_FRAMES} frames "
        f"(KV chunks of {base.attn_kv_chunk}, a "
        f"{AUD_FRAMES % base.attn_kv_chunk}-frame tail), haloc_axa n16m8k4: "
        f"{per_fwd} approx_add launches and no other kernel; logits "
        f"({tuple(logits.shape)}, finite) equal the plain version's on the "
        f"card, bit for bit; the prefill step's "
        f"logits (every frame's) differ from the full forward's in {diff} "
        f"of {logits.numel()}")

    # (e) times and the bound
    flops = hubert_flops(base, LM_BATCH, AUD_FRAMES)
    for label, cfg in (("exact", base), ("haloc_axa", hal)):
        def fwd(c=cfg):
            return T.forward(params, c, frames)[0]

        walls = []
        for _ in range(AUD_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls[1:])
        prof = kernel_classes(device_times(torch, fwd, 1))
        log(f"  (e) {AUD_ARCH} {label}: forward of {LM_BATCH} x {AUD_FRAMES} "
            f"frames {ms:.3f} ms (median of {AUD_TIMED}) = "
            f"{LM_BATCH * AUD_FRAMES * 1e3 / ms:.0f} frames/s ({card}); by "
            f"kernel class: "
            + (step_profile_line(prof, ms) if prof else
               "the profiler recorded no device time (not measured)"))
    log(f"      the forward's multiply-adds: {flops / 1e12:.3f} TFLOP, "
        f"{flops / BF16_FLOPS_PER_S * 1e3:.3f} ms at the 989 TFLOP/s dense "
        f"bf16 peak; its weights {tree_bytes(params) / 1e9:.3f} GB, "
        f"{tree_bytes(params) / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    del logits, pre
    torch.cuda.empty_cache()

    # (d) its first layers against the CPU path
    cut = dataclasses.replace(base, repeats=AUD_CPU_LAYERS)
    small = dict(params, pattern=[params["pattern"][0][:AUD_CPU_LAYERS]])
    one = {"frames": frames["frames"][:AUD_CPU_BATCH]}
    rec = ResidualRecorder(lm_numerics("haloc_axa", "cuda", dev))
    T.forward(small, dataclasses.replace(cut, approx=rec), one)
    card_e = T.forward(small, cut, one)[0]
    t0 = time.perf_counter()
    cpu_params = to_cpu(small)
    del params, small
    torch.cuda.empty_cache()
    cpu_e = T.forward(cpu_params, cut, {"frames": one["frames"].cpu()})[0]
    cpu_s = time.perf_counter() - t0
    exact_cc = lm_rel(torch, cpu_e, card_e.cpu())
    check(exact_cc < LM_TOL,
          f"{AUD_ARCH} cut to {AUD_CPU_LAYERS} layers, exact: the card's "
          f"logits against the CPU path's {exact_cc:.4f} >= {LM_TOL}")
    check_adds_on_cpu(torch, rec, lm_numerics("haloc_axa", "torch", "cpu"),
                      AUD_ARCH)
    log(f"  (d) {AUD_ARCH} cut to its first {AUD_CPU_LAYERS} layers (full "
        f"width), {AUD_CPU_BATCH} x {AUD_FRAMES} frames, the CPU path "
        f"({cpu_s:.1f} s): exact logits {exact_cc:.4f} (< {LM_TOL}); "
        f"haloc_axa: each of the card's {len(rec.calls)} residual adds "
        f"(the GELU output bias sums among them) equals the CPU path's add "
        f"on the same operands, bit for bit")
    return launches


def vision_audio_phase(torch, np, dev, counts, card, errs):
    """Phase 4j: cross attention and the audio frontend on the card
    (llama-3.2-vision-11b's ``generate`` and hubert-xlarge's forward at
    full width and depth, the residual adds in the ``approx_add``
    kernel), held against the plain versions, the full forward and the
    CPU path; returns the launches of the two paths."""
    total = {}
    for model in (vision_model, audio_model):
        t0 = time.perf_counter()
        launches = model(torch, np, dev, counts, card, errs)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        log(f"  {model.__name__} took {time.perf_counter() - t0:.1f} s")
    return total


# ------------------------------------------------------------ phase 4k --

#: Phase 4k's cells: Qwen3-4B at full width cut to TRAIN_LAYERS layers
#: (its 36 do not fit the card with fp32 AdamW states: 70.6 GB of
#: parameters, gradients, m and v) and granite-moe-1b-a400m at its full
#: config, trained on synthetic batches of TRAIN_BATCH x TRAIN_SEQ tokens
#: (``DataConfig(seq_len=128, global_batch=4)``).
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_PARAMS = "qwen3-4b", 24, 3_200_254_464
TRAIN_MOE_ARCH, TRAIN_MOE_PARAMS = "granite-moe-1b-a400m", 1_389_151_232
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 3
#: The card-against-CPU case: Qwen3-4B cut to its first two layers.
TRAIN_CPU_LAYERS = 2
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL = 0.05, 1e-3
#: Torch's CPU threads in (c)'s CPU half, a process beside phases 3-4c:
#: half the host's 8 cores, the rest for those phases and (g).
TRAIN_CPU_THREADS = 4
#: The flash VJP case: Qwen3-4B's attention at one 4096-token sequence
#: (past the plain path's 1M-score limit), against autograd through the
#: plain path.
FLASH_B, FLASH_S, FLASH_H, FLASH_HKV, FLASH_D = 1, 4096, 32, 8, 128
FLASH_TOL = 0.02
#: Published dense bf16 peak of an H100 SXM (NVIDIA's H100 datasheet).
BF16_FLOP_PER_S = 989e12
#: AdamW's bytes a parameter: it reads p, g, m and v and writes p, m and
#: v, fp32 each.
ADAMW_BYTES = 28
#: The restart case's smoke config and checkpoint directory.
TRAIN_RESTART_ARCH = "qwen3-4b"
TRAIN_CKPT_DIR = ROOT / "build" / "train_restart"


def train_batches(cfg, steps):
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    return [synthetic_batch(cfg, data, s) for s in range(steps)]


def copy_params(tree):
    """A copy of every leaf where it lies (on the card the state's 16 B a
    parameter leave room for one more fp32 copy of the parameters)."""
    from repro_torch.tree import leaves
    return [t.detach().clone() for t in leaves(tree)]


def train_run(torch, cfg, opt, batches, dev, seed=0):
    """``init_state(seed)`` on the card and one ``make_train_step`` per
    batch; returns (state, [(loss, ce, aux, grad_norm) a step], the
    warnings torch raised about nondeterministic ops)."""
    import warnings
    from repro_torch.launch import steps
    state = steps.init_state(seed, cfg, opt, device=dev)
    step = steps.make_train_step(cfg, opt)
    rows = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in batches:
            state, met = step(state, b)
            rows.append(tuple(float(met[k]) for k in
                              ("loss", "ce", "aux", "grad_norm")))
    nondet = sorted({str(w.message).split("\n")[0][:160] for w in caught
                     if "deterministic" in str(w.message)})
    return state, rows, nondet


def timed_train_step(torch, cfg, opt, state, batch):
    """One train step on ``state`` split into forward (``loss_fn``),
    backward (``torch.autograd.grad``) and update (``adamw.update``),
    each ended by a synchronize: wall ms (forward, backward, update)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, unflatten
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = [p.detach().requires_grad_(True) for p in leaves(state["params"])]
    loss, _ = T.loss_fn(unflatten(state["params"], flat), cfg, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    del loss, flat
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adamw.update(opt, unflatten(state["params"], grads), state["opt"],
                 state["params"])
    del grads
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def train_times(torch, cfg, opt, state, batch, label, card, flop, n_params,
                reps=3):
    """(f): the median split of ``reps`` timed steps after an untimed
    one, tokens/s, a profiled step's launches and idle share, and the
    bound (FLOP at the bf16 peak plus AdamW's bytes at 3.35 TB/s)."""
    from repro_torch.launch import steps
    split = [timed_train_step(torch, cfg, opt, state, batch)
             for _ in range(reps + 1)][1:]
    fwd, bwd, upd = (statistics.median(c) for c in zip(*split))
    step_ms = statistics.median(sum(r) for r in split)
    step = steps.make_train_step(cfg, opt)
    prof = kernel_classes(device_times(
        torch, lambda: step(state, batch), 1))
    flop_ms = flop / BF16_FLOP_PER_S * 1e3
    opt_ms = ADAMW_BYTES * n_params / HBM_BYTES_PER_S * 1e3
    log(f"  (f) {label}: step {step_ms:.3f} ms = forward {fwd:.3f} + "
        f"backward {bwd:.3f} + update {upd:.3f} ms (wall, median of {reps});"
        f" {TRAIN_BATCH * TRAIN_SEQ * 1e3 / step_ms:.1f} tokens/s; bound "
        f"{flop_ms + opt_ms:.3f} ms ({flop / 1e12:.3f} TFLOP at 989 TFLOP/s "
        f"= {flop_ms:.3f} ms, plus AdamW's {ADAMW_BYTES * n_params / 1e9:.2f}"
        f" GB at 3.35 TB/s = {opt_ms:.3f} ms), {step_ms / (flop_ms + opt_ms):.1f}x "
        f"the bound; {card}")
    if prof:
        log(f"      a profiled step: {step_profile_line(prof, step_ms)}")
    else:
        log("      a profiled step: the profiler recorded no device time "
            "(not measured)")
    return step_ms


def check_equal_runs(torch, a_rows, b_rows, a_params, b_state, nondet, what):
    """kernel == plain: every step's loss, ce, aux and grad_norm and every
    final parameter equal, bit for bit; where torch warned of a
    nondeterministic op, step 1's loss bit for bit and the rest within
    1e-6 relative."""
    from repro_torch.tree import leaves
    b_params = leaves(b_state["params"])
    if not nondet:
        check(a_rows == b_rows,
              f"{what}: the kernel's losses/grad norms {a_rows} differ from "
              f"the plain version's {b_rows}")
        for i, (x, y) in enumerate(zip(a_params, b_params, strict=True)):
            check(torch.equal(x, y),
                  f"{what}: final parameter leaf {i} differs between the "
                  f"kernel and the plain version")
        return "equal bit for bit"
    check(a_rows[0][0] == b_rows[0][0],
          f"{what}: step 1's loss differs between the kernel and the plain "
          f"version")
    for ra, rb in zip(a_rows, b_rows, strict=True):
        for x, y in zip(ra, rb):
            check(abs(x - y) <= 1e-6 * max(abs(y), 1e-30),
                  f"{what}: {ra} against {rb} past 1e-6 relative")
    worst = max(float((x.double() - y.double()).norm()
                      / max(float(y.double().norm()), 1e-30))
                for x, y in zip(a_params, b_params))
    check(worst <= 1e-6, f"{what}: final parameters {worst:.2e} apart")
    return (f"step 1's loss bit for bit, the rest within 1e-6 (final "
            f"parameters {worst:.2e} apart; nondeterministic ops: {nondet})")


def train_model(torch, np, dev, counts, card, arch, cfg, n_params, flop):
    """(b) or (d): TRAIN_STEPS counted steps under haloc_axa (the kernel),
    the same steps with the plain version on the card, then (f)'s times
    with exact adds and haloc_axa; returns the counted launches."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    hal = cfg.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    plain = cfg.with_approx(lm_numerics("haloc_axa", "torch", dev))
    batches = train_batches(cfg, TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    (state, rows, nondet), launches = run_counted(
        torch, counts, LM_PATH_KERNELS,
        lambda: train_run(torch, hal, opt, batches, dev),
        f"{arch} train path ({TRAIN_STEPS} steps)")
    peak = torch.cuda.max_memory_allocated(dev)
    predicted = train_state_bytes(state["params"])
    check(T.param_count(state["params"]) == n_params,
          f"{arch}: {T.param_count(state['params'])} parameters, not "
          f"{n_params}")
    per_step = 2 * cfg.num_layers
    check(launches["approx_add"] == per_step * TRAIN_STEPS,
          f"{arch}: approx_add launched {launches['approx_add']} times in "
          f"{TRAIN_STEPS} train steps, not {per_step} a step")
    check(all(n == 0 for k, n in launches.items() if k != "approx_add"),
          f"{arch}: the train path launched other kernels: {launches}")
    for loss, ce, aux, gnorm in rows:
        check(np.isfinite(loss) and gnorm > 0,
              f"{arch}: loss {loss}, grad_norm {gnorm}")
    if cfg.moe is not None:
        check(all(r[2] > 0 for r in rows), f"{arch}: aux {rows}")
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"  {arch}: {cfg.num_layers} layers, {n_params} parameters; "
        f"{TRAIN_STEPS} steps of make_train_step on {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens under haloc_axa: {per_step} approx_add "
        f"launches a step; (loss, ce, aux, grad_norm) a step: {rows}; "
        f"peak {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB "
        f"({(total - peak) / 2**30:.2f} GiB to spare) against "
        f"{predicted / 2**30:.2f} GiB predicted")
    a_params = copy_params(state["params"])
    step_ms = {}
    for label, c in (("haloc_axa", hal), ("exact", cfg)):
        step_ms[label] = train_times(torch, c, opt, state, batches[0],
                                     f"{arch} {label}", card, flop, n_params)
    del state
    torch.cuda.empty_cache()
    pstate, prow, pnondet = train_run(torch, plain, opt, batches, dev)
    nondet = sorted(set(nondet) | set(pnondet))
    how = check_equal_runs(torch, rows, prow, a_params, pstate, nondet,
                           f"{arch} train steps")
    log(f"  {arch}: the same {TRAIN_STEPS} steps with the plain version on "
        f"the card (deterministic algorithms, CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}): {how}")
    del pstate, a_params
    torch.cuda.empty_cache()
    return launches


def train_state_bytes(params):
    """Predicted peak: fp32 parameters, gradients, m and v (16 B a
    parameter) and the bf16 copies of the blocks' matrices that the
    backward keeps (2 B each; the embedding is gathered before its cast,
    the head runs under checkpointing)."""
    from repro_torch.tree import leaves_with_paths
    n = sum(t.numel() for _, t in leaves_with_paths(params))
    matrices = sum(t.numel() for path, t in leaves_with_paths(params)
                   if t.ndim >= 2 and path[0] not in ("embed", "lm_head"))
    return 16 * n + 2 * matrices


def train_cpu_inputs(torch):
    """(c)'s model, parameters and batch: Qwen3-4B cut to its first
    TRAIN_CPU_LAYERS layers at full width, its fp32 parameters drawn on
    the CPU from seed 1 (both halves draw the same), one batch."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cut = dataclasses.replace(get_config(TRAIN_ARCH),
                              repeats=TRAIN_CPU_LAYERS)
    return cut, T.init_params(1, cut, device="cpu"), \
        train_batches(cut, 1)[0]


def train_cpu_half():
    """(c)'s CPU half, ``chip_smoke.py --train-cpu-half``: one step's
    loss and gradients on the port's CPU path with exact adds and under
    haloc_axa, on TRAIN_CPU_THREADS threads; pickled to stdout as
    {label: (loss, [gradient leaves as numpy], seconds)} and "init"."""
    import pickle
    # the pickle alone on stdout: anything else printed goes to stderr
    result = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    import torch
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    torch.set_num_threads(TRAIN_CPU_THREADS)
    t0 = time.perf_counter()
    cut, params, batch = train_cpu_inputs(torch)
    out = {"init": time.perf_counter() - t0}
    for label, cfg in (("exact", cut), ("haloc_axa", cut.with_approx(
            lm_numerics("haloc_axa", "torch", "cpu")))):
        t0 = time.perf_counter()
        (loss, _), grads = steps.value_and_grad(params, cfg, batch)
        out[label] = (float(loss), [g.numpy() for g in leaves(grads)],
                      time.perf_counter() - t0)
    pickle.dump(out, result, protocol=5)
    result.close()


#: (g): the launcher at granite's full config.
TRAIN_LAUNCHER = ["-m", "repro_torch.launch.train", "--arch",
                  TRAIN_MOE_ARCH, "--adder", "haloc_axa", "--steps", "4",
                  "--batch", "4", "--seq", "128"]


def start_train_background(torch, dev):
    """Phase 4k's (c) and (g), started after the build: (c)'s CPU half
    and the launcher (g) each in a process of its own, then (c)'s card
    half here.  They run beside phases 3-4c, which time nothing, and are
    joined before phase 4d (:func:`finish_train_background`), so no timed
    cell runs beside them.  An exit before the join kills both."""
    import atexit
    import dataclasses
    from repro_torch.launch import steps
    from repro_torch.tree import leaves, tree_map
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    half = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--train-cpu-half"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE)
    logs = [open(out_dir / f"train_launcher.{k}", "w")
            for k in ("out", "err")]
    launcher = subprocess.Popen([sys.executable] + TRAIN_LAUNCHER, cwd=ROOT,
                                env=env, stdout=logs[0], stderr=logs[1])
    slogs = [open(out_dir / f"shard_launcher.{k}", "w")
             for k in ("out", "err")]
    sharded = subprocess.Popen([sys.executable] + SHARD_LAUNCHER, cwd=ROOT,
                               env=env, stdout=slogs[0], stderr=slogs[1])

    def kill():
        for proc in (half, launcher, sharded):
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(kill)
    cut, cpu_params, batch = train_cpu_inputs(torch)
    params = tree_map(lambda t: t.to(dev), cpu_params)
    del cpu_params
    rec = ResidualRecorder(lm_numerics("haloc_axa", "cuda", dev))
    card = {}
    for label, cfg in (("exact", cut),
                       ("haloc_axa", dataclasses.replace(cut, approx=rec))):
        (loss, _), grads = steps.value_and_grad(params, cfg, batch)
        card[label] = (float(loss), leaves(grads))
    with torch.no_grad():
        check_adds_on_cpu(torch, rec, lm_numerics("haloc_axa", "torch",
                                                  "cpu"),
                          f"{TRAIN_ARCH} train step")
    n_adds = len(rec.calls)
    del params, rec
    log(f"  (c)'s card half: {time.perf_counter() - t0:.1f} s (its "
        f"parameters drawn on the CPU); each of the card's {n_adds} "
        f"haloc_axa residual adds equals the CPU path's on its operands, "
        f"bit for bit")
    return {"half": half, "launcher": launcher, "logs": logs + slogs,
            "sharded": sharded, "card": card}


def finish_train_background(torch, dev, bg):
    """Waits for (c)'s CPU half and the launcher; (c): the card's loss
    within TRAIN_LOSS_TOL of the CPU path's and every gradient leaf within
    TRAIN_GRAD_TOL, exact adds (the haloc_axa figures printed); (g): the
    launcher exited 0 and printed its report line."""
    import pickle
    t0 = time.perf_counter()
    half, launcher = bg["half"], bg["launcher"]
    try:
        cpu = pickle.load(half.stdout)
    except Exception as e:  # the half's traceback is on stderr above
        half.wait()
        fail(f"(c)'s CPU half exited {half.returncode}: {e!r}")
    check(half.wait() == 0, f"(c)'s CPU half exited {half.returncode}")
    launcher.wait(timeout=600)
    bg["sharded"].wait(timeout=600)
    waited = time.perf_counter() - t0
    for f in bg["logs"]:
        f.close()
    figures = {}
    for label in ("exact", "haloc_axa"):
        loss, grads = bg["card"][label]
        cpu_loss, cpu_grads, secs = cpu[label]
        worst = 0.0
        for g, c in zip(grads, cpu_grads, strict=True):
            c = torch.from_numpy(c).to(dev, torch.float64)
            worst = max(worst, float((g.double() - c).norm()
                                     / max(float(c.norm()), 1e-30)))
        figures[label] = (loss, cpu_loss, worst, secs)
    init_s = cpu["init"]
    del bg["card"], cpu
    torch.cuda.empty_cache()
    loss, cpu_loss, worst, _ = figures["exact"]
    check(abs(loss - cpu_loss) <= TRAIN_LOSS_TOL * abs(cpu_loss),
          f"{TRAIN_ARCH} cut to {TRAIN_CPU_LAYERS} layers, exact: the "
          f"card's loss {loss} against the CPU path's {cpu_loss}")
    check(worst < TRAIN_GRAD_TOL,
          f"{TRAIN_ARCH} cut to {TRAIN_CPU_LAYERS} layers, exact: a "
          f"gradient leaf {worst:.4f} from the CPU path's")
    h = figures["haloc_axa"]
    log(f"  phase 4k (c) {TRAIN_ARCH} cut to its first {TRAIN_CPU_LAYERS} "
        f"layers (full width), one step on {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, the card against the CPU path (the CPU's half a process "
        f"on {TRAIN_CPU_THREADS} threads beside phases 3-4c: parameters "
        f"{init_s:.1f} s, exact {figures['exact'][3]:.1f} s, haloc_axa "
        f"{h[3]:.1f} s; waited {waited:.1f} s for it and (g) here): exact "
        f"loss {loss:.6f} / {cpu_loss:.6f} (within {TRAIN_LOSS_TOL} "
        f"relative), worst gradient leaf {worst:.4f} (< {TRAIN_GRAD_TOL}); "
        f"haloc_axa (printed, not gated: ROADMAP Queue C 3): loss "
        f"{h[0]:.6f} / {h[1]:.6f}, worst gradient leaf {h[2]:.4f}")
    out = (ROOT / "build" / "train_launcher.out").read_text().strip()
    lines = out.splitlines()
    check(launcher.returncode == 0 and lines
          and lines[-1].startswith(f"{TRAIN_MOE_ARCH}: loss "),
          f"python {' '.join(TRAIN_LAUNCHER)} exited {launcher.returncode}:"
          f" {out[-2000:]} "
          f"{(ROOT / 'build' / 'train_launcher.err').read_text()[-2000:]}")
    log(f"  phase 4k (g) python {' '.join(TRAIN_LAUNCHER)} (beside phases "
        f"3-4c): exit 0: {lines[-1]}")
    sharded = bg["sharded"]
    out = (ROOT / "build" / "shard_launcher.out").read_text().strip()
    lines = out.splitlines()
    check(sharded.returncode == 0 and lines
          and lines[-1].startswith("qwen3-4b-smoke: loss "),
          f"python {' '.join(SHARD_LAUNCHER)} exited {sharded.returncode}: "
          f"{out[-2000:]} "
          f"{(ROOT / 'build' / 'shard_launcher.err').read_text()[-2000:]}")
    log(f"  phase 4l (c) python {' '.join(SHARD_LAUNCHER)} (beside phases "
        f"3-4c): exit 0: {lines[-1]}")


def flash_case(torch, dev, card):
    """(e): the flash VJP against autograd through the plain path at
    Qwen3-4B's attention shapes, both timed with their peak memory."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    b, s, h, hkv, d = FLASH_B, FLASH_S, FLASH_H, FLASH_HKV, FLASH_D
    q, k, v, g = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
        rnd(b, s, h, d)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    res = {}
    for name, fn in (("flash", L.chunked_attention),
                     ("plain", L.plain_attention)):
        ms, peak = [], 0
        for _ in range(3):
            leaves_ = [t.detach().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*leaves_, pos, pos, causal=True)
            grads = torch.autograd.grad(out, leaves_, g)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated(dev) - base
        res[name] = (out.detach(), [x.detach() for x in grads],
                     statistics.median(ms[1:]), peak)
    (fo, fg, fms, fpeak), (po, pg, pms, ppeak) = res["flash"], res["plain"]

    def rel(x, y):
        return float((x.float() - y.float()).norm() / y.float().norm())

    errs = [rel(fo, po)] + [rel(x, y) for x, y in zip(fg, pg)]
    check(max(errs) < FLASH_TOL,
          f"flash VJP against the plain path: output, dq, dk, dv "
          f"{errs} (rule {FLASH_TOL})")
    log(f"  (e) flash VJP (chunked_attention, KV chunk 1024) at ({b}, {s}, "
        f"{h}/{hkv}, {d}), causal: output, dq, dk, dv within "
        f"{', '.join(f'{e:.4f}' for e in errs)} of autograd through "
        f"plain_attention (< {FLASH_TOL}); forward + backward {fms:.3f} ms, "
        f"peak {fpeak / 2**30:.3f} GiB above its inputs, against the plain "
        f"path's {pms:.3f} ms and {ppeak / 2**30:.3f} GiB (wall, median of "
        f"2; {card})")


def train_restart_case(torch, dev, counts):
    """(h): the smoke config trained 4 steps with a checkpoint every 2,
    restarted and run to step 6: steps 4 and 5's losses equal an
    uninterrupted run's, bit for bit.  Returns the counted launches."""
    import shutil
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, run
    cfg = get_smoke_config(TRAIN_RESTART_ARCH).with_approx(
        lm_numerics("haloc_axa", "cuda", dev))
    data = DataConfig(seq_len=64, global_batch=4, seed=3)
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=6)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)

    def loop(total, ckpt):
        return run(cfg, opt, data, TrainLoopConfig(
            total_steps=total, ckpt_every=2, log_every=1,
            ckpt_dir=str(ckpt) if ckpt else None), device=dev)["history"]

    def path():
        whole = loop(6, None)
        loop(4, TRAIN_CKPT_DIR)
        return whole, loop(6, TRAIN_CKPT_DIR)

    (whole, resumed), launches = run_counted(
        torch, counts, LM_PATH_KERNELS, path, "train loop restart path")
    got = {h["step"]: h["loss"] for h in resumed}
    want = {h["step"]: h["loss"] for h in whole}
    check(sorted(got) == [4, 5] and all(got[s] == want[s] for s in got),
          f"restart: steps 4-5 losses {got} against the uninterrupted "
          f"run's {want}")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    log(f"  (h) {cfg.name} under haloc_axa, 4 x 64 tokens: 4 steps with a "
        f"checkpoint every 2, restarted from step 4 and run to 6: losses "
        f"{[got[s] for s in (4, 5)]} equal the uninterrupted run's, bit for "
        f"bit")
    return launches


def moe_active_params(cfg, n_params):
    """The parameters a token's forward reaches: all but the routed
    experts, plus its top-k experts."""
    mc = cfg.moe
    expert = 3 * cfg.d_model * mc.d_ff
    layers = sum(s.mlp == "moe" for s in cfg.all_blocks())
    return n_params - layers * mc.num_experts * expert \
        + layers * mc.experts_per_token * expert


def train_phase(torch, np, dev, counts, card, errs):
    """Phase 4k: training on the card (loss and gradients, AdamW, the
    train step, data, checkpoints and the train loop) at Qwen3-4B's full
    width and granite-moe-1b-a400m's full config; returns the launches
    of the counted paths."""
    import dataclasses
    from repro_torch.configs import get_config
    for width in (2560, 1024):
        check_lm_kernel_shapes(torch, np, dev, errs, width=width,
                               prompt=TRAIN_SEQ)
    log(f"  (a) approx_add equals its plain version at the train step's "
        f"residual adds, ({TRAIN_BATCH}, {TRAIN_SEQ}, 2560) and "
        f"({TRAIN_BATCH}, {TRAIN_SEQ}, 1024), every kind, both forms")
    log("  (c) and (g) ran beside phases 3-4c (above)")
    torch.use_deterministic_algorithms(True, warn_only=True)
    total = {}
    try:
        qwen = dataclasses.replace(get_config(TRAIN_ARCH),
                                   repeats=TRAIN_LAYERS)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        granite = get_config(TRAIN_MOE_ARCH)
        cases = [("(b)", TRAIN_ARCH, qwen, TRAIN_PARAMS,
                  6 * TRAIN_PARAMS * tokens),
                 ("(d)", TRAIN_MOE_ARCH, granite, TRAIN_MOE_PARAMS,
                  6 * moe_active_params(granite, TRAIN_MOE_PARAMS) * tokens)]
        for tag, arch, cfg, n, flop in cases:
            t0 = time.perf_counter()
            log(f"  {tag} {arch}")
            launches = train_model(torch, np, dev, counts, card, arch, cfg,
                                   n, flop)
            for k, c in launches.items():
                total[k] = total.get(k, 0) + c
            log(f"  {tag} took {time.perf_counter() - t0:.1f} s")
        flash_case(torch, dev, card)
        launches = train_restart_case(torch, dev, counts)
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
    finally:
        torch.use_deterministic_algorithms(False)
    return total


# ------------------------------------------------------------ phase 4l --

#: Phase 4l's cells: Qwen3-4B at full width cut to SHARD_LAYERS layers,
#: trained SHARD_STEPS steps on TRAIN_BATCH x TRAIN_SEQ tokens through the
#: train loop on a (1, 1) mesh; granite-moe-1b-a400m's expert-parallel
#: prefill at its full config (and at SHARD_MOE_CPU_LAYERS layers against
#: the CPU path).
SHARD_LAYERS, SHARD_STEPS, SHARD_MOE_CPU_LAYERS = 4, 3, 2
#: The caching allocator hands a tensor a block of at least its bytes: a
#: large one rounded up to 2 MiB at most.
ALLOC_ROUND = 2 << 20
#: (c): the launcher under torch.distributed.run, one rank; --standalone
#: takes a free port for the rendezvous (the default 29500 may be taken).
SHARD_LAUNCHER = ["-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
                  "--arch", "qwen3-4b", "--smoke", "--steps", "2"]
#: (d): the tensor-parallel train loop on a TP_MESH ("data", "model")
#: mesh of two ranks on the one card (a gloo group: NCCL takes one rank a
#: device), each a process of its own (``chip_smoke.py --tp-rank``),
#: given TP_TIMEOUT seconds; its figures in TP_DIR.
TP_MESH = (1, 2)
TP_TIMEOUT = 600
TP_DIR = ROOT / "build" / "tp_ranks"
#: (d)'s serving: bf16 parameters from TP_SERVE_SEED, the prompt from
#: TP_PROMPT_SEED, LM_BATCH x LM_PROMPT tokens and LM_NEW greedy steps.
TP_SERVE_SEED, TP_PROMPT_SEED = 0, 29


def one_rank_mesh(torch):
    """A process group of this one process over NCCL (a ``HashStore``:
    no port) and the (1, 1) ("data", "model") mesh over it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = make_host_mesh(1, 1)
    check(hasattr(mesh, "get_group"),
          f"make_host_mesh(1, 1) over one NCCL rank gave {mesh!r}")
    return mesh


def loop_run(torch, cfg, opt, mesh, dev):
    """``train_loop.run`` for SHARD_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens (on ``mesh`` when one is given); returns (the state, the
    losses)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, run
    out = run(cfg, opt, DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH),
              TrainLoopConfig(total_steps=SHARD_STEPS, log_every=1),
              mesh=mesh, device=dev)
    return out["state"], [h["loss"] for h in out["history"]]


def check_same_state(torch, a, b, what):
    """Every leaf of two train states (parameters, m, v, count, step)
    equal, bit for bit (a sharded state's gathered)."""
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        check(torch.equal(R.full_tensor(x), R.full_tensor(y)),
              f"{what}: state leaf {i} differs")
    return len(la)


def sharded_step_times(torch, cfg, opt, mesh, dev, card, reps=3):
    """(a)'s times: the sharded step's wall ms (median of ``reps`` after
    one untimed), a profiled step's launches and idle share."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch import steps
    from repro_torch.sharding import rules as R
    state = R.place_state(steps.init_state(0, cfg, opt, device=dev), mesh)
    step = steps.make_train_step(cfg, opt, batch_axes=R.batch_axes(mesh),
                                 mesh=mesh)
    batch = synthetic_batch(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH), 0)
    ms = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        float(met["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(ms[1:])
    prof = kernel_classes(device_times(torch, lambda: step(state, batch), 1))
    line = step_profile_line(prof, step_ms) if prof else \
        "the profiler recorded no device time (not measured)"
    return step_ms, line


def sharded_train_case(torch, np, dev, counts, card, mesh):
    """(a): Qwen3-4B cut to SHARD_LAYERS layers through the train loop on
    the (1, 1) mesh, exact and haloc_axa, against the unsharded loop and
    the plain version; the placed state's bytes against the dry run's.
    Returns the counted launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    cut = dataclasses.replace(get_config(TRAIN_ARCH), repeats=SHARD_LAYERS)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    placed = R.place_state(steps.init_state(0, cut, opt, device=dev), mesh)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated(dev) - base
    want = dryrun.state_bytes(cut, mesh)
    n = len(leaves(placed))
    check(0 <= got - want <= ALLOC_ROUND * n,
          f"the placed state holds {got} bytes on the card, the dry run "
          f"says {want} (within {ALLOC_ROUND >> 20} MiB a leaf, {n} "
          f"leaves)")
    del placed
    log(f"  (a) {TRAIN_ARCH} at full width cut to {SHARD_LAYERS} layers: the "
        f"placed state allocates {got} bytes on the card; the dry run's "
        f"per-device state bytes on the (1, 1) mesh {want}, {got - want} "
        f"fewer (the caching allocator rounds each of the {n} leaves' "
        f"blocks up, by under {ALLOC_ROUND >> 20} MiB)")
    hal = cut.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    plain = cut.with_approx(lm_numerics("haloc_axa", "torch", dev))
    (h_state, h_loss), launches = run_counted(
        torch, counts, LM_PATH_KERNELS,
        lambda: loop_run(torch, hal, opt, mesh, dev),
        f"sharded train loop ({SHARD_STEPS} steps, haloc_axa)")
    per_step = 2 * cut.num_layers
    check(launches["approx_add"] == per_step * SHARD_STEPS,
          f"the sharded train loop launched approx_add "
          f"{launches['approx_add']} times in {SHARD_STEPS} steps, not "
          f"{per_step} a step")
    check(all(c == 0 for k, c in launches.items() if k != "approx_add"),
          f"the sharded train loop launched other kernels: {launches}")
    check(all(np.isfinite(x) for x in h_loss), f"haloc_axa losses {h_loss}")
    p_state, p_loss = loop_run(torch, plain, opt, mesh, dev)
    check(p_loss == h_loss, f"haloc_axa: the kernel's losses {h_loss} "
          f"against the plain version's {p_loss}")
    check_same_state(torch, h_state, p_state, "the kernel against the plain "
                     "version on the sharded loop")
    del p_state
    losses = {"haloc_axa": (h_state, h_loss), "exact": None}
    for label, cfg in (("haloc_axa", hal), ("exact", cut)):
        state, loss = losses[label] or loop_run(torch, cfg, opt, mesh, dev)
        u_state, u_loss = loop_run(torch, cfg, opt, None, dev)
        check(loss == u_loss, f"{label}: the sharded loop's losses {loss} "
              f"against the unsharded loop's {u_loss}")
        nleaves = check_same_state(torch, state, u_state,
                                   f"{label} sharded against unsharded")
        losses[label] = loss
        del state, u_state
        torch.cuda.empty_cache()
    del h_state
    log(f"  (a) train_loop.run(mesh=(1, 1)) {SHARD_STEPS} steps on "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, deterministic algorithms: "
        f"{per_step} approx_add launches a step; losses {losses}; the loss "
        f"and all {nleaves} leaves of the state (parameters, m, v, count, "
        f"step) equal the unsharded loop's bit for bit, exact and "
        f"haloc_axa; the kernel's sharded run equals the plain version's")
    for label, cfg in (("haloc_axa", hal), ("exact", cut)):
        step_ms, line = sharded_step_times(torch, cfg, opt, mesh, dev, card)
        log(f"  (a) {label} sharded step: {step_ms:.3f} ms (wall, median of "
            f"3; {card}); a profiled step: {line}")
        torch.cuda.empty_cache()
    return launches, losses


def ep_prefill(torch, cfg, params, prompt, mesh):
    from repro_torch.launch import steps
    from repro_torch.sharding import rules as R
    step = steps.make_prefill_step(cfg, TRAIN_SEQ,
                                   batch_axes=R.batch_axes(mesh), mesh=mesh)
    with torch.no_grad():
        return step(params, prompt)[0]


def ep_prefill_case(torch, dev, counts, card, mesh):
    """(b): granite-moe-1b-a400m's expert-parallel prefill
    (``use_shard_map=True``) on the (1, 1) mesh against ``moe_apply``'s,
    at its full config, counted; at SHARD_MOE_CPU_LAYERS layers the card
    against the CPU path.  Returns the counted launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.tree import tree_map
    base = get_config(MOE_ARCH)
    ep = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, use_shard_map=True))
    hal_ep = ep.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    hal = base.with_approx(lm_numerics("haloc_axa", "cuda", dev))
    params = T.init_params(0, base, device=dev, dtype=torch.bfloat16)
    placed = R.place(params, R.tree_shardings(params, mesh, R.PARAM_RULES),
                     mesh)
    prompt = lm_prompt(torch, base, TRAIN_BATCH, TRAIN_SEQ, dev, 7)
    got, launches = run_counted(
        torch, counts, LM_PATH_KERNELS,
        lambda: ep_prefill(torch, hal_ep, placed, prompt, mesh),
        f"{MOE_ARCH} expert-parallel prefill")
    check(launches["approx_add"] == 2 * base.num_layers,
          f"the expert-parallel prefill launched approx_add "
          f"{launches['approx_add']} times, not {2 * base.num_layers}")
    want = ep_prefill(torch, hal, placed, prompt, mesh)
    rel = lm_rel(torch, got, want)
    eex = lm_rel(torch, ep_prefill(torch, ep, placed, prompt, mesh),
                 ep_prefill(torch, base, placed, prompt, mesh))
    check(max(rel, eex) < MOE_TOL,
          f"{MOE_ARCH}: the expert-parallel prefill's logits {rel:.4f} "
          f"(haloc_axa) / {eex:.4f} (exact) from moe_apply's (rule "
          f"{MOE_TOL})")
    del params, placed
    torch.cuda.empty_cache()
    log(f"  (b) {MOE_ARCH} at its full config ({base.num_layers} layers, "
        f"{base.moe.num_experts} experts), use_shard_map=True on the (1, 1) "
        f"mesh, prefill of {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"{2 * base.num_layers} approx_add launches; last logits "
        f"{rel:.6f} (haloc_axa) and {eex:.6f} (exact) from moe_apply's "
        f"(rule {MOE_TOL})")
    cut = dataclasses.replace(ep, repeats=SHARD_MOE_CPU_LAYERS)
    cpu_params = T.init_params(1, cut, device="cpu", dtype=torch.bfloat16)
    card_params = R.place(tree_map(lambda t: t.to(dev), cpu_params),
                          R.tree_shardings(cpu_params, mesh, R.PARAM_RULES),
                          mesh)
    cpu_prompt = {"tokens": prompt["tokens"].cpu()}
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_logits = T.forward(cpu_params, cut, cpu_prompt,
                               mode="prefill", cache=T.init_cache(
                                   cut, TRAIN_BATCH, TRAIN_SEQ,
                                   device="cpu"))[0]
    cpu_s = time.perf_counter() - t0
    card_logits = ep_prefill(torch, cut, card_params, prompt, mesh)
    crel = lm_rel(torch, card_logits, cpu_logits)
    check(crel < MOE_TOL,
          f"{MOE_ARCH} cut to {SHARD_MOE_CPU_LAYERS} layers, exact: the "
          f"card's expert-parallel prefill {crel:.4f} from the CPU path's")
    log(f"  (b) cut to {SHARD_MOE_CPU_LAYERS} layers (parameters drawn on "
        f"the CPU), exact adds: the card's expert-parallel prefill on the "
        f"mesh against the CPU path's ({cpu_s:.1f} s there): last logits "
        f"{crel:.6f} apart (rule {MOE_TOL})")
    return launches


def tp_local_equal(torch, a, b):
    """Whether every leaf of two train states as this rank holds them
    (its shards) is equal, bit for bit; the first differing leaf's
    index or None."""
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b), strict=True)):
        if not torch.equal(R.local(x), R.local(y)):
            return i
    return None


def tp_grads_against_unsharded(torch, cfg, mesh, dev):
    """(d)'s step-1 gradients: the unsharded step's (the whole state on
    this rank) against the tensor-parallel step's on the same seed-0
    parameters and first batch; each leaf's squared difference and
    squared norm summed over its "model" shards (one all-reduce), so that
    each rank returns every leaf's relative error of the gathered
    gradient.  Returns (unsharded loss, tensor-parallel loss, [relative
    errors], seconds)."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    batch = synthetic_batch(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH), 0)
    params = T.init_params(0, cfg, device=dev)
    (u_loss, _), u_grads = steps.value_and_grad(params, cfg, batch)
    placed = R.place(params, R.tree_shardings(params, mesh, R.PARAM_RULES),
                     mesh)
    del params
    local, axes = steps.split_batch(batch, mesh, R.batch_axes(mesh))
    (t_loss, _), t_grads = steps.value_and_grad(placed, cfg, local, axes,
                                                mesh)
    del placed
    sums, sharded = [], []
    for u, t in zip(leaves(u_grads), leaves(t_grads), strict=True):
        mine = R.local(t).double()
        want = (R.local_shard(u, mesh, t.placements) if R.is_dtensor(t)
                else u).double()
        sums.append(torch.stack([((mine - want) ** 2).sum(),
                                 (want ** 2).sum()]))
        sharded.append(R.model_dim(t) is not None)
    del u_grads, t_grads
    stacked = torch.stack(sums).float()
    summed = R.sum_over(stacked.clone(), mesh, ("model",))
    mask = torch.tensor(sharded, device=dev)[:, None]
    stacked = torch.where(mask, summed, stacked)
    rel = [float((d / n).sqrt()) if n > 0 else float(d.sqrt())
           for d, n in stacked.unbind()]
    return float(u_loss), float(t_loss), rel, time.perf_counter() - t0


def tp_step_split(torch, cfg, opt, mesh, dev, reps=3):
    """(d)'s times on this rank: the tensor-parallel train step split into
    forward (``loss_fn``), backward and update, each ended by a
    synchronize (median of ``reps`` after an untimed one), and rank 0's
    profiled step (rank 1 runs the same step beside it)."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves, unflatten
    state = R.place_state(steps.init_state(0, cfg, opt, device=dev), mesh)
    whole = synthetic_batch(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH), 0)
    batch, axes = steps.split_batch(whole, mesh, R.batch_axes(mesh))

    def split():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = [p.detach().requires_grad_(True)
                for p in leaves(state["params"])]
        loss, _ = T.loss_fn(unflatten(state["params"], flat), cfg, batch,
                            axes, mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        del loss, flat
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw.update(opt, unflatten(state["params"], grads), state["opt"],
                     state["params"])
        del grads
        torch.cuda.synchronize()
        return ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                (time.perf_counter() - t2) * 1e3)

    rows = [split() for _ in range(reps + 1)][1:]
    fwd, bwd, upd = (statistics.median(c) for c in zip(*rows))
    step_ms = statistics.median(sum(r) for r in rows)
    step = steps.make_train_step(cfg, opt, batch_axes=R.batch_axes(mesh),
                                 mesh=mesh)
    if mesh.get_rank() == 0:
        prof = kernel_classes(device_times(torch, lambda: step(state, whole),
                                           1))
        line = step_profile_line(prof, step_ms) if prof else \
            "the profiler recorded no device time (not measured)"
    else:
        for _ in range(2):   # device_times' untimed call and its profiled one
            step(state, whole)
        torch.cuda.synchronize()
        line = None
    return {"fwd": fwd, "bwd": bwd, "upd": upd, "step": step_ms,
            "profile": line}


def tp_serve_run(torch, cfg, params, mesh, prompt, forced=None):
    """(d)'s serving run: the prefill step of ``prompt`` with a cache of
    LM_PROMPT + LM_NEW positions, then LM_NEW decode steps on the greedy
    tokens (``forced``: these tokens instead); on ``mesh`` the sharded
    steps, without one the unsharded.  Returns (each step's logits, the
    greedy token of each, the cache)."""
    from repro_torch.launch import steps
    from repro_torch.sharding import rules as R
    ba = None if mesh is None else R.batch_axes(mesh)
    prefill = steps.make_prefill_step(cfg, LM_PROMPT + LM_NEW,
                                      batch_axes=ba, mesh=mesh)
    decode = steps.make_decode_step(cfg, batch_axes=ba, mesh=mesh)
    with torch.no_grad():
        logits, cache = prefill(params, prompt)
        out = [logits]
        for i in range(LM_NEW):
            nxt = (logits[:, -1].float().argmax(-1)[:, None] if forced is None
                   else forced[:, i:i + 1])
            logits, cache = decode(params, {"tokens": nxt}, LM_PROMPT + i,
                                   cache)
            out.append(logits)
    toks = torch.cat([lg[:, -1].float().argmax(-1)[:, None] for lg in out], 1)
    return out, toks, cache


def tp_digest(torch, t):
    """The SHA-256 of a tensor's bytes (bf16 read as its bits)."""
    import hashlib
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def tp_serve(torch, cut, hal, plain, mesh, dev, counts):
    """(d)'s serving on this rank (the module docstring, 4l): the three
    runs on the placed parameters, the cache's bytes beside the dry
    run's, rank 0's unsharded passes and its times and profile.  Returns
    its figures for JSON."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    params = T.init_params(TP_SERVE_SEED, cut, device=dev,
                           dtype=torch.bfloat16)
    placed = R.place(params, R.tree_shardings(params, mesh, R.PARAM_RULES),
                     mesh)
    rank0 = mesh.get_rank() == 0
    if not rank0:
        del params
    prompt = lm_prompt(torch, cut, LM_BATCH, LM_PROMPT, dev, TP_PROMPT_SEED)
    for f in counts.values():
        f.launches = 0
    h_logits, h_toks, h_cache = tp_serve_run(torch, hal, placed, mesh,
                                                prompt)
    torch.cuda.synchronize()
    res = {"launches": {name: f.launches for name, f in counts.items()}}
    p_logits, p_toks, p_cache = tp_serve_run(torch, plain, placed, mesh,
                                                prompt)
    res["plain_equal"] = (
        all(torch.equal(a, b) for a, b in zip(h_logits, p_logits,
                                              strict=True))
        and torch.equal(h_toks, p_toks)
        and all(torch.equal(a, b) for a, b in zip(
            leaves(h_cache), leaves(p_cache), strict=True)))
    del p_logits, p_cache
    e_logits, e_toks, e_cache = tp_serve_run(torch, cut, placed, mesh,
                                                prompt)
    res["cache_bytes"] = (sum(t.nbytes for t in leaves(e_cache)),
                          dryrun.cache_bytes(cut, LM_BATCH,
                                             LM_PROMPT + LM_NEW, mesh),
                          [list(t.shape) for t in leaves(e_cache)][:3])
    res["digests"] = {label: [tp_digest(torch, lg) for lg in logits]
                      for label, logits in (("haloc_axa", h_logits),
                                            ("exact", e_logits))}
    res["tokens"] = {"haloc_axa": h_toks.tolist(), "exact": e_toks.tolist()}
    if rank0:   # the unsharded passes, teacher-forced with the sharded tokens
        res["unsharded"] = {}
        for label, cfg, logits, toks in (("exact", cut, e_logits, e_toks),
                                         ("haloc_axa", hal, h_logits,
                                          h_toks)):
            u_logits = tp_serve_run(torch, cfg, params, None, prompt,
                                    forced=toks)[0]
            res["unsharded"][label] = [lm_rel(torch, a, b) for a, b in
                                       zip(logits, u_logits, strict=True)]
        del params
    del h_logits, e_logits, h_cache, e_cache
    res["seconds"] = time.perf_counter() - t0
    # times: haloc_axa with the kernel, a cache with a spare slot for the
    # profiled step; the ranks run the same calls (their collectives pair)
    ba = R.batch_axes(mesh)
    prefill = steps.make_prefill_step(hal, LM_PROMPT + LM_NEW + 1,
                                      batch_axes=ba, mesh=mesh)
    decode = steps.make_decode_step(hal, batch_axes=ba, mesh=mesh)

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            got = fn()
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t1) * 1e3

    (logits, cache), prefill_ms = timed(lambda: prefill(placed, prompt))
    ms = []
    for i in range(LM_NEW):
        nxt = logits[:, -1].float().argmax(-1)[:, None]
        (logits, cache), t = timed(lambda: decode(
            placed, {"tokens": nxt}, LM_PROMPT + i, cache))
        ms.append(t)
    step_ms = statistics.median(ms)

    def step():
        with torch.no_grad():
            decode(placed, {"tokens": nxt}, LM_PROMPT + LM_NEW, cache)

    if rank0:
        prof = kernel_classes(device_times(torch, step, 1))
        line = step_profile_line(prof, step_ms) if prof else \
            "the profiler recorded no device time (not measured)"
    else:
        for _ in range(2):   # device_times' untimed call and its profiled one
            step()
        torch.cuda.synchronize()
        line = None
    res["times"] = {"prefill_ms": prefill_ms, "decode_ms": step_ms,
                    "profile": line}
    return res


def tp_rank(rank, port, out):
    """One rank of (d), ``chip_smoke.py --tp-rank RANK PORT OUT``: joins
    the two-rank gloo group on the card, builds the TP_MESH mesh and runs
    (d)'s cells; writes its figures to OUT as JSON (a rank that fails
    writes none and exits non-zero)."""
    import dataclasses
    import datetime
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    torch.use_deterministic_algorithms(True, warn_only=True)
    res = {"rank": rank}
    try:
        mesh = init_device_mesh("cuda", TP_MESH,
                                mesh_dim_names=("data", "model"))
        cut = dataclasses.replace(get_config(TRAIN_ARCH),
                                  repeats=SHARD_LAYERS)
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
        R.barrier(mesh)   # both ranks' card memory measured from here
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        placed = R.place_state(steps.init_state(0, cut, opt, device=dev),
                               mesh)
        torch.cuda.synchronize()
        res["state_bytes"] = (torch.cuda.memory_allocated(dev) - base,
                              dryrun.state_bytes(cut, mesh),
                              len(leaves(placed)))
        del placed
        hal = cut.with_approx(lm_numerics("haloc_axa", "cuda", dev))
        plain = cut.with_approx(lm_numerics("haloc_axa", "torch", dev))
        counts = counters()
        for f in counts.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        h_state, h_loss = loop_run(torch, hal, opt, mesh, dev)
        torch.cuda.synchronize()
        res["launches"] = {name: f.launches for name, f in counts.items()}
        res["loop_s"] = time.perf_counter() - t0
        res["peak"] = torch.cuda.max_memory_allocated(dev)
        res["haloc_axa"] = h_loss
        p_state, p_loss = loop_run(torch, plain, opt, mesh, dev)
        res["plain"] = p_loss
        res["plain_differs"] = tp_local_equal(torch, h_state, p_state)
        del h_state, p_state
        torch.cuda.empty_cache()
        e_state, res["exact"] = loop_run(torch, cut, opt, mesh, dev)
        del e_state
        torch.cuda.empty_cache()
        res["grads"] = tp_grads_against_unsharded(torch, cut, mesh, dev)
        torch.cuda.empty_cache()
        res["times"] = {label: tp_step_split(torch, cfg, opt, mesh, dev)
                        for label, cfg in (("haloc_axa", hal),
                                           ("exact", cut))}
        torch.cuda.empty_cache()
        res["serve"] = tp_serve(torch, cut, hal, plain, mesh, dev, counts)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def tensor_parallel_case(torch, np, dev, card, unsharded):
    """(d): Qwen3-4B at full width cut to SHARD_LAYERS layers, the train
    loop on a TP_MESH mesh of two gloo ranks on the card, compute over
    "model" tensor-parallel; each rank a process of its own
    (:func:`tp_rank`), its ``approx_add`` launches counted there.  Gates:
    each rank's placed state's bytes against the dry run's; the ranks'
    losses equal at every step; under haloc_axa the kernel's loop equal
    to the plain version's, bit for bit (every leaf each rank holds);
    with exact adds the losses within TRAIN_LOSS_TOL of (a)'s unsharded
    loop's and step 1's gradient leaves within TRAIN_GRAD_TOL of the
    unsharded step's (the haloc_axa losses printed beside the unsharded
    loop's: the adder turns each rounding the sums over "model" move
    into changes of up to 2^m units).  Returns the launches, both ranks'
    summed."""
    import shutil
    import socket
    torch.cuda.empty_cache()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(2):
        logs.append(open(TP_DIR / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
             str(r), str(port), str(TP_DIR / f"rank{r}.json")], cwd=ROOT,
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=TP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    for r, code in enumerate(codes):
        if code != 0 or not (TP_DIR / f"rank{r}.json").exists():
            tail = (TP_DIR / f"rank{r}.log").read_text()[-3000:]
            fail(f"(d) rank {r} of the two-rank gloo group on the card "
                 f"exited {code}:\n{tail}")
    ranks = [json.loads((TP_DIR / f"rank{r}.json").read_text())
             for r in range(2)]
    for res in ranks:
        got, want, n = res["state_bytes"]
        check(0 <= got - want <= ALLOC_ROUND * n,
              f"(d) rank {res['rank']}: the placed state holds {got} bytes "
              f"on the card, the dry run says {want} on (1, 2)")
        per_step = 2 * SHARD_LAYERS
        launches = res["launches"]
        check(launches["approx_add"] == per_step * SHARD_STEPS,
              f"(d) rank {res['rank']}: the tensor-parallel loop launched "
              f"approx_add {launches['approx_add']} times in {SHARD_STEPS} "
              f"steps, not {per_step} a step")
        check(all(c == 0 for k, c in launches.items() if k != "approx_add"),
              f"(d) rank {res['rank']}: other kernels launched: {launches}")
        check(all(np.isfinite(x) for x in res["haloc_axa"] + res["exact"]),
              f"(d) rank {res['rank']}: losses {res['haloc_axa']} / "
              f"{res['exact']}")
        check(res["plain"] == res["haloc_axa"]
              and res["plain_differs"] is None,
              f"(d) rank {res['rank']}: the kernel's loop against the plain "
              f"version's: losses {res['haloc_axa']} / {res['plain']}, "
              f"first differing state leaf {res['plain_differs']}")
        u_loss, t_loss, rel, _ = res["grads"]
        check(abs(t_loss - u_loss) <= TRAIN_LOSS_TOL * abs(u_loss)
              and max(rel) < TRAIN_GRAD_TOL,
              f"(d) rank {res['rank']}: step 1, exact: loss {t_loss} "
              f"against the unsharded step's {u_loss}, worst gradient leaf "
              f"{max(rel):.4f} (rule {TRAIN_GRAD_TOL})")
        worst = max(abs(a - b) / abs(b) for a, b in
                    zip(res["exact"], unsharded["exact"], strict=True))
        check(worst <= TRAIN_LOSS_TOL,
              f"(d) rank {res['rank']}: exact losses {res['exact']} against "
              f"the unsharded loop's {unsharded['exact']}")
    for label in ("haloc_axa", "exact", "plain"):
        check(ranks[0][label] == ranks[1][label],
              f"(d) {label}: the two model ranks' losses differ: "
              f"{ranks[0][label]} / {ranks[1][label]}")
    tp_serve_gates(np, ranks)
    r0 = ranks[0]
    got, want, n = r0["state_bytes"]
    h_rel = max(abs(a - b) / abs(b) for a, b in
                zip(r0["haloc_axa"], unsharded["haloc_axa"]))
    log(f"  (d) {TRAIN_ARCH} at full width cut to {SHARD_LAYERS} layers on a "
        f"{TP_MESH} (\"data\", \"model\") mesh of two gloo ranks on the "
        f"card, each a process ({seconds:.1f} s in all): each rank's placed "
        f"state {got} bytes on the card, the dry run's {want} "
        f"({got - want} fewer; {n} leaves)")
    log(f"  (d) train_loop.run {SHARD_STEPS} steps on {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, deterministic algorithms, compute over "
        f"\"model\" tensor-parallel: {2 * SHARD_LAYERS} approx_add launches "
        f"a step a rank; losses haloc_axa {r0['haloc_axa']} (the unsharded "
        f"loop's {unsharded['haloc_axa']}, {h_rel:.2e} apart at most: "
        f"printed, not gated), exact {r0['exact']} (the unsharded loop's "
        f"{unsharded['exact']}, rule {TRAIN_LOSS_TOL}); the two ranks' "
        f"losses equal bit for bit; the kernel's loop equals the plain "
        f"version's (losses and every leaf each rank holds)")
    u_loss, t_loss, rel, g_s = r0["grads"]
    log(f"  (d) step 1, exact adds, the tensor-parallel step against the "
        f"unsharded one on the same parameters ({g_s:.1f} s): loss "
        f"{t_loss} / {u_loss}, worst gathered gradient leaf {max(rel):.5f} "
        f"(rule {TRAIN_GRAD_TOL}), median {statistics.median(rel):.5f}")
    for label, t in r0["times"].items():
        log(f"  (d) {label} tensor-parallel step, rank 0: {t['step']:.3f} ms "
            f"= forward {t['fwd']:.3f} + backward {t['bwd']:.3f} + update "
            f"{t['upd']:.3f} ms (wall, median of 3; {card}); a profiled "
            f"step: {t['profile']}")
    log(f"  (d) peak memory a rank: {r0['peak'] / 2**30:.2f} GiB (rank 1 "
        f"{ranks[1]['peak'] / 2**30:.2f} GiB) in the counted loop; the "
        f"counted loop {r0['loop_s']:.1f} s")
    tp_serve_log(ranks, card)
    log("  (d) the collectives go through the host (gloo stages each CUDA "
        "tensor in host memory) and the two ranks share one card, so these "
        "times say nothing of tensor-parallel speed")
    return {k: sum(res["launches"][k] + res["serve"]["launches"][k]
                   for res in ranks)
            for k in ranks[0]["launches"]}


def tp_serve_gates(np, ranks):
    """(d)'s serving gates (the module docstring, 4l) on both ranks'
    figures."""
    forwards = 1 + LM_NEW
    for res in ranks:
        sv, r = res["serve"], res["rank"]
        got, want, _ = sv["cache_bytes"]
        check(got == want,
              f"(d) serving, rank {r}: the cache holds {got} bytes, the dry "
              f"run's cache_bytes on {TP_MESH} says {want}")
        launches = sv["launches"]
        check(launches["approx_add"] == 2 * SHARD_LAYERS * forwards
              and all(c == 0 for k, c in launches.items()
                      if k != "approx_add"),
              f"(d) serving, rank {r}: {launches} in {forwards} forwards, "
              f"not {2 * SHARD_LAYERS} approx_add launches a forward")
        check(sv["plain_equal"],
              f"(d) serving, rank {r}: the kernel's run differs from the "
              f"plain version's (logits, tokens or a cache tensor)")
    a, b = (res["serve"] for res in ranks)
    for label in ("haloc_axa", "exact"):
        same = [x == y for x, y in zip(a["digests"][label],
                                       b["digests"][label], strict=True)]
        check(all(same) and a["tokens"][label] == b["tokens"][label],
              f"(d) serving, {label}: the two model ranks' logits or tokens "
              f"differ (logits equal a step: {same})")
    rel = a["unsharded"]["exact"]
    check(all(np.isfinite(x) and x < LM_TOL for x in rel),
          f"(d) serving, exact: the tensor-parallel logits against the "
          f"unsharded pass's, each step {rel} (rule {LM_TOL})")


def tp_serve_log(ranks, card):
    a = ranks[0]["serve"]
    got, want, shapes = a["cache_bytes"]
    t = a["times"]
    log(f"  (d) serving {TRAIN_ARCH} at full width cut to {SHARD_LAYERS} "
        f"layers on {TP_MESH}, bf16 parameters placed by the rules: prefill "
        f"{LM_BATCH} x {LM_PROMPT} and {LM_NEW} greedy decode steps, "
        f"haloc_axa (kernel and plain) and exact ({a['seconds']:.1f} s on rank 0, "
        f"{ranks[1]['serve']['seconds']:.1f} s on rank 1): each rank's cache "
        f"{got} bytes ({shapes[0]} k and v a layer), the dry run's "
        f"cache_bytes {want}; {a['launches']['approx_add']} approx_add "
        f"launches a rank; the ranks' logits and tokens equal bit for bit at "
        f"every step; the kernel's run equals the plain version's (logits, "
        f"tokens, every cache tensor)")
    log(f"  (d) serving against rank 0's unsharded pass (teacher-forced with "
        f"the sharded tokens), max |d| / max(1, max |logit|) a step: exact "
        f"{[f'{x:.5f}' for x in a['unsharded']['exact']]} (rule {LM_TOL}), "
        f"haloc_axa {[f'{x:.5f}' for x in a['unsharded']['haloc_axa']]} "
        f"(printed, not gated: the adder turns each rounding the sums over "
        f"\"model\" move into changes of up to 2^m units)")
    log(f"  (d) serving, haloc_axa with the kernel, rank 0: prefill "
        f"{t['prefill_ms']:.3f} ms, decode {t['decode_ms']:.3f} ms a step "
        f"(wall, median of {LM_NEW}; {card}); a profiled decode step: "
        f"{t['profile']}")


def sharding_phase(torch, np, dev, counts, card):
    """Phase 4l: sharding on a one-rank DeviceMesh (the train loop on a
    (1, 1) mesh, the expert-parallel MoE), then the tensor-parallel train
    loop on two ranks (:func:`tensor_parallel_case`); returns the counted
    launches.  The one-rank process group is torn down before (d)."""
    import torch.distributed as dist
    mesh = one_rank_mesh(torch)
    total = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        a_launches, unsharded = sharded_train_case(torch, np, dev, counts,
                                                   card, mesh)
        for launches in (a_launches,
                         ep_prefill_case(torch, dev, counts, card, mesh)):
            for k, c in launches.items():
                total[k] = total.get(k, 0) + c
        log(f"  phase 4l's (a) and (b) took {time.perf_counter() - t0:.1f} s")
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    t0 = time.perf_counter()
    for k, c in tensor_parallel_case(torch, np, dev, card,
                                     unsharded).items():
        total[k] = total.get(k, 0) + c
    log(f"  phase 4l's (d) took {time.perf_counter() - t0:.1f} s")
    return total


# ------------------------------------------------------------ phase 4m --

#: Phase 4m's cells: the six examples through their ``main`` (the
#: documented entry points), on the card; the image and MAC examples also
#: at ENTRY_CPU_SIZE, against the CPU path; the train example at its full
#: default width (d_model 512, 8 layers, vocab 32768, batch 8 x 256) for
#: ENTRY_TRAIN_STEPS steps, its first ENTRY_TRAIN_CHECK against the plain
#: path; the three deprecated shims at ENTRY_SHIM_* shapes.
ENTRY_PATH_KERNELS = ("approx_add", "fft_axis", "conv2d_mac",
                      "approx_matmul", "butterfly")
ENTRY_IMAGE_SIZE, ENTRY_MAC_SIZE, ENTRY_CPU_SIZE = 512, 256, 128
ENTRY_TRAIN_STEPS, ENTRY_TRAIN_CHECK = 10, 3
ENTRY_TRAIN_TOKENS = 8 * 256
ENTRY_SERVE = ["--arch", "qwen3-4b", "--temperature", "0",
               "--new-tokens", "4"]
ENTRY_SHIM_ROWS, ENTRY_SHIM_HALF = 64, 512
ENTRY_SHIM_GEMM = 512


def same_quickstart(np, a, b):
    """Every figure of two quickstart runs equal."""
    fields = ("n_samples", "med", "mred", "nmed", "error_rate", "wce")
    return (a["add_full"] == b["add_full"] and a["hw"] == b["hw"]
            and a["error_distances"] == b["error_distances"]
            and all(tuple(getattr(x, f) for f in fields)
                    == tuple(getattr(y, f) for f in fields)
                    for x, y in zip(a["reports"], b["reports"], strict=True))
            and np.array_equal(a["residual_add"], b["residual_add"]))


def same_mac(np, a, b):
    return a["rows"] == b["rows"] and all(
        np.array_equal(a["outputs"][k], b["outputs"][k]) for k in a["outputs"])


def shim_operands(torch, np, dev):
    rng = np.random.default_rng(26)
    n16 = [torch.as_tensor(rng.integers(0, 1 << 16, (4, 256, 256)),
                           dtype=torch.int32, device=dev) for _ in range(2)]
    a8, b8 = (torch.as_tensor(rng.integers(-128, 128, (ENTRY_SHIM_GEMM,) * 2),
                              dtype=torch.int8, device=dev) for _ in range(2))
    planes = [torch.as_tensor(rng.integers(-(1 << 20), 1 << 20, (
        ENTRY_SHIM_ROWS, ENTRY_SHIM_HALF)), dtype=torch.int32, device=dev)
        for _ in range(4)]
    tw = [torch.as_tensor(rng.integers(-(1 << 14), 1 << 14, ENTRY_SHIM_HALF),
                          dtype=torch.int32, device=dev) for _ in range(2)]
    return n16, (a8, b8), planes + tw


def run_shims(torch, ops, operands, **where):
    import warnings
    from repro_torch.core.specs import paper_spec
    n16, (a8, b8), bf = operands
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (ops.approx_add(*n16, paper_spec("haloc_axa", 16, 8, 4),
                               **where),
                ops.approx_matmul(a8, b8, paper_spec("haloc_axa"), **where),
                ops.butterfly(*bf, paper_spec("haloc_axa"), **where))


def train_figures(np, hist):
    """Step ms (median of the steps after the first), tokens/s and the
    losses at steps 1 and ENTRY_TRAIN_STEPS of one adder's history."""
    ms = float(np.median([h["dt"] for h in hist[1:]])) * 1e3
    return ms, ENTRY_TRAIN_TOKENS / (ms / 1e3), hist[0]["loss"], \
        hist[-1]["loss"]


def entry_points_phase(torch, np, dev, counts, card):
    """Phase 4m: the six examples and the three deprecated shims through
    their entry points on the card, each kernel path against its plain
    path on the card bit for bit, the image, MAC and quickstart figures
    against the CPU path; returns the counted launches."""
    import shutil
    from repro_torch.examples import (adder_design_space, approx_mac,
                                      image_reconstruction, quickstart,
                                      serve_decode, train_approx_lm)
    from repro_torch.kernels import ops
    total = {name: 0 for name in ENTRY_PATH_KERNELS}
    secs = {}
    plain = ["--backend", "torch"]
    cpu = ["--device", "cpu"]

    def quiet(module, argv):
        """``module.main(argv)`` with its printout dropped (the runs that
        a counted run is compared with)."""
        with contextlib.redirect_stdout(io.StringIO()):
            return module.main(argv)

    def counted(module, kernels, argv):
        name = module.__name__.rsplit(".", 1)[-1]
        t0 = time.perf_counter()
        out, launches = run_counted(torch, counts, kernels,
                                    lambda: module.main(argv),
                                    f"entry point {name}")
        secs[name] = time.perf_counter() - t0
        for k in total:
            total[k] += launches[k]
        return out

    # quickstart: the residual add's approx_add
    q = counted(quickstart, ("approx_add",), [])
    check(same_quickstart(np, q, quiet(quickstart, plain)),
          "quickstart: the kernel path's figures differ from the plain "
          "path's on the card")
    check(same_quickstart(np, q, quiet(quickstart, cpu)),
          "quickstart: the card's figures differ from the CPU path's")
    log("  quickstart: every figure equal on the plain path and the CPU")
    # the design space (exact analytics on the card: no kernel)
    t0 = time.perf_counter()
    ds = adder_design_space.main([])
    secs["adder_design_space"] = time.perf_counter() - t0
    n_rows = sum(k <= m - 2 for m in adder_design_space.LSM_BITS
                 for k in (0, m // 4, m // 2))
    check(len(ds["rows"]) == n_rows and ds["frontier"] and all(
        np.isfinite(v) for r in ds["rows"] for v in r[2:]),
        f"adder_design_space rows: {ds['rows']}")
    # Fig 5: fft_axis
    out_dir = str(ROOT / "build" / "images_torch")
    img = counted(image_reconstruction, ("fft_axis",),
                  ["--size", str(ENTRY_IMAGE_SIZE), "--out", out_dir])
    check(img["scores"] == quiet(image_reconstruction,
        plain + ["--size", str(ENTRY_IMAGE_SIZE), "--out", out_dir])[
        "scores"], "image_reconstruction: the kernel path's PSNR/SSIM "
        "differ from the plain path's on the card")
    small = ["--size", str(ENTRY_CPU_SIZE), "--out", out_dir]
    check(quiet(image_reconstruction, small)["scores"]
          == quiet(image_reconstruction, cpu + small)["scores"],
          f"image_reconstruction at {ENTRY_CPU_SIZE}: the card differs "
          f"from the CPU path")
    log(f"  image_reconstruction: PSNR/SSIM equal on the plain path at "
        f"{ENTRY_IMAGE_SIZE} and the CPU at {ENTRY_CPU_SIZE}")
    # the MAC engine: conv2d_mac
    mac = counted(approx_mac, ("conv2d_mac",), ["--size", str(ENTRY_MAC_SIZE)])
    check(same_mac(np, mac, quiet(approx_mac,
        plain + ["--size", str(ENTRY_MAC_SIZE)])),
        "approx_mac: the kernel path's outputs differ from the plain path's")
    msmall = ["--size", str(ENTRY_CPU_SIZE)]
    check(same_mac(np, quiet(approx_mac, msmall),
                   quiet(approx_mac, cpu + msmall)),
          f"approx_mac at {ENTRY_CPU_SIZE}: the card differs from the CPU")
    log(f"  approx_mac: outputs equal on the plain path at {ENTRY_MAC_SIZE}"
        f" and the CPU at {ENTRY_CPU_SIZE}")
    # serving: approx_add in the residual stream, greedy
    srv = counted(serve_decode, ("approx_add",), ENTRY_SERVE)
    check(torch.equal(srv["tokens"], quiet(serve_decode,
        plain + ENTRY_SERVE)["tokens"]),
        "serve_decode: the kernel path's greedy tokens differ from the "
        "plain path's")
    log(f"  serve_decode: greedy tokens {tuple(srv['tokens'].shape)} equal "
        f"on the plain path")
    # training at full width, both adders
    ck = ROOT / "build" / "entry_train"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for tag, extra, steps in (("kernel", [], ENTRY_TRAIN_STEPS),
                                  ("plain", plain, ENTRY_TRAIN_CHECK)):
            d = f"{ck}_{tag}"
            for adder in ("haloc_axa", "off"):
                shutil.rmtree(f"{d}_{adder}", ignore_errors=True)
            argv = extra + ["--steps", str(steps), "--log-every", "1",
                            "--ckpt-dir", d]
            runs[tag] = counted(train_approx_lm, ("approx_add",), argv) \
                if tag == "kernel" else quiet(train_approx_lm, argv)
            for adder in ("haloc_axa", "off"):
                shutil.rmtree(f"{d}_{adder}", ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    for adder in ("haloc_axa", "off"):
        k = [h["loss"] for h in runs["kernel"][adder]["history"]]
        p = [h["loss"] for h in runs["plain"][adder]["history"]]
        check(len(k) == ENTRY_TRAIN_STEPS and k[:ENTRY_TRAIN_CHECK] == p,
              f"train_approx_lm {adder}: the kernel path's first "
              f"{ENTRY_TRAIN_CHECK} losses {k[:ENTRY_TRAIN_CHECK]} differ "
              f"from the plain path's {p}")
        ms, tok_s, l1, l10 = train_figures(
            np, runs["kernel"][adder]["history"])
        log(f"  train_approx_lm adder={adder} "
            f"({runs['kernel'][adder]['n_params']:,} parameters, batch "
            f"8 x 256): {ms:.3f} ms a step (median of steps 2-"
            f"{ENTRY_TRAIN_STEPS}), {tok_s:,.0f} tokens/s, loss "
            f"{l1:.6f} at step 1, {l10:.6f} at step {ENTRY_TRAIN_STEPS}; "
            f"first {ENTRY_TRAIN_CHECK} losses equal the plain path's "
            f"[{card}]")
    # the deprecated shims: approx_add, approx_matmul, butterfly
    operands = shim_operands(torch, np, dev)
    t0 = time.perf_counter()
    got, launches = run_counted(
        torch, counts, ("approx_add", "approx_matmul", "butterfly"),
        lambda: run_shims(torch, ops, operands), "deprecated shims")
    secs["kernels.ops shims"] = time.perf_counter() - t0
    for k in total:
        total[k] += launches[k]
    want = run_shims(torch, ops, operands, backend="torch", device=dev)
    flat = lambda r: [r[0], r[1], *r[2]]                      # noqa: E731
    check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(want),
                                                 strict=True)),
          "kernels.ops shims: the kernels differ from the plain path")
    log("  kernels.ops approx_add (4, 256, 256) n16, approx_matmul "
        f"{ENTRY_SHIM_GEMM}^3 int8, butterfly ({ENTRY_SHIM_ROWS}, "
        f"{ENTRY_SHIM_HALF}) n32: equal to the plain path")
    log("  wall seconds, each example's counted run: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    return total


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
    # phase 4k runs cuBLAS deterministically (before its first handle)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    log(f"  phase 1 took {time.perf_counter() - t_start:.1f} s")

    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"phase 2: built {len(_build.SOURCES)} kernels in {secs:.1f} s")
    report_ptxas(_build)
    log("phase 2b: phase 4k's (c) and (g) start beside phases 3-4c, which "
        "time nothing (joined before phase 4d)")
    train_bg = start_train_background(torch, dev)

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
    t_phase = time.perf_counter()
    from repro_torch.imgproc import (PIPELINES, compile_pipeline,
                                     format_table, synthetic_batch)
    batch = synthetic_batch(N_IMAGES, FULL_SIZE)
    gbatch = torch.as_tensor(batch, device=dev)
    counts = counters()
    (outs, rows), launches = run_counted(
        torch, counts, MAIN_PATH_KERNELS,
        lambda: run_main_path(torch, np, gbatch), "main path")
    t0 = time.perf_counter()
    cpu_outs, _ = run_main_path(torch, np, torch.as_tensor(batch[:1]),
                                backend="torch", device="cpu",
                                corpus=False, pair=batch[-1:])
    log(f"  CPU path (image 0): {time.perf_counter() - t0:.1f} s")
    check_outputs(torch, np, outs, cpu_outs, rows, FULL_SIZE)
    log(f"  {len(outs)} outputs equal the CPU path on image 0; tiled == "
        f"untiled")
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
    log(f"  phase 4 took {time.perf_counter() - t_phase:.1f} s")

    log("phase 4b: the Fig-5 FFT and lut path at full size")
    t_phase = time.perf_counter()
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

    log(f"  phase 4b took {time.perf_counter() - t_phase:.1f} s")

    log("phase 4c: the MAC path at full size")
    t_phase = time.perf_counter()
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

    log(f"  phase 4c took {time.perf_counter() - t_phase:.1f} s")
    finish_train_background(torch, dev, train_bg)

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

    log("phase 4g: the LM serving path at full width (Qwen3-4B)")
    t0 = time.perf_counter()
    l_launches = lm_phase(torch, np, dev, counts, card, errs)
    for name in LM_PATH_KERNELS:
        launches[name] += l_launches[name]
    log(f"  phase 4g took {time.perf_counter() - t0:.1f} s")

    log("phase 4h: MoE and MLA serving at full width (granite-moe-1b-a400m,"
        " DeepSeek-V2)")
    t0 = time.perf_counter()
    h_launches = moe_phase(torch, np, dev, counts, card, errs)
    for name in LM_PATH_KERNELS:
        launches[name] += h_launches[name]
    log(f"  phase 4h took {time.perf_counter() - t0:.1f} s")

    log("phase 4i: RG-LRU and SSD serving at full width (recurrentgemma-9b,"
        " mamba2-1.3b)")
    t0 = time.perf_counter()
    r_launches = recurrent_phase(torch, np, dev, counts, card, errs)
    for name in LM_PATH_KERNELS:
        launches[name] += r_launches[name]
    log(f"  phase 4i took {time.perf_counter() - t0:.1f} s")

    log("phase 4j: cross attention and the audio frontend at full width "
        "(llama-3.2-vision-11b, hubert-xlarge)")
    t0 = time.perf_counter()
    j_launches = vision_audio_phase(torch, np, dev, counts, card, errs)
    for name in LM_PATH_KERNELS:
        launches[name] += j_launches[name]
    log(f"  phase 4j took {time.perf_counter() - t0:.1f} s")

    log("phase 4k: training at full width (Qwen3-4B cut to "
        f"{TRAIN_LAYERS} layers, granite-moe-1b-a400m)")
    t0 = time.perf_counter()
    k_launches = train_phase(torch, np, dev, counts, card, errs)
    for name in LM_PATH_KERNELS:
        launches[name] += k_launches[name]
    log(f"  phase 4k took {time.perf_counter() - t0:.1f} s")

    log("phase 4l: sharding on a one-rank DeviceMesh (Qwen3-4B cut to "
        f"{SHARD_LAYERS} layers through the train loop, granite-moe-1b-a400m"
        f"'s expert-parallel prefill)")
    t0 = time.perf_counter()
    s_launches = sharding_phase(torch, np, dev, counts, card)
    for name in LM_PATH_KERNELS:
        launches[name] += s_launches[name]
    log(f"  phase 4l took {time.perf_counter() - t0:.1f} s")

    log("phase 4m: the entry points (the six examples and the deprecated "
        "kernel shims; train_approx_lm at its full width)")
    t0 = time.perf_counter()
    m_launches = entry_points_phase(torch, np, dev, counts, card)
    for name in ENTRY_PATH_KERNELS:
        launches[name] += m_launches[name]
    log(f"  phase 4m took {time.perf_counter() - t0:.1f} s")

    log("phase 5: times (CUDA events, median)")
    t_phase = time.perf_counter()
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
    log(f"  phases 5-5c took {time.perf_counter() - t_phase:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-cpu-half"]:
        sys.path.insert(0, str(ROOT / "src"))
        train_cpu_half()
    elif sys.argv[1:2] == ["--tp-rank"]:
        sys.path.insert(0, str(ROOT / "src"))
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
