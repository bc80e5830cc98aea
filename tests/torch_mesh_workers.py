"""The port's ranks for ``test_torch_sharding.py``: gloo process groups
of CPU ranks spawned with ``torch.multiprocessing``, each running the
jobs named at its start and saving what it found to ``OUT/<job>.<rank>.pt``
(``torch.save``), which the test reads.  Nothing here imports jax or
``repro``: the reference's inputs come in as a pickle of numpy arrays
(``torch_mesh_reference.py``'s ``.inputs``).
"""

import dataclasses
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

#: qwen3-4b-smoke's three-step cases on the (1, 2) mesh: (adder, clip).
STEP_CASES = (("off", 1e9), ("haloc_axa", 1e9), ("off", 1.0),
              ("haloc_axa", 1.0))
#: ``torch_mesh_reference``'s tensor-parallel whole-block cases (arch,
#: adder) and its attention mixer with q/k/v biases.
TP_BLOCKS = (("hubert-xlarge", "off"), ("hubert-xlarge", "haloc_axa"))
TP_BIAS_ARCH = "qwen1.5-4b"
#: ``torch_mesh_reference.CARRY_ARCH``: the first step on (1, 2) whose
#: exact adds' carry is rounded after a tensor-parallel MLP.
CARRY_ARCH = "gemma3-27b"
#: The prefill/decode case: prompt length, decode steps, context.
PROMPT, NEW, CTX = 12, 4, 16
#: ``torch_mesh_reference``'s serving cases: (arch, mesh, adder, vocab
#: padding multiple, decode steps), each prefilling SERVE_ROWS x
#: SERVE_PROMPT tokens (frames) into a cache of SERVE_CTX positions.
SERVE_CASES = (("qwen3-4b", "1x2", "off", 1, 4),
               ("qwen3-4b", "1x2", "haloc_axa", 1, 4),
               ("qwen3-4b", "2x2", "off", 1, 4),
               ("qwen3-4b", "2x2", "haloc_axa", 1, 4),
               ("qwen3-4b", "1x2", "off", 4, 4),
               ("qwen1.5-4b", "1x2", "off", 1, 4),
               ("gemma3-27b", "1x2", "off", 1, 4),
               ("gemma3-27b", "1x2", "haloc_axa", 1, 4),
               ("hubert-xlarge", "1x2", "off", 1, 0),
               ("granite-moe-1b-a400m", "2x2", "off", 1, 0))
SERVE_ROWS, SERVE_PROMPT, SERVE_CTX = 4, 32, 40
SERVE_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
#: ``torch_mesh_reference.FULL_CASES``: the serving cases whose
#: full-sequence forward is also compared.
FULL_CASES = (("gemma3-27b", "1x2", "off", 1),)
#: The configs whose caches the serving steps hold whole over "model"
#: (mixers computed gathered there) where ``CACHE_RULES`` would split
#: them, served on (1, 2) by ``job_cache12``: the RG-LRU (and one KV
#: head), the SSD, MLA, cross attention.
GATHERED_CACHE_ARCHS = ("recurrentgemma-9b", "mamba2-1.3b",
                        "deepseek-v2-236b", "llama-3.2-vision-11b")


def start(jobs, world, out_dir, ref_path):
    """The ranks of ``jobs`` (a tuple of names), started and not joined:
    ``torch.multiprocessing``'s context (``join()`` it)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp
    return mp.start_processes(_rank_main, args=(world, port, jobs, out_dir,
                                                ref_path),
                              nprocs=world, join=False,
                              start_method="spawn")


def _rank_main(rank, world, port, jobs, out_dir, ref_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    ref = None
    try:
        for job in jobs:
            if job in NEEDS_REF and ref is None:
                ref = _published(ref_path)
            if job in NEEDS_RESULTS and "results" not in ref:
                # the reference's results, beside its inputs
                ref["results"] = _published(str(ref_path)[:-len(".inputs")])
            t0 = time.perf_counter()
            out = JOBS[job](ref) if job in NEEDS_REF else JOBS[job]()
            out["seconds"] = time.perf_counter() - t0
            torch.save(out, os.path.join(out_dir, f"{job}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- helpers --

#: How long a rank waits for the reference to publish a pickle.
PUBLISH_TIMEOUT = 1200


def _published(path, timeout=PUBLISH_TIMEOUT):
    """The pickle at ``path`` once the reference has published it (with
    a rename); raises after ``timeout`` seconds without it (the rank
    then exits non-zero)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"the reference published no {path} in "
                               f"{timeout} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def cfg_of(arch, adder="off", shard_map=False, pad=1):
    """A smoke config: ``adder``'s residual adds (on the CPU), the
    expert-parallel MoE, the vocabulary padded to a multiple of ``pad``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.numerics.approx_ops import make_numerics
    cfg = get_smoke_config(arch)
    if pad > 1:
        cfg = dataclasses.replace(cfg, vocab_pad_multiple=pad)
    if adder != "off":
        cfg = cfg.with_approx(make_numerics(adder, "residual",
                                            backend="torch", device="cpu"))
    if shard_map:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, use_shard_map=True))
    return cfg


def mesh_of(shape, axes=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def full_leaves(tree):
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    return [R.full_tensor(t).detach().clone() for t in leaves(tree)]


def ref_key(path):
    """The reference's ``keystr`` of a port state path (the repeat index
    of a pattern leaf dropped) and that index (None elsewhere)."""
    keys, rep = [], None
    skip = None
    for i, k in enumerate(path):
        if k == "pattern":
            skip = i + 2
        if i == skip:
            rep = k
            continue
        keys.append(f"[{k}]" if isinstance(k, int) else f"['{k}']")
    return "".join(keys), rep


def case_batch(vocab, b=4, s=32, seed=7):
    """``torch_mesh_reference.case_batch``'s inputs."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def serve_inputs(cfg, seed=13):
    """``torch_mesh_reference.serve_inputs``: the prompt's ``tokens`` (or
    ``frames``) and the teacher-forced ``decode`` tokens."""
    rng = np.random.default_rng(seed)
    shape = (SERVE_ROWS, SERVE_PROMPT)
    out = {"decode": rng.integers(0, cfg.vocab_size, (SERVE_ROWS, 4)).astype(
        np.int32)}
    if cfg.audio is not None:
        out["frames"] = rng.standard_normal(
            shape + (cfg.audio.feat_dim,)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, shape).astype(
            np.int32)
    return out


def first_moe_mlp(params, cfg):
    """``torch_mesh_reference.first_moe_mlp``: the first MoE block's MLP
    (repeat 0) of the reference's stacked tree."""
    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[0]

    i = next(j for j, s in enumerate(cfg.pattern) if s.mlp == "moe")
    return first(params["pattern"][i]["mlp"])


def port_params(ref_params, cfg):
    from repro_torch.models import weights as W
    return W.from_reference(ref_params, cfg, device="cpu")


# ---------------------------------------------------------------- jobs --

def job_placements(ref):
    """Each rank's local shard of every state leaf on the (2, 2) and
    (2, 2, 1) meshes against the reference's shard at the same mesh
    coordinate: {(arch, mesh): (leaves equal, leaves, first differing)}."""
    from repro_torch.models import weights as W
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves_with_paths
    meshes = {"2x2": ((2, 2), ("data", "model")),
              "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
    out = {}
    for arch in ("qwen3-4b", "granite-moe-1b-a400m"):
        cfg = cfg_of(arch)
        full = W.state_from_reference(ref["shards"][(arch, "full")], cfg,
                                      device="cpu")
        for name, (shape, axes) in meshes.items():
            mesh = mesh_of(shape, axes)
            placed = R.place_state(full, mesh)
            want = ref["shards"][(arch, name)]
            c = tuple(mesh.get_coordinate())
            equal, total, first = 0, 0, None
            for path, t in leaves_with_paths(placed):
                key, rep = ref_key(path)
                shard = np.asarray(want[key][c])
                if rep is not None:
                    shard = shard[rep]
                got = R.local(t).numpy()
                ok = got.shape == shard.shape and got.dtype == shard.dtype \
                    and got.tobytes() == shard.tobytes()
                equal += ok
                total += 1
                if not ok and first is None:
                    first = (key, rep, got.shape, shard.shape)
            out[(arch, name)] = (equal, total, first)
    return out


def job_moe(ref):
    """``moe_apply_shard_map`` on the (2, 2) mesh for both MoE smoke
    configs: this rank's rows of the output and the aux."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import weights as W
    from repro_torch.tree import tree_map
    mesh = mesh_of((2, 2))
    out = {}
    for arch in ("granite-moe-1b-a400m", "deepseek-v2-236b"):
        cfg = cfg_of(arch, shard_map=True)
        p = tree_map(lambda a: W.to_tensor(a, "cpu"),
                     first_moe_mlp(ref["params"][arch], cfg))
        x = torch.from_numpy(np.array(ref["moe_x"][arch])).to(torch.bfloat16)
        rows = x.shape[0] // 2
        r = mesh.get_local_rank("data")
        with torch.no_grad():
            y, aux = MOE.moe_apply_shard_map(
                p, cfg, x[r * rows:(r + 1) * rows], batch_axes=("data",),
                mesh=mesh)
        out[arch] = (r, y.float().numpy(), float(aux))
    return out


def _grads(ref, arch, shape, shard_map=False, adder="off", pad=1):
    from repro_torch.launch import steps
    from repro_torch.sharding import rules as R
    cfg = cfg_of(arch, adder, shard_map, pad)
    mesh = mesh_of(shape)
    params = port_params(ref["pad_params"] if pad > 1 else
                         ref["params"][arch], cfg)
    placed = R.place(params, R.tree_shardings(params, mesh, R.PARAM_RULES),
                     mesh)
    batch, axes = steps.split_batch(case_batch(cfg.vocab_size), mesh,
                                    R.batch_axes(mesh))
    (loss, parts), grads = steps.value_and_grad(placed, cfg, batch, axes,
                                                mesh)
    return float(loss), float(parts["aux"]), \
        [g.numpy() for g in full_leaves(grads)]


def job_grads4(ref):
    """Losses and gradients on the (2, 2) mesh: both configs, granite
    also with the expert-parallel MoE."""
    return {("qwen3-4b", "2x2", False): _grads(ref, "qwen3-4b", (2, 2)),
            ("granite-moe-1b-a400m", "2x2", False):
                _grads(ref, "granite-moe-1b-a400m", (2, 2)),
            ("granite-moe-1b-a400m", "2x2", True):
                _grads(ref, "granite-moe-1b-a400m", (2, 2), True)}


#: The padded-vocab variant's multiple (qwen3-4b-smoke's 509 -> 512).
PAD = 4


def job_grads2(ref):
    """Losses and gradients on the (2, 1) mesh, both configs; on the
    (1, 2) mesh the (2, 2) cases' runs unsharded over "data" (granite
    also with the expert-parallel MoE), the padded-vocab variant of
    qwen3-4b-smoke, exact and haloc_axa, and CARRY_ARCH, exact."""
    out = {(arch, "2x1", False): _grads(ref, arch, (2, 1))
           for arch in ("qwen3-4b", "granite-moe-1b-a400m")}
    for arch, ep in (("qwen3-4b", False), ("granite-moe-1b-a400m", False),
                     ("granite-moe-1b-a400m", True)):
        out[(arch, "1x2", ep)] = _grads(ref, arch, (1, 2), ep)
    for adder in ("off", "haloc_axa"):
        out[("qwen3-4b+pad4", "1x2", adder)] = _grads(
            ref, "qwen3-4b", (1, 2), adder=adder, pad=PAD)
    out[(CARRY_ARCH, "1x2", False)] = _grads(ref, CARRY_ARCH, (1, 2))
    return out


def job_steps12(ref):
    """qwen3-4b-smoke's STEP_CASES on the (1, 2) mesh on the reference's
    batches, each step from the reference's state before it (its seed-1
    state, then the states its jitted steps reach, published with its
    results): {case: ([(loss, grad_norm)], [each step's full state
    leaves after it], [each step's full gradients, as its update read
    them])}."""
    from repro_torch.launch import steps
    from repro_torch.models import weights as W
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules as R
    want = ref["results"]["steps12"]
    mesh = mesh_of((1, 2))
    out = {}
    for adder, clip in STEP_CASES:
        cfg = cfg_of("qwen3-4b", adder)
        opt = AdamWConfig(warmup_steps=2, total_steps=10, clip_norm=clip)
        starts = [ref["shards"][("qwen3-4b", "full")]] + \
            want[(adder, clip)]["states"][:-1]
        rows, states, grads = [], [], []

        def keep(g):
            grads.append(full_leaves(g))
            return g

        fn = steps.make_train_step(cfg, opt, batch_axes=R.batch_axes(mesh),
                                   grad_transform=keep, mesh=mesh)
        for start, b in zip(starts, ref["step_batches"], strict=True):
            state = R.place_state(
                W.state_from_reference(start, cfg, device="cpu"), mesh)
            state, met = fn(state, b)
            rows.append((float(met["loss"]), float(met["grad_norm"])))
            states.append(full_leaves(state))
        out[(adder, clip)] = (rows, states, grads)
    return out


def job_tp12(ref):
    """The tensor-parallel pieces on the (1, 2) mesh, each on its rules'
    placements (a block's leaves under their block paths, as the step
    holds them): qwen3-4b-smoke's first SwiGLU MLP and attention mixer,
    qwen1.5-4b-smoke's attention mixer (q/k/v biases) and the whole first
    block of hubert-xlarge-smoke (``TP_BLOCKS``) (output, and the
    gradients of a cotangent for the parameters, gathered, and x), the
    padded variant's vocabulary-parallel lookup
    and head + CE; then the first step on the reference's state: the
    replicated leaves' gradients as this rank holds them, and the global
    norm of the sharded gradients beside the fp64 norm of the gathered
    ones."""
    from repro_torch.launch import steps
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves, leaves_with_paths, unflatten
    mesh = mesh_of((1, 2))
    tp = R.tensor_parallel(mesh)
    cfg = cfg_of("qwen3-4b")
    params = port_params(ref["params"]["qwen3-4b"], cfg)
    block = params["pattern"][0][0]
    inp = {k: torch.from_numpy(np.array(v)) for k, v in ref["tp"].items()}
    x = inp["x"].to(torch.bfloat16)
    g = inp["g"].to(torch.bfloat16)
    positions = torch.arange(x.shape[1], dtype=torch.int32)

    def placed(tree):
        return R.place(tree, R.tree_shardings(tree, mesh, R.PARAM_RULES),
                       mesh)

    def run(tree, fn):
        tree = placed(tree)
        flat = [t.detach().requires_grad_(True) for t in leaves(tree)]
        xr = x.clone().requires_grad_(True)
        y = fn(unflatten(tree, flat), xr)
        grads = torch.autograd.grad(y, flat + [xr], g)
        return (y.detach().float().numpy(),
                {"params": [R.full_tensor(t).numpy() for t in grads[:-1]],
                 "x": grads[-1].float().numpy()})

    def attn(c, mixer):
        return run({"mixer": mixer}, lambda b, xr: ATT.attn_apply(
            {k: T._local(v, (), ("model",) if k in T.MODEL_PARTIAL_LEAVES
                         else ())
             for k, v in b["mixer"].items()}, c, c.pattern[0], xr,
            positions, tp=tp))

    def whole_block(c, blk):
        """The block as the train step runs it: its leaves for
        tensor-parallel compute (``transformer._block_gathered``)."""
        spec = c.pattern[0]

        def fn(b, xr):
            tps = T.block_tensor_parallel(b, c, spec, mesh)
            assert None not in tps, "the block is not tensor-parallel"
            return T.block_apply(
                T._block_gathered(b, c, spec, xr.shape[1], "full", (), mesh,
                                  tps), c, spec, xr,
                {"positions": positions}, None, "full", (), mesh,
                tp=tps)[0]

        return run(blk, fn)

    out = {
        "swiglu": run({"mlp": block["mlp"]}, lambda b, xr: L.swiglu(
            T._local(b["mlp"], ()), xr, tp)),
        "attn": attn(cfg, block["mixer"]),
    }
    bcfg = cfg_of(TP_BIAS_ARCH)
    out["attn_bias"] = attn(bcfg, port_params(
        ref["params"][TP_BIAS_ARCH], bcfg)["pattern"][0][0]["mixer"])
    for arch, adder in TP_BLOCKS:
        bcfg = cfg_of(arch, adder)
        out[(arch, adder)] = whole_block(bcfg, port_params(
            ref["params"][arch], bcfg)["pattern"][0][0])
    pcfg = cfg_of("qwen3-4b", pad=PAD)
    pparams = port_params(ref["pad_params"], pcfg)
    with torch.no_grad():
        emb = placed({"embed": pparams["embed"]})
        out["lookup"] = T.embed_input(
            {"embed": T._local(emb["embed"], ())}, pcfg,
            {"tokens": inp["tokens"]}, tp=tp)[0].float().numpy()
        head = placed({"lm_head": pparams["lm_head"]})
        out["ce"] = float(T._head_loss(pcfg, T._local(head["lm_head"], ()),
                                       x, inp["labels"], tp))
    state = placed(pparams)
    batch, axes = steps.split_batch(case_batch(pcfg.vocab_size), mesh,
                                    R.batch_axes(mesh))
    _, grads = steps.value_and_grad(state, pcfg, batch, axes, mesh)
    out["replicated"] = {
        ".".join(map(str, path)): R.local(t).detach().clone()
        for path, t in leaves_with_paths(grads)
        if R.is_dtensor(t) and R.model_dim(t) is None}
    out["sharded"] = sorted(".".join(map(str, path)) for path, t in
                            leaves_with_paths(grads) if R.model_dim(t) is not
                            None)
    full = [R.full_tensor(t).double() for t in leaves(grads)]
    out["norm"] = (float(adamw.torch_global_norm(grads)),
                   float(torch.sqrt(sum((t * t).sum() for t in full))))
    return out


def job_serve21():
    """Greedy tokens of the prefill and decode steps on the (2, 1) mesh
    (qwen3-4b-smoke, haloc_axa, seed-1 parameters placed by the rules)."""
    return {"tokens": serve_tokens(mesh_of((2, 1)))}


def serve_tokens(mesh):
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    cfg = cfg_of("qwen3-4b", "haloc_axa")
    params = T.init_params(1, cfg, device="cpu", dtype=torch.bfloat16)
    ba = None
    if mesh is not None:
        params = R.place(params, R.tree_shardings(params, mesh,
                                                  R.PARAM_RULES), mesh)
        ba = R.batch_axes(mesh)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (4, PROMPT)).astype(np.int64)
    prefill = steps.make_prefill_step(cfg, CTX, batch_axes=ba, mesh=mesh)
    decode = steps.make_decode_step(cfg, batch_axes=ba, mesh=mesh)
    toks = []
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": torch.from_numpy(prompt)})
        for i in range(NEW):
            nxt = logits[:, -1].float().argmax(-1)[:, None]
            toks.append(nxt)
            logits, cache = decode(params, {"tokens": nxt}, PROMPT + i,
                                   cache)
    return torch.cat(toks, dim=1).numpy()


def serve_case(ref, arch, mesh_name, adder, pad, new):
    """One serving case on its gloo mesh: the prefill and decode steps on
    the reference's seed-1 parameters placed by the rules and
    ``serve_inputs`` (the teacher-forced tokens); {"logits": [the
    prefill's, each decode step's] as float32 numpy, "prefill_cache" and
    "cache": this rank's cache leaves after the prefill and after the last
    decode step (``leaves`` order, numpy copies), "slices": each cache
    leaf's (start, stop) a dim in the whole cache, as ``CACHE_RULES``
    places it (:func:`local_slices`: the batch axes' rows and the "model"
    rank's KV heads; every case's cache is its attention's), "bytes":
    (the bytes this rank's cache holds, the dry run's ``cache_bytes``)};
    for FULL_CASES also "full": ``forward(mode="full")``'s logits (the
    whole batch's)."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    cfg = cfg_of(arch, adder, pad=pad)
    mesh = mesh_of(SERVE_MESHES[mesh_name])
    params = port_params(ref["pad_params"] if pad > 1 else
                         ref["params"][arch], cfg)
    placed = R.place(params, R.tree_shardings(params, mesh, R.PARAM_RULES),
                     mesh)
    inp = serve_inputs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inp.items() if k != "decode"}
    ba = R.batch_axes(mesh)
    prefill = steps.make_prefill_step(cfg, SERVE_CTX, batch_axes=ba,
                                      mesh=mesh)
    decode = steps.make_decode_step(cfg, batch_axes=ba, mesh=mesh)

    def snapshot(cache):
        return [t.clone().numpy() if t.dtype != torch.bfloat16 else
                t.float().numpy() for t in leaves(cache)]

    with torch.no_grad():
        logits, cache = prefill(placed, batch)
        out = {"logits": [logits.float().numpy()],
               "prefill_cache": snapshot(cache)}
        toks = torch.from_numpy(inp["decode"])
        for i in range(new):
            logits, cache = decode(placed, {"tokens": toks[:, i:i + 1]},
                                   SERVE_PROMPT + i, cache)
            out["logits"].append(logits.float().numpy())
    out["cache"] = snapshot(cache)
    if (arch, mesh_name, adder, pad) in FULL_CASES:
        local, axes = steps.split_batch(batch, mesh, ba)
        with torch.no_grad():
            full = T.forward(placed, cfg, local, mode="full",
                             batch_axes=axes, mesh=mesh)[0]
        out["full"] = (full if axes is None else R.gather_rows(
            full, mesh, axes)).float().numpy()
    whole = steps.cache_shapes(cfg, SERVE_ROWS, SERVE_CTX)
    specs = R.spec_leaves(R.cache_shardings(whole, mesh))
    out["slices"] = [[(sl.start, sl.stop) for sl in local_slices(
        t.shape, sp, mesh)] for t, sp in zip(leaves(whole), specs,
                                             strict=True)]
    out["bytes"] = (sum(t.nbytes for t in leaves(cache)),
                    dryrun.cache_bytes(cfg, SERVE_ROWS, SERVE_CTX, mesh))
    return out


def local_slices(shape, spec, mesh):
    """This rank's slice of each dim of a leaf of ``shape`` placed by
    ``spec`` on a ``DeviceMesh``: a dim on several axes cut by the major
    one first, as ``rules.local_shard`` cuts it."""
    from repro_torch.sharding import rules as R
    sizes = R.mesh_shape(mesh)
    out = []
    for n, entry in zip(shape, spec):
        axes = R._axes(entry)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        step = n // int(np.prod([sizes[a] for a in axes]))
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def job_cache12():
    """GATHERED_CACHE_ARCHS served on (1, 2): seed-1 parameters placed by
    the rules, a prefill of SERVE_ROWS x 8 tokens (and a vision model's
    embeddings) into a cache of 12 positions, then one decode step:
    {arch: {"held": (this rank's cache bytes after the prefill, after
    the decode step), "dryrun": the dry run's ``cache_bytes``, "rules":
    its ``CACHE_RULES`` figure, "shapes": each cache leaf's local shape
    after the decode step, "whole": its shape in the whole cache}}."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    mesh = mesh_of((1, 2))
    ba = R.batch_axes(mesh)
    rng = np.random.default_rng(17)
    prompt, ctx = 8, 12
    out = {}
    for arch in GATHERED_CACHE_ARCHS:
        cfg = cfg_of(arch)
        params = T.init_params(1, cfg, device="cpu", dtype=torch.bfloat16)
        placed = R.place(params, R.tree_shardings(params, mesh,
                                                  R.PARAM_RULES), mesh)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (SERVE_ROWS, prompt)).astype(np.int32))}
        if cfg.vision is not None:
            batch["vision"] = torch.from_numpy(rng.standard_normal(
                (SERVE_ROWS, cfg.vision.seq_len, cfg.vision.embed_dim)
            ).astype(np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            logits, cache = steps.make_prefill_step(
                cfg, ctx, batch_axes=ba, mesh=mesh)(placed, batch)
            held = [sum(t.nbytes for t in leaves(cache))]
            nxt = logits[:, -1].float().argmax(-1)[:, None].to(torch.int32)
            _, cache = steps.make_decode_step(cfg, batch_axes=ba, mesh=mesh)(
                placed, {"tokens": nxt}, prompt, cache)
            held.append(sum(t.nbytes for t in leaves(cache)))
        out[arch] = {
            "held": tuple(held),
            "dryrun": dryrun.cache_bytes(cfg, SERVE_ROWS, ctx, mesh),
            "rules": dryrun.cache_bytes(cfg, SERVE_ROWS, ctx, mesh,
                                        rules=True),
            "shapes": [tuple(t.shape) for t in leaves(cache)],
            "whole": [tuple(t.shape) for t in leaves(steps.cache_shapes(
                cfg, SERVE_ROWS, ctx))]}
    return out


def job_serve12(ref):
    """The (1, 2) SERVE_CASES (:func:`serve_case`) by case."""
    return {c[:4]: serve_case(ref, *c) for c in SERVE_CASES
            if c[1] == "1x2"}


def job_serve22(ref):
    """The (2, 2) SERVE_CASES (:func:`serve_case`) by case."""
    return {c[:4]: serve_case(ref, *c) for c in SERVE_CASES
            if c[1] == "2x2"}


#: The collectives counted against the dry run's plan, on (2, 2): (arch,
#: expert-parallel MoE, step kind, vocabulary padding multiple); the
#: batch is ``case_batch``'s 4 x 32.
COLLECTIVE_CASES = (("qwen3-4b", False, "train", 1),
                    ("qwen3-4b", False, "prefill", 1),
                    ("qwen3-4b", False, "decode", 1),
                    ("granite-moe-1b-a400m", True, "train", 1),
                    ("granite-moe-1b-a400m", True, "prefill", 1),
                    ("qwen3-4b", False, "train", PAD),
                    ("qwen3-4b", False, "prefill", PAD),
                    ("qwen3-4b", False, "decode", PAD))
#: The context of the counted prefill and decode steps.
COLLECTIVE_CTX = 48
#: torch's collective ops (the functional ones DTensor issues and the
#: c10d ones of ``torch.distributed``'s calls) by the dry run's names.
COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                  "_allgather_base_": "all-gather",
                  "allgather_": "all-gather",
                  "reduce_scatter_tensor": "reduce-scatter",
                  "_reduce_scatter_base_": "reduce-scatter",
                  "reduce_scatter_": "reduce-scatter",
                  "all_reduce": "all-reduce", "allreduce_": "all-reduce"}


def counting_mode():
    """A dispatch mode that counts every collective op run under it, with
    the bytes of its result, as the dry run's plan does; other c10d ops
    but the waits and autograd wrappers are kept by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.plan = {op: {"count": 0, "bytes": 0}
                         for op in ("all-gather", "reduce-scatter",
                                    "all-reduce")}
            self.other = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace in ("_c10d_functional", "c10d"):
                name = func._schema.name.split("::")[1]
                if name in COLLECTIVE_OPS:
                    res = out
                    while isinstance(res, (list, tuple)):
                        res = res[0]
                    rec = self.plan[COLLECTIVE_OPS[name]]
                    rec["count"] += 1
                    rec["bytes"] += res.numel() * res.element_size()
                elif name not in ("wait_tensor", "_wrap_tensor_autograd"):
                    self.other.append(name)
            return out

    return Count()


def job_collectives():
    """The collectives one train, prefill or decode step issues on the
    (2, 2) mesh (COLLECTIVE_CASES; seed-1 fp32 parameters, the dry run's
    dtype), counted on this rank: {case: (plan, other ops)}."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules as R
    mesh = mesh_of((2, 2))
    ba = R.batch_axes(mesh)
    out = {}
    for arch, ep, kind, pad in COLLECTIVE_CASES:
        cfg = cfg_of(arch, shard_map=ep, pad=pad)
        batch = case_batch(cfg.vocab_size)
        count = counting_mode()
        if kind == "train":
            opt = AdamWConfig()
            state = R.place_state(steps.init_state(1, cfg, opt,
                                                   device="cpu"), mesh)
            step = steps.make_train_step(cfg, opt, batch_axes=ba, mesh=mesh)
            with count:
                step(state, batch)
        else:
            p = T.init_params(1, cfg, device="cpu")
            p = R.place(p, R.tree_shardings(p, mesh, R.PARAM_RULES), mesh)
            tokens = torch.from_numpy(batch["tokens"]).long()
            prefill = steps.make_prefill_step(cfg, COLLECTIVE_CTX,
                                              batch_axes=ba, mesh=mesh)
            with torch.no_grad():
                if kind == "prefill":
                    with count:
                        prefill(p, {"tokens": tokens})
                else:
                    _, cache = prefill(p, {"tokens": tokens})
                    decode = steps.make_decode_step(cfg, batch_axes=ba,
                                                    mesh=mesh)
                    with count:
                        decode(p, {"tokens": tokens[:, :1]},
                               tokens.shape[1], cache)
        out[(arch, ep, kind, pad)] = (count.plan, count.other)
    return out


def job_elastic():
    """A placed qwen3-4b-smoke state saved on the (2, 1) mesh and
    restored on (1, 2); ``reshard_state`` (2, 1) -> (1, 2) -> (2, 1)."""
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules as R
    from repro_torch.tree import leaves
    cfg = cfg_of("qwen3-4b")
    opt = AdamWConfig()
    full = steps.init_state(1, cfg, opt, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():   # m and v nonzero, so that a swap would show
        for t in leaves(full["opt"]):
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=gen))
    want = full_leaves(full)
    a, b = mesh_of((2, 1)), mesh_of((1, 2))
    placed = R.place_state(full, a)
    tmp = tempfile.mkdtemp() if dist.get_rank() == 0 else None
    box = [tmp]
    dist.broadcast_object_list(box, src=0)
    ckpt = Checkpointer(box[0])
    ckpt.save(5, placed)
    R.barrier(a)
    like = steps.state_shapes(cfg, opt)
    restored = ckpt.restore(like, shardings=R.placed_state_specs(like, b),
                            mesh=b)
    got = full_leaves(restored)
    back = reshard_state(reshard_state(placed, b), a)
    return {"restore_equal": [torch.equal(x, y) for x, y in zip(got, want)],
            "restore_on": [tuple(t.device_mesh.shape)
                           for t in leaves(restored) if R.is_dtensor(t)][:1],
            "reshard_equal": [torch.equal(x, y) for x, y in
                              zip(full_leaves(back), want)],
            "reshard_local": [torch.equal(R.local(x), R.local(y)) for x, y in
                              zip(leaves(back), leaves(placed))]}


def job_fault():
    """The train loop on the (2, 1) mesh: 4 steps with a checkpoint
    every 2 and a ``SimulatedFault`` at step 3, against the same loop
    uninterrupted."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (SimulatedFault,
                                                TrainLoopConfig, run)
    cfg = cfg_of("qwen3-4b", "haloc_axa")
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=4)
    data = DataConfig(seq_len=32, global_batch=2, seed=3)
    mesh = mesh_of((2, 1))
    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise SimulatedFault("lost a host")

    def loop(ckpt_dir, fault_hook=None):
        return run(cfg, opt, data, TrainLoopConfig(
            total_steps=4, ckpt_every=2, log_every=1, ckpt_dir=ckpt_dir),
            mesh=mesh, fault_hook=fault_hook)

    whole = loop(None)
    faulted = loop(box[0], hook)
    return {"whole": [h["loss"] for h in whole["history"]],
            "faulted": [(h["step"], h["loss"]) for h in faulted["history"]],
            "failures": faulted["failures"],
            "step": int(faulted["state"]["step"]),
            "equal": [torch.equal(x, y) for x, y in
                      zip(full_leaves(whole["state"]),
                          full_leaves(faulted["state"]))]}


JOBS = {"placements": job_placements, "moe": job_moe, "grads4": job_grads4,
        "grads2": job_grads2, "steps12": job_steps12, "tp12": job_tp12,
        "serve21": job_serve21, "elastic": job_elastic, "fault": job_fault,
        "collectives": job_collectives, "serve12": job_serve12,
        "serve22": job_serve22, "cache12": job_cache12}
NEEDS_REF = ("placements", "moe", "grads4", "grads2", "steps12", "tp12",
             "serve12", "serve22")
#: The jobs that also read the reference's results (its states).
NEEDS_RESULTS = ("steps12",)
