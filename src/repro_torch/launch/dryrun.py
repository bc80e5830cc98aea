"""The dry run on the meta device: does a cell fit, and what does its
sharded step move (the port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-4b --shape train_4k --mesh multi

For one (arch, shape) cell on the reference's production meshes
(``single``: (16, 16) ("data", "model"); ``multi``: (2, 16, 16) ("pod",
"data", "model")) it builds the step's inputs on the meta device (no
allocation), places them with the sharding rules on the abstract mesh
(no 256 or 512 ranks are needed) and writes a record:

- ``params_total``, ``params_active`` (the reference's
  ``count_params``/``active_param_count``), ``model_flops`` (6 or 2 x
  active parameters x tokens), ``tokens``, ``seq``, ``devices``;
- ``memory``: the per-device bytes of the parameters, the optimizer
  state, the cache and the batch under the rules' placements, and
  ``argument_size_in_bytes``, their sum over the step's arguments (the
  reference's compiled ``memory_analysis`` field of that name).  The
  cache is counted as a port rank holds it (:func:`cache_bytes`): a
  mixer computed gathered over "model" (cross attention, RG-LRU, SSD)
  keeps its cache whole there, where the reference's ``CACHE_RULES``
  split it; a decode record also gives that ``CACHE_RULES`` figure,
  ``cache_rules_bytes``;
- ``collectives``: the port's own plan, the all-gathers, reduce-scatters
  and all-reduces its sharded step issues, each with its count and the
  bytes of its results on one device (:func:`collective_plan`).

The reference's HLO FLOP and collective figures (``launch/hlo_cost.py``)
have no counterpart: torch produces no HLO.  Cells run in this process
(there is no device count to isolate), in a few seconds all.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict

from repro_torch.models import transformer as T
from repro_torch.models.moe import EXPERT_LEAVES
from repro_torch.sharding import rules as R
from repro_torch.tree import leaves_with_paths

COLLECTIVES = ("all-gather", "reduce-scatter", "all-reduce")


def count_params(tree) -> int:
    return sum(t.numel() for _, t in leaves_with_paths(tree))


def active_param_count(cfg, params_tree) -> int:
    """Total params minus the inactive expert fraction (MoE), by the
    reference's rule: a leaf under ``mlp`` and ``wi``/``wg``/``wo`` with
    at least three dims in the reference's stacked layout (a pattern
    leaf has one more there) counts ``(1 - k / E)`` of its size, rounded
    down per stacked leaf."""
    total = count_params(params_tree)
    if cfg.moe is None:
        return total
    frac = 1.0 - cfg.moe.experts_per_token / cfg.moe.num_experts
    stacked: Dict[tuple, list] = {}
    for path, leaf in leaves_with_paths(params_tree):
        names = R.path_names(path)
        pattern = path[0] == "pattern"
        if "mlp" in names and any(n in ("wi", "wg", "wo") for n in names) \
                and leaf.ndim + pattern >= 3:
            # one reference leaf: the pattern position and the path in
            # the block, the repeat index dropped
            key = (path[:2] + path[3:]) if pattern else path
            stacked.setdefault(key, []).append(leaf.numel())
    return total - sum(int(float(sum(n)) * frac) for n in stacked.values())


def _spec_axes(spec):
    return [a for entry in spec for a in R._axes(entry)]


def _plan_add(plan, op, nbytes, count=1):
    rec = plan[op]
    rec["count"] += count
    rec["bytes"] += nbytes * count


def gather_plan(plan, leaf, spec, mesh, times=1, keep=()):
    """A leaf's gather into its full tensor (or, over the mesh dims in
    ``keep``, its shard): one all-gather a sharded mesh dim, the last
    mesh dim first, each result the leaf's shard times the dims gathered
    so far."""
    sizes = R.mesh_shape(mesh)
    size = R.shard_bytes(leaf, spec, mesh)
    for a in reversed([a for a in sizes if a in _spec_axes(spec)
                       and a not in keep]):
        if sizes[a] > 1:
            size *= sizes[a]
            _plan_add(plan, "all-gather", size, times)


def grad_plan(plan, leaf, spec, mesh, batch, times=1, keep=()):
    """A leaf's gradient summed over the batch axes and cut to its
    placement: a reduce-scatter on a batch dim the leaf is sharded on
    (its result the shard over that dim and those in ``keep``), an
    all-reduce on one it is replicated on."""
    sizes = R.mesh_shape(mesh)
    nbytes = leaf.numel() * leaf.element_size()
    for a in keep:
        if a in _spec_axes(spec):
            nbytes //= sizes[a]
    for a in batch:
        if sizes[a] == 1:
            continue
        if a in _spec_axes(spec):
            nbytes //= sizes[a]
            _plan_add(plan, "reduce-scatter", nbytes, times)
        else:
            _plan_add(plan, "all-reduce", nbytes, times)


def tensor_parallel_blocks(cfg, params, specs, mesh):
    """Each block's (mixer, MLP) flags, in block order: whether it
    computes tensor-parallel over "model" on ``mesh`` with its leaves
    placed by ``specs`` (all False at model = 1): the steps' choice,
    :func:`repro_torch.models.transformer.tensor_parallel_parts`, read
    from the specs instead of the DTensors' placements."""
    from repro_torch.tree import unflatten
    m = R.mesh_shape(mesh).get("model", 1)
    if m == 1:
        return [(False, False)] * len(cfg.all_blocks())
    sharded = unflatten(params, ["model" in _spec_axes(s)
                                 for s in R.spec_leaves(specs)])
    return [T.tensor_parallel_parts(cfg, spec, flags, m)
            for spec, flags in zip(cfg.all_blocks(),
                                   T.blocks_in_order(cfg, sharded),
                                   strict=True)]


def tensor_parallel_plan(cfg, params, specs, mesh):
    """What a step computes tensor-parallel over "model" (none at model
    = 1; the same blocks in the train, prefill and decode steps): (each
    leaf's role in :func:`repro_torch.tree.leaves` order -- "shard" for
    a leaf kept on its "model" shard, "partial" for a replicated one
    whose gradient each "model" rank holds a part of (the q/k norm scales
    of a tensor-parallel mixer), else None --, the number of
    tensor-parallel mixers, of SwiGLU MLPs, of GELU MLPs, whether the
    embedding and whether the head (and in training the CE) are
    vocabulary-parallel).  The blocks: :func:`tensor_parallel_blocks`."""
    from repro_torch.models.config import SWIGLU
    from repro_torch.tree import leaves, unflatten
    flat = R.spec_leaves(specs)
    roles = unflatten(params, [None] * len(flat))
    if R.mesh_shape(mesh).get("model", 1) == 1:
        return leaves(roles), 0, 0, 0, False, False
    sharded = unflatten(params, ["model" in _spec_axes(s) for s in flat])
    n_attn = n_swiglu = n_gelu = 0
    for spec, flags, role, (attn, mlp) in zip(
            cfg.all_blocks(), T.blocks_in_order(cfg, sharded),
            T.blocks_in_order(cfg, roles),
            tensor_parallel_blocks(cfg, params, specs, mesh)):
        parts = [("mixer", attn), ("mlp", mlp)]
        for part, on in parts:
            if not on:
                continue
            for name, sub in role[part].items():
                for leaf in sub:
                    sub[leaf] = "shard" if flags[part][name][leaf] else \
                        "partial" if name in T.MODEL_PARTIAL_LEAVES else None
        n_attn += attn
        n_swiglu += mlp and spec.mlp == SWIGLU
        n_gelu += mlp and spec.mlp != SWIGLU
    vocab = {}
    for name, leaf in (("embed", "table"), ("lm_head", "w")):
        vocab[name] = name in sharded and sharded[name][leaf]
        if vocab[name]:
            roles[name][leaf] = "shard"
    return (leaves(roles), n_attn, n_swiglu, n_gelu, vocab.get("embed"),
            vocab.get("lm_head"))


def serving_head(cfg, specs, mesh) -> str:
    """How the sharded prefill and decode steps compute the head with its
    leaves placed by ``specs`` on ``mesh`` (the choice of
    :func:`repro_torch.models.transformer._serving_head`, from the specs):
    "columns" where the rules shard its vocabulary over "model" (each
    rank's logits gathered in bf16), "rows" where
    :func:`repro_torch.models.transformer.head_rows_split` (fp32 partials
    summed over "model"), else "whole"."""
    w = specs["lm_head"]["w"]
    m = R.mesh_shape(mesh).get("model", 1)
    if m > 1 and "model" in _spec_axes(w[1:]):
        return "columns"
    if m > 1 and T.head_rows_split(cfg.d_model, R.shard_factor(w[:1], mesh),
                                   m):
        return "rows"
    return "whole"


def collective_plan(cfg, kind, mesh, params, specs, batch_specs, seq,
                    microbatches=1) -> dict:
    """The collectives of one step of the port's sharded path, per
    device: the parameters' gathers (each microbatch; the expert-parallel
    MoE's expert matrices and the tensor-parallel leaves over the mesh
    dims but "model" only), in training the gradients' reductions and
    AdamW's norm, the loss's mean, the MoE layers' load-balancing sums
    and expert-parallel all-reduces, the tensor-parallel compute's sums
    over "model" (:func:`tensor_parallel_plan`), and at prefill and
    decode the head's logits made whole over "model" (a vocabulary-parallel
    head's bf16 columns gathered; a row-parallel one's partials summed
    in fp32, :func:`repro_torch.models.transformer.head_rows_split`) and
    gathered over the batch axes.  ``tests/test_torch_sharding.py``
    counts what the step issues on a (2, 2) mesh of gloo ranks against
    it."""
    sizes = R.mesh_shape(mesh)
    ba = R.batch_axes(mesh) or ()
    rows = next(iter(batch_specs.values())).shape[0]
    split = rows % R.batch_size(mesh, ba) == 0
    shards = R.batch_size(mesh, ba) if split else 1
    axes = ba if split and shards > 1 else ()
    local_rows = rows // shards
    plan = {op: {"count": 0, "bytes": 0} for op in COLLECTIVES}
    m = sizes.get("model", 1)
    mc = cfg.moe
    ep = (mc is not None and mc.use_shard_map and kind != "decode"
          and seq > 1 and split and bool(ba) and "model" in sizes
          and mc.num_experts % m == 0)
    roles, n_attn, n_swiglu, n_gelu, tp_embed, tp_head = \
        tensor_parallel_plan(cfg, params, specs, mesh)
    flat = [(t, spec, ("model",) if role == "shard" or (
                 ep and path[-2] == "mlp" and path[-1] in EXPERT_LEAVES)
             else (), role)
            for (path, t), spec, role in zip(leaves_with_paths(params),
                                             R.spec_leaves(specs), roles)]
    times = microbatches if kind == "train" else 1
    for leaf, spec, keep, _ in flat:
        gather_plan(plan, leaf, spec, mesh, times, keep)
    if kind == "train":
        for leaf, spec, keep, role in flat:
            grad_plan(plan, leaf, spec, mesh, axes, times, keep)
            if role == "partial":   # each model rank's heads' part
                _plan_add(plan, "all-reduce",
                          leaf.numel() * leaf.element_size(), times)
        # the tensor-parallel sums over "model", in fp32: each mixer's
        # row-parallel output and its q, k and v inputs' cotangents; each
        # MLP's output and its column-parallel inputs' cotangents; the
        # embedding's lookup; the head's input cotangent and the CE's max
        # and (sum of exponentials, gold logit), again in the head's
        # recompute
        rows_s = local_rows // microbatches * seq
        act = rows_s * cfg.d_model * 4
        n_act = 4 * n_attn + 3 * n_swiglu + 2 * n_gelu + tp_embed + tp_head
        _plan_add(plan, "all-reduce", act, n_act * times)
        if tp_head:
            _plan_add(plan, "all-reduce", rows_s * 4, 2 * times)
            _plan_add(plan, "all-reduce", 2 * rows_s * 4, 2 * times)
        for a in sizes:   # AdamW's global norm
            if sizes[a] > 1 and any(a in _spec_axes(f[1]) for f in flat):
                _plan_add(plan, "all-reduce", 4 * len(flat))
        if axes:   # the loss, ce and aux's means
            _plan_add(plan, "all-reduce", 12 * len(axes), times)
    else:
        # the tensor-parallel sums over "model", in fp32: each mixer's and
        # MLP's row-parallel output and the embedding's lookup; the head's
        # logits (the last position's where the model is causal) made
        # whole over "model"
        s = 1 if kind == "decode" else seq
        positions = 1 if cfg.causal else s
        _plan_add(plan, "all-reduce", local_rows * s * cfg.d_model * 4,
                  n_attn + n_swiglu + n_gelu + tp_embed)
        logits = local_rows * positions * cfg.padded_vocab
        head = serving_head(cfg, specs, mesh)
        if head == "columns":
            _plan_add(plan, "all-gather", logits * 2)
        elif head == "rows":
            _plan_add(plan, "all-reduce", logits * 4)
    moe_blocks = sum(s.mlp == "moe" for s in cfg.all_blocks())
    if moe_blocks:
        s = 1 if kind == "decode" else seq
        chunks = mc.seq_chunks if s > 1 and mc.seq_chunks > 1 \
            and s % mc.seq_chunks == 0 else 1
        e4 = mc.num_experts * 4
        if kind == "decode" and axes:
            for a in axes:   # the batch's rows gathered for one dispatch
                _plan_add(plan, "all-gather", rows * cfg.d_model * 2,
                          moe_blocks)
        elif axes:
            # the aux: the mean probabilities and the counts (and the
            # probabilities' cotangent in training), each chunk
            n = (3 if kind == "train" else 2) * chunks * moe_blocks * times
            for a in axes:
                _plan_add(plan, "all-reduce", e4, n)
        if ep and m > 1:
            act = local_rows // (microbatches if kind == "train" else 1) \
                * s * cfg.d_model * 2
            _plan_add(plan, "all-reduce", act, moe_blocks * times)
            if kind == "train":   # x's and the router's cotangents
                _plan_add(plan, "all-reduce", act, moe_blocks * times)
                _plan_add(plan, "all-reduce", cfg.d_model * e4,
                          moe_blocks * times)
    if kind != "train" and axes:
        positions = 1 if cfg.causal else seq
        for a in reversed(axes):
            _plan_add(plan, "all-gather",
                      rows * positions * cfg.padded_vocab * 2)
    return plan


def cache_bytes(cfg, rows: int, ctx_len: int, mesh,
                rules: bool = False) -> int:
    """Per-device bytes of the cache of ``rows`` sequences of up to
    ``ctx_len`` positions on ``mesh``, as a rank of the port's sharded
    prefill and decode steps holds it
    (:func:`repro_torch.models.transformer.cache_shardings`): a
    tensor-parallel self-attention block's ``k``/``v`` over its rows and
    KV/m heads, every other mixer's cache over its rows only, whole over
    "model" (its compute is gathered there; the blocks from
    :func:`tensor_parallel_blocks` on the rules' parameter placement).
    ``rules``: placed by ``CACHE_RULES`` alone instead, "model" kept on
    every leaf the axis divides (what the reference's sharded step
    holds)."""
    from repro_torch.launch.steps import cache_shapes, params_shapes
    c_shapes = cache_shapes(cfg, rows, ctx_len)
    if rules:
        return R.tree_shard_bytes(c_shapes, R.cache_shardings(c_shapes,
                                                              mesh), mesh)
    p_shapes = params_shapes(cfg)
    attn = [a for a, _ in tensor_parallel_blocks(
        cfg, p_shapes, R.tree_shardings(p_shapes, mesh, R.PARAM_RULES),
        mesh)]
    return R.tree_shard_bytes(
        c_shapes, T.cache_shardings(c_shapes, cfg, mesh, attn), mesh)


def state_bytes(cfg, mesh) -> int:
    """Per-device bytes of the train state (parameters, m, v, count and
    step) placed by ``state_shardings`` on ``mesh``."""
    from repro_torch.launch.steps import state_shapes
    from repro_torch.optim.adamw import AdamWConfig
    st = state_shapes(cfg, AdamWConfig())
    return R.tree_shard_bytes(st, R.state_shardings(st, mesh), mesh)


def _config(arch, approx, vocab_pad, moe_shardmap):
    """The cell's config with the options that change its record: the
    vocabulary's padding (the embedding's and head's shapes) and the
    expert-parallel MoE (its collectives).  The reference's options that
    change only its HLO (``seq_shard``, ``fast_emul``, ``attn_kv_chunk``,
    MLA's absorbed decode) have no counterpart here."""
    from repro_torch.configs import get_config
    from repro_torch.numerics.approx_ops import make_numerics
    cfg = get_config(arch)
    if approx != "off":
        cfg = cfg.with_approx(make_numerics(approx, "residual",
                                            backend="torch", device="cpu"))
    if vocab_pad > 1:
        cfg = dataclasses.replace(cfg, vocab_pad_multiple=vocab_pad)
    if moe_shardmap and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, use_shard_map=True))
    return cfg


def run_cell(arch: str, shape: str, mesh_kind: str, approx: str,
             out_dir: str, variant: str = "", vocab_pad: int = 1,
             microbatches: int = 1, moe_shardmap: bool = False) -> dict:
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch.input_specs import batch_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import params_shapes, state_shapes
    from repro_torch.optim.adamw import AdamWConfig

    t0 = time.time()
    cfg = _config(arch, approx, vocab_pad, moe_shardmap)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    kind, specs, seq = batch_specs(cfg, shape)
    p_shapes = params_shapes(cfg)
    p_specs = R.tree_shardings(p_shapes, mesh, R.PARAM_RULES)
    b_bytes = R.tree_shard_bytes(specs, R.data_sharding(specs, mesh), mesh)
    mem = {"params_bytes": R.tree_shard_bytes(p_shapes, p_specs, mesh),
           "opt_bytes": 0, "cache_bytes": 0, "batch_bytes": b_bytes}
    if kind == "train":
        st = state_shapes(cfg, AdamWConfig())
        mem["opt_bytes"] = R.tree_shard_bytes(
            st["opt"], R.state_shardings(st, mesh)["opt"], mesh)
        mem["state_bytes"] = state_bytes(cfg, mesh)
        mem["argument_size_in_bytes"] = mem["state_bytes"] + b_bytes
    else:
        args = mem["params_bytes"] + b_bytes
        if kind == "decode":
            rows = specs["tokens"].shape[0]
            mem["cache_bytes"] = cache_bytes(cfg, rows, seq, mesh)
            mem["cache_rules_bytes"] = cache_bytes(cfg, rows, seq, mesh,
                                                   rules=True)
            pos = torch.empty((), dtype=torch.int32, device="meta")
            args += mem["cache_bytes"] + pos.element_size()
        mem["argument_size_in_bytes"] = args
    plan = collective_plan(cfg, kind, mesh, p_shapes, p_specs, specs, seq,
                           microbatches)

    n_total = count_params(p_shapes)
    n_active = active_param_count(cfg, p_shapes)
    seqlen, gbatch, _ = SHAPES[shape]
    tokens = gbatch * (1 if kind == "decode" else seqlen)
    model_flops = (6 if kind == "train" else 2) * n_active * tokens
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "kind": kind,
        "approx": approx, "variant": variant,
        "devices": int(math.prod(R.mesh_shape(mesh).values())),
        "seq": seq, "tokens": tokens,
        "params_total": n_total, "params_active": n_active,
        "model_flops": float(model_flops),
        "memory": mem, "collectives": plan,
        "dryrun_s": time.time() - t0,
    }
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{mesh_kind}__{approx}" + (
        f"__{variant}" if variant else "")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh")}
                     | {"argument_size_in_bytes":
                        mem["argument_size_in_bytes"]}))
    return rec


def orchestrate(args) -> int:
    """Every cell of ``configs.cells()`` (filtered by ``--archs``/
    ``--shapes``) on every mesh of ``--meshes``, in this process; a
    failing cell writes ``<tag>.ERROR.json`` and the sweep goes on."""
    from repro_torch.configs import cells
    todo = [(a, s) for a, s in cells()
            if (not args.archs or a in args.archs.split(","))
            and (not args.shapes or s in args.shapes.split(","))]
    results = []
    for mesh_kind in args.meshes.split(","):
        for arch, shape in todo:
            tag = f"{arch}__{shape}__{mesh_kind}__{args.approx}"
            path = os.path.join(args.out, tag + ".json")
            if args.resume and os.path.exists(path):
                print(f"[skip existing] {tag}")
                continue
            t0 = time.time()
            try:
                run_cell(arch, shape, mesh_kind, args.approx, args.out)
                ok = True
            except Exception:
                ok = False
                err = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "approx": args.approx,
                       "error": traceback.format_exc()[-4000:]}
                with open(os.path.join(args.out, tag + ".ERROR.json"),
                          "w") as f:
                    json.dump(err, f, indent=1)
                print(err["error"], flush=True)
            results.append((tag, ok))
            print(f"[{'ok' if ok else 'FAIL'}] {tag} "
                  f"({time.time() - t0:.2f}s)", flush=True)
    good = sum(1 for _, ok in results if ok)
    print(f"dry-run sweep: {good}/{len(results)} cells succeeded")
    return 0 if good == len(results) else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--approx", default="haloc_axa")
    ap.add_argument("--out", default="experiments/artifacts_torch")
    ap.add_argument("--variant", default="", help="artifact tag suffix")
    ap.add_argument("--vocab-pad", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-shardmap", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        return orchestrate(args)
    try:
        run_cell(args.arch, args.shape, args.mesh, args.approx, args.out,
                 variant=args.variant, vocab_pad=args.vocab_pad,
                 microbatches=args.microbatches,
                 moe_shardmap=args.moe_shardmap)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
