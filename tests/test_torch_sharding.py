"""The port's sharding (``repro_torch.sharding.rules``, ``launch.mesh``,
``runtime.elastic``, the sharded steps of ``launch.steps``, the train
loop and checkpoints on a mesh, ``moe.moe_apply_shard_map``) against
``repro``'s, on the CPU at the smoke sizes.

Multi-rank cases run in gloo process groups of 2 and 4 CPU ranks
spawned with ``torch.multiprocessing`` (``torch_mesh_workers.py``); the
reference's runs on host meshes larger than 1 x 1 run in a subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``torch_mesh_reference.py``).  Tolerances:

- specs: the port's equal the reference's ``resolve_spec`` on a
  ``FakeMesh`` exactly (a pattern leaf's without the stacked leading
  ``None``), every leaf of ``params_shapes``, ``state_shapes`` and
  ``cache_shapes`` of the ten configs, full and smoke, on 1 x 1, 16 x
  16, 2 x 16 x 16 and 4 x 2 meshes;
- placements: each rank's local shard on (2, 2) and (2, 2, 1) equals
  the reference's ``addressable_shards`` at its mesh coordinate, bit for
  bit;
- ``moe_apply_shard_map`` on (2, 2): the output equals the reference's
  bit for bit (both MoE smoke configs, deepseek's with shared experts),
  the aux within 1e-6;
- the (1, 2) train steps (qwen3-4b-smoke, exact and haloc_axa; compute
  over "model" tensor-parallel) on the reference's batches, each from
  the reference's state before it, against the reference's jitted with
  the same shardings: step 1's loss within 1e-6 and gradients within
  0.05; each of three steps' losses within 1e-6, grad norms within 1e-3
  and every parameter, m and v after it within 0.05, with and without
  the default clip; and each step's update against the reference's
  AdamW update of the same gradients from the same state: bit for bit
  unclipped, within 4e-6 clipped, the grad norm within 4e-7 of the
  port's own norm of those gradients unsharded and within 1e-6 of the
  reference's;
- data parallel, (2, 1) and (2, 2): losses within 1e-6 of the port's
  step unsharded over "data" (the unsharded port; on (2, 2) the port's
  (1, 2) step) and of the reference's jitted with the same shardings
  (ROADMAP Queue C 18, closed), every gradient leaf within 0.05 (0.08
  with MoE layers); the expert-parallel step on (2, 1) within 1e-4 of
  the unsharded port's loss (its bf16 partial sums round otherwise, as
  the reference's);
- the prefill and decode steps on (2, 1): the unsharded port's tokens;
- the collectives one train, prefill or decode step issues on each rank
  of (2, 2), counted at torch's collective ops: the dry run's plan,
  counts and bytes exactly (a padded-vocab train, prefill and decode
  step too); no leaf computed tensor-parallel gathered over "model";
- elastic: ``choose_mesh_shape`` equal to the reference's; a state saved
  on (2, 1) and restored on (1, 2) bit for bit; ``reshard_state`` round
  trips; the train loop on (2, 1) recovers from a ``SimulatedFault`` to
  the uninterrupted run's state, bit for bit.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import arch_names as ref_arch_names
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.optim import adamw as ref_adamw
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.runtime.elastic import choose_mesh_shape as ref_choose
from repro.sharding import rules as RR
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.elastic import choose_mesh_shape
from repro_torch.sharding import rules as R
from repro_torch.tree import leaves_with_paths

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_mesh_runs as TMR  # noqa: E402
import torch_mesh_workers as TW  # noqa: E402

GRAD_TOL, MOE_GRAD_TOL, LOSS_TOL = 0.05, 0.08, 1e-6
#: A train step's grad norm against the reference's jitted step from the
#: same state: the port's backward on the CPU is within GRAD_TOL of the
#: reference's a leaf, not bit for bit (ROADMAP Queue C 15/16), which
#: moves the norm of the (1, 2) steps by 1.2e-5 to 4.2e-4 (measured).
NORM_TOL = 1e-3
#: A train step's grad norm against the port's own norm of the same
#: gradients unsharded (``adamw.torch_global_norm``; 0 measured).
CLIP_NORM_TOL = 4e-7
#: A train step's grad norm against the reference's ``global_norm`` of
#: the same gradients, which sums each leaf in XLA:CPU's order (the port's
#: norm a shard at a time in torch's: 3.9e-7 to 6.4e-7 measured).
SAME_GRADS_NORM_TOL = 1e-6
#: A clipped update's leaves against the reference's update of the same
#: gradients (relative norm): its clip scale takes the port's norm (within
#: SAME_GRADS_NORM_TOL of the reference's) and ``v`` reads it squared
#: (1.1e-6 measured).  Unclipped, the update is the reference's bit for bit.
CLIP_TOL = 4e-6
#: The expert-parallel step's loss against the unsharded port's.
EP_LOSS_TOL = 1e-4


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


# --------------------------------------------------------------- rules --

def _ref_tree(arch, size, tree):
    cfg = (ref_config if size == "full" else ref_smoke)(arch)
    if tree == "params":
        return ref_steps.params_shapes(cfg)
    if tree == "state":
        return ref_steps.state_shapes(cfg, RefAdamWConfig())
    return ref_steps.cache_shapes(cfg, 32, 128)


def _port_tree(arch, size, tree):
    cfg = (get_config if size == "full" else get_smoke_config)(arch)
    if tree == "params":
        return steps.params_shapes(cfg)
    if tree == "state":
        return steps.state_shapes(cfg, AdamWConfig())
    return steps.cache_shapes(cfg, 32, 128)


def _ref_specs(tree, mesh, rules):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        logical = RR._match(RR.path_names(path), rules)
        spec = () if logical is None else tuple(
            RR.resolve_spec(leaf.shape, logical, mesh))
        out[jax.tree_util.keystr(path)] = (
            tuple(leaf.shape), spec + (None,) * (leaf.ndim - len(spec)))
    return out


def _port_specs(tree, mesh, kind):
    if kind == "state":
        return R.state_shardings(tree, mesh)
    if kind == "cache":
        return R.cache_shardings(tree, mesh)
    return R.tree_shardings(tree, mesh, R.PARAM_RULES)


@pytest.mark.parametrize("tree", ("params", "state", "cache"))
@pytest.mark.parametrize("size", ("full", "smoke"))
@pytest.mark.parametrize("arch", ref_arch_names())
def test_specs_equal_reference(arch, size, tree):
    ref = _ref_tree(arch, size, tree)
    port = _port_tree(arch, size, tree)
    rules = RR.CACHE_RULES if tree == "cache" else RR.PARAM_RULES
    for name, (shape, axes) in MESHES.items():
        want = _ref_specs(ref, FakeMesh(shape, axes), rules)
        mesh = R.MeshShape(axes, shape)
        got = R.spec_leaves(_port_specs(port, mesh, tree))
        flat = list(leaves_with_paths(port))
        assert len(got) == len(flat)
        seen = set()
        for (path, leaf), spec in zip(flat, got):
            key, rep = TW.ref_key(path)
            rshape, rspec = want[key]
            seen.add(key)
            if rep is not None:   # the reference's stacked leaf
                rshape, rspec = rshape[1:], rspec[1:]
            assert tuple(leaf.shape) == rshape, (name, key)
            assert spec == rspec, (name, key, spec, rspec)
        assert seen == set(want), (name, set(want) - seen)


def test_resolve_spec_drops_nondivisible_and_reused_axes():
    mesh = R.MeshShape(("data", "model"), (16, 16))
    assert R.resolve_spec((20 * 128, 49155), ("tp", "tp"), mesh) \
        == ("model", None)
    assert R.resolve_spec((49155, 2560), ("tp", "fsdp"), mesh) \
        == (None, "data")


def test_batch_axes_data_sharding_and_placements():
    mesh = R.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert R.batch_axes(mesh) == ("pod", "data")
    batch = {"tokens": np.zeros((64, 8), np.int32),
             "odd": np.zeros((3, 8), np.int32),
             "pos": np.zeros((), np.int32)}
    specs = R.data_sharding(batch, mesh)
    assert specs == {"tokens": (("pod", "data"), None), "odd": (None, None),
                     "pos": ()}
    assert R.shard_factor(specs["tokens"], mesh) == 32

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")

    from torch.distributed.tensor import Replicate, Shard
    assert R.placements((("pod", "data"), "model"), Mesh3()) \
        == [Shard(0), Shard(0), Shard(1)]
    assert R.placements((None,), Mesh3()) == [Replicate()] * 3


def test_production_meshes_are_abstract_without_a_process_group():
    assert M.make_production_mesh() == R.MeshShape(("data", "model"),
                                                   (16, 16))
    assert M.make_production_mesh(multi_pod=True).size == 512
    assert M.make_host_mesh(2, 1).shape == {"data": 2, "model": 1}


# ------------------------------------------------------------- elastic --

@pytest.mark.parametrize("mp", (1, 2, 4, 8, 16))
def test_choose_mesh_shape_equals_reference(mp):
    assert choose_mesh_shape(256, 16) == ref_choose(256, 16) == (16, 16)
    assert choose_mesh_shape(512, 16, pod_size=256) == (2, 16, 16)
    for pod in (None, 0, 8, 64, 256):
        for n in range(1, 601):
            try:
                want = ref_choose(n, mp, pod_size=pod)
            except ValueError:
                with pytest.raises(ValueError):
                    choose_mesh_shape(n, mp, pod_size=pod)
                continue
            assert choose_mesh_shape(n, mp, pod_size=pod) == want, (n, pod)


# ------------------------------------------------------- the rank runs --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's host-mesh runs (a subprocess), the port's ranks
    (2 and 4 gloo ranks) and the unsharded port's counterparts, side by
    side (``torch_mesh_runs.mesh_runs``: made once a test run)."""
    return TMR.mesh_runs(tmp_path_factory)


def test_placements_equal_reference_shards(runs):
    for r, res in enumerate(TMR.load(runs["dir"], "placements", 4)):
        for case, (equal, total, first) in res.items():
            assert equal == total and first is None, (r, case, first)


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m",
                                  "deepseek-v2-236b"))
def test_moe_shard_map_equals_reference(runs, arch):
    want = runs["ref"]["moe"][arch]
    rows = {}
    for res in TMR.load(runs["dir"], "moe", 4):
        r, y, aux = res[arch]
        rows.setdefault(r, []).append(y)
        assert abs(aux - want["aux"]) <= LOSS_TOL * abs(want["aux"])
    for parts in rows.values():   # the model ranks hold one output
        assert np.array_equal(parts[0], parts[1])
    got = np.concatenate([rows[0][0], rows[1][0]])
    assert np.array_equal(got, want["out"]), \
        f"{np.mean(got != want['out']):.4f} of elements differ"


def _first_steps(runs, adder, clip):
    """The (1, 2) steps of both ranks and the reference's jitted ones."""
    res = TMR.load(runs["dir"], "steps12", 2)
    return res[0][(adder, clip)], res[1][(adder, clip)], \
        runs["ref"]["steps12"][(adder, clip)]


def _state_leaves(tree):
    """The reference's train state as the port's full leaves, in the
    port's order."""
    from repro_torch.models import weights as W
    from repro_torch.tree import leaves
    return leaves(W.state_from_reference(tree, get_smoke_config("qwen3-4b"),
                                         device="cpu"))


def _as_reference(like, grads):
    """The port's full gradients (its parameters' leaf order) in the
    layout of the reference's parameter tree ``like``: a pattern leaf's
    repeats stacked."""
    from repro_torch.models import weights as W
    paths = [p for p, _ in leaves_with_paths(W.from_reference(
        like, get_smoke_config("qwen3-4b"), device="cpu"))]
    flat = {jax.tree_util.keystr(p): np.array(v, copy=True)
            for p, v in jax.tree_util.tree_leaves_with_path(like)}
    for path, g in zip(paths, grads, strict=True):
        key, rep = TW.ref_key(path)
        if rep is None:
            flat[key] = g.numpy()
        else:
            flat[key][rep] = g.numpy()
    return jax.tree_util.tree_map_with_path(
        lambda p, _: flat[jax.tree_util.keystr(p)], like)


def _reference_update(clip, before, grads):
    """The reference's jitted AdamW update of its train state ``before``
    with the port's full gradients: (the state after it as the port's
    leaves, the grad norm it took)."""
    cfg = RefAdamWConfig(warmup_steps=2, total_steps=10, clip_norm=clip)
    j = jax.tree.map(jax.numpy.asarray, before)
    params, opt, met = jax.jit(lambda g, o, p: ref_adamw.update(
        cfg, g, o, p))(_as_reference(before["params"], grads), j["opt"],
                       j["params"])
    after = {"params": params, "opt": opt, "step": j["step"] + 1}
    return _state_leaves(jax.tree.map(np.asarray, after)), \
        float(met["grad_norm"])


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
def test_one_by_two_first_step_against_reference(runs, adder):
    """Tensor-parallel compute: the (1, 2) step's first loss within
    LOSS_TOL of the reference's jitted step on the same mesh (not of the
    unsharded step: ROADMAP Queue C 18), every gradient leaf within
    GRAD_TOL, on both ranks."""
    a, b, want = _first_steps(runs, adder, 1e9)
    first = want["first"]
    for rows, _, grads in (a, b):
        assert abs(rows[0][0] - first["loss"]) <= LOSS_TOL * first["loss"]
        worst = max(_rel(g.numpy(), w) for g, w in zip(
            grads[0], _port_order(first["grads"], "qwen3-4b"), strict=True))
        assert worst < GRAD_TOL, worst


def _steps_against_reference(runs, adder, clip):
    """Each of the three (1, 2) steps, from the reference's state before
    it, against the reference's jitted step: the loss within LOSS_TOL,
    the grad norm within NORM_TOL, every parameter, m and v after it
    within GRAD_TOL.  And, so that an update missing or misapplied on a
    shard fails, against the update of the step's own gradients from the
    same state: the grad norm within CLIP_NORM_TOL of the port's norm of
    them unsharded and within SAME_GRADS_NORM_TOL of the reference's;
    every leaf after it the reference's AdamW update's bit for bit
    (within CLIP_TOL when clipped), the counters equal.  The model
    ranks' figures are equal bit for bit."""
    from repro_torch.models import weights as W
    from repro_torch.tree import unflatten
    (rows, states, grads), (rows1, states1, grads1), want = \
        _first_steps(runs, adder, clip)
    assert rows == rows1
    for one, other in ((states, states1), (grads, grads1)):
        assert all(torch.equal(x, y) for s, t in zip(one, other, strict=True)
                   for x, y in zip(s, t, strict=True))
    befores = [want["start"]] + want["states"][:-1]
    for step, ((loss, gn), (rloss, rgn), after, g, before, ref_after) in \
            enumerate(zip(rows, want["rows"], states, grads, befores,
                          want["states"], strict=True)):
        assert abs(loss - rloss) <= LOSS_TOL * rloss, step
        assert abs(gn - rgn) <= NORM_TOL * rgn, (step, gn, rgn)
        own = float(port_adamw.torch_global_norm(unflatten(
            W.from_reference(before["params"], get_smoke_config("qwen3-4b"),
                             device="cpu"), g)))
        assert abs(gn - own) <= CLIP_NORM_TOL * own, (step, gn, own)
        updated, norm = _reference_update(clip, before, g)
        assert abs(gn - norm) <= SAME_GRADS_NORM_TOL * norm, (step, gn, norm)
        worst = 0.0
        for x, y, z in zip(after, updated, _state_leaves(ref_after),
                           strict=True):
            if not x.is_floating_point():
                assert torch.equal(x, y) and torch.equal(x, z), step
                continue
            if clip > norm:
                assert torch.equal(x, y), step
            else:
                assert _rel(x.numpy(), y.numpy()) <= CLIP_TOL, step
            worst = max(worst, _rel(x.numpy(), z.numpy()))
        assert worst < GRAD_TOL, (step, worst)


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
def test_one_by_two_steps_unclipped_against_reference(runs, adder):
    _steps_against_reference(runs, adder, 1e9)


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
def test_one_by_two_steps_clipped_against_reference(runs, adder):
    """As the unclipped steps, with the default clip (each step's grad
    norm above 1, so that the clip scales every update)."""
    _, _, want = _first_steps(runs, adder, 1.0)
    assert all(gn > 1 for _, gn in want["rows"])
    _steps_against_reference(runs, adder, 1.0)


def _dp(runs, arch, mesh, shard_map):
    job, world = ("grads4", 4) if mesh == "2x2" else ("grads2", 2)
    return TMR.load(runs["dir"], job, world)[0][(arch, mesh, shard_map)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else \
        float(np.linalg.norm(got))


DP_CASES = [("qwen3-4b", "2x1", False), ("qwen3-4b", "2x2", False),
            ("granite-moe-1b-a400m", "2x1", False),
            ("granite-moe-1b-a400m", "2x2", False),
            ("granite-moe-1b-a400m", "2x2", True)]


@pytest.mark.parametrize("arch,mesh,shard_map", DP_CASES)
def test_data_parallel_against_unsharded_port(runs, arch, mesh, shard_map):
    """The data-parallel step against the port's step unsharded over
    "data": the unsharded port on (2, 1); on (2, 2), whose compute over
    "model" is tensor-parallel, the port's (1, 2) step (the same
    expert-parallel MoE)."""
    loss, aux, grads = _dp(runs, arch, mesh, shard_map)
    if mesh == "2x1":
        closs, caux, cgrads = runs["cpu"]["grads"][arch]
        tol = EP_LOSS_TOL if shard_map else LOSS_TOL
    else:
        closs, caux, cgrads = TMR.load(runs["dir"], "grads2", 2)[0][
            (arch, "1x2", shard_map)]
        tol = LOSS_TOL
    assert abs(loss - closs) <= tol * closs
    gtol = MOE_GRAD_TOL if "granite" in arch else GRAD_TOL
    worst = max(_rel(g, c) for g, c in zip(grads, cgrads, strict=True))
    assert worst < gtol, worst


@pytest.mark.parametrize("arch,mesh,shard_map", DP_CASES)
def test_data_parallel_loss_against_reference(runs, arch, mesh, shard_map):
    loss, aux, _ = _dp(runs, arch, mesh, shard_map)
    want = runs["ref"]["grads"][(arch, mesh, shard_map)]
    assert abs(loss - want["loss"]) <= LOSS_TOL * want["loss"]
    assert abs(aux - want["aux"]) <= LOSS_TOL * max(want["aux"], 1.0)


@pytest.mark.parametrize("arch,mesh,shard_map", DP_CASES)
def test_data_parallel_grads_against_reference(runs, arch, mesh, shard_map):
    _, _, grads = _dp(runs, arch, mesh, shard_map)
    want = _port_order(runs["ref"]["grads"][(arch, mesh, shard_map)]
                       ["grads"], arch)
    gtol = MOE_GRAD_TOL if "granite" in arch else GRAD_TOL
    worst = max(_rel(g, w) for g, w in zip(grads, want, strict=True))
    assert worst < gtol, worst


def _port_order(grads, arch):
    """The reference's gradient tree as the port's leaves, in the port's
    order (the pattern unstacked repeat by repeat)."""
    from repro_torch.models import weights as W
    tree = W.from_reference(grads, get_smoke_config(arch), device="cpu")
    return [t.numpy() for _, t in leaves_with_paths(tree)]


@pytest.mark.parametrize("arch,ep,kind,pad", [
    pytest.param(*c, id="-".join(map(str, c[:3] if c[3] == 1 else c)))
    for c in TW.COLLECTIVE_CASES])
def test_collectives_equal_the_dry_runs_plan(runs, arch, ep, kind, pad):
    """What one step issues on each rank of the (2, 2) mesh, counted at
    torch's collective ops: the dry run's ``collective_plan`` for the
    same config, mesh and batch, counts and result bytes exactly, and no
    other collective.  No leaf the step computes tensor-parallel is
    gathered over "model": in training every all-gather is a leaf's over
    "data"; at prefill and decode so is every one but the logits' (over
    the batch axes, and over "model" where the head is vocabulary-parallel)."""
    from repro_torch.launch.dryrun import collective_plan, tensor_parallel_plan
    cfg = TW.cfg_of(arch, shard_map=ep, pad=pad)
    mesh = M.make_host_mesh(2, 2)
    shapes = steps.params_shapes(cfg)
    rows, seq = TW.case_batch(cfg.vocab_size)["tokens"].shape
    tokens = torch.empty((rows, 1 if kind == "decode" else seq),
                         device="meta")
    want = collective_plan(cfg, kind, mesh, shapes,
                           R.tree_shardings(shapes, mesh, R.PARAM_RULES),
                           {"tokens": tokens},
                           TW.COLLECTIVE_CTX if kind == "decode" else seq)
    for r, res in enumerate(TMR.load(runs["dir"], "collectives", 4)):
        got, other = res[(arch, ep, kind, pad)]
        assert got == want and not other, (r, got, want, other)
    specs = R.tree_shardings(shapes, mesh, R.PARAM_RULES)
    over_data = sum("data" in [a for e in sp for a in R._axes(e)]
                    for sp in R.spec_leaves(specs))
    roles, *_, tp_head = tensor_parallel_plan(cfg, shapes, specs, mesh)
    assert "shard" in roles
    if kind == "train":
        # every all-gather is a leaf's over "data"; none over "model"
        assert want["all-gather"]["count"] == over_data
    elif arch == "qwen3-4b":
        # the leaves' over "data", then the logits'
        assert want["all-gather"]["count"] == over_data + 1 + tp_head


def test_prefill_and_decode_on_two_ranks_give_unsharded_tokens(runs):
    for res in TMR.load(runs["dir"], "serve21", 2):
        assert np.array_equal(res["tokens"], runs["cpu"]["tokens"])


def test_save_on_two_by_one_restores_on_one_by_two(runs):
    for res in TMR.load(runs["dir"], "elastic", 2):
        assert res["restore_on"] == [(1, 2)]
        assert all(res["restore_equal"]) and res["restore_equal"]


def test_reshard_state_round_trips(runs):
    for res in TMR.load(runs["dir"], "elastic", 2):
        assert all(res["reshard_equal"]) and all(res["reshard_local"])


def test_train_loop_on_a_mesh_recovers_from_a_fault(runs):
    for res in TMR.load(runs["dir"], "fault", 2):
        assert res["failures"] == 1 and res["step"] == 4
        assert [loss for s, loss in res["faulted"] if s != 2] \
            == [res["whole"][s] for s in (0, 1, 3)]
        assert all(res["equal"])
