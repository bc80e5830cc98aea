"""Tensor-parallel compute over the mesh's "model" axis (the port's
``sharding.rules.TensorParallel``, ``layers.dense_column``/``dense_row``,
the attention mixer's, the embedding's and the head and CE's
vocabulary shards) against the reference's GSPMD-partitioned functions,
on a (1, 2) ("data", "model") mesh of two gloo CPU ranks.

The reference's side runs in ``torch_mesh_reference.py`` (its ``tp12``
and padded-vocab ``grads`` cases), the port's in ``torch_mesh_workers.py``
(``job_tp12``, ``job_grads2``), made once for this file and
``test_torch_sharding.py`` (``torch_mesh_runs.py``).  Tolerances:

- on the rules' placements, the first block of qwen3-4b-smoke's SwiGLU
  MLP and attention mixer, qwen1.5-4b-smoke's attention mixer (its q/k/v
  biases column-parallel) and hubert-xlarge-smoke's whole first block
  (bidirectional attention, a GELU MLP whose output bias is added once
  after the sum over "model"; exact, and haloc_axa, whose residual add
  reads that bias sum in fp32): the output equal to the reference's
  jitted with the same shardings bit for bit on both ranks, the VJP of
  a cotangent (every parameter's gradient, gathered, and x's) within
  ``GRAD_TOL``;
- the padded-vocab variant (``vocab_pad_multiple=4``: 509 -> 512, which
  "model" divides): the vocabulary-parallel lookup bit for bit, the
  vocabulary-parallel head + CE within ``LOSS_TOL``, and the first step's
  loss (exact and haloc_axa) within ``LOSS_TOL`` of the reference's on
  the same mesh, every gradient leaf within ``GRAD_TOL``;
- gemma3-27b-smoke's first step, exact adds (a tensor-parallel MLP's
  residual sum rounded before the next norm reads it): the loss within
  ``LOSS_TOL`` of the reference's on the same mesh, every gradient leaf
  within ``GRAD_TOL``;
- a replicated leaf's gradient (the norm scales; the q/k norm scales'
  summed over "model") equal on both ranks bit for bit, and the sharded
  global norm (``adamw.torch_global_norm``) within 1e-6 of the fp64 norm
  of the gathered gradients (a "model" shard counted once).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_mesh_runs as TMR  # noqa: E402
import torch_mesh_workers as TW  # noqa: E402

GRAD_TOL, LOSS_TOL = 0.05, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TMR.mesh_runs(tmp_path_factory)


def _tp(runs):
    return TMR.load(runs["dir"], "tp12", 2), runs["ref"]["tp12"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else \
        float(np.linalg.norm(got))


def _port_leaves(tree, cfg):
    """A reference tree (a block's leaves or a whole parameter tree) as
    the port's leaves, in the port's order."""
    from repro_torch.models import weights as W
    from repro_torch.tree import leaves
    if "pattern" in tree:
        return [t.numpy() for t in leaves(W.from_reference(tree, cfg,
                                                           device="cpu"))]
    return [W.to_tensor(a, "cpu").numpy() for a in leaves(tree)]


@pytest.mark.parametrize("part", ("swiglu", "attn", "attn_bias")
                         + TW.TP_BLOCKS)
def test_block_part_equals_reference(runs, part):
    ranks, ref = _tp(runs)
    want, want_vjp = ref[part]
    cfg = get_smoke_config("qwen3-4b")
    for res in ranks:
        got, vjp = res[part]
        assert np.array_equal(got, want), \
            f"{np.mean(got != want):.4f} of elements differ"
        worst = max(_rel(g, w) for g, w in zip(
            vjp["params"], _port_leaves(want_vjp["params"], cfg),
            strict=True))
        assert worst < GRAD_TOL, worst
        assert _rel(vjp["x"], want_vjp["x"]) < GRAD_TOL


def test_vocab_parallel_lookup_equals_reference(runs):
    ranks, ref = _tp(runs)
    for res in ranks:
        assert np.array_equal(res["lookup"], ref["lookup"])


def test_vocab_parallel_cross_entropy_against_reference(runs):
    ranks, ref = _tp(runs)
    for res in ranks:
        assert abs(res["ce"] - ref["ce"]) <= LOSS_TOL * ref["ce"]


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
def test_padded_vocab_first_step_against_reference(runs, adder):
    key = ("qwen3-4b+pad4", "1x2", adder)
    want = runs["ref"]["grads"][key]
    cfg = TW.cfg_of("qwen3-4b", pad=TW.PAD)
    for res in TMR.load(runs["dir"], "grads2", 2):
        loss, _, grads = res[key]
        assert abs(loss - want["loss"]) <= LOSS_TOL * want["loss"]
        worst = max(_rel(g, w) for g, w in zip(
            grads, _port_leaves(want["grads"], cfg), strict=True))
        assert worst < GRAD_TOL, worst


def test_carried_sum_first_step_against_reference(runs):
    """gemma3-27b-smoke's first step on (1, 2), exact adds: the loss
    within LOSS_TOL of the reference's jitted step on the same mesh and
    every gradient leaf within GRAD_TOL, on both ranks (after each
    tensor-parallel MLP the next norm reads the rounded residual sum, not
    the unrounded carry; the suffix block reads the pattern's)."""
    key = (TW.CARRY_ARCH, "1x2", False)
    want = runs["ref"]["grads"][key]
    cfg = TW.cfg_of(TW.CARRY_ARCH)
    for res in TMR.load(runs["dir"], "grads2", 2):
        loss, _, grads = res[key]
        assert abs(loss - want["loss"]) <= LOSS_TOL * want["loss"]
        worst = max(_rel(g, w) for g, w in zip(
            grads, _port_leaves(want["grads"], cfg), strict=True))
        assert worst < GRAD_TOL, worst


def test_replicated_leaf_gradient_equal_on_model_ranks(runs):
    a, b = (res["replicated"] for res in _tp(runs)[0])
    assert set(a) == set(b) and any("qn" in k for k in a)
    assert all(k.endswith("scale") for k in a), sorted(a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sharded_global_norm_counts_each_shard_once(runs):
    for res in _tp(runs)[0]:
        assert res["sharded"], "no leaf sharded over model"
        got, want = res["norm"]
        assert abs(got - want) <= 1e-6 * want
