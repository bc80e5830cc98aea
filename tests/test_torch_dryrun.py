"""The port's dry run (``repro_torch.launch.dryrun``,
``launch.input_specs``) against ``repro``'s counts and placements, on the
meta device.

``python -m repro_torch.launch.dryrun --all`` runs in a subprocess (every
cell of ``configs.cells()`` on the ``single`` and ``multi`` meshes); for
each record:

- ``params_total``, ``params_active``, ``model_flops`` and ``tokens``
  equal the reference's ``count_params``, ``active_param_count`` and
  formula on its ``eval_shape`` trees, exactly;
- ``argument_size_in_bytes`` equals the sum of the shard sizes derived
  from the reference's specs (``resolve_spec`` on a ``FakeMesh`` of the
  production shape, the inputs by ``data_sharding``'s rule) and shapes
  (``eval_shape``, no compile), exactly, the cache as a port rank holds
  it (a mixer computed gathered over "model" keeps its cache whole
  there); a decode record's ``cache_rules_bytes`` equals the reference's
  cache under ``CACHE_RULES`` exactly.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_config
from repro.launch import input_specs as ref_inputs
from repro.launch import steps as ref_steps
from repro.numerics.approx_ops import make_numerics as ref_numerics
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.sharding import rules as RR
from repro_torch.configs import cells
from repro_torch.launch.input_specs import batch_specs

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _reference_counts():
    """The reference's ``count_params``/``active_param_count`` (its
    module sets ``XLA_FLAGS`` for 512 host devices on import: put
    back)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return dryrun.count_params, dryrun.active_param_count


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _shard_bytes(tree, mesh, rules, model=True):
    """A device's bytes of ``tree`` placed by ``rules``; ``model=False``:
    held whole over "model"."""
    total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        logical = RR._match(RR.path_names(path), rules)
        if logical is not None:
            for axes in RR.resolve_spec(leaf.shape, logical, mesh):
                for a in (() if axes is None else axes
                          if isinstance(axes, tuple) else (axes,)):
                    if model or a != "model":
                        n //= mesh.shape[a]
        total += n
    return total


def _port_cache_bytes(cfg, cache, mesh):
    """A device's bytes of the reference's ``cache`` as the port's ranks
    hold it: a self-attention block's by ``CACHE_RULES`` (at these
    meshes every block whose KV heads "model" divides computes
    tensor-parallel), every other mixer's whole over "model" (computed
    gathered there)."""
    return sum(_shard_bytes(block, mesh, RR.CACHE_RULES,
                            model=spec.mixer == "attn")
               for part in ("prefix", "pattern", "suffix")
               for block, spec in zip(cache[part], getattr(cfg, part),
                                      strict=True))


def _batch_bytes(specs, mesh):
    ba = [a for a in ("pod", "data") if a in mesh.axis_names]
    shards = int(np.prod([mesh.shape[a] for a in ba]))
    total = 0
    for leaf in jax.tree.leaves(specs):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        if leaf.ndim and leaf.shape[0] % shards == 0:
            n //= shards
        total += n
    return total


@functools.lru_cache(maxsize=None)
def reference_record(arch, shape, mesh_kind):
    count_params, active_param_count = _reference_counts()
    cfg = ref_config(arch).with_approx(ref_numerics("haloc_axa", "residual"))
    mesh = FakeMesh(*MESHES[mesh_kind])
    kind, specs, seq = ref_inputs.batch_specs(cfg, shape)
    p = ref_steps.params_shapes(cfg)
    n_total, n_active = count_params(p), active_param_count(cfg, p)
    seqlen, gbatch, _ = REF_SHAPES[shape]
    tokens = gbatch * (1 if kind == "decode" else seqlen)
    args = _batch_bytes(specs, mesh)
    cache = port_cache = 0
    if kind == "train":
        args += _shard_bytes(ref_steps.state_shapes(cfg, RefAdamWConfig()),
                             mesh, RR.PARAM_RULES)
    else:
        args += _shard_bytes(p, mesh, RR.PARAM_RULES)
        if kind == "decode":
            c = ref_steps.cache_shapes(cfg, specs["tokens"].shape[0], seq)
            cache = _shard_bytes(c, mesh, RR.CACHE_RULES)
            port_cache = _port_cache_bytes(cfg, c, mesh)
            args += 4 + port_cache
    return {"params_total": n_total, "params_active": n_active,
            "tokens": tokens, "kind": kind, "seq": seq,
            "model_flops": float((6 if kind == "train" else 2) * n_active
                                 * tokens),
            "argument_size_in_bytes": args, "cache_rules_bytes": cache}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --all`` in a subprocess."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--all", "--out", str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert f"dry-run sweep: {2 * len(cells())}/{2 * len(cells())} cells " \
        "succeeded" in r.stdout
    return out


def test_cells_are_the_reference_cells():
    assert cells() == ref_cells()
    assert cells(include_skipped=True) == ref_cells(include_skipped=True)


@pytest.mark.parametrize("mesh_kind", tuple(MESHES))
@pytest.mark.parametrize("arch,shape", ref_cells())
def test_dryrun_record_equals_reference(sweep, arch, shape, mesh_kind):
    path = sweep / f"{arch}__{shape}__{mesh_kind}__haloc_axa.json"
    rec = json.loads(path.read_text())
    want = reference_record(arch, shape, mesh_kind)
    for key in ("params_total", "params_active", "model_flops", "tokens",
                "kind", "seq"):
        assert rec[key] == want[key], key
    assert rec["memory"]["argument_size_in_bytes"] \
        == want["argument_size_in_bytes"]
    assert rec["memory"].get("cache_rules_bytes", 0) \
        == want["cache_rules_bytes"]
    assert rec["devices"] == (256 if mesh_kind == "single" else 512)
    plan = rec["collectives"]
    assert set(plan) == {"all-gather", "reduce-scatter", "all-reduce"}
    assert plan["all-gather"]["count"] > 0
    if rec["kind"] == "train":
        assert plan["reduce-scatter"]["count"] > 0


@pytest.mark.parametrize("shape", tuple(REF_SHAPES))
def test_batch_specs_match_reference(shape):
    for arch in ("qwen3-4b", "llama-3.2-vision-11b", "hubert-xlarge"):
        from repro_torch.configs import get_config
        kind, specs, seq = batch_specs(get_config(arch), shape)
        rkind, rspecs, rseq = ref_inputs.batch_specs(ref_config(arch), shape)
        assert (kind, seq) == (rkind, rseq)
        assert set(specs) == set(rspecs)
        for k, t in specs.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(rspecs[k].shape)
            assert str(t.dtype).replace("torch.", "") == \
                str(rspecs[k].dtype)
