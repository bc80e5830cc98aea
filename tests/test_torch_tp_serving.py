"""Tensor-parallel prefill and decode over the mesh's "model" axis (the
port's sharded serving steps, ``launch.steps.make_prefill_step`` and
``make_decode_step`` on a mesh, with head-sharded KV caches) against
the reference's own serving steps jitted with the rules' shardings on
the same mesh, on gloo CPU meshes of 2 and 4 ranks.

The reference's side runs in ``torch_mesh_reference.py`` (its ``serve``
results: ``serve_cases``, jitted as ``repro.launch.dryrun`` jits them),
the port's in ``torch_mesh_workers.py`` (``job_serve12``,
``job_serve22``), made once for this file, ``test_torch_sharding.py``
and ``test_torch_tensor_parallel.py`` (``torch_mesh_runs.py``).  The
cases (``SERVE_CASES``): qwen3-4b-smoke on (1, 2) and (2, 2), exact and
haloc_axa, and its padded vocabulary (509 -> 512) on (1, 2);
qwen1.5-4b-smoke (q/k/v biases), gemma3-27b-smoke (windowed ring caches,
a suffix block, exact adds carried past the pattern) exact and
haloc_axa, and hubert-xlarge-smoke (prefill only, every position's
logits) on (1, 2); granite-moe-1b-a400m-smoke's prefill on (2, 2) (the
attention tensor-parallel, the MoE gathered).  Each prefills 4 x 32
tokens into a cache of 40 positions, then decodes 4 teacher-forced
tokens.  Tolerances: none, every check is bit for bit:

- the logits at prefill and at every decode step equal the reference's
  on both ranks (and so the ranks' greedy tokens are equal);
- each rank's cache, after the prefill and after the last decode step,
  is the reference's whole cache cut by ``CACHE_RULES`` for that rank
  (``sharding.rules.cache_shardings``, ``torch_mesh_workers.local_slices``):
  its batch rows and, in every tensor-parallel attention block, its KV/m
  heads;
- each rank's cache bytes equal the dry run's ``cache_bytes``; so do
  those of the configs whose mixers compute gathered over "model" and
  keep their caches whole there (``GATHERED_CACHE_ARCHS`` on (1, 2),
  ``job_cache12``: recurrentgemma-9b-, mamba2-1.3b-, deepseek-v2-236b-
  and llama-3.2-vision-11b-smoke), which exceed ``CACHE_RULES``' figure
  where it splits them over "model";
- the mesh's logits are not the unsharded ones (the port unsharded on
  the same parameters and tokens differs from them), so the checks
  above see the sharded sums;
- gemma3-27b-smoke's full-sequence forward (the train step's) on (1, 2)
  equals the reference's on that mesh;
- the head's placement at prefill and decode (vocabulary columns gathered,
  d_model rows summed over "model", or whole: the dry run's
  ``serving_head``, ``models.transformer.head_rows_split``) is the one
  the reference's compiled steps choose (``torch_head_reference.py``,
  ``HEAD_CASES``: qwen3-4b-smoke on ten meshes from (2, 2) to
  (2, 16, 16) and padded on (16, 16); granite-moe-1b-a400m, mamba2-1.3b
  and hubert-xlarge at full width, one repeat, on (16, 16) and
  (2, 16, 16)).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import torch_head_reference as THR  # noqa: E402
import torch_mesh_runs as TMR  # noqa: E402
import torch_mesh_workers as TW  # noqa: E402

CASES = [pytest.param(*c[:4], id="-".join(map(str, c[:4])))
         for c in TW.SERVE_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TMR.mesh_runs(tmp_path_factory)


def _ranks(runs, case):
    """Each rank's results of ``case`` and the reference's."""
    job, world = ("serve12", 2) if case[1] == "1x2" else ("serve22", 4)
    return [res[case] for res in TMR.load(runs["dir"], job, world)], \
        runs["ref"]["serve"][case]


def _differ(got, want):
    return f"{np.mean(got != want):.4f} of elements differ, max |d| " \
        f"{float(np.abs(got - want).max()):.6g}"


@pytest.mark.parametrize("arch,mesh,adder,pad", CASES)
def test_serving_logits_equal_reference(runs, arch, mesh, adder, pad):
    ranks, want = _ranks(runs, (arch, mesh, adder, pad))
    for r, res in enumerate(ranks):
        assert len(res["logits"]) == len(want["logits"])
        for step, (got, ref) in enumerate(zip(res["logits"],
                                              want["logits"])):
            assert got.shape == ref.shape, (r, step)
            assert np.array_equal(got, ref), (r, step, _differ(got, ref))


@pytest.mark.parametrize("arch,mesh,adder,pad", CASES)
def test_ranks_logits_and_greedy_tokens_equal(runs, arch, mesh, adder, pad):
    ranks, _ = _ranks(runs, (arch, mesh, adder, pad))
    first = ranks[0]["logits"]
    for res in ranks[1:]:
        for a, b in zip(first, res["logits"], strict=True):
            assert np.array_equal(a, b)
            assert np.array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("arch,mesh,adder,pad", CASES)
def test_local_cache_is_the_reference_cache_cut_by_the_rules(
        runs, arch, mesh, adder, pad):
    from repro_torch.models import weights as W
    from repro_torch.tree import leaves, leaves_with_paths
    ranks, want = _ranks(runs, (arch, mesh, adder, pad))
    cfg = TW.cfg_of(arch, adder, pad=pad)
    split = 0
    for key in ("prefill_cache", "cache"):
        whole = W.cache_from_reference(want[key], cfg, device="cpu")
        paths = [p for p, _ in leaves_with_paths(whole)]
        for r, res in enumerate(ranks):
            for path, ref, got, sl in zip(paths, leaves(whole), res[key],
                                          res["slices"], strict=True):
                cut = ref.float().numpy() if ref.is_floating_point() else \
                    ref.numpy()
                cut = cut[tuple(slice(a, b) for a, b in sl)]
                assert got.shape == cut.shape, (r, key, path)
                assert np.array_equal(got, cut), (r, key, path,
                                                  _differ(got, cut))
                split += path[-1] in ("k", "v") and \
                    sl[2][1] - sl[2][0] < ref.shape[2]
    assert split, "no rank holds a head-split k/v"


@pytest.mark.parametrize("arch,mesh,adder,pad", CASES)
def test_cache_bytes_equal_the_dry_runs(runs, arch, mesh, adder, pad):
    ranks, _ = _ranks(runs, (arch, mesh, adder, pad))
    for res in ranks:
        got, want = res["bytes"]
        assert got == want


def test_mesh_logits_are_not_the_unsharded_ones(runs):
    """qwen3-4b-smoke, exact adds, (1, 2): the port unsharded (which
    equals the reference unsharded, ROADMAP Queue C 2) differs from the
    reference on the mesh at prefill and at some decode step."""
    from repro_torch.launch import steps
    from repro_torch.models import weights as W
    case = ("qwen3-4b", "1x2", "off", 1)
    want = runs["ref"]["serve"][case]["logits"]
    cfg = TW.cfg_of("qwen3-4b")
    params = W.from_reference(runs["ref"]["params"]["qwen3-4b"], cfg,
                              device="cpu")
    inp = TW.serve_inputs(cfg)
    with torch.no_grad():
        logits, cache = steps.make_prefill_step(cfg, TW.SERVE_CTX)(
            params, {"tokens": torch.from_numpy(inp["tokens"])})
        got = [logits.float().numpy()]
        decode = steps.make_decode_step(cfg)
        for i in range(len(want) - 1):
            logits, cache = decode(params, {"tokens": torch.from_numpy(
                inp["decode"][:, i:i + 1])}, TW.SERVE_PROMPT + i, cache)
            got.append(logits.float().numpy())
    d = [float(np.abs(a - b).max()) for a, b in zip(got, want, strict=True)]
    assert d[0] > 0 and max(d[1:]) > 0, d


@pytest.mark.parametrize("case", TW.FULL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_full_forward_on_the_mesh_equals_reference(runs, case):
    ranks, want = _ranks(runs, case)
    for res in ranks:
        assert np.array_equal(res["full"], want["full"]), \
            _differ(res["full"], want["full"])


#: The GATHERED_CACHE_ARCHS whose caches ``CACHE_RULES`` splits over
#: "model" (the RG-LRU's and the SSD's states, cross attention's k/v);
#: MLA's it splits over the rows only.
RULES_SPLIT = ("recurrentgemma-9b", "mamba2-1.3b", "llama-3.2-vision-11b")


@pytest.mark.parametrize("arch", TW.GATHERED_CACHE_ARCHS)
def test_gathered_mixer_cache_bytes_equal_the_dry_runs(runs, arch):
    """On (1, 2) each rank holds every leaf of its cache whole but a
    tensor-parallel attention block's k/v (half their KV heads), after
    the prefill and after a decode step, and its bytes are the dry run's
    ``cache_bytes``."""
    for res in TMR.load(runs["dir"], "cache12", 2):
        got = res[arch]
        assert got["held"] == (got["dryrun"], got["dryrun"])
        for local, whole in zip(got["shapes"], got["whole"], strict=True):
            if local != whole:
                assert len(whole) == 4 and local[2] * 2 == whole[2] and \
                    local[:2] + local[3:] == whole[:2] + whole[3:], \
                    (local, whole)
        if arch in RULES_SPLIT:
            assert got["dryrun"] > got["rules"]
        else:
            assert got["dryrun"] == got["rules"]


@pytest.fixture(scope="module")
def head_hlo():
    """``torch_head_reference.py``'s reading, in a subprocess (its own
    XLA host devices)."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, THR.__file__], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", THR.HEAD_CASES, ids=THR.case_id)
def test_serving_head_is_the_reference_partitioners(head_hlo, case):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.sharding import rules as R
    arch, full, pad, shape, _ = case
    cfg = dataclasses.replace(get_config(arch), repeats=1) if full else \
        TW.cfg_of(arch)
    if pad > 1:
        cfg = dataclasses.replace(cfg, vocab_pad_multiple=pad)
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    mesh = R.MeshShape(names, shape)
    p = steps.params_shapes(cfg)
    got = dryrun.serving_head(cfg, R.tree_shardings(p, mesh, R.PARAM_RULES),
                              mesh)
    assert got == head_hlo[THR.case_id(case)]
