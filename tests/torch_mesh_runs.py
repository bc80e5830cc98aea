"""The mesh runs that ``test_torch_sharding.py``,
``test_torch_tensor_parallel.py`` and ``test_torch_tp_serving.py`` read:
the reference's host-mesh runs (``torch_mesh_reference.py``, a
subprocess with four XLA host devices), the port's gloo ranks
(``torch_mesh_workers.py``: groups of 2 and 4 CPU ranks) and the
unsharded port's counterparts, made once per test run.

Under ``pytest-xdist`` the files may run in several workers: the first
to ask makes the runs in a directory beside the workers' temp dirs,
under a file lock, and the others wait for it and read what it wrote.
"""

import fcntl
import os
import pathlib
import pickle
import subprocess
import sys
import time

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
sys.path.insert(0, str(HERE))
import torch_mesh_workers as TW  # noqa: E402

_CACHE = {}


def _wait_for(path, proc, timeout=600):
    """Waits until ``path`` exists (the reference publishes it with a
    rename); fails if ``proc`` exits first."""
    t0 = time.time()
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            pytest.fail(f"the reference exited {proc.returncode}: "
                        f"{proc.stderr.read()[-3000:]}")
        assert time.time() - t0 < timeout, f"no {path}"
        time.sleep(0.2)


def _join(ctx, proc):
    """Joins ``ctx``'s ranks; fails if the reference ``proc`` fails first
    (a rank may be waiting for what it never publishes: :func:`_make`
    then ends the ranks)."""
    while not ctx.join(timeout=1):
        if proc.poll() not in (None, 0):
            pytest.fail(f"the reference exited {proc.returncode}: "
                        f"{proc.stderr.read()[-3000:]}")


def _make(d):
    """The runs, their rank outputs in ``d``: {"ref": the reference's
    results (its inputs' parameters under "params"), "cpu": the unsharded
    port's, "dir": d}."""
    from repro_torch.launch import steps
    ref_path = d / "ref.pkl"
    inputs = d / "ref.pkl.inputs"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    ref_proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_reference.py"),
         str(ref_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # steps12 waits for the reference's inputs after the others
    ctxs = [TW.start(("serve21", "elastic", "fault", "cache12", "steps12"),
                     2, d, inputs)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = {"grads": {}, "tokens": TW.serve_tokens(None)}
        _wait_for(inputs, ref_proc)
        ctxs.append(TW.start(("placements", "moe", "grads4", "collectives",
                              "serve22"), 4, d, inputs))
        ctxs.append(TW.start(("grads2", "tp12", "serve12"), 2, d, inputs))
        with open(inputs, "rb") as f:
            params = pickle.load(f)["params"]
        for arch in ("qwen3-4b", "granite-moe-1b-a400m"):
            cfg = TW.cfg_of(arch)
            (loss, parts), grads = steps.value_and_grad(
                TW.port_params(params[arch], cfg), cfg,
                TW.case_batch(cfg.vocab_size))
            cpu["grads"][arch] = (float(loss), float(parts["aux"]),
                                  [g.numpy() for g in
                                   TW.full_leaves(grads)])
        for ctx in ctxs:
            _join(ctx, ref_proc)
        _, err = ref_proc.communicate(timeout=600)
        assert ref_proc.returncode == 0, err[-3000:]
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        ref["params"] = params
    finally:
        torch.set_num_threads(threads)
        if ref_proc.poll() is None:
            ref_proc.kill()
        for p in (p for ctx in ctxs for p in ctx.processes):
            if p.is_alive():
                p.kill()
    return {"ref": ref, "cpu": cpu, "dir": d}


def mesh_runs(tmp_path_factory):
    """The runs (:func:`_make`), made once for every test file and xdist
    worker of this test run."""
    if "runs" in _CACHE:
        return _CACHE["runs"]
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent   # shared by the run's workers
    d = root / "torch_mesh_runs"
    done = root / "torch_mesh_runs.pkl"
    with open(root / "torch_mesh_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if done.exists():
                with open(done, "rb") as f:
                    runs = pickle.load(f)
            else:
                d.mkdir(exist_ok=True)
                runs = _make(d)
                with open(str(done) + ".tmp", "wb") as f:
                    pickle.dump(runs, f, protocol=5)
                os.replace(str(done) + ".tmp", done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _CACHE["runs"] = runs
    return runs


def load(d, job, world):
    """Each rank's results of ``job`` (its seconds left out)."""
    out = [torch.load(d / f"{job}.{r}.pt", weights_only=False)
           for r in range(world)]
    for res in out:
        res.pop("seconds")
    return out
