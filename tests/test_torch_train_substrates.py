"""The port's training substrate (``repro_torch.data.pipeline``,
``checkpoint.checkpointer``, ``runtime.train_loop``, ``launch.train``)
against ``repro``'s, on the CPU at the smoke sizes: the counterparts of
``tests/test_substrates.py`` (less ``choose_mesh_shape`` and the elastic
reshard, which need a mesh: ROADMAP Queue A item 5) and of
``tests/test_system.py::test_train_checkpoint_serve_roundtrip``.

- the synthetic batches equal the reference's bit for bit, for a text,
  an audio and a vision config, across steps and host slices;
  ``skip_to`` resumes the stream;
- checkpoints: the round trip (fp32, int32 and bf16 leaves, dict keys
  in jax's sorted order, lists in order), a corrupted leaf raising
  ``IOError``, async saves and the keep policy, a leaf-count mismatch;
- the train loop: the loss falls, two injected faults are recovered
  from the last checkpoint, and a restart from a checkpoint gives the
  uninterrupted run's losses bit for bit;
- train -> checkpoint -> restore -> ``generate`` under haloc_axa;
- ``launch.train.main`` with ``--smoke --device cpu`` prints its line;
  ``--model-parallel 2`` and a mesh raise naming Queue A item 5; without
  a card the defaults raise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.data import pipeline as RD
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, DataIterator, \
    synthetic_batch
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models.serving import generate
from repro_torch.numerics.approx_ops import make_numerics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import SimulatedFault, \
    TrainLoopConfig, run
from repro_torch.tree import leaves, tree_map

CPU = "cpu"
CFG = get_smoke_config("qwen1.5-4b")
DATA = DataConfig(seq_len=32, global_batch=2, seed=7)
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=60)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops: one thread runs them about as
    fast alone, and far faster beside the suite's other workers, which
    would otherwise share the cores eight threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("arch", ["qwen3-4b", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_batches_equal_reference(arch):
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    for data in (DataConfig(seq_len=48, global_batch=4, seed=3),
                 DataConfig(seq_len=48, global_batch=4, seed=3, host_id=1,
                            num_hosts=2)):
        rdata = RD.DataConfig(**dataclasses.asdict(data))
        for step in (0, 1, 17):
            got = synthetic_batch(cfg, data, step)
            want = RD.synthetic_batch(rcfg, rdata, step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_and_resumable():
    b1 = synthetic_batch(CFG, DATA, step=5)
    it = DataIterator(CFG, DATA, start_step=0)
    it.skip_to(5)
    np.testing.assert_array_equal(b1["tokens"], next(it)["tokens"])
    assert it.step == 6
    h0 = synthetic_batch(CFG, DataConfig(seq_len=32, global_batch=4,
                                         host_id=0, num_hosts=2), 0)
    assert h0["tokens"].shape[0] == 2
    t = synthetic_batch(CFG, DataConfig(seq_len=128, global_batch=2),
                        0)["tokens"][0]
    np.testing.assert_array_equal(t[32:64], t[:32])


# ------------------------------------------------------------ checkpoint --

def _state():
    return {"b": {"c": torch.ones((3, 3)), "a": torch.arange(10)},
            "w": torch.linspace(-1, 1, 12).reshape(3, 4).to(torch.bfloat16),
            "list": [torch.zeros(2), torch.full((2, 2), 7.0)],
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_integrity(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _state()
    ck.save(7, state)
    like = tree_map(lambda t: torch.empty_like(t, device="meta"), state)
    rest = ck.restore(like, device=CPU)
    for got, want in zip(leaves(rest), leaves(state), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(rest["step"]) == 7
    d = os.path.join(str(tmp_path), "step_00000007")
    # leaf 0 is b/a (sorted keys), as jax flattens the tree
    assert np.array_equal(np.load(os.path.join(d, "leaf_00000.npy")),
                          np.arange(10))
    with open(os.path.join(d, "leaf_00001.npy"), "r+b") as f:
        f.seek(64)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        ck.restore(like, device=CPU)
    with pytest.raises(ValueError, match="leaves"):
        Checkpointer(str(tmp_path)).restore({"x": torch.zeros(1)},
                                            device=CPU)


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        state["x"] += 1
        ck.async_save(s, state)       # the host copy is taken at once
    ck.wait()
    found = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("step_"))
    assert len(found) == 2 and found[-1].endswith("4")
    assert torch.equal(ck.restore(state, step=3, device=CPU)["x"],
                       torch.full((4,), 3.0))


# -------------------------------------------------------------- training --

def test_train_loop_loss_decreases(tmp_path):
    loop = TrainLoopConfig(total_steps=40, ckpt_every=50, log_every=5,
                           ckpt_dir=str(tmp_path))
    out = run(CFG, OPT, DATA, loop, device=CPU)
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    assert last < first - 0.2, (first, last)


def test_train_loop_fault_recovery(tmp_path):
    """Kill the step twice mid-run; the loop restores from the checkpoint
    and still reaches total_steps."""
    fails = {"left": 2}

    def hook(step):
        if step == 25 and fails["left"] > 0:
            fails["left"] -= 1
            raise SimulatedFault("injected")

    loop = TrainLoopConfig(total_steps=30, ckpt_every=10, log_every=10,
                           ckpt_dir=str(tmp_path))
    out = run(CFG, OPT, DATA, loop, fault_hook=hook, device=CPU)
    assert out["failures"] == 2
    assert int(out["state"]["step"]) == 30

    def crash(step):
        raise RuntimeError("not a simulated fault")

    with pytest.raises(RuntimeError, match="not a simulated"):
        run(CFG, OPT, DATA, dataclasses.replace(loop, total_steps=31),
            fault_hook=crash, device=CPU)


def test_train_loop_restart_gives_uninterrupted_losses(tmp_path):
    def loop(total, ckpt):
        return TrainLoopConfig(total_steps=total, ckpt_every=4, log_every=1,
                               ckpt_dir=ckpt)

    whole = run(CFG, OPT, DATA, loop(12, None), device=CPU)["history"]
    run(CFG, OPT, DATA, loop(8, str(tmp_path)), device=CPU)
    out = run(CFG, OPT, DATA, loop(12, str(tmp_path)), device=CPU)
    assert int(out["state"]["step"]) == 12
    resumed = {h["step"]: h["loss"] for h in out["history"]}
    assert sorted(resumed) == [8, 9, 10, 11]
    for h in whole[8:]:
        assert resumed[h["step"]] == h["loss"]


def test_train_checkpoint_serve_roundtrip(tmp_path):
    cfg = get_smoke_config("qwen3-4b").with_approx(make_numerics(
        "haloc_axa", "residual", fast=True, backend="torch", device=CPU))
    data = DataConfig(seq_len=32, global_batch=2, seed=3)
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=30)
    loop = TrainLoopConfig(total_steps=30, ckpt_every=10, log_every=10,
                           ckpt_dir=str(tmp_path))
    out = run(cfg, opt, data, loop, device=CPU)
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    state = Checkpointer(str(tmp_path)).restore(
        steps.state_shapes(cfg, opt), device=CPU)
    for got, want in zip(leaves(state), leaves(out["state"]), strict=True):
        assert torch.equal(got, want)
    prompts = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)), dtype=torch.int32)}
    seqs = generate(state["params"], cfg, prompts, 6, temperature=0.0)
    assert tuple(seqs.shape) == (2, 14)
    assert int(seqs.max()) < cfg.vocab_size and int(seqs.min()) >= 0


# -------------------------------------------------------------- launcher --

def test_launch_train_main_on_the_cpu(capsys):
    train_launcher.main(["--arch", "qwen3-4b", "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "32", "--device", "cpu",
                         "--adder", "haloc_axa"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("qwen3-4b-smoke: loss ")
    assert "over 3 steps; stragglers flagged: 0; failures recovered: 0" \
        in line


def test_mesh_and_model_parallel_raise(capsys):
    """Without ranks a mesh cannot run: the launcher's
    ``--model-parallel 2`` outside ``torch.distributed.run`` is a usage
    error naming it, and the loop refuses an abstract mesh."""
    from repro_torch.sharding.rules import MeshShape
    with pytest.raises(SystemExit):
        train_launcher.main(["--smoke", "--model-parallel", "2",
                             "--device", "cpu"])
    assert "torch.distributed.run" in capsys.readouterr().err
    with pytest.raises(TypeError, match="DeviceMesh"):
        run(CFG, OPT, DATA, TrainLoopConfig(total_steps=1),
            mesh=MeshShape(("data", "model"), (2, 1)), device=CPU)


def test_defaults_raise_without_a_card(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(CFG, OPT, DATA, TrainLoopConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.init_state(0, CFG, OPT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launcher.main(["--smoke", "--steps", "1"])
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore({"x": torch.zeros(2)})
