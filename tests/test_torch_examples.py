"""The port's entry points (``repro_torch.examples``) against ``repro``'s
own API, on the CPU at small sizes (``--device cpu``: the ``"torch"``
backend), on the same seeds and inputs:

- ``quickstart``: ``add_full``, the four Monte-Carlo error reports (MRED
  included), the hardware rows, the batch's error distances and the
  residual add, all equal;
- ``adder_design_space``: every row (MED, NMED, energy) and the
  frontier equal;
- ``image_reconstruction --size 64``: each Table-1 kind's PSNR and SSIM
  equal;
- ``approx_mac --size 32``: every configuration's outputs, PSNR and
  agreement equal;
- ``serve_decode``: greedy tokens (2 x 8 + 2) equal the reference's
  ``generate`` at temperature 0 on the same parameters and prompt;
- ``train_approx_lm``: d 64, 2 layers, 3 steps, both adders, from the
  reference's initial state (written as the port's step-0 checkpoint):
  each step's loss within ``LOSS_TOL`` of the reference's ``run``; a
  checkpoint written at step 2 restores to the same state (the resumed
  run's step and final state equal the uninterrupted run's bit for bit);
- each example raises without a card unless asked for the CPU.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ax import make_engine as ref_engine
from repro.ax.mul import MacSpec as RMacSpec
from repro.ax.mul import MulSpec as RMulSpec
from repro.core import hwcost as ref_hw
from repro.core import metrics as ref_metrics
from repro.core.specs import AdderSpec as RAdderSpec
from repro.core.specs import TABLE1_KINDS as REF_KINDS
from repro.core.specs import paper_spec as ref_paper_spec
from repro.image import pipeline as ref_pipe
from repro.image import quality as ref_quality
from repro.numerics.fixed_point import FixedPointFormat as RFmt
from repro_torch.examples import (adder_design_space, approx_mac,
                                  image_reconstruction, quickstart,
                                  serve_decode, train_approx_lm)
from repro_torch.tree import leaves

CPU = ["--device", "cpu"]
LOSS_TOL = 1e-6
#: The loss after an update: the gradients are the reference's within
#: bf16 roundings, not bit for bit (ROADMAP Queue C 16), and AdamW's
#: first step moves each parameter by +-lr by its gradient's sign alone,
#: so a gradient element of the other sign moves it by 2 lr.
UPDATED_LOSS_TOL = 1e-2


def _report_fields(rep):
    return (rep.n_samples, rep.med, rep.mred, rep.nmed, rep.error_rate,
            rep.wce)


def test_quickstart_equals_reference():
    got = quickstart.main(CPU)
    spec = ref_paper_spec("haloc_axa")
    ax = ref_engine(spec, backend="numpy")
    assert got["add_full"] == int(ax.add_full(np.uint64(53_000),
                                              np.uint64(12_345)))
    for rep, kind in zip(got["reports"], quickstart.KINDS, strict=True):
        want = ref_metrics.simulate_error_metrics(
            ref_paper_spec(kind), n_samples=quickstart.N_SAMPLES)
        assert rep.spec.kind == kind
        assert _report_fields(rep) == _report_fields(want), kind
    for kind, row in got["hw"].items():
        r = ref_hw.report(ref_paper_spec(kind))
        assert row == (r.transistors, r.energy_fj, r.delay_ns), kind
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
    ed = np.abs(ax.add_full(x, y).astype(np.int64) - (x + y).astype(np.int64))
    assert got["error_distances"] == ed.tolist()
    lm = ref_engine("haloc_axa", fmt=RFmt(16, 8), backend="jax", fast=True)
    xs, ys = got["residual_inputs"]
    want = np.asarray(lm.residual_add(jnp.asarray(xs), jnp.asarray(ys)))
    np.testing.assert_array_equal(got["residual_add"], want)


def test_adder_design_space_rows_equal_reference():
    got = adder_design_space.main(CPU)
    e_acc = ref_hw.switching_energy_fj(RAdderSpec(kind="accurate"))
    want = []
    for m in adder_design_space.LSM_BITS:
        for k in (0, m // 4, m // 2):
            if k > m - 2:
                continue
            spec = RAdderSpec(kind="haloc_axa", n_bits=32, lsm_bits=m,
                              const_bits=k)
            rep = ref_metrics.exact_error_metrics(spec)
            e = ref_hw.switching_energy_fj(spec)
            want.append((m, k, rep.med, rep.nmed, e, e / e_acc))
    assert got["rows"] == want
    assert got["frontier"]


def test_image_reconstruction_scores_equal_reference(tmp_path):
    got = image_reconstruction.main(CPU + ["--size", "64",
                                           "--out", str(tmp_path)])
    img = ref_pipe.synthetic_image(64)
    assert tuple(got["scores"]) == tuple(REF_KINDS)
    for kind in REF_KINDS:
        rec = np.asarray(ref_pipe.reconstruct(img, ref_paper_spec(kind)))
        assert got["scores"][kind] == (ref_quality.psnr(img, rec),
                                       ref_quality.ssim(img, rec)), kind


def _ref_mac(spec):
    return RMacSpec(RAdderSpec(**dataclasses.asdict(spec.adder)),
                    RMulSpec(**dataclasses.asdict(spec.mul)))


def _ref_infer(img, mac1, mac2):
    l1 = ref_engine(_ref_mac(mac1), fmt=RFmt(16, 0), backend="jax")
    l2 = ref_engine(_ref_mac(mac2), fmt=RFmt(16, 0), backend="jax")
    h1 = np.asarray(l1.conv2d(img.astype(np.int32), approx_mac.SMOOTH,
                              shift=4))
    h1 = np.clip(h1, 0, 255).astype(np.int32)
    h2 = np.asarray(l2.conv2d(h1, approx_mac.SHARPEN, shift=0))
    return np.clip(h2, 0, 255).astype(np.uint8)


def test_approx_mac_rows_equal_reference():
    got = approx_mac.main(CPU + ["--size", "32"])
    img = ref_pipe.synthetic_image(32)
    golden = _ref_infer(img, approx_mac.EXACT, approx_mac.EXACT)
    for name, mac1, mac2 in approx_mac.CONFIGS:
        out = _ref_infer(img, mac1, mac2)
        np.testing.assert_array_equal(got["outputs"][name], out)
        d = out.astype(np.int64) - golden.astype(np.int64)
        assert got["rows"][name] == (
            ref_quality.psnr(golden, out),
            100.0 * float(np.mean(np.abs(d) <= 1)),
            float(np.abs(d).mean())), name


def test_serve_decode_greedy_tokens_equal_reference():
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import transformer as RT
    from repro.models.serving import generate as ref_generate
    from repro.numerics.approx_ops import make_numerics as ref_numerics
    from repro_torch.models import weights as W
    rcfg = ref_smoke("qwen3-4b").with_approx(ref_numerics("haloc_axa",
                                                          "residual"))
    rparams = RT.init_params(jax.random.key(0), rcfg)
    cfg = serve_decode.build_config("qwen3-4b", "haloc_axa", "torch", "cpu")
    params = W.from_reference(jax.tree.map(np.asarray, rparams), cfg,
                              device="cpu")
    got = serve_decode.main(CPU + ["--temperature", "0", "--batch", "2",
                                   "--prompt-len", "8", "--new-tokens", "2"],
                            params=params)
    prompt = got["prompt"]["tokens"].numpy()
    assert prompt.shape == (2, 8)
    want = ref_generate(rparams, rcfg, {"tokens": jnp.asarray(prompt)}, 2,
                        temperature=0.0)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))


TRAIN = ["--d-model", "64", "--layers", "2", "--batch", "2", "--seq", "32",
         "--steps", "3", "--log-every", "1", "--ckpt-every", "2"]


def test_train_approx_lm_follows_reference_and_resumes(tmp_path):
    from repro.data.pipeline import DataConfig as RData
    from repro.launch import steps as ref_steps
    from repro.models.config import BlockSpec as RBlock
    from repro.models.config import ModelConfig as RModel
    from repro.numerics.approx_ops import make_numerics as ref_numerics
    from repro.optim.adamw import AdamWConfig as ROpt
    from repro.runtime import train_loop as ref_loop
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models import weights as W

    ckpt = str(tmp_path / "ck")
    ref_opt = ROpt(lr=1e-3, warmup_steps=20, total_steps=3)
    want = {}
    for adder in ("haloc_axa", "off"):
        rcfg = RModel(name="approx-lm-64x2", family="dense", d_model=64,
                      num_heads=8, num_kv_heads=4, head_dim=8, d_ff=192,
                      vocab_size=32768, pattern=(RBlock(),), repeats=2)
        if adder != "off":
            rcfg = rcfg.with_approx(ref_numerics(adder, "residual"))
        rcfg = rcfg.validate()
        state = jax.jit(lambda: ref_steps.init_state(
            jax.random.key(0), rcfg, ref_opt))()
        cfg = train_approx_lm.build_model(64, 2, adder, "torch", "cpu")
        Checkpointer(f"{ckpt}_{adder}").save(0, W.state_from_reference(
            jax.tree.map(np.asarray, state), cfg, device="cpu"))
        out = ref_loop.run(rcfg, ref_opt, RData(seq_len=32, global_batch=2),
                           ref_loop.TrainLoopConfig(total_steps=3,
                                                    log_every=1))
        want[adder] = [h["loss"] for h in out["history"]]

    got = train_approx_lm.main(CPU + TRAIN + ["--ckpt-dir", ckpt])
    for adder, losses in want.items():
        hist = got[adder]["history"]
        assert [h["step"] for h in hist] == [0, 1, 2]
        for h, loss in zip(hist, losses, strict=True):
            tol = LOSS_TOL if h["step"] == 0 else UPDATED_LOSS_TOL
            assert abs(h["loss"] - loss) <= tol * abs(loss), (adder, h)
        # resume from the step-2 checkpoint
        shutil.rmtree(f"{ckpt}_{adder}/step_{3:08d}")
    again = train_approx_lm.main(CPU + TRAIN + ["--ckpt-dir", ckpt])
    for adder in want:
        hist = again[adder]["history"]
        assert [h["step"] for h in hist] == [2]
        assert hist[0]["loss"] == got[adder]["history"][2]["loss"]
        for a, b in zip(leaves(again[adder]["state"]),
                        leaves(got[adder]["state"]), strict=True):
            assert torch.equal(a, b), adder


@pytest.mark.parametrize("module", [quickstart, adder_design_space,
                                    image_reconstruction, approx_mac,
                                    serve_decode, train_approx_lm])
def test_examples_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])
