"""The port's loss and gradients (``repro_torch.launch.steps.
value_and_grad`` over ``models.transformer.loss_fn``) against the
reference's jitted ``jax.value_and_grad(loss_fn)``, on the CPU, for every
arch's smoke config (2 x 32 tokens, seed 1; SSD chunk 8 as in
``tests/test_models_smoke.py``) with exact adds, and for qwen3-4b,
granite, mamba2 and llama-3.2-vision under haloc_axa, on the reference's
parameters (``models.weights.from_reference``) and the same batch.

- the loss, ce and aux within 1e-6 relative (1e-4 with exact adds where
  the forward differs in the last bits: ROADMAP Queue C 2);
- every gradient leaf within 0.05 relative Frobenius error (0.08 with MoE
  layers), and the same leaves zero in both;
- the cross attention's four scalar gates in a test of their own (under
  haloc_axa a strict xfail, ROADMAP Queue C 15).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.configs import arch_names
from repro_torch.launch import steps
from repro_torch.models import weights as W
from repro_torch.tree import leaves, leaves_with_paths
from test_torch_training import (CPU, GRAD_TOL, LOSS_TOL,
                                 MOE_GRAD_TOL, batch_np, configs, port_batch,
                                 ref_batch, rel_fro)

#: The cross attention's scalar gates: each one's gradient is the sum of
#: every product of the gated output and its gradient, reduced with a
#: bf16 accumulator (XLA:CPU's reduction, ``layers.bf16_sum``), so it
#: moves with the last bits of the output gradient, which the port's
#: backward does not reach bit for bit (ROADMAP Queue C 15); they have
#: their own test.
GATES = ("gate", "gate_mlp")
HALOC_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m", "mamba2-1.3b",
               "llama-3.2-vision-11b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in ``test_torch_training.py``: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def reference_grads(name, adder, seed=1):
    """The reference's jitted value_and_grad(loss_fn) at the smoke config
    on :func:`batch_np`'s batch; parameters, loss, parts and gradients as
    numpy."""
    rcfg, _ = configs(name, adder)
    rp = jax.jit(RT.init_params, static_argnums=1)(jax.random.key(seed), rcfg)
    b = batch_np(rcfg, seed)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, x: RT.loss_fn(p, rcfg, x), has_aux=True))(rp, ref_batch(b))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(rp), b, float(loss), {k: float(v) for k, v in
                                       parts.items()}, to_np(grads)


CASES = [(n, "off") for n in arch_names()] + [(n, "haloc_axa")
                                               for n in HALOC_ARCHS]


def port_grads(name, adder):
    """The port's loss, parts and gradients on :func:`reference_grads`'
    parameters and batch, and the reference's gradients in the port's
    layout."""
    tree, b, ref_loss, ref_parts, ref_grads = reference_grads(name, adder)
    _, cfg = configs(name, adder)
    params = W.from_reference(tree, cfg, device=CPU)
    (loss, parts), grads = steps.value_and_grad(params, cfg, port_batch(b))
    return cfg, loss, parts, grads, W.from_reference(ref_grads, cfg,
                                                     device=CPU)


def leaf_errors(grads, want, keep):
    """(relative Frobenius error, path) of each leaf ``keep(path)``
    selects; a leaf the reference gives a zero gradient must be zero."""
    out = []
    for (path, got), ref in zip(leaves_with_paths(grads), leaves(want),
                                strict=True):
        if not keep(path):
            continue
        got, ref = got.double().numpy(), ref.double().numpy()
        if not ref.any():
            assert not got.any(), path
            continue
        out.append((rel_fro(got, ref), path))
    return out


def test_final_norm_scale_gradient_equals_reference():
    """The final norm's scale gradient, its reduction over the (B, S)
    rows as LLVM vectorizes it inside the compiled step, equals the
    reference's bit for bit on qwen3-4b-smoke with exact adds (ROADMAP
    Queue C 16's norm scales; the q/k norms' reduction is held at their
    (B, S, H, D) shapes by ``test_rms_norm_vjp_is_xlas``)."""
    _, _, _, grads, want = port_grads("qwen3-4b", "off")
    assert torch.equal(grads["final_norm"]["scale"],
                       want["final_norm"]["scale"])


@pytest.mark.parametrize("name,adder", CASES)
def test_loss_and_gradients_match_reference(name, adder):
    _, _, ref_loss, ref_parts, _ = reference_grads(name, adder)
    cfg, loss, parts, grads, want = port_grads(name, adder)
    tol = LOSS_TOL
    assert abs(float(loss) - ref_loss) <= tol * abs(ref_loss)
    assert abs(float(parts["ce"]) - ref_parts["ce"]) <= tol * ref_parts["ce"]
    assert (abs(float(parts["aux"]) - ref_parts["aux"])
            <= max(tol * abs(ref_parts["aux"]), 0.0))
    gtol = MOE_GRAD_TOL if cfg.moe is not None else GRAD_TOL
    worst = max(leaf_errors(grads, want, lambda p: p[-1] not in GATES))
    print(f"{name} {adder}: loss {float(loss):.8f} / {ref_loss:.8f}; worst "
          f"gradient leaf {worst[1]} at {worst[0]:.4f}")
    assert worst[0] < gtol, worst


@pytest.mark.parametrize("adder", [
    "off", pytest.param("haloc_axa", marks=pytest.mark.xfail(
        strict=True, reason="ROADMAP Queue C 15: the first cross block's "
        "gate_mlp gradient 0.0606 from the reference's (bf16 "
        "accumulation of an output gradient not bit-exact)"))])
def test_cross_gate_gradients_match_reference(adder):
    name = "llama-3.2-vision-11b"
    _, _, _, grads, want = port_grads(name, adder)
    errs = leaf_errors(grads, want, lambda p: p[-1] in GATES)
    print(f"{name} {adder}: gate gradients {sorted(errs)}")
    assert len(errs) == 4 and max(errs)[0] < GRAD_TOL, errs
