"""The port's training path (``repro_torch.models.transformer.loss_fn``,
``launch.steps``' ``init_state``/``value_and_grad``/``make_train_step``,
``models.layers``' derivative rules and flash VJP) against ``repro``'s,
on the CPU at the smoke sizes, on the same numpy-seeded inputs.

- ``cpu_dot_f32``: its forward under autograd is the ordered product
  unchanged, bit for bit, and its gradients (the two transposed products,
  in the layouts the reference's compiled train step gives them) equal
  ``jax.vjp``'s of the bf16 product;
- each emulation wrapped with jax's derivative rule (``xla_exp32``,
  ``xla_log1p32``, ``xla_tanh32``, ``softplus32``) has jax's gradient at
  points in each of its branches, bit for bit; the composed ones
  (``sigmoid32``, ``softmax32``, ``row_sum``, ``fma32``, ``rms_norm``)
  within 4 fp32 ulps; ``xla_rsqrt32`` is XLA:CPU's ``rsqrt``, and
  ``rms_norm``'s and ``silu``'s VJPs the reference's, bit for bit; ``bf16_sum`` is
  XLA:CPU's bf16 reduction, bit for bit, and the gated product's
  gradients are jax's (the gate's within one ulp);
- the attention mixer's VJP (qwen3-4b-smoke, 32 keys) equal to the
  jitted reference's bit for bit;
- the flash VJP against ``jax.vjp`` of the reference's
  ``chunked_attention`` (chunk 16, causal, windows 0 and 8): within 0.02
  relative Frobenius error of the eager one, and bit for bit the jitted
  one (and at 1040 tokens, two chunks of 1024);
- (the ten archs' losses and gradients: ``test_torch_train_grads.py``)
- one ``make_train_step`` from ``state_from_reference`` against the
  reference's jitted step (loss, ce, aux within the loss tolerance,
  grad_norm within 1e-2, step and count equal), with one microbatch and
  with two;
- the counterparts of ``test_smoke_train_step`` (every arch, the port's
  own parameters) and ``test_smoke_train_with_approx_numerics``
  (qwen1.5-4b under haloc_axa and loa).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import layers as RL
from repro.numerics import approx_ops as ref_ops
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro_torch.configs import arch_names, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import weights as W
from repro_torch.numerics import approx_ops as ops
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves

CPU = "cpu"
OPT = AdamWConfig(warmup_steps=2, total_steps=10)
REF_OPT = RefAdamWConfig(warmup_steps=2, total_steps=10)
LOSS_TOL = 1e-6
#: Gradient leaves' relative Frobenius error, without and with MoE layers.
GRAD_TOL, MOE_GRAD_TOL = 0.05, 0.08


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops: one thread runs them about as
    fast alone, and far faster beside the suite's other workers, which
    would otherwise share the cores eight threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(cfg):
    if cfg.ssd is not None:
        cfg = dataclasses.replace(
            cfg, ssd=dataclasses.replace(cfg.ssd, chunk=8))
    return cfg


def configs(name, adder="off"):
    rcfg, cfg = _small(ref_smoke(name)), _small(get_smoke_config(name))
    if adder != "off":
        rcfg = rcfg.with_approx(ref_ops.make_numerics(adder, "residual"))
        cfg = cfg.with_approx(ops.make_numerics(adder, "residual",
                                                backend="torch", device=CPU))
    return rcfg, cfg


def batch_np(cfg, seed, b=2, s=32):
    """Tokens or frames, a vision model's embeddings, and labels, drawn
    with numpy (the floats bf16-valued)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.audio is not None:
        out["frames"] = rng.standard_normal((b, s, cfg.audio.feat_dim))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.vision is not None:
        out["vision"] = rng.standard_normal(
            (b, cfg.vision.seq_len, cfg.vision.embed_dim))
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s))
    return {k: (np.asarray(jnp.asarray(v, jnp.bfloat16)) if v.dtype.kind
                == "f" else v.astype(np.int32)) for k, v in out.items()}


def ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_batch(b):
    return {k: W.to_tensor(v, CPU) for k, v in b.items()}


def rel_fro(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ products --

DOT_SHAPES = [(64, 64, 192), (64, 192, 64), (20, 48, 509), (2, 37, 40)]


@pytest.mark.parametrize("m,k,n", DOT_SHAPES)
def test_cpu_dot_f32_forward_unchanged_and_gradients(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((k, n)) * k ** -0.5, jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
    ta, tb = (W.to_tensor(np.asarray(t), CPU).requires_grad_() for t in (a, b))
    got = L.cpu_dot_f32(ta, tb)
    assert torch.equal(got.detach(), L._ordered_dot(ta.detach(), tb.detach(),
                                                    False, False))
    want, vjp = jax.vjp(jax.jit(lambda x, y: x @ y), a, b)
    out = L.matmul(ta, tb)
    np.testing.assert_array_equal(out.detach().float().numpy(), as_f32(want))
    out.backward(W.to_tensor(np.asarray(g), CPU))
    ga, gb = jax.jit(vjp)(g)
    np.testing.assert_array_equal(ta.grad.float().numpy(), as_f32(ga))
    np.testing.assert_array_equal(tb.grad.float().numpy(), as_f32(gb))


# ------------------------------------------------------------ emulations --

#: Points in each branch: exp's clamp and its range; log1p's small
#: (|x| < sqrt(2) - 1) and large branches; tanh's x, polynomial and
#: +-1 branches; softplus below, at and above 0.
POINTS = {
    "exp": [-100.0, -3.0, -0.5, 0.0, 0.7, 5.0, 80.0, 100.0],
    "log1p": [-0.9, -0.3, -1e-3, 0.0, 0.2, 0.41, 0.5, 3.0, 40.0],
    "tanh": [-25.0, -3.0, -0.5, -1e-4, 0.0, 2e-4, 0.3, 1.0, 7.9, 21.0],
    "softplus": [-30.0, -2.0, -0.5, 0.0, 0.5, 3.0, 25.0],
}
WRAPPED = {"exp": (L.xla_exp32, jnp.exp),
           "log1p": (L.xla_log1p32, jnp.log1p),
           "tanh": (L.xla_tanh32, jnp.tanh),
           "softplus": (L.softplus32, jax.nn.softplus)}


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_wrapped_emulation_gradient_is_jaxs(name):
    port, ref = WRAPPED[name]
    x = np.asarray(POINTS[name], np.float32)
    t = torch.tensor(x, requires_grad=True)
    out = port(t)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax.jit(ref)(jnp.asarray(x))))
    out.backward(torch.ones_like(out))
    want = jax.jit(jax.vmap(jax.grad(ref)))(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64))))


SCALE = np.linspace(0.5, 2, 64).astype(np.float32)
COMPOSED = {
    "sigmoid32": (lambda x: L.sigmoid32(x).sum(),
                  lambda x: jax.nn.sigmoid(x).sum()),
    "softmax32": (lambda x: (L.softmax32(x.reshape(4, -1))
                             * torch.arange(16.0)).sum(),
                  lambda x: (jax.nn.softmax(x.reshape(4, -1))
                             * jnp.arange(16.0)).sum()),
    "row_sum": (lambda x: (L.row_sum(x.reshape(1, -1) ** 2)).sum(),
                lambda x: jnp.sum(x ** 2)),
    "fma32": (lambda x: L.fma32(x, x * 1.5, x * x).sum(),
              lambda x: (x * (x * 1.5) + x * x).sum()),
    "rms_norm": (lambda x: (L.rms_norm({"scale": torch.tensor(SCALE)},
                                       x.reshape(1, 64))
                            * torch.arange(64.0)).sum(),
                 lambda x: (RL.rms_norm({"scale": jnp.asarray(SCALE)},
                                        x.reshape(1, 64))
                            * jnp.arange(64.0)).sum()),
}


@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_composed_functions_differentiate_as_jax(name):
    port, ref = COMPOSED[name]
    x = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    port(t).backward()
    want = np.asarray(jax.jit(jax.grad(ref))(jnp.asarray(x)))
    assert _ulps(t.grad.numpy(), want) <= 4


def test_xla_rsqrt32_is_xlas_rsqrt():
    """XLA:CPU's fp32 ``rsqrt`` (the ``rsqrtps`` estimate and two Newton
    steps) bit for bit over ten decades, where the correctly rounded
    value differs in about one input in eight."""
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.random(50_000) * 4 + 1e-3,
                        10.0 ** rng.uniform(-6, 4, 50_000)]).astype(
                            np.float32)
    want = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(v)))
    got = L.xla_rsqrt32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    rounded = (1 / np.sqrt(v.astype(np.float64))).astype(np.float32)
    assert 0.05 < np.mean(rounded != want) < 0.2


@pytest.mark.parametrize("shape", [(2, 32, 64), (64, 64), (1, 64),
                                   (2, 32, 4, 16), (2, 32, 2, 16),
                                   (2, 27, 64), (2, 24, 3, 16), (2, 22, 64),
                                   (2, 64, 64), (2, 128, 4, 16)])
def test_rms_norm_vjp_is_xlas(shape):
    """``rms_norm``'s value and both gradients equal the reference's VJP
    jitted with runtime inputs, as the compiled step holds them, bit for
    bit: the qwen3-4b smoke step's (B, S, D) block and final norms and
    (B, S, H, D) q/k norms (the scale's reduction vectorized over S, also
    with S rows left over at 24 <= S < 32), one FMA a row below S = 23,
    and rows in one window or windowed (S = 64, 128)."""
    rng = np.random.default_rng(sum(shape))
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    scale = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    g = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)

    def fwd_vjp(x, s, g):
        out, vjp = jax.vjp(lambda x, s: RL.rms_norm({"scale": s}, x), x, s)
        return (out,) + vjp(g)

    out, gx, gs = jax.jit(fwd_vjp)(x, jnp.asarray(scale), g)
    tx = W.to_tensor(np.asarray(x), CPU).requires_grad_()
    ts = torch.tensor(scale, requires_grad=True)
    got = L.rms_norm({"scale": ts}, tx)
    got.backward(W.to_tensor(np.asarray(g), CPU))
    np.testing.assert_array_equal(got.detach().float().numpy(), as_f32(out))
    np.testing.assert_array_equal(tx.grad.float().numpy(), as_f32(gx))
    np.testing.assert_array_equal(ts.grad.numpy(), np.asarray(gs))


def test_silu_vjp_is_xlas():
    """``silu``'s bf16 gradient as XLA computes ``jax.nn.silu``'s, every op
    rounded: bit for bit."""
    rng = np.random.default_rng(7)
    a, g = (jnp.asarray(rng.standard_normal((64, 192)) * 3, jnp.bfloat16)
            for _ in range(2))
    out, vjp = jax.vjp(jax.nn.silu, a)
    (want,) = jax.jit(vjp)(g)
    ta = W.to_tensor(np.asarray(a), CPU).requires_grad_()
    got = L.silu(ta)
    got.backward(W.to_tensor(np.asarray(g), CPU))
    np.testing.assert_array_equal(got.detach().float().numpy(), as_f32(out))
    np.testing.assert_array_equal(ta.grad.float().numpy(), as_f32(want))


GATE_SHAPES = [(2, 32, 64), (4, 31, 64), (2, 40, 70), (3, 33, 65), (1000,)]


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_bf16_sum_is_xlas_bf16_reduction(shape):
    """``layers.bf16_sum`` reduces as XLA:CPU reduces a bf16 tensor (a
    bf16 accumulator, windows of 32 with the padding centred): equal to
    ``lax.reduce`` of the bf16 values, bit for bit."""
    a = jnp.asarray(np.random.default_rng(len(shape)).standard_normal(
        shape), jnp.bfloat16)
    want = jax.jit(lambda x: jax.lax.reduce(
        x, jnp.bfloat16(0), jax.lax.add, tuple(range(x.ndim))))(a)
    assert float(L.bf16_sum(W.to_tensor(np.asarray(a), CPU))) == float(want)


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_gate_gradient_is_xlas(shape):
    """The gated product's backward: ``out``'s gradient bit for bit, the
    gate's (the bf16 reduction of the bf16 products, then tanh's rule)
    within one fp32 ulp (XLA contracts tanh's rule into an FMA or not by
    the reduction's fusion)."""
    rng = np.random.default_rng(len(shape))
    out = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)

    def f(p, o):
        return jnp.tanh(p).astype(o.dtype) * o

    _, vjp = jax.vjp(f, jnp.float32(0.3), out)
    want_gate, want_out = jax.jit(vjp)(g)
    tp = torch.tensor(0.3, requires_grad=True)
    to = W.to_tensor(np.asarray(out), CPU).requires_grad_()
    ATT.gate(ATT.tanh_gates([tp])[0], to).backward(
        W.to_tensor(np.asarray(g), CPU))
    assert _ulps(tp.grad.numpy(), np.asarray(want_gate)) <= 1
    np.testing.assert_array_equal(to.grad.float().numpy(), as_f32(want_out))


# --------------------------------------------------------------- flash --

@pytest.mark.parametrize("window", [0, 8])
def test_flash_vjp_matches_reference(window):
    rng = np.random.default_rng(window)
    b, s, h, hkv, d = 2, 40, 4, 2, 16
    q, k, v, g = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                  for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                                (b, s, h, d)))
    pos = jnp.arange(s, dtype=jnp.int32)

    def f(q, k, v):
        return RL.chunked_attention(q, k, v, pos, pos, causal=True,
                                    window=window, chunk=16)

    want, vjp = jax.vjp(f, q, k, v)
    grads = vjp(g)
    tq, tk, tv = (W.to_tensor(np.asarray(t), CPU).requires_grad_()
                  for t in (q, k, v))
    tpos = torch.arange(s, dtype=torch.int32)
    out = L.chunked_attention(tq, tk, tv, tpos, tpos, causal=True,
                              window=window, chunk=16)
    out.backward(W.to_tensor(np.asarray(g), CPU))
    assert rel_fro(out.detach().float().numpy(), as_f32(want)) < 0.02
    for got, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        assert rel_fro(got.float().numpy(), as_f32(ref)) < 0.02


@pytest.mark.parametrize("b,s,h,hkv,d,chunk,window,seed", [
    (2, 40, 4, 2, 16, 16, 0, 0), (2, 40, 4, 2, 16, 16, 8, 8),
    (1, 1040, 2, 1, 16, 1024, 0, 1040)])
def test_flash_vjp_equals_jitted_reference(b, s, h, hkv, d, chunk, window,
                                           seed):
    """dq, dk and dv equal the jitted reference VJP's bit for bit: the
    backward's products in XLA:CPU's order and layouts (those with an fp32
    operand as FMA chains), delta one chain, the log-sum-exp's log XLA's;
    the last case is hubert-like, sq * skv > 1024^2 (two chunks of 1024,
    the products past the swept grid)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                  for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                                (b, s, h, d)))
    pos = jnp.arange(s, dtype=jnp.int32)

    def vjp(q, k, v, g):
        return jax.vjp(lambda q, k, v: RL.chunked_attention(
            q, k, v, pos, pos, causal=True, window=window, chunk=chunk),
            q, k, v)[1](g)

    grads = jax.jit(vjp)(q, k, v, g)
    tq, tk, tv = (W.to_tensor(np.asarray(t), CPU).requires_grad_()
                  for t in (q, k, v))
    tpos = torch.arange(s, dtype=torch.int32)
    out = L.chunked_attention(tq, tk, tv, tpos, tpos, causal=True,
                              window=window, chunk=chunk)
    out.backward(W.to_tensor(np.asarray(g), CPU))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_array_equal(got.float().numpy(), as_f32(ref))


def test_attention_mixer_vjp_equals_jitted_reference():
    """The attention mixer (``attn_apply``: q/k/v products, q/k norms,
    RoPE, plain attention at 32 keys, the output product) of
    qwen3-4b-smoke: the port's input and parameter gradients equal the
    jitted reference VJP's bit for bit (the softmax backward's row sum as
    XLA's vectorized FMA reduction, ``layers._lane_fma_row_sum``)."""
    from repro.models import attention as RATT
    rcfg, cfg = configs("qwen3-4b", "off")
    spec, rspec = cfg.pattern[0], rcfg.pattern[0]
    rp = RATT.attn_init(jax.random.key(1), rcfg, rspec)
    b, s = 2, 32
    rng = np.random.default_rng(0)
    x, g = (jnp.asarray(rng.standard_normal((b, s, cfg.d_model)),
                        jnp.bfloat16) for _ in range(2))
    pos = jnp.arange(s, dtype=jnp.int32)

    def vjp(p, x, g):
        return jax.vjp(lambda p, x: RATT.attn_apply(p, rcfg, rspec, x, pos),
                       p, x)[1](g)

    rgp, rgx = jax.jit(vjp)(rp, x, g)
    tp = jax.tree.map(lambda a: W.to_tensor(np.asarray(a), CPU)
                      .requires_grad_(), rp)
    tx = W.to_tensor(np.asarray(x), CPU).requires_grad_()
    ATT.attn_apply(tp, cfg, spec, tx, torch.arange(s, dtype=torch.int32)
                   ).backward(W.to_tensor(np.asarray(g), CPU))
    np.testing.assert_array_equal(tx.grad.float().numpy(), as_f32(rgx))
    for name in rp:
        for leaf in rp[name]:
            np.testing.assert_array_equal(tp[name][leaf].grad.numpy(),
                                          as_f32(rgp[name][leaf]))


# ---------------------------------------------------------- train step --

def _state_np(state):
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("name,adder,micro", [
    ("qwen3-4b", "off", 1), ("granite-moe-1b-a400m", "haloc_axa", 1),
    ("qwen3-4b", "haloc_axa", 2)])
def test_train_step_from_reference_state_matches(name, adder, micro):
    rcfg, cfg = configs(name, adder)
    rstate = ref_steps.init_state(jax.random.key(4), rcfg, REF_OPT)
    b = batch_np(rcfg, 4)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, REF_OPT,
                                              microbatches=micro))
    rstate2, rmet = rstep(rstate, ref_batch(b))
    start = W.state_from_reference(_state_np(rstate), cfg, device=CPU)
    state = W.state_from_reference(_state_np(rstate), cfg, device=CPU)
    state2, met = steps.make_train_step(cfg, OPT, microbatches=micro)(
        state, port_batch(b))
    tol = LOSS_TOL
    for key in ("loss", "ce", "aux"):
        assert abs(float(met[key]) - float(rmet[key])) <= tol * max(
            abs(float(rmet[key])), 1e-30), key
    assert abs(float(met["grad_norm"]) - float(rmet["grad_norm"])) <= \
        1e-2 * float(rmet["grad_norm"])
    assert float(met["lr"]) == float(rmet["lr"])
    assert int(state2["step"]) == int(rstate2["step"]) == 1
    assert int(state2["opt"]["count"]) == int(rstate2["opt"]["count"]) == 1
    # m and v leaf by leaf within the gradient tolerance; the parameters'
    # step from the start elementwise: Adam's first step is lr times
    # mh / (|mh| + eps) (mh = m / (1 - b1)) plus the decay, so wherever
    # the two mh agree in sign and exceed 100 eps (or are both zero) the
    # two steps agree within 2 % of lr
    want = W.state_from_reference(_state_np(rstate2), cfg, device=CPU)
    gtol = MOE_GRAD_TOL if cfg.moe is not None else GRAD_TOL
    for part in ("m", "v"):
        for i, (got, ref) in enumerate(zip(leaves(state2["opt"][part]),
                                           leaves(want["opt"][part]),
                                           strict=True)):
            got, ref = got.double().numpy(), ref.double().numpy()
            if not ref.any():
                assert not got.any(), (part, i)
                continue
            assert rel_fro(got, ref) < gtol, (part, i, rel_fro(got, ref))
    lr = float(rmet["lr"])
    for i, (p, rp, p0, m, rm) in enumerate(zip(
            leaves(state2["params"]), leaves(want["params"]),
            leaves(start["params"]), leaves(state2["opt"]["m"]),
            leaves(want["opt"]["m"]), strict=True)):
        held = ((m == 0) & (rm == 0)) | (
            (torch.sign(m) == torch.sign(rm))
            & (torch.minimum(m.abs(), rm.abs()) >= 100 * OPT.eps * (1 - OPT.b1)))
        err = ((p - p0) - (rp - p0))[held].abs()
        assert err.numel() == 0 or float(err.max()) <= 2e-2 * lr, i


@pytest.mark.parametrize("name", arch_names())
def test_smoke_train_step_on_the_port(name):
    """``tests/test_models_smoke.py::test_smoke_train_step`` on the port,
    its parameters from its own generator."""
    cfg = _small(get_smoke_config(name))
    b = port_batch(batch_np(cfg, 0))
    state = steps.init_state(0, cfg, OPT, device=CPU)
    state2, metrics = steps.make_train_step(cfg, OPT)(state, b)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2["step"]) == 1
    logits, _, _ = T.forward(state2["params"], cfg, b, mode="full")
    assert logits.shape == (*b["labels"].shape, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("adder", ["haloc_axa", "loa"])
def test_smoke_train_with_approx_numerics_on_the_port(adder):
    _, cfg = configs("qwen1.5-4b", adder)
    state = steps.init_state(2, cfg, OPT, device=CPU)
    _, metrics = steps.make_train_step(cfg, OPT)(
        state, port_batch(batch_np(cfg, 2)))
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


def test_train_step_raises_for_a_mesh():
    """An abstract mesh (no ranks) cannot run a step; ``batch_axes``
    without a mesh is the unsharded step."""
    from repro_torch.sharding.rules import MeshShape
    cfg = get_smoke_config("qwen3-4b")
    with pytest.raises(TypeError, match="DeviceMesh"):
        steps.make_train_step(cfg, OPT, batch_axes=("data",),
                              mesh=MeshShape(("data", "model"), (2, 1)))
    steps.make_train_step(cfg, OPT, batch_axes=("data",))
