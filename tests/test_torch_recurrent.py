"""The port's recurrent mixers (``repro_torch.models.rglru``/``ssd``) and
the hybrid and SSM models built on them (recurrentgemma-9b, mamba2-1.3b)
against ``repro``'s, on the CPU at the smoke sizes, on the same
numpy-seeded inputs.

The port computes what XLA:CPU's compiled step computes: its fp32
``exp``/``log1p``, its fused multiply-adds, its orders of summation, the
sums its fusions keep in fp32.  Module level (conv and gate biases drawn
nonzero, which the reference's init leaves zero):

- ``causal_conv`` with and without a state, ``_gates`` (the input term
  reading the conv's bias add unrounded), ``rglru_apply`` with and
  without ``h0``, ``rglru_prefill``/``_decode``, ``ssd._ssd_core`` at a
  divisible length and at a short tail, ``ssd_apply`` through its
  remainder path, ``ssd_prefill``/``_decode``: bit for bit (also at the
  reference's own init); ``ssd_apply`` from a start state within the
  reference's rule, max |d| / max(1, max |x|) < 0.04 (a lone jitted step
  fuses its norm's input otherwise);
- the order functions: ``rglru.associative_scan`` against
  ``jax.lax.associative_scan`` (lengths 1 to 2100) and ``ssd.cumsum``
  against ``jnp.cumsum`` under ``jit`` (up to 256, the full config's
  chunk); ``layers.xla_exp32``/``xla_log1p32``/``sigmoid32``/
  ``softplus32``/``fma32``/``sqrt32`` and ``row_sum``, bit for bit.

Model level, both smoke configs, exact adds and haloc_axa, with
``test_torch_lm_serving.py``'s helpers (the reference's greedy run of 4 x
(20 + 12) tokens):

- ``forward`` in the full, prefill and decode modes within the rule; the
  prefill cache within it, its dtypes the reference's (fp32 ``h`` and
  ``state``, bf16 conv states);
- teacher-forced ``generate`` within the rule, and the port's greedy run
  returning its own teacher-forced logits;
- the full-mode and teacher-forced logits equal the reference's bit for
  bit under haloc_axa at seeds 1 and 2 and with every bias drawn nonzero
  (and with exact adds for mamba2-1.3b; recurrentgemma-9b's exact adds
  are within the rule: ROADMAP Queue C 2);
- the reference's prefill/decode parity test (exact adds) run on the
  port; under haloc_axa the port's full, prefill and decode logits on its
  own parameters equal the reference's on them (mamba2-1.3b's decode
  figure is outside the rule there, in the reference too: Queue C 11);
- ``launch.serve.main`` on the CPU for both archs;
- the bf16 trees keep ``lam``, ``a_log`` and ``dt_bias`` in fp32, the
  parameter and cache shapes follow the reference's, and ``forward``
  builds RoPE tables only for the blocks that rotate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import layers as RL
from repro.models import rglru as RR
from repro.models import ssd as RS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import ssd as SS
from repro_torch.models import transformer as T
from repro_torch.models import weights as W
from repro_torch.models.serving import generate, teacher_forced_logits

import test_torch_lm_serving as LM
from test_torch_lm_serving import (NEW, PROMPT, TOL, _shapes, _unstacked,
                                   f32, port_cfg, reference_run, rel_err)

RG_ARCH, SSD_ARCH = "recurrentgemma-9b", "mamba2-1.3b"
ARCHS = (RG_ARCH, SSD_ARCH)
CPU = "cpu"


def bits(x):
    return f32(x).view(np.int32)


def assert_equal(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def bf16_pair(rng, shape, scale=1.0):
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                    jnp.bfloat16)
    return a, W.to_tensor(np.asarray(a), CPU)


def to_port(tree):
    return W._map(jax.tree.map(np.asarray, tree),
                  lambda a, _p: W.to_tensor(a, CPU))


@functools.lru_cache(maxsize=None)
def mixer(arch, seed):
    """(ref cfg, cfg, ref spec, spec, ref params, port params) of the smoke
    config's first mixer, its biases drawn nonzero (the reference's init
    leaves them zero)."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rspec, spec = rcfg.pattern[0], cfg.pattern[0]
    if arch == RG_ARCH:
        rp = RR.rglru_init(jax.random.key(seed), rcfg, rspec)
        names = (("conv_b",), ("wa", "b"), ("wi", "b"))
    else:
        rp = RS.ssd_init(jax.random.key(seed), rcfg, rspec)
        names = (("conv_x", "b"), ("conv_bc", "b"))
    rng = np.random.default_rng(seed + 100)
    for path in names:
        node = rp
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = jnp.asarray(
            rng.standard_normal(node[path[-1]].shape).astype(np.float32)
            * 0.3)
    return rcfg, cfg, rspec, spec, rp, to_port(rp)


# ------------------------------------------------------- order functions --

def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16, 31, 100, 2100])
def test_associative_scan_order_equals_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (3, n, 40)).astype(np.float32)
    b = rng.standard_normal((3, n, 40)).astype(np.float32)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1)[1])(a, b)
    got = RG.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 8, 16, 17, 31, 88, 256])
def test_cumsum_order_equals_jnp(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((2, 3, n, 8)) * 0.1).astype(np.float32)
    want = jax.jit(lambda x: jnp.cumsum(x, axis=2))(x)
    assert_equal(SS.cumsum(torch.from_numpy(x), dim=2), want)


def test_fp32_functions_equal_xla():
    rng = np.random.default_rng(0)
    edge = [0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -2.0, 88.9, -87.5]
    cases = (
        (jnp.exp, L.xla_exp32, rng.uniform(-90, 90, 200000)),
        (jnp.log1p, L.xla_log1p32, np.concatenate([
            rng.uniform(-0.99, 3, 100000),
            np.exp(rng.uniform(-30, 0, 100000))])),
        (jax.nn.sigmoid, L.sigmoid32, rng.standard_normal(200000) * 8),
        (jax.nn.softplus, L.softplus32, rng.standard_normal(200000) * 8),
        # correctly rounded, as the model's fusions take it (a lone jitted
        # jnp.sqrt is another routine)
        (np.sqrt, L.sqrt32, rng.uniform(0, 2, 200000)))
    for jf, tf, x in cases:
        x = np.concatenate([x, edge]).astype(np.float32)
        with np.errstate(invalid="ignore"):
            want = np.asarray(jf(x) if jf is np.sqrt else jax.jit(jf)(x))
        got = tf(torch.from_numpy(x)).numpy()
        same = (got.view(np.int32) == want.view(np.int32)) | (
            np.isnan(got) & np.isnan(want))
        assert same.all(), (jf, x[~same][:4], got[~same][:4],
                            want[~same][:4])
    a, b, c = (rng.standard_normal(200000).astype(np.float32)
               for _ in range(3))
    assert_equal(L.fma32(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(c)),
                 jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    for width in (16, 64, 128, 2048):
        x = (rng.standard_normal((4, 9, width)) ** 2).astype(np.float32)
        assert_equal(L.row_sum(torch.from_numpy(x)),
                     jax.jit(lambda x: jnp.sum(x, axis=-1))(x))


# ---------------------------------------------------------------- rglru --

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rcfg, cfg, _, _, rp, p = mixer(RG_ARCH, 1)
    rng = np.random.default_rng(2)
    xj, xt = bf16_pair(rng, (3, 9, cfg.rglru.width))
    sj, st = bf16_pair(rng, (3, 3, cfg.rglru.width))
    want, wstate = jax.jit(lambda p, x, s: RR.causal_conv(
        x, p["conv_w"], p["conv_b"], s if with_state else None))(rp, xj, sj)
    got, gstate = RG.causal_conv(xt, p["conv_w"], p["conv_b"],
                                 st if with_state else None)
    assert got.dtype == torch.bfloat16
    assert_equal(got, want)
    assert_equal(gstate, wstate)


def test_gates_match_reference():
    rcfg, cfg, _, _, rp, p = mixer(RG_ARCH, 3)
    xj, xt = bf16_pair(np.random.default_rng(3), (4, 11, cfg.d_model))

    def ref(p, x):
        u, _ = RR.causal_conv(RL.dense(p["proj_x"], x), p["conv_w"],
                              p["conv_b"])
        return RR._gates(p, rcfg, u)

    a, bterm = jax.jit(ref)(rp, xj)
    u_conv, u32, _, _ = RG._branches(p, xt)
    ga, gb = RG._gates(p, cfg, u_conv, u32)
    assert ga.dtype == gb.dtype == torch.float32
    assert_equal(ga, a)
    # i * u reads the conv's bias add unrounded, as XLA's fusion does
    assert_equal(gb, bterm)
    assert not torch.equal(RG._gates(p, cfg, u_conv, u_conv.float())[1],
                           gb)


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_apply_matches_reference(h0):
    rcfg, cfg, rspec, spec, rp, p = mixer(RG_ARCH, 4)
    rng = np.random.default_rng(4)
    xj, xt = bf16_pair(rng, (4, 31, cfg.d_model))
    hj = rng.standard_normal((4, cfg.rglru.width)).astype(np.float32)
    want, (wh, wc) = jax.jit(lambda p, x, h: RR.rglru_apply(
        p, rcfg, rspec, x, h0=h if h0 else None))(rp, xj, hj)
    got, (gh, gc) = RG.rglru_apply(p, cfg, spec, xt,
                                   h0=torch.from_numpy(hj) if h0 else None)
    assert got.dtype == torch.bfloat16 and gh.dtype == torch.float32
    assert_equal(got, want)
    assert_equal(gh, wh)
    assert_equal(gc, wc)


def test_rglru_prefill_and_decode_match_reference():
    rcfg, cfg, rspec, spec, rp, p = mixer(RG_ARCH, 5)
    rng = np.random.default_rng(5)
    xs = [bf16_pair(rng, (2, 13, cfg.d_model))] + [
        bf16_pair(rng, (2, 1, cfg.d_model)) for _ in range(4)]
    cache = RR.rglru_cache_init(rcfg, 2)
    pc = RG.rglru_cache_init(cfg, 2, device=CPU)
    fns = (jax.jit(lambda p, x, c: RR.rglru_prefill(p, rcfg, rspec, x, c)),
           jax.jit(lambda p, x, c: RR.rglru_decode(p, rcfg, rspec, x, c)))
    for i, (xj, xt) in enumerate(xs):
        want, cache = fns[min(i, 1)](rp, xj, cache)
        step = RG.rglru_prefill if i == 0 else RG.rglru_decode
        got, pc = step(p, cfg, spec, xt, pc)
        assert pc["h"].dtype == torch.float32
        assert pc["conv"].dtype == torch.bfloat16
        assert_equal(got, want)
        assert_equal(pc["h"], cache["h"])
        assert_equal(pc["conv"], cache["conv"])


def test_rglru_mixer_equals_reference_bit_for_bit_at_its_init():
    """With the reference's own init (zero biases) the outputs, the last
    state and a decode step equal the reference's bit for bit."""
    rcfg, cfg = ref_smoke(RG_ARCH), get_smoke_config(RG_ARCH)
    rspec, spec = rcfg.pattern[0], cfg.pattern[0]
    for seed in range(3):
        rp = RR.rglru_init(jax.random.key(seed), rcfg, rspec)
        p = to_port(rp)
        rng = np.random.default_rng(seed)
        xj, xt = bf16_pair(rng, (4, 31, cfg.d_model))
        hj = rng.standard_normal((4, cfg.rglru.width)).astype(np.float32)
        want, (wh, _) = jax.jit(lambda p, x, h: RR.rglru_apply(
            p, rcfg, rspec, x, h0=h))(rp, xj, hj)
        got, (gh, _) = RG.rglru_apply(p, cfg, spec, xt,
                                      h0=torch.from_numpy(hj))
        assert_equal(got, want)
        assert_equal(gh, wh)
        cache = {"h": jnp.asarray(hj), "conv": xj[:, :3]}
        want, wc = jax.jit(lambda p, x, c: RR.rglru_decode(
            p, rcfg, rspec, x, c))(rp, xj[:, 5:6], cache)
        got, gc = RG.rglru_decode(p, cfg, spec, xt[:, 5:6], {
            "h": torch.from_numpy(hj), "conv": xt[:, :3]})
        assert_equal(got, want)
        assert_equal(gc["h"], wc["h"])


# ------------------------------------------------------------------ ssd --

def _ssd_inputs(seed, s):
    rcfg, cfg, rspec, spec, rp, p = mixer(SSD_ARCH, seed)
    rng = np.random.default_rng(seed)
    xj, xt = bf16_pair(rng, (4, s, cfg.d_model))
    heads = cfg.ssd.d_inner // cfg.ssd.head_dim
    s0 = (rng.standard_normal((4, heads, cfg.ssd.d_state, cfg.ssd.head_dim))
          * 0.5).astype(np.float32)
    return rcfg, cfg, rspec, spec, rp, p, xj, xt, s0


@pytest.mark.parametrize("s,state", [(16, False), (16, True), (31, False),
                                     (31, True)])
def test_ssd_apply_matches_reference(s, state):
    """16 is two whole chunks of the smoke config's 8; 31 takes the
    remainder path (three chunks and a 7-token tail)."""
    rcfg, cfg, rspec, spec, rp, p, xj, xt, s0 = _ssd_inputs(6, s)
    want, (wh, wx, wb) = jax.jit(lambda p, x, s0: RS.ssd_apply(
        p, rcfg, rspec, x, state0=s0 if state else None))(rp, xj, s0)
    got, (gh, gx, gb) = SS.ssd_apply(
        p, cfg, spec, xt, state0=torch.from_numpy(s0) if state else None)
    assert got.dtype == torch.bfloat16 and gh.dtype == torch.float32
    assert_equal(gh, wh)
    assert_equal(gx, wx)
    assert_equal(gb, wb)
    if state:       # the norm's input is fused otherwise: within the rule
        assert rel_err(got, want) < TOL
    else:
        assert_equal(got, want)


@pytest.mark.parametrize("s,q", [(24, 8), (7, 7)])
def test_ssd_core_matches_reference(s, q):
    rcfg, cfg, rspec, spec, rp, p, xj, xt, s0 = _ssd_inputs(7, s)

    def ref(p, x, s0):
        z, xh, bh, ch, dt, ld, _, _ = RS._project(p, rcfg, x)
        return RS._ssd_core(p, rcfg, xh, bh, ch, dt, ld, q, s0)

    want, wh = jax.jit(ref)(rp, xj, s0)
    z, xh, bh, ch, dt, ld, _, _ = SS._project(p, cfg, xt)
    got, gh = SS._ssd_core(cfg, xh, bh, ch, dt, ld, q,
                           torch.from_numpy(s0))
    assert_equal(got, want)
    assert_equal(gh, wh)


def test_ssd_prefill_and_decode_match_reference():
    rcfg, cfg, rspec, spec, rp, p, _, _, _ = _ssd_inputs(8, 1)
    rng = np.random.default_rng(8)
    xs = [bf16_pair(rng, (2, 13, cfg.d_model))] + [
        bf16_pair(rng, (2, 1, cfg.d_model)) for _ in range(4)]
    cache = RS.ssd_cache_init(rcfg, 2)
    pc = SS.ssd_cache_init(cfg, 2, device=CPU)
    fns = (jax.jit(lambda p, x, c: RS.ssd_prefill(p, rcfg, rspec, x, c)),
           jax.jit(lambda p, x, c: RS.ssd_decode(p, rcfg, rspec, x, c)))
    for i, (xj, xt) in enumerate(xs):
        want, cache = fns[min(i, 1)](rp, xj, cache)
        step = SS.ssd_prefill if i == 0 else SS.ssd_decode
        got, pc = step(p, cfg, spec, xt, pc)
        assert pc["state"].dtype == torch.float32
        assert pc["conv_x"].dtype == pc["conv_bc"].dtype == torch.bfloat16
        assert_equal(got, want)
        for key in ("state", "conv_x", "conv_bc"):
            assert_equal(pc[key], cache[key])


# ---------------------------------------------------------------- model --

@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
@pytest.mark.parametrize("name", ARCHS)
def test_forward_modes_match_reference(name, adder):
    tree, toks, ref_steps_, ref_cache, ref_full, _ = reference_run(name,
                                                                   adder)
    cfg = port_cfg(name, adder)
    params = W.from_reference(tree, cfg, device=CPU)
    full, cache, aux = T.forward(params, cfg, {"tokens": toks[:, :-1]})
    assert cache is None and float(aux) == 0.0
    assert full.shape == ref_full.shape and full.dtype == torch.bfloat16
    errs = {"full": rel_err(full, ref_full)}
    _, pc = steps.make_prefill_step(cfg, PROMPT + NEW)(
        params, {"tokens": toks[:, :PROMPT]})
    want = W.cache_from_reference(ref_cache, cfg, device=CPU)
    for got_c, want_c in zip(T.blocks_in_order(cfg, pc),
                             T.blocks_in_order(cfg, want), strict=True):
        assert sorted(got_c) == sorted(want_c)
        for key, w in want_c.items():
            assert got_c[key].dtype == w.dtype, key
            if key == "pos":
                assert torch.equal(got_c["pos"], w)
                continue
            assert w.dtype == (torch.float32 if key in ("h", "state")
                               else torch.bfloat16)
            errs["cache"] = max(errs.get("cache", 0.0),
                                rel_err(got_c[key], w))
    tf = teacher_forced_logits(params, cfg, toks, PROMPT)
    errs["prefill"] = rel_err(tf[:, 0], ref_steps_[:, 0])
    errs["decode"] = max(rel_err(tf[:, i], ref_steps_[:, i])
                         for i in range(1, NEW))
    print(name, adder, errs)
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
@pytest.mark.parametrize("name", ARCHS)
def test_generate_teacher_forced_against_reference(name, adder):
    tree, toks, ref_steps_, *_ = reference_run(name, adder)
    cfg = port_cfg(name, adder)
    params = W.from_reference(tree, cfg, device=CPU, dtype=torch.bfloat16)
    tf = f32(teacher_forced_logits(params, cfg, toks, PROMPT))
    for i in range(NEW):
        assert rel_err(tf[:, i], ref_steps_[:, i]) < TOL, i
    got, logits = generate(params, cfg, {"tokens": toks[:, :PROMPT]}, NEW,
                           return_logits=True)
    assert got.shape == toks.shape
    assert torch.equal(logits, teacher_forced_logits(params, cfg, got,
                                                     PROMPT))
    assert torch.equal(got[:, PROMPT:], logits.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("name,adder,seed", [
    (RG_ARCH, "haloc_axa", 1), (RG_ARCH, "haloc_axa", 2),
    (SSD_ARCH, "haloc_axa", 1), (SSD_ARCH, "haloc_axa", 2),
    (SSD_ARCH, "off", 1)])
def test_logits_equal_reference(name, adder, seed):
    """Under haloc_axa the adder turns a one-ulp difference into up to 2^m
    units, so the mixers must round as XLA:CPU rounds: full-mode and
    teacher-forced logits equal, bit for bit."""
    tree, toks, ref_steps_, _, ref_full, _ = (
        reference_run(name, adder) if seed == 1
        else reference_run(name, adder, seed))
    cfg = port_cfg(name, adder)
    params = W.from_reference(tree, cfg, device=CPU, dtype=torch.bfloat16)
    full, _, _ = T.forward(params, cfg, {"tokens": toks[:, :-1]})
    np.testing.assert_array_equal(f32(full), ref_full)
    tf = teacher_forced_logits(params, cfg, toks, PROMPT)
    np.testing.assert_array_equal(f32(tf), ref_steps_)


#: The bias leaves the reference's init leaves zero, drawn nonzero below.
BIASES = {RG_ARCH: ("conv_b", "b"), SSD_ARCH: ("b",)}


@pytest.mark.parametrize("name", ARCHS)
def test_haloc_axa_logits_equal_reference_with_nonzero_biases(name):
    """The reference's parameters with every conv and gate bias drawn
    nonzero (its init leaves them zero, so the other model tests cannot
    see where a bias add is rounded): the greedy run's teacher-forced and
    full-mode logits under haloc_axa equal the reference's bit for bit."""
    rcfg, init, prefill, decode, forward = LM.reference_steps(name,
                                                              "haloc_axa")
    rng = np.random.default_rng(3)

    def draw(path, a):
        keys = [getattr(k, "key", None) for k in path]
        if any(k == "mixer" for k in keys) and keys[-1] in BIASES[name]:
            return jnp.asarray(rng.standard_normal(a.shape).astype(
                np.float32) * 0.5)
        return a

    rp = jax.tree_util.tree_map_with_path(draw, init(jax.random.key(1),
                                                     rcfg))
    prompt = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (LM.BATCH, PROMPT)).astype(np.int32)
    logits, cache = prefill(rp, {"tokens": jnp.asarray(prompt)})
    toks, want = [prompt], []
    for i in range(NEW):
        want.append(f32(logits[:, -1]))
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
        toks.append(nxt[:, None])
        if i < NEW - 1:
            logits, cache = decode(rp, {"tokens": jnp.asarray(nxt[:, None])},
                                   jnp.int32(PROMPT + i), cache)
    toks = np.concatenate(toks, axis=1)
    want_full = f32(forward(rp, jnp.asarray(toks[:, :-1]))[0])
    cfg = port_cfg(name, "haloc_axa")
    params = W.from_reference(jax.tree.map(np.asarray, rp), cfg, device=CPU,
                              dtype=torch.bfloat16)
    full = T.forward(params, cfg, {"tokens": toks[:, :-1]})[0]
    np.testing.assert_array_equal(f32(full), want_full)
    np.testing.assert_array_equal(
        f32(teacher_forced_logits(params, cfg, toks, PROMPT)),
        np.stack(want, axis=1))


def to_reference(params):
    """The port's parameter tree in the reference's layout (each pattern
    position's blocks stacked) as jax arrays."""
    def leaves(tree):
        return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), tree)

    out = {k: leaves(v) for k, v in params.items() if k != "pattern"}
    out["pattern"] = [jax.tree.map(lambda *xs: jnp.stack(xs),
                                   *[leaves(b) for b in blocks])
                      for blocks in params["pattern"]]
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_parity_on_the_recurrent_port(name):
    """``tests/test_models_smoke.py::test_smoke_prefill_decode_parity``
    (exact adds), run on the port."""
    LM.test_prefill_decode_parity_on_the_port(name, "off")


@pytest.mark.parametrize("name", ARCHS)
def test_haloc_axa_parity_figures_equal_the_reference_s(name):
    """The parity test's setting under haloc_axa: the port's full,
    prefill and decode logits on its own parameters equal the reference's
    on the same parameters, bit for bit, so the prefill/decode figure is
    the reference's own.  It passes the 0.04 rule for recurrentgemma-9b;
    mamba2-1.3b's decode step (the recurrent form) and its full forward
    (the chunked form) round differently and the adder amplifies that, in
    the reference too (ROADMAP Queue C 11)."""
    cfg = port_cfg(name, "haloc_axa")
    rcfg = LM.reference_steps(name, "haloc_axa")[0]
    params = T.init_params(1, cfg, device=CPU)
    b, s = 2, 24
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    full, _, _ = T.forward(params, cfg, {"tokens": tokens})
    pre, cache = steps.make_prefill_step(cfg, s)(
        params, {"tokens": tokens[:, :s - 1]})
    dec, _ = steps.make_decode_step(cfg)(
        params, {"tokens": tokens[:, s - 1:]}, s - 1, cache)
    rp, toks = to_reference(params), jnp.asarray(tokens.numpy(), jnp.int32)
    want_full = jax.jit(lambda p, t: LM.RT.forward(
        p, rcfg, {"tokens": t})[0])(rp, toks)
    want_pre, rc = jax.jit(ref_steps.make_prefill_step(rcfg, s))(
        rp, {"tokens": toks[:, :s - 1]})
    want_dec, _ = jax.jit(ref_steps.make_decode_step(rcfg))(
        rp, {"tokens": toks[:, s - 1:]}, jnp.int32(s - 1), rc)
    for got, want in ((full, want_full), (pre, want_pre), (dec, want_dec)):
        np.testing.assert_array_equal(f32(got), f32(want))
    rel = rel_err(dec[:, 0], full[:, s - 1])
    print(f"{name} haloc_axa: decode against full {rel:.4f}")
    assert rel_err(pre[:, 0], full[:, s - 2]) < TOL
    if name == RG_ARCH:
        assert rel < TOL


@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_main_on_the_cpu(name, capsys):
    serve.main(["--arch", name, "--smoke", "--device", "cpu", "--adder",
                "haloc_axa", "--batch", "2", "--prompt-len", "11",
                "--new-tokens", "3"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith(f"{name}-smoke: (2, 14); "), out
    assert "(3 steps x batch 2 in " in out and " tok/s " in out


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_trees_keep_the_fp32_leaves(name):
    cfg = get_smoke_config(name)
    fp32 = ("lam",) if name == RG_ARCH else ("a_log", "dt_bias")
    trees = [T.init_params(2, cfg, device=CPU, dtype=torch.bfloat16)]
    tree, *_ = reference_run(name, "off")
    trees.append(W.from_reference(tree, cfg, device=CPU,
                                  dtype=torch.bfloat16))
    for params in trees:
        for spec, blk in zip(cfg.all_blocks(),
                             T.blocks_in_order(cfg, params)):
            if spec.mixer == "attn":
                continue
            m = blk["mixer"]
            for key in fp32:
                assert m[key].dtype == torch.float32, key
            assert blk["ln1"]["scale"].dtype == torch.float32
            w = m["proj_x"]["w"] if name == RG_ARCH else m["in_x"]["w"]
            assert w.dtype == torch.bfloat16
    # the port's own draws follow the reference's distributions
    m = trees[0]["pattern"][0][0]["mixer"]
    if name == RG_ARCH:
        a = torch.exp(-cfg.rglru.c_exponent * torch.nn.functional.softplus(
            m["lam"]))
        assert float(a.min()) >= 0.9 - 1e-4 and float(a.max()) <= 0.999
    else:
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.101


def test_params_and_cache_shapes_follow_the_reference():
    for name in ARCHS:
        cfg, rcfg = get_config(name), ref_get_config(name)
        got = steps.params_shapes(cfg)
        want = ref_steps.params_shapes(rcfg)
        assert T.param_count(got) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(want))
        assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                            _unstacked(want, rcfg.repeats)) == _shapes(got), \
            name
        cs = steps.cache_shapes(cfg, 4, 160)
        rcs = _unstacked(ref_steps.cache_shapes(rcfg, 4, 160), rcfg.repeats)
        for c, rc in zip(T.blocks_in_order(cfg, cs),
                         T.blocks_in_order(cfg, rcs), strict=True):
            assert _shapes(c) == {k: (tuple(v.shape), str(v.dtype))
                                  for k, v in rc.items()}


def test_forward_builds_rope_tables_only_for_rotating_blocks(monkeypatch):
    """One table pair per (base, dims) of the blocks that rotate: none for
    the recurrent mixers, none for cross attention (llama-3.2-vision-11b's
    self blocks rotate at base 500000, its cross blocks not at all), one
    for hubert-xlarge's encoder blocks."""
    import dataclasses
    from repro_torch.models.config import BlockSpec
    calls = []
    real = L.rope_tables
    monkeypatch.setattr(L, "rope_tables",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    vision = get_smoke_config("llama-3.2-vision-11b")
    vision = dataclasses.replace(vision, pattern=(
        BlockSpec(rope_base=500_000.0), BlockSpec(mixer="cross")))
    cases = ((get_smoke_config(SSD_ARCH), 0), (get_smoke_config(RG_ARCH), 1),
             (vision, 1), (get_smoke_config("hubert-xlarge"), 1))
    for cfg, want in cases:
        calls.clear()
        params = T.init_params(0, cfg, device=CPU)
        if cfg.audio is not None:
            batch = {"frames": torch.zeros((1, 5, cfg.audio.feat_dim))}
        else:
            batch = {"tokens": np.zeros((1, 5), np.int32)}
        if cfg.vision is not None:
            batch["vision"] = torch.zeros((1, cfg.vision.seq_len,
                                           cfg.vision.embed_dim))
        T.forward(params, cfg, batch)
        assert len(calls) == want, cfg.name
        if cfg is vision:
            assert calls[0][2] == 500_000.0     # the self blocks' base
