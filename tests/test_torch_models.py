"""The port's LM modules (``repro_torch.numerics.approx_ops``,
``configs``, ``models.layers``, ``models.attention``,
``models.transformer``) against ``repro``'s, on the CPU.

Inputs come from numpy seeds; parameters are the reference's
``init_params`` carried across by ``models.weights.from_reference``.

- ``make_numerics`` gives the reference's spec, format, ``where`` and
  ``fast`` for every adder kind and ``where``, raises the same errors,
  and its shims warn;
- every config of the ten archs equals the reference's field for field
  (less ``approx.backend`` and ``approx.device``);
- each layer function equals the reference in fp32 (rtol 1e-5, atol
  1e-6) and in bf16 within one bf16 ulp of the output's largest
  magnitude (2^-7 of it);
- attention's apply, both prefill branches and decode, clamps included:
  outputs and caches' k/v within bf16 tolerance, ``pos`` exactly;
- a block with the GELU MLP; the unported mixers and inputs raise.

The transformer's forward modes and generation are held in
``test_torch_lm_serving.py``.  The reference runs under ``jax.jit``.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_names as ref_arch_names
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.core.specs import AdderSpec as RefSpec
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.config import BlockSpec as RefBlockSpec
from repro.numerics import approx_ops as ref_ops
from repro.numerics.fixed_point import FixedPointFormat as RefFormat
from repro_torch.ax import registered_kinds
from repro_torch.configs import SHAPES, SKIPS, arch_names, cells, \
    get_config, get_smoke_config
from repro_torch.core.specs import AdderSpec
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import transformer as T
from repro_torch.models import weights as W
from repro_torch.models.config import BlockSpec
from repro_torch.numerics import approx_ops as ops
from repro_torch.numerics.fixed_point import FixedPointFormat

DENSE = ("qwen3-4b", "gemma3-27b", "qwen1.5-4b", "qwen1.5-32b")
#: The reference's parity rule (tests/test_models_smoke.py).
TOL = 0.04
CPU = "cpu"


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def f32(x):
    """A jax array or a tensor as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def pair(a, jdt, tdt):
    return jnp.asarray(a).astype(jdt), torch.as_tensor(a).to(tdt)


def assert_close(got, want, dtype, what=""):
    g, w = f32(got), f32(want)
    if dtype == "fp32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)
    else:   # one bf16 ulp of the largest magnitude
        np.testing.assert_array_less(
            np.abs(g - w), np.abs(w).max() * 2.0 ** -7 + 1e-30,
            err_msg=what)


@functools.lru_cache(maxsize=None)
def _jitted(fn, kw):
    kw = dict(kw)
    return jax.jit(lambda *a: fn(*a, **kw))


def ref(fn, *args, **kw):
    """The reference's ``fn(*args, **kw)`` under ``jax.jit`` (keyword
    arguments static; one compile per function, keywords and shapes)."""
    return _jitted(fn, tuple(sorted(kw.items())))(*args)


DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------ approx_ops --

def _spec_tuple(spec):
    return (spec.kind, spec.n_bits, spec.lsm_bits, spec.const_bits)


@pytest.mark.parametrize("where", ("off", "residual", "residual+logits"))
def test_make_numerics_matches_reference(where):
    for kind in registered_kinds():
        for kw in ({}, {"n_bits": 12, "frac_bits": 4}, {"lsm_bits": 6},
                   {"const_bits": 1, "fast": True}):
            try:
                want = ref_ops.make_numerics(kind, where, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    ops.make_numerics(kind, where, backend="torch",
                                      device=CPU, **kw)
                continue
            got = ops.make_numerics(kind, where, backend="torch",
                                    device=CPU, **kw)
            assert _spec_tuple(got.spec) == _spec_tuple(want.spec), kind
            assert (got.fmt.n_bits, got.fmt.frac_bits) == \
                (want.fmt.n_bits, want.fmt.frac_bits)
            assert (got.where, got.fast, got.enabled) == \
                (want.where, want.fast, want.enabled)
            assert (got.backend, got.device) == ("torch", CPU)
    with pytest.raises(ValueError, match="unknown adder kind"):
        ops.make_numerics("nope", "residual")
    with pytest.raises(ValueError, match="unknown adder kind"):
        ref_ops.make_numerics("nope", "residual")


def test_numerics_config_validation_engine_and_defaults():
    cfg = ops.ApproxNumericsConfig()
    assert (cfg.backend, cfg.device, cfg.where, cfg.enabled) == \
        ("cuda", None, "off", False)
    x = torch.linspace(-2, 2, 7, dtype=torch.bfloat16)
    assert torch.equal(cfg.residual_add(x, x), x + x)   # no engine built
    with pytest.raises(ValueError, match="bad approx 'where'"):
        ops.ApproxNumericsConfig(where="logits")
    with pytest.raises(ValueError, match="must match"):
        ops.ApproxNumericsConfig(spec=AdderSpec("haloc_axa", 16, 8, 4),
                                 fmt=FixedPointFormat(12, 4))
    on = ops.make_numerics("haloc_axa", "residual+logits", backend="torch",
                           device=CPU)
    eng = on.engine
    assert eng.backend.name == "torch" and eng.device.type == "cpu"
    assert eng is on.engine
    assert eng.spec == AdderSpec("haloc_axa", 16, 8, 4)
    ref = ref_ops.make_numerics("haloc_axa", "residual+logits")
    xs = np.linspace(-3, 3, 40, dtype=np.float32)
    ys = xs[::-1].copy()
    np.testing.assert_array_equal(
        on.residual_add(torch.as_tensor(xs), torch.as_tensor(ys)).numpy(),
        np.asarray(ref.residual_add(jnp.asarray(xs), jnp.asarray(ys))))


def test_deprecated_shims_warn_and_match():
    spec = AdderSpec("haloc_axa", 16, 8, 4)
    rspec = RefSpec("haloc_axa", 16, 8, 4)
    fmt, rfmt = FixedPointFormat(16, 8), RefFormat(16, 8)
    rng = np.random.default_rng(5)
    qx = rng.integers(-30000, 30000, 64).astype(np.int32)
    qy = rng.integers(-30000, 30000, 64).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want_add = ref_ops.approx_add_signed(qx, qy, rspec, rfmt)
        want_sum = np.asarray(ref_ops.approx_sum(jnp.asarray(qx), rspec,
                                                 rfmt))
    with pytest.warns(DeprecationWarning, match="approx_add_signed"):
        got = ops.approx_add_signed(qx, qy, spec, fmt)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want_add)
    with pytest.warns(DeprecationWarning, match="approx_sum"):
        got = ops.approx_sum(torch.as_tensor(qx), spec, fmt)
    assert int(got) == int(want_sum)
    cfg = ops.make_numerics("haloc_axa", "residual", backend="torch",
                            device=CPU)
    x = torch.linspace(-1, 1, 9)
    with pytest.warns(DeprecationWarning, match="approx_residual_add"):
        assert torch.equal(ops.approx_residual_add(x, x, cfg),
                           cfg.residual_add(x, x))
    for kind in registered_kinds():
        for m, k in ((8, 4), (6, 0), (10, 5)):
            try:
                rs = RefSpec(kind, 16, m, k)
            except ValueError:
                continue
            assert ops.effective_lsb_bias(AdderSpec(kind, 16, m, k)) == \
                ref_ops.effective_lsb_bias(rs)


# --------------------------------------------------------------- configs --

def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["approx"].pop("backend")
    d["approx"].pop("device", None)
    return d


def test_configs_equal_reference_field_for_field():
    assert arch_names() == ref_arch_names()
    from repro import configs as ref_configs
    assert SHAPES == ref_configs.SHAPES and SKIPS == ref_configs.SKIPS
    assert cells() == ref_configs.cells()
    assert cells(True) == ref_configs.cells(True)
    for name in arch_names():
        assert _fields(get_config(name)) == _fields(ref_get_config(name))
        assert _fields(get_smoke_config(name)) == \
            _fields(ref_get_smoke(name))
        assert get_config(name).approx.backend == "cuda"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


# ---------------------------------------------------------------- layers --

def _qkv_arrays(rng, b, sq, skv, h, hkv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ("fp32", "bf16"))
def test_dense_norm_rope_mlps(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    xj, xt = pair(x, jdt, tdt)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    pj = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    pt = {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}
    assert_close(PL.dense(pt, xt), ref(RL.dense, pj, xj), dtype, "dense")
    sc = rng.standard_normal(64).astype(np.float32)
    assert_close(PL.rms_norm({"scale": torch.as_tensor(sc)}, xt),
                 ref(RL.rms_norm, {"scale": jnp.asarray(sc)}, xj), dtype, "rms")
    for base in (1e4, 1e6):
        pos = np.arange(3, 27, dtype=np.int32)
        cj, sj = ref(RL.rope_tables, jnp.asarray(pos), dim=16, base=base)
        ct, st = PL.rope_tables(torch.as_tensor(pos), 16, base)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        cr, sr = PL.rope_tables(range(3, 27), 16, base, CPU)
        assert torch.equal(cr, ct) and torch.equal(sr, st)
        q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
        qj, qt = pair(q, jdt, tdt)
        assert_close(PL.apply_rope(qt, ct, st), ref(RL.apply_rope, qj, cj, sj),
                     dtype, "rope")
    mlp = {k: (rng.standard_normal(s) / 8).astype(np.float32) for k, s in
           (("wi", (64, 160)), ("wg", (64, 160)), ("wo", (160, 64)))}
    assert_close(PL.swiglu({k: {"w": torch.as_tensor(v)}
                            for k, v in mlp.items()}, xt),
                 ref(RL.swiglu, {k: {"w": jnp.asarray(v)}
                                 for k, v in mlp.items()}, xj),
                 dtype, "swiglu")
    gm = {"wi": {"w": mlp["wi"], "b": b[:1].repeat(160)},
          "wo": {"w": mlp["wo"], "b": b[:64]}}
    assert_close(
        PL.gelu_mlp({k: {n: torch.as_tensor(a) for n, a in v.items()}
                     for k, v in gm.items()}, xt),
        ref(RL.gelu_mlp, {k: {n: jnp.asarray(a) for n, a in v.items()}
                          for k, v in gm.items()}, xj), dtype, "gelu_mlp")
    if dtype == "bf16":   # the reference's rounding, op for op
        y = xt * 3
        assert torch.equal(PL.silu(y), torch.tensor(
            f32(ref(jax.nn.silu, xj * 3))).bfloat16())
        assert torch.equal(PL.gelu_tanh(y), torch.tensor(
            f32(ref(jax.nn.gelu, xj * 3))).bfloat16())


@pytest.mark.parametrize("dtype", ("fp32", "bf16"))
@pytest.mark.parametrize("causal", (True, False))
def test_attention_paths(dtype, causal):
    """plain, chunked (ragged KV: padded to the chunk with position -1)
    and local (S > window, S not a multiple of it), GQA."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    for h, hkv in ((4, 2),):   # MHA runs in the qwen1.5 forward tests
        q, k, v = _qkv_arrays(rng, 2, 37, 37, h, hkv, 16)
        (qj, qt), (kj, kt), (vj, vt) = (pair(a, jdt, tdt) for a in (q, k, v))
        pos = np.arange(37, dtype=np.int32)
        pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
        for window in (0, 8):
            assert_close(
                PL.plain_attention(qt, kt, vt, pt, pt, causal=causal,
                                   window=window),
                ref(RL.plain_attention, qj, kj, vj, pj, pj, causal=causal,
                    window=window), dtype,
                f"plain h{h}/{hkv} w{window}")
            assert_close(
                PL.chunked_attention(qt, kt, vt, pt, pt, causal=causal,
                                     window=window, chunk=16),
                ref(RL.chunked_attention, qj, kj, vj, pj, pj,
                    causal=causal, window=window, chunk=16), dtype,
                f"chunked h{h}/{hkv} w{window}")
        if causal:
            for window in (8, 10):
                assert_close(PL.local_attention(qt, kt, vt, window=window),
                             ref(RL.local_attention, qj, kj, vj,
                                 window=window),
                             dtype, f"local w{window}")
        # a batch of query positions against a cache with empty slots
        kvpos = np.where(np.arange(37) < 30, np.arange(37), -1)
        kvpos = np.stack([kvpos, np.roll(kvpos, 3)]).astype(np.int32)
        qpos = np.stack([pos, pos + 1]).astype(np.int32)
        assert_close(
            PL.plain_attention(qt, kt, vt, torch.as_tensor(qpos),
                               torch.as_tensor(kvpos), causal=causal),
            ref(RL.plain_attention, qj, kj, vj, jnp.asarray(qpos),
                jnp.asarray(kvpos), causal=causal), dtype,
            "plain batched positions")


def test_attention_any_routes():
    rng = np.random.default_rng(3)
    q, k, v = _qkv_arrays(rng, 1, 40, 40, 4, 2, 16)
    (qj, qt), (kj, kt), (vj, vt) = (pair(a, jnp.float32, torch.float32)
                                    for a in (q, k, v))
    pos = np.arange(40, dtype=np.int32)
    pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
    cases = {
        "local": dict(window=16),
        "plain": dict(window=0),
        "plain (decode)": dict(window=0, plain_limit=1, sq=1),
        "chunked": dict(window=0, plain_limit=100, kv_chunk=16),
    }
    expect = {
        "local": lambda: PL.local_attention(qt, kt, vt, window=16),
        "plain": lambda: PL.plain_attention(qt, kt, vt, pt, pt),
        "plain (decode)": lambda: PL.plain_attention(qt[:, -1:], kt, vt,
                                                     pt[-1:], pt),
        "chunked": lambda: PL.chunked_attention(qt, kt, vt, pt, pt,
                                                chunk=16),
    }
    for name, kw in cases.items():
        kw = dict(kw)
        sq = kw.pop("sq", 40)
        got = PL.attention_any(qt[:, -sq:], kt, vt, pt[-sq:], pt, **kw)
        assert torch.equal(got, expect[name]()), name
        assert_close(got, ref(RL.attention_any, qj[:, -sq:], kj, vj,
                                   pj[-sq:], pj, **kw), "fp32", name)


# ------------------------------------------------------------- attention --

def _block_params(rcfg, seed):
    rp = RA.attn_init(jax.random.key(seed), rcfg, rcfg.pattern[0])
    tree = jax.tree.map(np.asarray, rp)
    return rp, {k: {n: torch.as_tensor(a) for n, a in v.items()}
                for k, v in tree.items()}


def _cmp_cache(got, want, what, tol=None):
    """k and v within one bf16 ulp (``tol=None``) or within ``tol`` of
    their largest magnitude; pos exactly."""
    for key in ("k", "v"):
        if tol is None:
            assert_close(got[key], want[key], "bf16", f"{what} {key}")
        else:
            assert rel_err(f32(got[key]), f32(want[key])) < tol, \
                f"{what} {key}"
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]),
                                  err_msg=what + " pos")


@pytest.mark.parametrize("window", (0, 8))
def test_attn_apply_prefill_and_decode(window):
    """attn_apply; attn_prefill with S >= size (the ring layout, argsort
    of the tail) and S < size (the slot scatter); attn_decode past the
    window, at the last slot, past the end of a global cache (clamped)
    and at a negative position (from the end)."""
    base = get_smoke_config("qwen3-4b")
    spec = BlockSpec(window=window, rope_base=1e4)
    cfg = dataclasses.replace(base, pattern=(spec,))
    rcfg = dataclasses.replace(ref_get_smoke("qwen3-4b"),
                               pattern=(RefBlockSpec(window=window,
                                                     rope_base=1e4),))
    rp, pp = _block_params(rcfg, 7)
    rspec = rcfg.pattern[0]
    r_apply = jax.jit(lambda p, x, ps: RA.attn_apply(p, rcfg, rspec, x, ps))
    r_prefill = jax.jit(lambda p, x, ps, c: RA.attn_prefill(
        p, rcfg, rspec, x, ps, c))
    r_decode = jax.jit(lambda p, x, pos, c: RA.attn_decode(
        p, rcfg, rspec, x, pos, c))
    rng = np.random.default_rng(4)
    for s, ctx in ((20, 24), (20, 20), (6, 24)):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        xj, xt = pair(x, jnp.bfloat16, torch.bfloat16)
        pos = np.arange(s, dtype=np.int32)
        pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
        assert_close(PA.attn_apply(pp, cfg, spec, xt, pt),
                     r_apply(rp, xj, pj),
                     "bf16", "attn_apply")
        rc = RA.attn_cache_init(rcfg, rcfg.pattern[0], 2, ctx)
        pc = PA.attn_cache_init(cfg, spec, 2, ctx, device=CPU)
        assert pc["k"].shape == rc["k"].shape
        ro, rc = r_prefill(rp, xj, pj, rc)
        po, pc = PA.attn_prefill(pp, cfg, spec, xt, pt, pc)
        assert_close(po, ro, "bf16", f"prefill s{s} ctx{ctx}")
        _cmp_cache(pc, rc, f"prefill s{s} ctx{ctx} w{window}")
        size = pc["k"].shape[1]
        for p in (s, s + 1, size - 1, size, size + 5, -2):
            xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            xdj, xdt = pair(xd, jnp.bfloat16, torch.bfloat16)
            ro, rc = r_decode(rp, xdj, jnp.int32(p), rc)
            po, pc = PA.attn_decode(pp, cfg, spec, xdt, p, pc)
            assert_close(po, ro, "bf16", f"decode at {p}")
            _cmp_cache(pc, rc, f"decode at {p} (s{s} ctx{ctx} w{window})")


def test_decode_slot_follows_dynamic_update_slice():
    for size in (1, 4, 7):
        for window in (0, 3):
            for pos in range(-2 * size, 3 * size):
                c = jnp.zeros((size,), jnp.int32)
                slot = (pos % size) if window > 0 else pos
                got = jax.lax.dynamic_update_slice_in_dim(
                    c, jnp.ones((1,), jnp.int32), slot, axis=0)
                want = int(np.argmax(np.asarray(got)))
                assert PA.decode_slot(pos, size, window) == want, \
                    (size, window, pos)


def test_embedding_clamps_out_of_range_ids():
    cfg = get_smoke_config("qwen3-4b")
    rcfg = ref_get_smoke("qwen3-4b")
    table = np.random.default_rng(6).standard_normal(
        (cfg.padded_vocab, cfg.d_model)).astype(np.float32)
    ids = np.array([[0, 5, cfg.vocab_size - 1, cfg.vocab_size,
                     cfg.vocab_size + 40, -1, -3, -cfg.vocab_size,
                     -cfg.vocab_size - 9]], np.int32)
    want, _ = RT.embed_input({"embed": {"table": jnp.asarray(table)}}, rcfg,
                             {"tokens": jnp.asarray(ids)})
    got, _ = T.embed_input({"embed": {"table": torch.as_tensor(table)}}, cfg,
                           {"tokens": torch.as_tensor(ids)})
    np.testing.assert_array_equal(f32(got), f32(want))


# ----------------------------------------------------------- transformer --

def test_gelu_block_matches_reference():
    """The GELU MLP in a causal dense block (no stock dense config has
    one)."""
    rcfg = dataclasses.replace(ref_get_smoke("qwen3-4b"),
                               pattern=(RefBlockSpec(mlp="gelu"),))
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              pattern=(BlockSpec(mlp="gelu"),))
    rp = jax.jit(RT.init_params, static_argnums=1)(jax.random.key(3), rcfg)
    toks = np.random.default_rng(3).integers(0, 509, (2, 12)).astype(np.int32)
    want = jax.jit(lambda p, t: RT.forward(p, rcfg, {"tokens": t})[0])(
        rp, jnp.asarray(toks))
    got = T.forward(W.from_reference(jax.tree.map(np.asarray, rp), cfg,
                                     device=CPU), cfg, {"tokens": toks})[0]
    assert rel_err(f32(got), f32(want)) < TOL


@pytest.mark.parametrize("name", [n for n in arch_names()
                                  if get_config(n).family != "dense"])
def test_unported_families_raise(name):
    """Every family beyond the dense one is ported (MoE, MLA, hybrid,
    SSM, and since the cross attention and audio slice the vision and
    audio ones): its full and smoke configs pass ``check_ported`` and
    build parameters and caches; ``batch_axes`` without a mesh (a layout
    hint, as the reference's sharding constraint) changes no value."""
    for cfg in (get_config(name), get_smoke_config(name)):
        assert T.check_ported(cfg) is cfg
        T.init_params(0, cfg, device="meta")
        T.init_cache(cfg, 1, 8, device="meta")
    base = get_smoke_config(name)
    params = T.init_params(0, base, device=CPU)
    batch = ({"frames": torch.zeros((1, 2, base.audio.feat_dim))}
             if base.audio is not None
             else {"tokens": np.zeros((1, 2), np.int32)})
    if base.vision is not None:
        batch["vision"] = torch.zeros((1, base.vision.seq_len,
                                       base.vision.embed_dim))
    got = T.forward(params, base, batch, batch_axes=("data",))[0]
    assert torch.equal(got, T.forward(params, base, batch)[0])
