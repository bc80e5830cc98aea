"""The port's cross attention and audio frontend
(``repro_torch.models.attention.cross_*``, the vision and audio inputs of
``models.transformer``) and the two models built on them
(llama-3.2-vision-11b, hubert-xlarge) against ``repro``'s, on the CPU at
the smoke sizes, on the same numpy-seeded inputs and parameters.

The reference's init leaves every bias and both tanh gates (``gate``,
``gate_mlp``) zero, which makes a cross block the identity and hides
where a bias add is rounded, so every tree here has them drawn nonzero.

- the GELU MLP's output bias under haloc_axa (the residual add reads the
  bias sum unrounded in fp32, as XLA's fusion does): a GELU block's
  logits equal the reference's bit for bit at seeds 1-3, with exact adds
  too;
- ``layers.xla_tanh32`` equals ``jnp.tanh`` bit for bit over 3 x 10^6
  values (clamp edges, tiny values, +-0), and after the bf16 cast where
  torch's ``tanh`` does not; ``softmax32`` and ``apply_rope`` (its FMAs)
  equal XLA's; ``cpu_dot_f32`` at the products' new classes (K = 17
  held as [N, K], N = 17, M = 68);
- ``cross_kv``, ``cross_attn_apply`` and a CROSS block, and the chunked
  non-causal attention with a ragged tail: bit for bit;
- llama-3.2-vision-11b-smoke: ``forward`` in the full, prefill and decode
  modes, the prefill cache (the cross k/v too) and ``generate`` equal the
  reference's greedy run bit for bit under haloc_axa at seeds 1-2 and
  with exact adds at seed 1;
- hubert-xlarge-smoke: the full forward at the default KV chunk and at 8,
  and the prefill step on frames, bit for bit (haloc_axa and exact);
- the bf16 trees keep ``gate`` and ``gate_mlp`` fp32; the parameter and
  cache shapes follow the reference's; ``launch.serve.main`` serves
  llama-3.2-vision-11b on the CPU, and hubert-xlarge exits (encoder-only).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.config import BlockSpec as RefBlockSpec
from repro.numerics import approx_ops as ref_ops
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve, steps
from repro_torch.models import attention as PA
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import weights as W
from repro_torch.models.config import BlockSpec
from repro_torch.models.serving import generate, teacher_forced_logits
from repro_torch.numerics import approx_ops as ops

from test_torch_lm_serving import _shapes, _unstacked, f32

VISION, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
CPU = "cpu"
#: The generation held against the reference: 4 prompts of 20 tokens, 12
#: new tokens each; hubert scores 4 x 31 frames.
BATCH, PROMPT, NEW, FRAMES = 4, 20, 12, 31


def bits(x):
    return f32(x).view(np.int32)


def assert_equal(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def bf16_pair(rng, shape, scale=1.0):
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                    jnp.bfloat16)
    return a, W.to_tensor(np.asarray(a), CPU)


def configs(name, adder):
    rcfg, cfg = ref_smoke(name), get_smoke_config(name)
    if adder != "off":
        rcfg = rcfg.with_approx(ref_ops.make_numerics(adder, "residual"))
        cfg = cfg.with_approx(ops.make_numerics(adder, "residual",
                                                backend="torch", device=CPU))
    return rcfg, cfg


def nonzero(tree, seed, names=("b", "gate", "gate_mlp")):
    """``tree`` with the leaves named ``names`` drawn from a numpy seed:
    the gates N(0, 1), the biases N(0, 0.1)."""
    rng = np.random.default_rng(seed + 50)

    def draw(path, a):
        key = getattr(path[-1], "key", None)
        if key not in names:
            return a
        scale = 1.0 if key.startswith("gate") else 0.1
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                           * scale)

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def reference_steps(name, adder):
    """The reference's config and its jitted init, prefill, decode and full
    forward (compiled once for every seed)."""
    rcfg, _ = configs(name, adder)
    return (rcfg, jax.jit(RT.init_params, static_argnums=1),
            jax.jit(ref_steps.make_prefill_step(rcfg, PROMPT + NEW)),
            jax.jit(ref_steps.make_decode_step(rcfg)),
            jax.jit(lambda p, b: RT.forward(p, rcfg, b)[0]))


@functools.lru_cache(maxsize=None)
def vision_run(adder, seed=1):
    """The reference's greedy run of llama-3.2-vision-11b-smoke: (its
    parameters as numpy, the vision input as numpy bf16, the tokens, each
    step's logits (B, NEW, V), its prefill cache, the full-mode logits on
    the tokens less the last)."""
    rcfg, init, prefill, decode, forward = reference_steps(VISION, adder)
    rp = nonzero(init(jax.random.key(seed), rcfg), seed)
    rng = np.random.default_rng(seed)
    vis = jnp.asarray(rng.standard_normal(
        (BATCH, rcfg.vision.seq_len, rcfg.vision.embed_dim)).astype(
            np.float32), jnp.bfloat16)
    prompt = rng.integers(0, rcfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    logits, cache = prefill(rp, {"tokens": jnp.asarray(prompt),
                                 "vision": vis})
    pre_cache = jax.tree.map(np.asarray, cache)
    toks, want = [prompt], []
    for i in range(NEW):
        want.append(f32(logits[:, -1]))
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
        toks.append(nxt[:, None])
        if i < NEW - 1:
            logits, cache = decode(rp, {"tokens": jnp.asarray(nxt[:, None])},
                                   jnp.int32(PROMPT + i), cache)
    toks = np.concatenate(toks, axis=1)
    full = forward(rp, {"tokens": jnp.asarray(toks[:, :-1]), "vision": vis})
    return (jax.tree.map(np.asarray, rp), np.asarray(vis), toks,
            np.stack(want, axis=1), pre_cache, f32(full))


# ------------------------------------------------- the GELU output bias --

@functools.lru_cache(maxsize=None)
def gelu_reference(adder):
    """qwen3-4b-smoke with GELU blocks: (the reference's config and its
    jitted forward, the port's config)."""
    rcfg, cfg = configs("qwen3-4b", adder)
    rcfg = dataclasses.replace(rcfg, pattern=(RefBlockSpec(mlp="gelu"),))
    cfg = dataclasses.replace(cfg, pattern=(BlockSpec(mlp="gelu"),))
    return (rcfg, jax.jit(lambda p, t: RT.forward(p, rcfg, {"tokens": t})[0]),
            cfg)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gelu_output_bias_equals_reference_under_haloc_axa(seed):
    """qwen3-4b-smoke with GELU blocks and every bias drawn nonzero: the
    second residual add reads ``dot + b`` as XLA's fusion hands it, the
    rounded product plus the bf16 bias in fp32, unrounded, so under
    haloc_axa the logits equal the reference's bit for bit (with the bias
    rounded first 9,000-10,800 of 12,216 differ); with exact adds too."""
    toks = np.random.default_rng(seed).integers(0, 509, (2, 12)).astype(
        np.int32)
    for adder in ("haloc_axa", "off"):
        rcfg, forward, cfg = gelu_reference(adder)
        rp = nonzero(jax.jit(RT.init_params, static_argnums=1)(
            jax.random.key(seed), rcfg), seed, ("b",))
        want = forward(rp, jnp.asarray(toks))
        params = W.from_reference(jax.tree.map(np.asarray, rp), cfg,
                                  device=CPU, dtype=torch.bfloat16)
        got = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0]
        assert_equal(got, want)


# ------------------------------------------------------ fp32 functions --

def test_xla_tanh32_equals_jnp_tanh():
    rng = np.random.default_rng(0)
    edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 20.0, -20.0, 19.999998,
            L.TANH_CLAMP, -L.TANH_CLAMP, L.TANH_SMALL, -L.TANH_SMALL,
            1e-45, -1e-45, 1e-39, 3e38, -3e38]
    x = np.concatenate([rng.uniform(-10, 10, 600000),
                        rng.standard_normal(300000) * 2,
                        np.exp(rng.uniform(-40, 3, 100000))
                        * rng.choice([-1, 1], 100000),
                        edge]).astype(np.float32)
    up = np.nextafter(x, np.float32(np.inf))
    x = np.concatenate([x, up, np.nextafter(x, np.float32(-np.inf))])
    want = np.asarray(jax.jit(jnp.tanh)(x))
    got = L.xla_tanh32(torch.from_numpy(x)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:4], got[~same][:4], want[~same][:4])
    # the gates' bf16 cast: where torch's own tanh rounds to another bf16
    # value (0xc05dc66b among them), XLA's is followed
    g = np.concatenate([np.array([0xC05DC66B], np.uint32).view(np.float32),
                        x[np.isfinite(x)]])
    wb = f32(jax.jit(lambda g: jnp.tanh(g).astype(jnp.bfloat16))(g))
    tb = f32(torch.tanh(torch.from_numpy(g)).to(torch.bfloat16))
    moved = wb != tb
    assert moved[0] and moved.sum() >= 2
    assert_equal(L.xla_tanh32(torch.from_numpy(g[moved])).to(torch.bfloat16),
                 wb[moved])
    assert float(L.xla_tanh32(torch.from_numpy(g[:1])).to(
        torch.bfloat16)) == -1.0


def test_softmax32_and_rope_equal_xla():
    """The attention's probabilities (XLA's exp and sum order) and the
    RoPE rotation (XLA:CPU contracts the first product of each half into
    an FMA), bit for bit; torch's own softmax and a plain rotation differ
    in the last bit."""
    rng = np.random.default_rng(1)
    s = (rng.standard_normal((16, 16, 31, 64)) * 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: jax.nn.softmax(s, axis=-1))(s))
    assert_equal(L.softmax32(torch.from_numpy(s)), want)
    assert (torch.softmax(torch.from_numpy(s), -1).numpy() != want).any()
    xj, xt = bf16_pair(rng, (64, 31, 16, 16))
    pos = jnp.arange(31, dtype=jnp.int32)
    want = jax.jit(lambda x: RL.apply_rope(
        x, *RL.rope_tables(pos, 16, 10000.0)))(xj)
    assert_equal(L.apply_rope(xt, *L.rope_tables(range(31), 16, 10000.0)),
                 want)


def test_cpu_dot_f32_equals_xla_at_the_new_classes():
    """The products the two models add: the cross PV product held as
    [N, K] with K = 17 vision positions (N = 1, 20, 23, 31 queries), the
    cross scores (N = 17), the vision K/V projections and adapter (M =
    68), hubert's frontend (K = 24) and head (N = 97)."""
    from test_torch_moe_mla import _operands, _xla_dot
    cases = ([(16, 17, n, {"rhs_t": True}) for n in (1, 20, 23, 24, 31)]
             + [(m, 16, 17, {}) for m in (1, 20, 31)]
             + [(68, 64, 32, {}), (68, 48, 64, {}), (124, 24, 64, {}),
                (80, 24, 64, {}), (124, 64, 97, {}), (80, 64, 97, {})])
    for m, k, n, flags in cases:
        assert L.xla_cpu_dot_order(m, k, n, **flags) is not None
        a, b = _operands(m, k, n, m * 7919 + k * 31 + n)
        got = L.cpu_dot_f32(torch.from_numpy(a), torch.from_numpy(b),
                            **flags)
        assert_equal(got, _xla_dot(a, b, **flags))


# ---------------------------------------------------------- the modules --

@functools.lru_cache(maxsize=None)
def cross_setup(seed=3):
    rcfg, cfg = configs(VISION, "off")
    rspec, spec = rcfg.pattern[1], cfg.pattern[1]
    rp = nonzero(jax.jit(lambda k: RT.block_init(k, rcfg, rspec))(
        jax.random.key(seed)), seed)
    p = W._map(jax.tree.map(np.asarray, rp),
               lambda a, path: W.to_tensor(
                   a, CPU, torch.float32 if path[-1] in W.FP32_LEAVES
                   else torch.bfloat16))
    rng = np.random.default_rng(seed)
    vis = bf16_pair(rng, (BATCH, rcfg.vision.seq_len, rcfg.d_model))
    x = bf16_pair(rng, (BATCH, FRAMES, rcfg.d_model))
    return rcfg, cfg, rspec, spec, rp, p, vis, x


def test_cross_kv_and_cross_attn_apply_match_reference():
    rcfg, cfg, rspec, spec, rp, p, (vj, vt), (xj, xt) = cross_setup()
    assert p["mixer"]["gate"].dtype == torch.float32
    assert float(p["mixer"]["gate"]) != 0.0
    kv = jax.jit(lambda p, v: RA.cross_kv(p, rcfg, v))(rp["mixer"], vj)
    got_kv = PA.cross_kv(p["mixer"], cfg, vt)
    for g, w in zip(got_kv, kv):
        assert g.dtype == torch.bfloat16
        assert_equal(g, w)
    want = jax.jit(lambda p, x, kv: RA.cross_attn_apply(
        p, rcfg, rspec, x, kv))(rp["mixer"], xj, kv)
    t_mix = PA.tanh_gates([p["mixer"]["gate"]])[0]
    got = PA.cross_attn_apply(p["mixer"], cfg, spec, xt, got_kv, t_mix)
    assert got.dtype == torch.bfloat16
    assert_equal(got, want)
    # the unrounded product an approximate add reads rounds to the same
    wide = PA.cross_attn_apply(p["mixer"], cfg, spec, xt, got_kv, t_mix,
                               keep_fp32=True)
    assert wide.dtype == torch.float32
    assert torch.equal(wide.to(torch.bfloat16), got)


@pytest.mark.parametrize("adder", ["haloc_axa", "off"])
def test_cross_block_matches_reference(adder):
    """A CROSS block in the full, prefill and decode modes (the decode
    reads the prefill's cross cache), with its two tanh gates."""
    rcfg, cfg, rspec, spec, rp, p, (vj, vt), (xj, xt) = cross_setup()
    rcfg, cfg = (dataclasses.replace(c, approx=a.approx) for c, a in
                 zip((rcfg, cfg), configs(VISION, adder)))
    pos = jnp.arange(FRAMES, dtype=jnp.int32)
    tpos = torch.arange(FRAMES, dtype=torch.int32)
    want = jax.jit(lambda p, x, v: RT.block_apply(
        p, rcfg, rspec, x, {"vis": v, "positions": pos}, None, "full")[0])(
        rp, xj, vj)
    gates = tuple(PA.tanh_gates([p["mixer"]["gate"],
                                 p["gate_mlp"]]).unbind())
    got = T.block_apply(p, cfg, spec, xt, {"vis": vt, "positions": tpos},
                        None, "full", tanh_gates=gates)[0]
    assert_equal(got, want)
    rc = RT.block_cache_init(rcfg, rspec, BATCH, 40)
    pc = T.block_cache_init(cfg, spec, BATCH, 40, device=CPU)
    assert _shapes(pc) == {k: (tuple(v.shape), str(v.dtype))
                           for k, v in rc.items()}
    want, rc, _ = jax.jit(lambda p, x, v, c: RT.block_apply(
        p, rcfg, rspec, x, {"vis": v, "positions": pos}, c, "prefill"))(
        rp, xj, vj, rc)
    got, pc, _, _ = T.block_apply(p, cfg, spec, xt,
                                  {"vis": vt, "positions": tpos}, pc,
                                  "prefill", tanh_gates=gates)
    assert_equal(got, want)
    for key in ("k", "v"):
        assert pc[key].dtype == torch.bfloat16
        assert_equal(pc[key], rc[key])
    want = jax.jit(lambda p, x, c: RT.block_apply(
        p, rcfg, rspec, x, {"pos": jnp.int32(FRAMES),
                            "positions": jnp.int32(FRAMES)[None]}, c,
        "decode")[0])(rp, xj[:, :1], rc)
    got = T.block_apply(p, cfg, spec, xt[:, :1], {"pos": FRAMES}, pc,
                        "decode", tanh_gates=gates)[0]
    assert_equal(got, want)


@pytest.mark.parametrize("s,chunk", [(31, 8), (40, 16)])
def test_chunked_non_causal_attention_matches_reference(s, chunk):
    """The encoder's memory-bounded path (hubert-xlarge's 1500 frames take
    it at its 1024 chunk): KV chunks with a ragged tail padded with
    position -1, no causal mask."""
    rng = np.random.default_rng(s)
    (qj, qt), (kj, kt), (vj, vt) = (bf16_pair(rng, (BATCH, s, 4, 16))
                                    for _ in range(3))
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(lambda q, k, v: RL.chunked_attention(
        q, k, v, jnp.asarray(pos), jnp.asarray(pos), causal=False,
        chunk=chunk))(qj, kj, vj)
    got = L.chunked_attention(qt, kt, vt, torch.from_numpy(pos),
                              torch.from_numpy(pos), causal=False,
                              chunk=chunk)
    assert_equal(got, want)


# ---------------------------------------------------------- the models --

@pytest.mark.parametrize("adder,seed", [("haloc_axa", 1), ("haloc_axa", 2),
                                        ("off", 1)])
def test_vision_forward_modes_and_generate_match_reference(adder, seed):
    """llama-3.2-vision-11b-smoke: full mode, the prefill and decode steps
    (teacher-forced on the reference's greedy tokens), the prefill cache
    and the port's own greedy run, bit for bit, with exact adds too (the
    cross block's norm reads the self block's exact sum unrounded, as in
    XLA's layer scan)."""
    tree, vis, toks, want_steps, ref_cache, want_full = vision_run(adder,
                                                                   seed)
    _, cfg = configs(VISION, adder)
    params = W.from_reference(tree, cfg, device=CPU, dtype=torch.bfloat16)
    vt = W.to_tensor(vis, CPU)
    full = T.forward(params, cfg, {"tokens": torch.from_numpy(toks[:, :-1]),
                                   "vision": vt})[0]
    tf = teacher_forced_logits(params, cfg, torch.from_numpy(toks), PROMPT,
                               vision=vt)
    _, pc = steps.make_prefill_step(cfg, PROMPT + NEW)(
        params, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                 "vision": vt})
    want_c = W.cache_from_reference(ref_cache, cfg, device=CPU)
    pairs = [(full, want_full), (tf, want_steps)] + [
        (g[key], w[key]) for g, w in zip(T.blocks_in_order(cfg, pc),
                                         T.blocks_in_order(cfg, want_c))
        for key in w]
    for got, want in pairs:
        assert_equal(got, want)
    got, logits = generate(params, cfg, {"tokens": toks[:, :PROMPT],
                                         "vision": vt}, NEW,
                           return_logits=True)
    np.testing.assert_array_equal(got.numpy(), toks)
    assert torch.equal(logits, teacher_forced_logits(params, cfg, got,
                                                     PROMPT, vision=vt))


@functools.lru_cache(maxsize=None)
def audio_params(adder, seed):
    rcfg, init, *_ = reference_steps(AUDIO, adder)
    rp = nonzero(init(jax.random.key(seed), rcfg), seed)
    frames = bf16_pair(np.random.default_rng(seed),
                       (BATCH, FRAMES, rcfg.audio.feat_dim))
    return rcfg, rp, frames


@functools.lru_cache(maxsize=None)
def audio_steps(adder, chunk):
    """The reference's jitted full forward at KV chunk ``chunk``, and its
    prefill step."""
    rcfg = dataclasses.replace(reference_steps(AUDIO, adder)[0],
                               attn_kv_chunk=chunk)
    return (jax.jit(lambda p, f: RT.forward(p, rcfg, {"frames": f})[0]),
            jax.jit(ref_steps.make_prefill_step(rcfg, PROMPT)))


@pytest.mark.parametrize("adder,seed", [("haloc_axa", 1), ("haloc_axa", 2),
                                        ("off", 1)])
def test_audio_forward_and_prefill_match_reference(adder, seed):
    """hubert-xlarge-smoke (encoder-only, GELU MLPs with biases): the full
    forward at the default KV chunk and at 8 (a ragged chunk tail where
    the encoder path takes its chunks), and the prefill step on frames,
    which returns every position's logits; bit for bit."""
    rcfg, rp, (fj, ft) = audio_params(adder, seed)
    _, cfg = configs(AUDIO, adder)
    params = W.from_reference(jax.tree.map(np.asarray, rp), cfg, device=CPU,
                              dtype=torch.bfloat16)
    assert "embed" not in params and "frontend" in params
    for chunk in (cfg.attn_kv_chunk, 8):
        want = audio_steps(adder, chunk)[0](rp, fj)
        got = T.forward(params, dataclasses.replace(cfg, attn_kv_chunk=chunk),
                        {"frames": ft})[0]
        assert got.shape == (BATCH, FRAMES, cfg.vocab_size)
        assert_equal(got, want)
    want, _ = audio_steps(adder, cfg.attn_kv_chunk)[1](
        rp, {"frames": fj[:, :PROMPT]})
    got, cache = steps.make_prefill_step(cfg, PROMPT)(
        params, {"frames": ft[:, :PROMPT]})
    assert got.shape == (BATCH, PROMPT, cfg.vocab_size)
    assert_equal(got, want)


# ------------------------------------------------------- trees, launcher --

@pytest.mark.parametrize("name", [VISION, AUDIO])
def test_bf16_trees_keep_the_gates_fp32_and_shapes_follow(name):
    cfg = get_smoke_config(name)
    trees = [T.init_params(2, cfg, device=CPU, dtype=torch.bfloat16)]
    if name == VISION:
        trees.append(W.from_reference(vision_run("haloc_axa")[0], cfg,
                                      device=CPU, dtype=torch.bfloat16))
    for params in trees:
        for spec, blk in zip(cfg.all_blocks(),
                             T.blocks_in_order(cfg, params)):
            assert blk["ln1"]["scale"].dtype == torch.float32
            assert blk["mixer"]["wq"]["w"].dtype == torch.bfloat16
            if spec.mixer == "cross":
                assert blk["mixer"]["gate"].dtype == torch.float32
                assert blk["gate_mlp"].dtype == torch.float32
                assert blk["mixer"]["gate"].shape == ()
    fresh = trees[0]
    if name == AUDIO:
        assert fresh["frontend"]["b"].dtype == torch.bfloat16
        assert not torch.any(fresh["frontend"]["b"] != 0)
    else:
        blk = fresh["pattern"][1][0]
        assert float(blk["mixer"]["gate"]) == 0.0 == float(blk["gate_mlp"])
    full, rfull = get_config(name), ref_get_config(name)
    got, want = steps.params_shapes(full), ref_steps.params_shapes(rfull)
    assert T.param_count(got) == sum(int(np.prod(x.shape))
                                     for x in jax.tree.leaves(want))
    assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        _unstacked(want, rfull.repeats)) == _shapes(got)
    cs = steps.cache_shapes(full, 4, 160)
    rcs = _unstacked(ref_steps.cache_shapes(rfull, 4, 160), rfull.repeats)
    for c, rc in zip(T.blocks_in_order(full, cs),
                     T.blocks_in_order(full, rcs), strict=True):
        assert _shapes(c) == {k: (tuple(v.shape), str(v.dtype))
                              for k, v in rc.items()}


def test_launch_serve_on_the_cpu(capsys):
    serve.main(["--arch", VISION, "--smoke", "--device", "cpu", "--adder",
                "haloc_axa", "--batch", "2", "--prompt-len", "9",
                "--new-tokens", "3"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith(f"{VISION}-smoke: (2, 12); "), out
    assert "(3 steps x batch 2 in " in out and " tok/s " in out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])
