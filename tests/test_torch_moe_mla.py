"""The port's MoE and MLA modules (``repro_torch.models.moe``/``mla``) and
its CPU product order (``models.layers.cpu_dot_f32``) against ``repro``'s,
on the CPU at the smoke sizes, on the same numpy-seeded inputs.

- ``_capacity`` over a grid and ``_dispatch_indices`` (overflow drops,
  ties, several rows): exactly equal;
- the gating: the same router logits give the same expert ids, and gates
  and probabilities within 1e-6;
- ``moe_apply`` for both MoE smoke configs, one and two sequence chunks, a
  decode step (S == 1), shared experts on and off: the output within the
  reference's parity rule (max |d| / max(1, max |out|) < 0.04; it is equal
  bit for bit on these inputs, which the test reports), the aux loss
  within 1e-6 relative;
- ``mla_apply``, ``mla_prefill`` and ``mla_decode`` in both decode modes:
  within the rule, the cache's positions exactly; absorbed against
  decompress on both packages;
- ``cpu_dot_f32`` equal bit for bit to XLA:CPU's fp32 ``dot`` of
  bf16-valued operands over ``tools/xla_dot_order.py``'s grid, operand
  layouts included; the class it does not match (few rows split between
  threads) is a strict xfail naming ROADMAP Queue C 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_smoke_config as ref_smoke
from repro.models import mla as RMLA
from repro.models import moe as RMOE
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import weights as W

TOL = 0.04
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
MLA_ARCH = "deepseek-v2-236b"


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_err(got, want):
    got, want = f32(got), f32(want)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a jax array and a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                    jnp.bfloat16)
    return a, W.to_tensor(np.asarray(a), "cpu")


def to_port(tree):
    """A reference parameter tree (one block's) as torch tensors."""
    return W._map(jax.tree.map(np.asarray, tree),
                  lambda a, _p: W.to_tensor(a, "cpu"))


def with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def with_mla(cfg, **kw):
    return dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, **kw))


# ------------------------------------------------------------ dispatch --

@pytest.mark.parametrize("experts,k,factor", [
    (4, 2, 1.25), (8, 3, 1.25), (32, 8, 1.25), (160, 6, 1.25), (8, 3, 8.0),
    (64, 1, 0.5)])
def test_capacity_matches_reference(experts, k, factor):
    mc = dataclasses.replace(ref_smoke("deepseek-v2-236b").moe,
                             num_experts=experts, experts_per_token=k,
                             capacity_factor=factor)
    for tokens in range(1, 300):
        assert MOE._capacity(tokens, mc) == RMOE._capacity(tokens, mc), \
            tokens


def _ids(case, rng):
    """(ids (B, T, k), gates, experts, capacity) for a dispatch case."""
    if case == "overflow":      # most pairs to expert 0: drops past cap
        b, t, k, e, cap = 2, 24, 2, 4, 4
        ids = np.where(rng.random((b, t, k)) < 0.7, 0,
                       rng.integers(0, e, (b, t, k)))
    elif case == "ties":        # every token routed alike, rows equal
        b, t, k, e, cap = 3, 10, 3, 8, 8
        ids = np.broadcast_to(np.array([5, 1, 5])[None, None], (b, t, k))
    else:                       # several rows, random routing
        b, t, k, e, cap = 4, 31, 3, 8, 12
        ids = rng.integers(0, e, (b, t, k))
    gates = rng.random((b, t, k)).astype(np.float32)
    return np.ascontiguousarray(ids).astype(np.int32), gates, e, cap


@pytest.mark.parametrize("case", ["overflow", "ties", "rows"])
def test_dispatch_indices_match_reference(case):
    ids, gates, e, cap = _ids(case, np.random.default_rng(7))
    want_tok, (want_src, want_dest, want_keep) = jax.jit(
        RMOE._dispatch_indices, static_argnums=(2, 3))(
        jnp.asarray(ids), jnp.asarray(gates), e, cap)
    got_tok, (got_src, got_dest, got_keep) = MOE._dispatch_indices(
        torch.as_tensor(ids), torch.as_tensor(gates), e, cap)
    for got, want in ((got_tok, want_tok), (got_src, want_src),
                      (got_dest, want_dest), (got_keep, want_keep)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "overflow":
        assert not bool(np.asarray(want_keep).all())


def test_gating_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 17, 8)).astype(np.float32)
    logits[:, :5, 6] = logits[:, :5, 2]         # ties: the lower id first
    logits[0, 5] = 0.0
    k = 3

    def ref(lg):
        probs = jax.nn.softmax(lg, axis=-1)
        g, i = lax.top_k(probs, k)
        return probs, g / jnp.maximum(g.sum(-1, keepdims=True), 1e-9), i

    probs, gates, ids = jax.jit(ref)(jnp.asarray(logits))
    p_probs, p_gates, p_ids = MOE.gate(torch.as_tensor(logits), k)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(p_gates.numpy(), np.asarray(gates),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p_probs.numpy(), np.asarray(probs),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- moe ---

MOE_VARIANTS = {
    "chunks1": dict(seq=16, moe=dict(seq_chunks=1)),
    "chunks2": dict(seq=16, moe=dict(seq_chunks=2)),
    "decode": dict(seq=1, moe=dict()),
    "shared_on": dict(seq=12, moe=dict(num_shared_experts=1,
                                       shared_d_ff=40)),
    "shared_off": dict(seq=12, moe=dict(num_shared_experts=0,
                                        shared_d_ff=0)),
}


@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_apply_matches_reference(name, variant):
    v = MOE_VARIANTS[variant]
    rcfg = with_moe(ref_smoke(name), **v["moe"])
    cfg = with_moe(get_smoke_config(name), **v["moe"])
    rp = RMOE.moe_init(jax.random.key(11), rcfg)
    rng = np.random.default_rng(11)
    xj, xt = bf16_pair(rng, (4, v["seq"], cfg.d_model))
    want, want_aux = jax.jit(lambda p, x: RMOE.moe_apply(p, rcfg, x))(rp, xj)
    got, aux = MOE.moe_apply(to_port(rp), cfg, xt)
    got = got.to(torch.bfloat16)        # the residual add rounds it
    assert got.shape == want.shape
    assert ("shared" in rp) == bool(cfg.moe.num_shared_experts)
    equal = float(np.mean(f32(got) == f32(want)))
    print(f"{name} {variant}: {equal:.4f} of the outputs equal")
    assert rel_err(got, want) < TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


def test_moe_shard_map_falls_back_without_a_mesh():
    cfg = get_smoke_config("granite-moe-1b-a400m")
    p = to_port(RMOE.moe_init(jax.random.key(2), ref_smoke(
        "granite-moe-1b-a400m")))
    x = torch.randn(2, 8, cfg.d_model).to(torch.bfloat16)
    a, aux_a = MOE.moe_apply_shard_map(p, cfg, x)
    b, aux_b = MOE.moe_apply(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    # a "model" axis that does not divide the experts: the reference's
    # fallback too
    from repro_torch.sharding.rules import MeshShape
    c, aux_c = MOE.moe_apply_shard_map(
        p, cfg, x, batch_axes=("data",),
        mesh=MeshShape(("data", "model"), (1, 3)))
    assert torch.equal(c, b) and torch.equal(aux_c, aux_b)


def test_deepseek_exact_add_logits_equal_reference_at_seed_3():
    """ROADMAP Queue C 14: with exact adds XLA rounds the routed plus
    shared experts' sum to bf16 before the residual add (under an
    approximate adder it keeps it in fp32).  DeepSeek-V2's smoke config at
    seed 3, full mode: the logits equal the reference's bit for bit (rel
    0.1268 before, past the 0.08 MoE rule)."""
    from test_torch_lm_serving import port_cfg, reference_run
    from repro_torch.models import transformer as T
    tree, toks, _, _, ref_full, ref_aux = reference_run(MLA_ARCH, "off", 3)
    cfg = port_cfg(MLA_ARCH, "off")
    params = W.from_reference(tree, cfg, device="cpu")
    full, _, aux = T.forward(params, cfg, {"tokens": toks[:, :-1]})
    np.testing.assert_array_equal(f32(full), ref_full)
    assert abs(float(aux) - ref_aux) <= 1e-6 * abs(ref_aux)


# --------------------------------------------------------------- mla ---

def _mla_setup(mode="decompress", seed=5):
    rcfg = with_mla(ref_smoke(MLA_ARCH), decode_mode=mode)
    cfg = with_mla(get_smoke_config(MLA_ARCH), decode_mode=mode)
    spec, rspec = cfg.prefix[0], rcfg.prefix[0]
    rp = RMLA.mla_init(jax.random.key(seed), rcfg, rspec)
    return rcfg, cfg, rspec, spec, rp, to_port(rp)


def test_mla_apply_matches_reference():
    rcfg, cfg, rspec, spec, rp, p = _mla_setup()
    xj, xt = bf16_pair(np.random.default_rng(5), (2, 12, cfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    want = jax.jit(lambda p, x: RMLA.mla_apply(p, rcfg, rspec, x,
                                               jnp.asarray(pos)))(rp, xj)
    got = MLA.mla_apply(p, cfg, spec, xt, torch.as_tensor(pos))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert rel_err(got, want) < TOL


def _decode_run(pkg, mode, ctx=16, prompt=10, steps=(10, 11, 12, 20)):
    """Prefill ``prompt`` positions, then decode one token at each of
    ``steps`` (20 lies past the cache: clamped to its last slot), on
    ``pkg`` ("ref" or "port").  Returns the outputs and caches."""
    rcfg, cfg, rspec, spec, rp, p = _mla_setup(mode)
    rng = np.random.default_rng(9)
    xs = [bf16_pair(rng, (2, prompt, cfg.d_model))]
    xs += [bf16_pair(rng, (2, 1, cfg.d_model)) for _ in steps]
    outs, caches = [], []
    if pkg == "ref":
        cache = RMLA.mla_cache_init(rcfg, 2, ctx)
        out, cache = jax.jit(lambda p, x, c: RMLA.mla_prefill(
            p, rcfg, rspec, x, jnp.arange(prompt, dtype=jnp.int32), c))(
            rp, xs[0][0], cache)
        outs.append(out)
        caches.append(jax.tree.map(np.asarray, cache))
        dec = jax.jit(lambda p, x, pos, c: RMLA.mla_decode(
            p, rcfg, rspec, x, pos, c))
        for (xj, _), pos in zip(xs[1:], steps):
            out, cache = dec(rp, xj, jnp.int32(pos), cache)
            outs.append(out)
            caches.append(jax.tree.map(np.asarray, cache))
        return outs, caches
    cache = MLA.mla_cache_init(cfg, 2, ctx, device="cpu")
    out, cache = MLA.mla_prefill(p, cfg, spec, xs[0][1],
                                 torch.arange(prompt, dtype=torch.int32),
                                 cache)
    outs.append(out)
    caches.append({k: v.clone() for k, v in cache.items()})
    for (_, xt), pos in zip(xs[1:], steps):
        out, cache = MLA.mla_decode(p, cfg, spec, xt, pos, cache)
        outs.append(out)
        caches.append({k: v.clone() for k, v in cache.items()})
    return outs, caches


@pytest.mark.parametrize("mode", ["decompress", "absorbed"])
def test_mla_prefill_and_decode_match_reference(mode):
    want, want_c = _decode_run("ref", mode)
    got, got_c = _decode_run("port", mode)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.shape == w.shape
        assert rel_err(g, w) < TOL, (mode, i)
    for g, w in zip(got_c, want_c, strict=True):
        np.testing.assert_array_equal(g["pos"].numpy(), w["pos"])
        assert g["ckv"].dtype == g["krope"].dtype == torch.bfloat16
        assert rel_err(g["ckv"], w["ckv"]) < TOL
        assert rel_err(g["krope"], w["krope"]) < TOL
    # the step at 20 wrote the last slot, as dynamic_update_slice clamps
    assert int(got_c[-1]["pos"][-1]) == 20


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_mla_absorbed_equals_decompress(pkg):
    dec, _ = _decode_run(pkg, "decompress")
    absd, _ = _decode_run(pkg, "absorbed")
    for a, d in zip(absd[1:], dec[1:], strict=True):
        assert rel_err(a, d) < TOL


# ------------------------------------------------------ the CPU order --

def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = np.array(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
                   .astype(jnp.float32))
    b = np.array(jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
                   .astype(jnp.float32))
    return a, b


def _xla_dot(a, b, lhs_t=False, rhs_t=False):
    """XLA's fp32 dot of a @ b, with a held as [K, M] (``lhs_t``) and b as
    [N, K] (``rhs_t``) where asked."""
    lhs = a.T.copy() if lhs_t else a
    rhs = b.T.copy() if rhs_t else b
    dims = (((0,) if lhs_t else (1,), (1,) if rhs_t else (0,)), ((), ()))
    return np.asarray(jax.jit(lambda x, y: lax.dot_general(
        x, y, dims, preferred_element_type=jnp.float32))(
        jnp.asarray(lhs), jnp.asarray(rhs)))


DOT_GRID = {
    # (rows, contracting, columns) lists, operand layout
    "rows_upto_50": ((2, 4, 23, 46, 50), (16, 31, 64, 96, 192, 256),
                     (4, 16, 17, 32, 64, 96, 192, 509, 601, 640), {}),
    "rows_over_50": ((51, 80, 124), (16, 31, 64, 160, 256),
                     (4, 16, 24, 25, 32, 33, 48, 49, 64, 65, 96, 509, 601),
                     {}),
    "one_row": ((1,), (16, 64, 192), (8, 48, 509, 601), {}),
    "lhs_t": ((4, 16, 64), (16, 23, 31, 64, 128), (4, 16, 31, 48, 80), {
        "lhs_t": True}),
    "rhs_t": ((4, 16, 64), (16, 23, 31, 64, 128), (4, 16, 20, 23, 31, 48,
                                                    80), {"rhs_t": True}),
    "vector": ((16, 32, 64), (8, 16, 24, 31, 32, 64, 128), (1,), {}),
    "vector_t": ((1,), (16, 24, 32, 64), (24, 32, 64), {"rhs_t": True}),
    # K not a multiple of 4 within one column tile: llama-3.2-vision-11b's
    # cross PV product (K = 17 vision positions, rhs held as [N, K]) and
    # the M > 50 class it shares; N = 16 with few rows
    "odd_k": ((16, 124), (9, 10, 17, 19), (17, 20, 31), {"rhs_t": True}),
    "odd_k_rows": ((4, 20, 46), (9, 13, 17, 18), (16,), {}),
    # past one column tile, K not a multiple of 4: the width's chains on
    # each side of the bounds where the library takes another order
    "past_one_tile": ((80,), (7, 13, 14, 22, 25, 45, 47),
                      (80, 97, 153, 353, 601), {}),
    "past_one_tile_t": ((16,), (7, 11, 13, 22, 45), (81, 97, 161, 345),
                        {"rhs_t": True}),
}


@pytest.mark.parametrize("case", sorted(DOT_GRID))
def test_cpu_dot_f32_equals_xla_dot(case):
    ms, ks, ns, flags = DOT_GRID[case]
    checked = 0
    for m in ms:
        for k in ks:
            for n in ns:
                if L.xla_cpu_dot_order(m, k, n, **flags) is None:
                    continue
                a, b = _operands(m, k, n, m * 7919 + k * 31 + n)
                want = _xla_dot(a, b, **flags)
                got = L.cpu_dot_f32(torch.from_numpy(a), torch.from_numpy(b),
                                    **flags).numpy()
                assert np.array_equal(got, want), (case, m, k, n)
                checked += 1
    assert checked >= 12


def test_dense_and_batched_products_equal_xla():
    """``dense`` on bf16 (the reference's ``x @ w``) and the batched
    forms the port's attention and experts take, bit for bit."""
    rng = np.random.default_rng(4)
    for shape in ((4, 31, 64, 509), (4, 20, 96, 640), (2, 1, 64, 601),
                  (1, 80, 64, 192)):
        b, s, d, n = shape
        xj, xt = bf16_pair(rng, (b, s, d))
        wj, wt = bf16_pair(rng, (d, n), d ** -0.5)
        want = jax.jit(lambda x, w: x @ w)(xj, wj)
        got = L.dense({"w": wt}, xt)
        np.testing.assert_array_equal(f32(got), f32(want))
    # the attention's PV product, held as XLA holds it: (v^T p^T)^T
    pj, pt = bf16_pair(rng, (4, 4, 31, 31))
    vj, vt = bf16_pair(rng, (4, 31, 4, 16))
    want = jax.jit(lambda p, v: jnp.einsum("bhqk,bkhd->bhqd", p, v))(pj, vj)
    np.testing.assert_array_equal(f32(L._mix(pt, vt)), f32(want))


def _width_chains(n):
    r = (n - 1) % 64 + 1
    return 1 if r > 48 else 2 if 16 < r <= 32 else 4


@pytest.mark.parametrize("m,k,n,flags", [
    (124, 9, 97, {}), (124, 10, 80, {}), (124, 7, 353, {}),
    (124, 45, 225, {}), (80, 5, 153, {}), (80, 11, 345, {}),
    (16, 5, 145, {"rhs_t": True}), (16, 10, 132, {"rhs_t": True})])
def test_cpu_dot_other_order_past_one_tile(m, k, n, flags):
    """Where ``xla_cpu_dot_order`` gives no order for the M > 50 chains
    past one column tile, the library does not take the chains of the
    last tile's width: the bounds pick out no shape the width fits."""
    assert L.xla_cpu_dot_order(m, k, n, **flags) is None
    a, b = _operands(m, k, n, m * 7919 + k * 31 + n)
    width = L._chains(torch.from_numpy(a), torch.from_numpy(b), 0, k,
                      _width_chains(n)).numpy()
    assert not np.array_equal(width, _xla_dot(a, b, **flags))


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue C 1: the M > 50 "
                   "chains past one column tile where the library takes "
                   "another order by K and the tile count (the port takes "
                   "torch's fp32 GEMM)")
def test_cpu_dot_f32_other_order_past_one_tile():
    a, b = _operands(124, 10, 80, 0)
    got = L.cpu_dot_f32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, _xla_dot(a, b, False, False))


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue C 1: few rows with "
                   "K >= 128 and N > 508, where XLA:CPU splits N between "
                   "threads (the port takes torch's fp32 GEMM)")
def test_cpu_dot_f32_few_rows_split_between_threads():
    a, b = _operands(4, 128, 601, 0)
    got = L.cpu_dot_f32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, _xla_dot(a, b, False, False))
