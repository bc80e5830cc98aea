"""The port's optimizer and gradient compression
(``repro_torch.optim.adamw``, ``optim.compression``) against
``repro.optim``'s, on the CPU, on the same numpy-seeded inputs.

- ``schedule`` at steps 0-120 equals the reference's jitted schedule;
- ``update``, given the reference's gradients and states, equals the
  reference's jitted update bit for bit (parameters, ``m``, ``v``, the
  learning rate, the global norm), clipped or not;
- ``global_norm`` equals the reference's jitted one bit for bit (each
  leaf's sum of squares XLA:CPU's reduction; a pattern's unstacked
  blocks summed as the reference's stacked leaves), the quadratic the
  reference's test converges on,
  weight decay on ``ndim >= 2`` only, and the in-place contract; a
  pattern's unstacked vectors decayed as the reference's stacked ones,
  bit for bit;
- ``topk_sparsify_with_ef`` equals the reference's over several steps,
  and its error feedback preserves the signal;
- int8 stochastic rounding is unbiased, bounded and seeded (the same
  noise in every process: a SHA-256 of the seed and the leaf's path);
- ``make_grad_transform``'s kinds and errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C

SHAPES = {"w": (16, 40), "b": (40,), "e": (3, 5, 7)}


def tree_np(rng, scale=1.0, positive=False):
    return {k: ((rng.random(s) if positive else rng.standard_normal(s))
                * scale).astype(np.float32) for k, s in SHAPES.items()}


def to_torch(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def test_schedule_matches_reference():
    for cfg in (A.AdamWConfig(warmup_steps=5, total_steps=60),
                A.AdamWConfig()):
        ref = RA.AdamWConfig(**{f: getattr(cfg, f) for f in
                                cfg.__dataclass_fields__})
        fn = jax.jit(lambda s: RA.schedule(ref, s))
        for step in range(121):
            assert float(A.schedule(cfg, step)) == float(fn(jnp.int32(step)))
            assert float(A.schedule(cfg, torch.tensor(step))) == \
                float(fn(jnp.int32(step)))


@pytest.mark.parametrize("count", [0, 3, 7, 30])
@pytest.mark.parametrize("gscale", [1e-3, 10.0])
def test_update_matches_reference_bit_for_bit(gscale, count):
    rng = np.random.default_rng(int(gscale * 1000) + count)
    params, grads = tree_np(rng), tree_np(rng, gscale)
    m, v = tree_np(rng, 0.01), tree_np(rng, 1e-4, positive=True)
    cfg = A.AdamWConfig(warmup_steps=5, total_steps=60)
    ref_cfg = RA.AdamWConfig(warmup_steps=5, total_steps=60)
    j = jax.tree.map(jnp.asarray, {"p": params, "g": grads, "m": m,
                                   "v": v})
    rp, ropt, rmet = jax.jit(lambda g, o, p: RA.update(ref_cfg, g, o, p))(
        j["g"], {"m": j["m"], "v": j["v"], "count": jnp.int32(count)},
        j["p"])
    tp, topt, tmet = A.update(cfg, to_torch(grads), {
        "m": to_torch(m), "v": to_torch(v),
        "count": torch.tensor(count, dtype=torch.int32)}, to_torch(params))
    assert float(tmet["grad_norm"]) == float(rmet["grad_norm"])
    assert int(topt["count"]) == int(ropt["count"]) == count + 1
    assert float(tmet["lr"]) == float(rmet["lr"])
    for k in SHAPES:
        for got, want in ((tp[k], rp[k]), (topt["m"][k], ropt["m"][k]),
                          (topt["v"][k], ropt["v"][k])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_global_norm_matches_reference():
    g = tree_np(np.random.default_rng(5), 3.0)
    want = float(jax.jit(RA.global_norm)(jax.tree.map(jnp.asarray, g)))
    assert float(A.global_norm(to_torch(g))) == want


@pytest.mark.parametrize("shapes", [
    {"a": (7,), "b": (3, 5, 7), "c": (5, 32)},
    {"emb": (300, 64), "row": (1000,), "cube": (40, 33, 65)},
    {"s": (), "v": (33,), "m": (64, 96)}])
def test_xla_sum_of_squares_matches_reference(shapes):
    """Each leaf's sum of squares alone, short leaves (one fused FMA
    chain) and long ones (rounded squares, windows of 32), bit for bit."""
    rng = np.random.default_rng(len(shapes) + sum(map(len, shapes.values())))
    for name, shape in shapes.items():
        g = (rng.standard_normal(shape) * 2.5).astype(np.float32)
        want = float(jax.jit(RA.global_norm)({name: jnp.asarray(g)}))
        assert float(A.global_norm({name: torch.tensor(g)})) == want, shape


def test_global_norm_of_an_unstacked_pattern_matches_the_stacked_reference():
    """The reference stacks a pattern position's blocks into one leaf; the
    port sums its unstacked blocks as that leaf, in the reference's leaf
    order."""
    rng = np.random.default_rng(11)
    repeats = 3
    block = {"scale": (40,), "w": (40, 24), "gate": ()}
    outer = {"final_norm": {"scale": (40,)}, "embed": {"table": (50, 40)}}
    top = {k: {n: (rng.standard_normal(sh) * 3).astype(np.float32)
               for n, sh in leaf.items()} for k, leaf in outer.items()}
    stacked = {n: (rng.standard_normal((repeats, *sh)) * 3).astype(np.float32)
               for n, sh in block.items()}
    want = float(jax.jit(RA.global_norm)(jax.tree.map(
        jnp.asarray, {**top, "pattern": [stacked]})))
    port = {**jax.tree.map(lambda x: torch.tensor(np.array(x)), top),
            "pattern": [[{n: torch.tensor(x[r]) for n, x in stacked.items()}
                         for r in range(repeats)]]}
    assert float(A.global_norm(port)) == want


def test_adamw_converges_quadratic():
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    opt = A.init(params)
    cfg = A.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=300,
                        weight_decay=0.0)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, _ = A.update(cfg, grads, opt, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_weight_decay_only_on_matrices_and_update_in_place():
    params = {"w": torch.ones(4, 3), "b": torch.ones(3),
              "nest": [{"k": torch.ones(2, 2, 2)}]}
    grads = {"w": torch.zeros(4, 3), "b": torch.zeros(3),
             "nest": [{"k": torch.zeros(2, 2, 2)}]}
    opt = A.init(params)
    assert opt["m"]["nest"][0]["k"].dtype == torch.float32
    w = params["w"]
    cfg = A.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10)
    new, new_opt, met = A.update(cfg, grads, opt, params)
    assert new["w"] is w                       # updated in place
    lr = float(met["lr"])
    assert torch.all(new["w"] < 1) and torch.all(new["nest"][0]["k"] < 1)
    np.testing.assert_allclose(new["w"].numpy(), 1 - lr * 0.1, rtol=1e-6)
    assert torch.equal(new["b"], torch.ones(3))
    assert int(new_opt["count"]) == 1


def test_weight_decay_on_pattern_leaves_as_the_reference_stacks_them():
    """The reference decays by its own leaves' ndim, and a pattern
    position's blocks are stacked there: the port's unstacked pattern
    vectors decay too (scalars do not), the other vectors do not."""
    rng = np.random.default_rng(9)
    repeats = 2
    block = {"scale": (8,), "w": (8, 4), "gate": ()}
    outer = {"final_norm": {"scale": (8,)}, "embed": {"table": (5, 8)}}

    def draw(scale):
        return ({k: {n: (rng.standard_normal(sh) * scale).astype(np.float32)
                     for n, sh in leaf.items()} for k, leaf in outer.items()},
                {n: (rng.standard_normal((repeats, *sh)) * scale).astype(
                    np.float32) for n, sh in block.items()})

    trees = {}
    for name, scale in (("p", 1.0), ("g", 1e-3), ("m", 0.01)):
        top, stacked = draw(scale)
        trees[name] = (top, stacked)
    vtop, vstacked = draw(1e-2)
    trees["v"] = (jax.tree.map(lambda x: x * x, vtop),
                  {n: x * x for n, x in vstacked.items()})

    def ref_tree(name):
        top, stacked = trees[name]
        return jax.tree.map(jnp.asarray, {**top, "pattern": [stacked]})

    def port_tree(name):
        top, stacked = trees[name]
        return {**jax.tree.map(lambda x: torch.tensor(np.array(x)), top),
                "pattern": [[{n: torch.tensor(np.array(x[r]))
                              for n, x in stacked.items()}
                             for r in range(repeats)]]}

    cfg = A.AdamWConfig(warmup_steps=0, total_steps=10)
    ref_cfg = RA.AdamWConfig(warmup_steps=0, total_steps=10)
    rp, ropt, _ = jax.jit(lambda g, o, p: RA.update(ref_cfg, g, o, p))(
        ref_tree("g"), {"m": ref_tree("m"), "v": ref_tree("v"),
                        "count": jnp.int32(2)}, ref_tree("p"))
    tp, topt, _ = A.update(cfg, port_tree("g"), {
        "m": port_tree("m"), "v": port_tree("v"),
        "count": torch.tensor(2, dtype=torch.int32)}, port_tree("p"))
    for got, want in ((tp, rp), (topt["m"], ropt["m"]),
                      (topt["v"], ropt["v"])):
        for k in outer:
            for n in outer[k]:
                np.testing.assert_array_equal(got[k][n].numpy(),
                                              np.asarray(want[k][n]))
        for r in range(repeats):
            for n in block:
                np.testing.assert_array_equal(
                    got["pattern"][0][r][n].numpy(),
                    np.asarray(want["pattern"][0][n][r]))


# ------------------------------------------------------------ compression --

def test_topk_sparsify_with_ef_matches_reference():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32),
         "b": rng.standard_normal(37).astype(np.float32)}
    ref_g = jax.tree.map(jnp.asarray, g)
    ref_ef = RC.init_error_feedback(ref_g)
    ef = C.init_error_feedback(to_torch(g))
    for _ in range(5):
        rk, ref_ef = jax.jit(lambda a, b: RC.topk_sparsify_with_ef(
            a, b, 0.05))(ref_g, ref_ef)
        kept, ef = C.topk_sparsify_with_ef(to_torch(g), ef, 0.05)
        for k in g:
            np.testing.assert_array_equal(kept[k].numpy(), np.asarray(rk[k]))
            np.testing.assert_array_equal(ef[k].numpy(),
                                          np.asarray(ref_ef[k]))


def test_topk_error_feedback_preserves_signal():
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=(64, 64)),
                           dtype=torch.float32)}
    ef = C.init_error_feedback(g)
    total = torch.zeros_like(g["w"])
    steps = 200
    for _ in range(steps):
        kept, ef = C.topk_sparsify_with_ef(g, ef, ratio=0.05)
        total = total + kept["w"]
    np.testing.assert_allclose((total / steps).numpy(), g["w"].numpy(),
                               atol=0.1)
    assert float(ef["w"].abs().max()) < 20.0


def test_int8_quantize_dequantize_unbiased_and_seeded():
    g = {"w": torch.linspace(-1, 1, 1024), "nest": [torch.ones(3, 5)]}
    out = C.int8_quantize_dequantize(g)
    err = (out["w"] - g["w"]).numpy()
    assert np.max(np.abs(err)) < 2.0 / 127
    # unbiased: averaged over seeds the error vanishes
    mean = torch.stack([C.int8_quantize_dequantize(g, seed=s)["w"]
                        for s in range(200)]).mean(0)
    assert float((mean - g["w"]).abs().max()) < 2e-3
    # seeded: the same seed gives the same values, another seed others
    assert torch.equal(C.int8_quantize_dequantize(g, seed=3)["w"],
                       C.int8_quantize_dequantize(g, seed=3)["w"])
    assert not torch.equal(C.int8_quantize_dequantize(g, seed=3)["w"],
                           C.int8_quantize_dequantize(g, seed=4)["w"])
    # the same in every process: a stable hash of (seed, path)
    assert C.leaf_seed(0, ("w",)) == C.leaf_seed(0, ("w",)) != \
        C.leaf_seed(0, ("nest", 0))
    assert C.leaf_seed(0, ("w",)) == 2529535730404094287
    # the reference's own bound on the same values
    ref = RC.int8_quantize_dequantize({"w": jnp.linspace(-1, 1, 1024)})
    assert np.max(np.abs(np.asarray(ref["w"]) - np.linspace(-1, 1, 1024))) \
        < 2.0 / 127


def test_make_grad_transform_kinds_and_errors():
    assert C.make_grad_transform(C.CompressionConfig("none")) is None
    assert RC.make_grad_transform(RC.CompressionConfig("none")) is None
    fn = C.make_grad_transform(C.CompressionConfig("int8"))
    g = {"w": torch.linspace(-1, 1, 64)}
    assert torch.equal(fn(g)["w"], C.int8_quantize_dequantize(g)["w"])
    for kind in ("topk_ef", "bogus"):
        with pytest.raises(ValueError, match=kind):
            C.make_grad_transform(C.CompressionConfig(kind))
        with pytest.raises(ValueError, match=kind):
            RC.make_grad_transform(RC.CompressionConfig(kind))
