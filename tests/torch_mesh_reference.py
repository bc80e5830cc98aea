"""The reference's runs on host meshes larger than 1 x 1, for
``test_torch_sharding.py``: run as a script in a subprocess whose
environment sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
and ``JAX_PLATFORMS=cpu`` before jax loads (the reference is not
edited for it).

    python tests/torch_mesh_reference.py OUT.pkl

writes two pickles of numpy arrays.  First ``OUT.pkl.inputs`` (published
with a rename as soon as it is complete, so that the port's ranks can
start on it while the rest compiles):

- ``shards``: for qwen3-4b-smoke and granite-moe-1b-a400m-smoke, a
  seeded train state (``init_state(key(1))``) placed with the rules'
  ``state_shardings`` (``device_put``, as the reference's
  ``reshard_state`` places one) on a (2, 2) ("data", "model") mesh and a
  (2, 2, 1) ("pod", "data", "model") mesh: every leaf's
  ``addressable_shards`` by mesh coordinate, and the full state;
- ``params``: the seed-1 parameters (``init_params(key(1))``) of both
  configs, of the MoE configs and of the tensor-parallel cases';
- ``moe_x``: the MoE case's 4 x 16 bf16 tokens from
  ``np.random.default_rng(1)``, by config;
- ``pad_params``: qwen3-4b-smoke's seed-1 parameters with
  ``vocab_pad_multiple=4`` (509 -> 512, which "model" divides);
- ``step_batches``: the three (1, 2) train steps' batches (the
  reference's ``synthetic_batch``, 2 x 32 tokens, seed 5);
- ``tp``: the tensor-parallel cases' inputs (:func:`tp_inputs`).

Then ``OUT.pkl``:

- ``moe``: ``moe_apply_shard_map`` of both MoE smoke configs
  (``use_shard_map=True``; deepseek's with shared experts) on the (2, 2)
  mesh, on ``moe_x`` and the seed-1 parameters of the first MoE block:
  its output and aux;
- ``grads``: the loss and gradients of ``loss_fn`` jitted with the
  rules' shardings (parameters placed by ``PARAM_RULES``, the batch by
  ``data_sharding``) for qwen3-4b-smoke and granite-moe-1b-a400m-smoke
  on (2, 1) and (2, 2), and granite's on (2, 2) with
  ``use_shard_map=True``, on ``case_batch``'s inputs and the seed-1
  parameters; and on (1, 2) qwen3-4b-smoke's padded-vocab variant,
  exact and haloc_axa (``("qwen3-4b+pad4", "1x2", adder)``), and
  gemma3-27b-smoke, exact (``CARRY_ARCH``: its exact adds' carry
  rounded after a tensor-parallel MLP);
- ``steps12``: qwen3-4b-smoke on the (1, 2) mesh, exact and haloc_axa,
  from ``shards``' full state: the first step's loss and gradients, and
  three steps of ``make_train_step`` jitted with the state's and the
  batches' shardings, with and without clipping (``STEP_CASES``): the
  state the first starts from, each step's loss and grad norm and the
  state after it;
- ``tp12``: on the (1, 2) mesh, jitted with the rules' shardings, the
  first block's SwiGLU MLP and attention mixer of qwen3-4b-smoke, the
  attention mixer of qwen1.5-4b-smoke (q/k/v biases) and the whole first
  block of hubert-xlarge-smoke, exact and haloc_axa (``TP_BLOCKS``; its
  GELU MLP's biases) (each: output and VJP on ``tp``'s input and
  cotangent), and the padded variant's embedding lookup and head + CE
  (``loss_fn``'s ``head_loss``);
- ``serve``: SERVE_CASES, the prefill and decode steps jitted with the
  rules' shardings as ``repro.launch.dryrun`` jits them, on the seed-1
  parameters and ``serve_inputs`` (:func:`serve_cases`): each step's
  logits and the cache after the prefill and after the last decode
  step; for FULL_CASES the full-sequence forward's logits too.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model"))}
SHARD_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m")
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
#: (arch, mesh, moe.use_shard_map)
GRAD_CASES = (("qwen3-4b", "2x1", False), ("qwen3-4b", "2x2", False),
              ("granite-moe-1b-a400m", "2x1", False),
              ("granite-moe-1b-a400m", "2x2", False),
              ("granite-moe-1b-a400m", "2x2", True))
MOE_SHAPE = (4, 16)
#: qwen3-4b-smoke's three-step cases on the (1, 2) mesh: (adder, clip).
STEP_CASES = (("off", 1e9), ("haloc_axa", 1e9), ("off", 1.0),
              ("haloc_axa", 1.0))
#: The padded-vocab variant's multiple (509 -> 512).
PAD = 4
#: The tensor-parallel whole-block cases: hubert-xlarge-smoke's first
#: block (bidirectional attention, a GELU MLP with biases), (arch, adder).
TP_BLOCKS = (("hubert-xlarge", "off"), ("hubert-xlarge", "haloc_axa"))
#: The tensor-parallel attention mixer with q/k/v biases.
TP_BIAS_ARCH = "qwen1.5-4b"
#: The config whose first step on (1, 2) holds the carry's rounding after
#: a tensor-parallel MLP (a suffix block reads the pattern's carry).
CARRY_ARCH = "gemma3-27b"
#: The serving cases (``torch_mesh_workers.SERVE_CASES``): the prefill of
#: SERVE_ROWS x SERVE_PROMPT tokens (frames) with a cache of SERVE_CTX,
#: then ``new`` teacher-forced decode steps: (arch, mesh, adder, vocab
#: padding multiple, new).
SERVE_CASES = (("qwen3-4b", "1x2", "off", 1, 4),
               ("qwen3-4b", "1x2", "haloc_axa", 1, 4),
               ("qwen3-4b", "2x2", "off", 1, 4),
               ("qwen3-4b", "2x2", "haloc_axa", 1, 4),
               ("qwen3-4b", "1x2", "off", 4, 4),
               ("qwen1.5-4b", "1x2", "off", 1, 4),
               ("gemma3-27b", "1x2", "off", 1, 4),
               ("gemma3-27b", "1x2", "haloc_axa", 1, 4),
               ("hubert-xlarge", "1x2", "off", 1, 0),
               ("granite-moe-1b-a400m", "2x2", "off", 1, 0))
SERVE_ROWS, SERVE_PROMPT, SERVE_CTX = 4, 32, 40
#: The serving cases whose full-sequence forward (the train step's) is
#: also compared: gemma3-27b-smoke's exact adds carried past a
#: tensor-parallel MLP.
FULL_CASES = (("gemma3-27b", "1x2", "off", 1),)


def step_opt(AdamWConfig, clip):
    """The (1, 2) train steps' optimizer."""
    return AdamWConfig(warmup_steps=2, total_steps=10, clip_norm=clip)


def tp_inputs(d_model, vocab, seed=11, b=2, s=32):
    """The tensor-parallel cases' inputs: bf16-valued x and a cotangent
    (b, s, d_model) float32, tokens and labels (b, s) int32."""
    import ml_dtypes
    rng = np.random.default_rng(seed)

    def bf16(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16).astype(np.float32)

    return {"x": bf16((b, s, d_model)), "g": bf16((b, s, d_model)),
            "tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def serve_inputs(cfg, seed=13):
    """A serving case's inputs: the prompt's ``tokens`` (int32), or an
    audio model's ``frames`` (float32), and the decode steps' teacher-forced
    ``decode`` tokens (int32), from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    shape = (SERVE_ROWS, SERVE_PROMPT)
    out = {"decode": rng.integers(0, cfg.vocab_size, (SERVE_ROWS, 4)).astype(
        np.int32)}
    if cfg.audio is not None:
        out["frames"] = rng.standard_normal(
            shape + (cfg.audio.feat_dim,)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, shape).astype(
            np.int32)
    return out


def case_batch(vocab, b=4, s=32, seed=7):
    """Tokens and labels (int32) of the gradient cases."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def moe_input(d_model, seed=1):
    """The MoE case's (B, S, D) float32 values (bf16-valued)."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(MOE_SHAPE + (d_model,)).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def first_moe_mlp(params, cfg):
    """The first MoE block's MLP parameters (repeat 0 of its pattern
    position), as the reference's stacked tree holds them."""
    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[0]

    i = next(j for j, s in enumerate(cfg.pattern) if s.mlp == "moe")
    return first(params["pattern"][i]["mlp"])


def dump(obj, path):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f, protocol=5)
    os.replace(path + ".tmp", path)


def main(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config
    from repro.data.pipeline import DataConfig, synthetic_batch
    from repro.launch import steps
    from repro.models import attention as RA
    from repro.models import layers as RL
    from repro.models import moe as RMOE
    from repro.models import transformer as RT
    from repro.numerics.approx_ops import make_numerics
    from repro.optim.adamw import AdamWConfig
    from repro.sharding import rules as R

    def mesh_of(name):
        shape, axes = MESHES[name]
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    def coord(mesh, device):
        return tuple(int(i) for i in np.argwhere(mesh.devices == device)[0])

    def smoke(arch, shard_map=False, adder="off", pad=1):
        cfg = get_smoke_config(arch)
        if shard_map:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, use_shard_map=True))
        if adder != "off":
            cfg = cfg.with_approx(make_numerics(adder, "residual"))
        if pad > 1:
            cfg = dataclasses.replace(cfg, vocab_pad_multiple=pad)
        return cfg

    to_np = jax.tree_util.Partial(jax.tree.map, np.asarray)
    init = jax.jit(RT.init_params, static_argnums=1)
    inputs = {"shards": {}, "params": {}, "moe_x": {}}
    opt = AdamWConfig()
    for arch in SHARD_ARCHS:
        cfg = smoke(arch)
        shapes = steps.state_shapes(cfg, opt)
        full = jax.jit(lambda k: steps.init_state(k, cfg, opt))(
            jax.random.key(1))
        for name in ("2x2", "2x2x1"):
            mesh = mesh_of(name)
            state = jax.device_put(full, R.state_shardings(shapes, mesh))
            inputs["shards"][(arch, name)] = {
                jax.tree_util.keystr(p): {coord(mesh, s.device):
                                          np.asarray(s.data)
                                          for s in leaf.addressable_shards}
                for p, leaf in jax.tree_util.tree_leaves_with_path(state)}
        inputs["shards"][(arch, "full")] = to_np(full)
    params = {arch: init(jax.random.key(1), smoke(arch))
              for arch in sorted(set(SHARD_ARCHS + MOE_ARCHS + (
                  TP_BIAS_ARCH,) + tuple(a for a, _ in TP_BLOCKS)
                  + tuple(c[0] for c in SERVE_CASES)))}
    inputs["params"] = {k: to_np(v) for k, v in params.items()}
    inputs["moe_x"] = {arch: moe_input(smoke(arch).d_model)
                       for arch in MOE_ARCHS}
    qwen = smoke("qwen3-4b")
    pad_params = init(jax.random.key(1), smoke("qwen3-4b", pad=PAD))
    inputs["pad_params"] = to_np(pad_params)
    inputs["step_batches"] = [
        synthetic_batch(qwen, DataConfig(seq_len=32, global_batch=2, seed=5),
                        s) for s in range(3)]
    inputs["tp"] = tp_inputs(qwen.d_model, qwen.vocab_size)
    dump(inputs, path + ".inputs")

    res = {"moe": {}, "grads": {}}
    mesh = mesh_of("2x2")
    for arch in MOE_ARCHS:
        cfg = smoke(arch, shard_map=True)
        p = first_moe_mlp(params[arch], cfg)
        x = jnp.asarray(inputs["moe_x"][arch], jnp.bfloat16)
        with mesh:
            out, aux = jax.jit(lambda p, x: RMOE.moe_apply_shard_map(
                p, cfg, x, batch_axes=("data",), mesh=mesh))(p, x)
        res["moe"][arch] = {"out": np.asarray(out.astype(jnp.float32)),
                            "aux": float(aux)}

    def value_and_grad(cfg, p, batch, mesh):
        p_sh = R.tree_shardings(jax.eval_shape(lambda: p), mesh,
                                R.PARAM_RULES)
        b_sh = R.data_sharding(batch, mesh)
        ba = R.batch_axes(mesh)

        def vg(p, b):
            return jax.value_and_grad(lambda q: RT.loss_fn(
                q, cfg, b, batch_axes=ba, mesh=mesh), has_aux=True)(p)

        with mesh:
            (loss, parts), grads = jax.jit(
                vg, in_shardings=(p_sh, b_sh))(p, batch)
        return {"loss": float(loss), "aux": float(parts["aux"]),
                "grads": to_np(grads)}

    def jnp_batch(batch):
        return {k: jnp.asarray(v) for k, v in batch.items()}

    for arch, name, shard_map in GRAD_CASES:
        cfg = smoke(arch, shard_map)
        res["grads"][(arch, name, shard_map)] = value_and_grad(
            cfg, params[arch], jnp_batch(case_batch(cfg.vocab_size)),
            mesh_of(name))
    one_two = mesh_of("1x2")
    for adder in ("off", "haloc_axa"):
        cfg = smoke("qwen3-4b", adder=adder, pad=PAD)
        res["grads"][("qwen3-4b+pad4", "1x2", adder)] = value_and_grad(
            cfg, pad_params, jnp_batch(case_batch(cfg.vocab_size)), one_two)
    cfg = smoke(CARRY_ARCH)
    res["grads"][(CARRY_ARCH, "1x2", False)] = value_and_grad(
        cfg, params[CARRY_ARCH], jnp_batch(case_batch(cfg.vocab_size)),
        one_two)

    res["steps12"] = {}
    full = inputs["shards"][("qwen3-4b", "full")]
    batches = [jnp_batch(b) for b in inputs["step_batches"]]
    for adder, clip in STEP_CASES:
        cfg = smoke("qwen3-4b", adder=adder)
        opt = step_opt(AdamWConfig, clip)
        st_sh = R.state_shardings(steps.state_shapes(cfg, opt), one_two)
        b_sh = R.data_sharding(batches[0], one_two)
        ba = R.batch_axes(one_two)
        with one_two:
            fn = jax.jit(steps.make_train_step(cfg, opt, batch_axes=ba,
                                               mesh=one_two),
                         in_shardings=(st_sh, b_sh))
            state = jax.device_put(jax.tree.map(jnp.asarray, full), st_sh)
            rows, states = [], []
            for b in batches:
                state, met = fn(state, b)
                rows.append((float(met["loss"]), float(met["grad_norm"])))
                states.append(to_np(state))
        res["steps12"][(adder, clip)] = {
            "rows": rows, "states": states, "start": full,
            "first": value_and_grad(cfg, jax.tree.map(jnp.asarray,
                                                      full["params"]),
                                    batches[0], one_two)}

    res["tp12"] = tp_cases(jax, jnp, RA, RL, R, smoke, params, pad_params,
                           inputs["tp"], one_two, to_np)
    res["serve"] = serve_cases(jax, jnp, R, steps, smoke, params, pad_params,
                               mesh_of, to_np)
    dump(res, path)


def serve_cases(jax, jnp, R, steps, smoke, params, pad_params, mesh_of,
                to_np):
    """SERVE_CASES: the prefill step and the decode steps jitted with the
    rules' shardings as ``repro.launch.dryrun`` jits them (the parameters
    by ``PARAM_RULES``, the batch by ``data_sharding``, the cache by
    ``cache_shardings``, the position replicated) on the seed-1
    parameters and ``serve_inputs``: {case: {"logits": [the prefill's,
    each decode step's] as float32, "prefill_cache": the cache after the
    prefill, "cache": after the last decode step; for FULL_CASES "full":
    ``forward(mode="full")``'s logits jitted the same way}}."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as RT

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    out = {}
    for arch, name, adder, pad, new in SERVE_CASES:
        cfg = smoke(arch, adder=adder, pad=pad)
        mesh = mesh_of(name)
        p = pad_params if pad > 1 else params[arch]
        inp = serve_inputs(cfg)
        batch = {k: jnp.asarray(v) for k, v in inp.items() if k != "decode"}
        ba = R.batch_axes(mesh)
        p_sh = R.tree_shardings(jax.eval_shape(lambda: p), mesh,
                                R.PARAM_RULES)
        with mesh:
            prefill = jax.jit(steps.make_prefill_step(cfg, SERVE_CTX,
                                                      batch_axes=ba),
                              in_shardings=(p_sh, R.data_sharding(batch,
                                                                  mesh)))
            logits, cache = prefill(p, batch)
            rec = {"logits": [f32(logits)], "prefill_cache": to_np(cache)}
            if new:
                c_sh = R.cache_shardings(jax.eval_shape(lambda: cache), mesh)
                toks = jnp.asarray(inp["decode"])
                decode = jax.jit(steps.make_decode_step(cfg, batch_axes=ba),
                                 in_shardings=(
                                     p_sh, R.data_sharding(
                                         {"tokens": toks[:, :1]}, mesh),
                                     NamedSharding(mesh, P()), c_sh),
                                 donate_argnums=(3,))
                for i in range(new):
                    logits, cache = decode(p, {"tokens": toks[:, i:i + 1]},
                                           jnp.int32(SERVE_PROMPT + i), cache)
                    rec["logits"].append(f32(logits))
            rec["cache"] = to_np(cache)
            if (arch, name, adder, pad) in FULL_CASES:
                rec["full"] = f32(jax.jit(
                    lambda p, b: RT.forward(p, cfg, b, mode="full",
                                            batch_axes=ba)[0],
                    in_shardings=(p_sh, R.data_sharding(batch, mesh)))(
                        p, batch))
        out[(arch, name, adder, pad)] = rec
    return out


def tp_cases(jax, jnp, RA, RL, R, smoke, params, pad_params, inp, mesh,
             to_np):
    """The tensor-parallel cases on ``mesh``, each jitted with the rules'
    shardings on its parameters (a block's leaves under their block
    paths) and its activations replicated: {"swiglu" | "attn" |
    "attn_bias" | (arch, adder) of ``TP_BLOCKS``: (output, VJP of the
    parameters and x), "lookup": output, "ce": loss}, the outputs as
    float32 numpy."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.models import transformer as RT
    cfg = smoke("qwen3-4b")
    block = jax.tree.map(lambda a: a[0], params["qwen3-4b"]["pattern"][0])
    x = jnp.asarray(inp["x"], jnp.bfloat16)
    g = jnp.asarray(inp["g"], jnp.bfloat16)
    rep = NamedSharding(mesh, P())

    def shardings(tree):
        return R.tree_shardings(jax.eval_shape(lambda: tree), mesh,
                                R.PARAM_RULES)

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    positions = jnp.arange(x.shape[1], dtype=jnp.int32)

    def first_block(arch):
        return jax.tree.map(lambda a: a[0], params[arch]["pattern"][0])

    def attn(c, blk):
        return (lambda b, x: RA.attn_apply(b["mixer"], c, c.pattern[0], x,
                                           positions),
                {"mixer": blk["mixer"]})

    def whole_block(c, blk):
        return (lambda b, x: RT.block_apply(
            b, c, c.pattern[0], x, {"positions": positions}, None,
            "full")[0], blk)

    fns = {"swiglu": (lambda blk, x: RL.swiglu(blk["mlp"], x),
                      {"mlp": block["mlp"]}),
           "attn": attn(cfg, block),
           "attn_bias": attn(smoke(TP_BIAS_ARCH), first_block(TP_BIAS_ARCH))}
    for arch, adder in TP_BLOCKS:
        fns[(arch, adder)] = whole_block(smoke(arch, adder=adder),
                                         first_block(arch))

    def run(fn, blk):
        def fwd_vjp(b, x, g):
            return jax.vjp(fn, b, x)[1](g)

        y = jax.jit(fn, in_shardings=(shardings(blk), rep))(blk, x)
        gb, gx = jax.jit(fwd_vjp, in_shardings=(shardings(blk), rep, rep))(
            blk, x, g)
        return f32(y), {"params": to_np(gb), "x": f32(gx)}

    out = {}
    with mesh:
        for name, (fn, blk) in fns.items():
            out[name] = run(fn, blk)
        pcfg = smoke("qwen3-4b", pad=PAD)
        tokens = jnp.asarray(inp["tokens"])
        labels = jnp.asarray(inp["labels"])
        emb = {"embed": pad_params["embed"]}
        out["lookup"] = f32(jax.jit(
            lambda p, t: RT_embed(p, pcfg, t),
            in_shardings=(shardings(emb), rep))(emb, tokens))
        head = {"lm_head": pad_params["lm_head"]}
        out["ce"] = float(jax.jit(
            lambda p, x, lab: RT_head_loss(jnp, RL, pcfg, p["lm_head"], x,
                                           lab),
            in_shardings=(shardings(head), rep, rep))(head, x, labels))
    return out


def RT_embed(p, cfg, tokens):
    """``transformer.embed_input``'s lookup."""
    from repro.models import transformer as RT
    return RT.embed_input(p, cfg, {"tokens": tokens})[0]


def RT_head_loss(jnp, RL, cfg, w, x, labels):
    """``transformer.loss_fn``'s ``head_loss`` (without its checkpoint,
    which changes no value)."""
    import jax
    from repro.models import transformer as RT
    logits = RL.dense(w, x)
    if cfg.padded_vocab != cfg.vocab_size:
        viota = jax.lax.broadcasted_iota(jnp.int32, logits.shape,
                                         logits.ndim - 1)
        logits = jnp.where(viota < cfg.vocab_size, logits,
                           jnp.asarray(RL.NEG_INF, logits.dtype))
    return RT.softmax_cross_entropy(logits, labels).mean()


if __name__ == "__main__":
    main(sys.argv[1])
