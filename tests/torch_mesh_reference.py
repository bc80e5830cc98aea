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
- ``params``: both configs' seed-1 parameters (``init_params(key(1))``);
- ``moe_x``: the MoE case's 4 x 16 bf16 tokens from
  ``np.random.default_rng(1)``, by config.

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
  parameters.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model"))}
SHARD_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m")
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
#: (arch, mesh, moe.use_shard_map)
GRAD_CASES = (("qwen3-4b", "2x1", False), ("qwen3-4b", "2x2", False),
              ("granite-moe-1b-a400m", "2x1", False),
              ("granite-moe-1b-a400m", "2x2", False),
              ("granite-moe-1b-a400m", "2x2", True))
MOE_SHAPE = (4, 16)


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
    from repro.launch import steps
    from repro.models import moe as RMOE
    from repro.models import transformer as RT
    from repro.optim.adamw import AdamWConfig
    from repro.sharding import rules as R

    def mesh_of(name):
        shape, axes = MESHES[name]
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    def coord(mesh, device):
        return tuple(int(i) for i in np.argwhere(mesh.devices == device)[0])

    def smoke(arch, shard_map=False):
        cfg = get_smoke_config(arch)
        if shard_map:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, use_shard_map=True))
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
              for arch in sorted(set(SHARD_ARCHS + MOE_ARCHS))}
    inputs["params"] = {k: to_np(v) for k, v in params.items()}
    inputs["moe_x"] = {arch: moe_input(smoke(arch).d_model)
                       for arch in MOE_ARCHS}
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

    for arch, name, shard_map in GRAD_CASES:
        cfg = smoke(arch, shard_map)
        mesh = mesh_of(name)
        batch = {k: jnp.asarray(v) for k, v in
                 case_batch(cfg.vocab_size).items()}
        p_sh = R.tree_shardings(jax.eval_shape(lambda: params[arch]), mesh,
                                R.PARAM_RULES)
        b_sh = R.data_sharding(batch, mesh)
        ba = R.batch_axes(mesh)

        def vg(p, b):
            return jax.value_and_grad(lambda q: RT.loss_fn(
                q, cfg, b, batch_axes=ba, mesh=mesh), has_aux=True)(p)

        with mesh:
            (loss, parts), grads = jax.jit(
                vg, in_shardings=(p_sh, b_sh))(params[arch], batch)
        res["grads"][(arch, name, shard_map)] = {
            "loss": float(loss), "aux": float(parts["aux"]),
            "grads": to_np(grads)}
    dump(res, path)


if __name__ == "__main__":
    main(sys.argv[1])
