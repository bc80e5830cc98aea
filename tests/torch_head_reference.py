"""How the reference's partitioned prefill and decode steps compute the
head, read from their compiled HLO: ``python torch_head_reference.py``
prints one JSON object, {case id: "columns" | "rows" | "whole"}, for
each of ``HEAD_CASES``.

Each step is jitted as ``repro.launch.dryrun`` jits it (the parameters
by ``PARAM_RULES``, the batch by ``data_sharding``, at decode the cache
by ``cache_shardings`` and the position replicated), lowered on abstract
shapes and compiled for a mesh of XLA host devices (it sets
``--xla_force_host_platform_device_count`` to ``DEVICES`` before jax
loads; nothing is allocated):

- "columns": the step returns each "model" rank's vocabulary columns of
  the logits (its result's last dim V/m);
- "rows": the logits are whole on every rank and an all-reduce sums
  fp32 partials of the whole vocabulary (each "model" rank's share of
  the head's d_model rows), each partial rounded to bf16 first
  ("rows unrounded" if not);
- "whole": neither (the head's rows gathered, the product whole).

``test_torch_tp_serving.py`` holds the port's choice
(``models.transformer.head_rows_split``, the dry run's
``collective_plan``) to it.
"""

import dataclasses
import json
import os
import re
import sys

#: The host devices of the largest mesh below.
DEVICES = 512
#: (arch, full width, vocabulary padding multiple, mesh shape, step
#: kind): smoke widths, or the full width cut to one repeat of the
#: pattern; the 3-dim meshes are ("pod", "data", "model").
HEAD_CASES = tuple(
    [("qwen3-4b", False, 1, m, k)
     for m in ((16, 16), (4, 16), (2, 16), (8, 8), (4, 8), (2, 2), (16, 8),
               (8, 4), (4, 2), (2, 16, 16))
     for k in ("prefill", "decode")]
    + [("qwen3-4b", False, 4, (16, 16), k) for k in ("prefill", "decode")]
    + [("granite-moe-1b-a400m", True, 1, m, "decode")
       for m in ((16, 16), (2, 16, 16))]
    + [("mamba2-1.3b", True, 1, m, k) for m in ((16, 16), (2, 16, 16))
       for k in ("prefill", "decode")]
    + [("hubert-xlarge", True, 1, (16, 16), "prefill")])
#: Rows, prompt length and context of the compiled steps.
ROWS, PROMPT, CTX = 32, 8, 16


def case_id(case):
    arch, full, pad, mesh, kind = case
    return "-".join([arch, "full" if full else "smoke", f"pad{pad}",
                     "x".join(map(str, mesh)), kind])


def config(arch, full, pad):
    from repro.configs import get_config, get_smoke_config
    cfg = dataclasses.replace(get_config(arch), repeats=1) if full else \
        get_smoke_config(arch)
    return dataclasses.replace(cfg, vocab_pad_multiple=pad) if pad > 1 \
        else cfg


def read(case):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.launch.steps import (cache_shapes, make_decode_step,
                                    make_prefill_step, params_shapes)
    from repro.sharding import rules as R
    arch, full, pad, shape, kind = case
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)
    cfg = config(arch, full, pad)
    ba = R.batch_axes(mesh)
    p_shapes = params_shapes(cfg)
    p_sh = R.tree_shardings(p_shapes, mesh, R.PARAM_RULES)
    with mesh:
        if kind == "prefill":
            specs = {"tokens": jax.ShapeDtypeStruct((ROWS, PROMPT),
                                                    jnp.int32)} \
                if cfg.audio is None else {"frames": jax.ShapeDtypeStruct(
                    (ROWS, PROMPT, cfg.audio.feat_dim), jnp.float32)}
            step = jax.jit(make_prefill_step(cfg, CTX, batch_axes=ba),
                           in_shardings=(p_sh, R.data_sharding(specs, mesh)))
            args = (p_shapes, specs)
        else:
            specs = {"tokens": jax.ShapeDtypeStruct((ROWS, 1), jnp.int32)}
            c_shapes = cache_shapes(cfg, ROWS, CTX)
            step = jax.jit(make_decode_step(cfg, batch_axes=ba),
                           in_shardings=(p_sh, R.data_sharding(specs, mesh),
                                         NamedSharding(mesh, P()),
                                         R.cache_shardings(c_shapes, mesh)),
                           donate_argnums=(3,))
            args = (p_shapes, specs, jax.ShapeDtypeStruct((), jnp.int32),
                    c_shapes)
        text = step.lower(*args).compile().as_text()
    v = cfg.padded_vocab
    entry = next(line for line in text.splitlines()
                 if line.startswith("ENTRY"))
    last = int(re.search(r"-> \(\w+\[([0-9,]+)\]", entry).group(1)
               .split(",")[-1])
    if last != v:
        return "columns"
    summed = re.search(
        r"= f32\[[0-9]+,[0-9]+,%d\]\S* all-reduce\(%%([\w.-]+)" % v, text)
    if not summed:
        return "whole"
    # the partials: the product rounded to bf16 and promoted back
    operand = re.search(r"%%%s = .*calls=%%([\w.-]+)" % re.escape(
        summed.group(1)), text)
    body = text[text.index(f"%{operand.group(1)} "):]
    body = body[:body.index("\n}")]
    return "rows" if re.search(r"= bf16\[[0-9,]+\]\S* convert\(", body) \
        else "rows unrounded"


def main():
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={DEVICES}"
    print(json.dumps({case_id(c): read(c) for c in HEAD_CASES}))


if __name__ == "__main__":
    sys.exit(main())
