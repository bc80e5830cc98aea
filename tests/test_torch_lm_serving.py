"""The port's LM serving path (``repro_torch.models.transformer``,
``models.serving``, ``launch.steps``, ``launch.serve``) against
``repro``'s, on the CPU, at the four dense smoke configs and the two MoE
ones (granite-moe-1b-a400m; deepseek-v2-236b with MLA).

The reference generates greedily (its jitted prefill and decode steps,
as ``repro.models.serving.generate`` runs them), keeping each step's
logits; its parameters are carried across by
``models.weights.from_reference``.  Tolerance: the reference's own parity
rule, max |d| / max(1, max |logit|) < 0.04.

- ``forward`` in the full, prefill and decode modes, exact and under
  haloc_axa, within the rule, and its MoE aux loss within 1e-6 relative
  under haloc_axa (1e-3 with exact adds: ROADMAP Queue C 2);
  the prefill cache's tensors within the rule too and its positions
  exactly;
- under haloc_axa the full-mode and teacher-forced logits equal the
  reference's bit for bit, the dense configs at seeds 1-4 and the MoE
  ones at seed 1 (ROADMAP Queue C 1: the CPU products follow XLA:CPU's
  order of summation);
- ``generate``, teacher-forced: the reference's tokens fed to the port's
  prefill and decode give every step's logits within the rule, and the
  port's top-1 equals the reference's token at every step where the
  reference's top-1 leads its top-2 by more than twice the tolerance (the
  count of such steps is reported, and must not be 0); the port's own
  greedy ``generate`` returns the logits of its own teacher-forced run;
- the reference's prefill/decode parity test, run on the port (MoE at
  capacity factor 8, one sequence chunk, within 0.08, as there);
- sampling is deterministic under a seed, with tokens in the vocabulary;
- ``launch.serve.main`` runs on the CPU and prints its report line;
- ``init_params`` and the meta-device shapes follow the reference's tree;
- without a card the defaults raise and never carry on on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.launch import steps as ref_steps
from repro.models import serving as ref_serving
from repro.models import transformer as RT
from repro.numerics import approx_ops as ref_ops
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models import weights as W
from repro_torch.models.serving import (generate, teacher_forced_logits,
                                        throughput_report)
from repro_torch.numerics import approx_ops as ops

DENSE = ("qwen3-4b", "gemma3-27b", "qwen1.5-4b", "qwen1.5-32b")
MOE = ("granite-moe-1b-a400m", "deepseek-v2-236b")
ARCHS = DENSE + MOE
TOL = 0.04
#: The reference's parity rule with MoE layers (tests/test_models_smoke.py).
MOE_TOL = 0.08
CPU = "cpu"
#: The generation held against the reference: 4 prompts of 20 tokens, 12
#: new tokens each (48 steps to compare tokens at).
PROMPT, NEW, BATCH = 20, 12, 4


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_err(got, want):
    got, want = f32(got), f32(want)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def port_cfg(name, adder):
    cfg = get_smoke_config(name)
    if adder != "off":
        cfg = cfg.with_approx(ops.make_numerics(adder, "residual",
                                                backend="torch", device=CPU))
    return cfg


@functools.lru_cache(maxsize=None)
def reference_steps(name, adder):
    """The reference's config and its jitted init, prefill, decode and
    full forward, compiled once for every seed."""
    rcfg = ref_get_smoke(name)
    if adder != "off":
        rcfg = rcfg.with_approx(ref_ops.make_numerics(adder, "residual"))
    return (rcfg, jax.jit(RT.init_params, static_argnums=1),
            jax.jit(ref_steps.make_prefill_step(rcfg, PROMPT + NEW)),
            jax.jit(ref_steps.make_decode_step(rcfg)),
            jax.jit(lambda p, t: RT.forward(p, rcfg, {"tokens": t})))


@functools.lru_cache(maxsize=None)
def reference_run(name, adder, seed=1):
    """The reference's greedy generation of NEW tokens after a PROMPT-long
    prompt, each step's logits kept (B, NEW, V), its prefill cache, and
    its full-mode logits and aux loss on the generated sequence less its
    last token; the parameters as numpy.  (Call it with ``seed`` only
    when it is not 1, so that the runs are shared.)"""
    rcfg, init, prefill, decode, forward = reference_steps(name, adder)
    rp = init(jax.random.key(seed), rcfg)
    prompt = np.random.default_rng(seed).integers(
        0, rcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    logits, cache = prefill(rp, {"tokens": jnp.asarray(prompt)})
    pre_cache = jax.tree.map(np.asarray, cache)
    out, steps_ = [jnp.asarray(prompt)], []
    for i in range(NEW):
        steps_.append(logits[:, -1])
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out.append(nxt)
        if i < NEW - 1:
            logits, cache = decode(rp, {"tokens": nxt}, jnp.int32(PROMPT + i),
                                   cache)
    toks = np.asarray(jnp.concatenate(out, axis=1))
    full, _, aux = forward(rp, jnp.asarray(toks[:, :-1]))
    return (jax.tree.map(np.asarray, rp), toks,
            f32(jnp.stack(steps_, axis=1)), pre_cache, f32(full),
            float(aux))


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
@pytest.mark.parametrize("name", ARCHS)
def test_forward_modes_match_reference(name, adder):
    tree, toks, ref_steps_, ref_cache, ref_full, ref_aux = reference_run(
        name, adder)
    cfg = port_cfg(name, adder)
    params = W.from_reference(tree, cfg, device=CPU)
    full, cache, aux = T.forward(params, cfg, {"tokens": toks[:, :-1]},
                                 mode="full")
    assert cache is None and aux.dtype == torch.float32
    # haloc_axa's activations equal the reference's bit for bit; exact
    # adds round some sums differently (ROADMAP Queue C 2), and the
    # router's probabilities follow
    aux_tol = 1e-6 if adder == "haloc_axa" else 1e-3
    assert abs(float(aux) - ref_aux) <= aux_tol * abs(ref_aux)
    assert (ref_aux != 0.0) == (cfg.moe is not None)
    assert full.shape == ref_full.shape and full.dtype == torch.bfloat16
    errs = {"full": rel_err(full, ref_full)}
    _, pc = steps.make_prefill_step(cfg, PROMPT + NEW)(
        params, {"tokens": toks[:, :PROMPT]})
    want = W.cache_from_reference(ref_cache, cfg, device=CPU)
    for got_c, want_c in zip(T.blocks_in_order(cfg, pc),
                             T.blocks_in_order(cfg, want), strict=True):
        assert sorted(got_c) == sorted(want_c)
        for key, w in want_c.items():
            if key == "pos":
                assert torch.equal(got_c["pos"], w)
                continue
            assert got_c[key].dtype == w.dtype == torch.bfloat16
            errs["cache"] = max(errs.get("cache", 0.0),
                                rel_err(got_c[key], w))
    tf = teacher_forced_logits(params, cfg, toks, PROMPT)
    errs["prefill"] = rel_err(tf[:, 0], ref_steps_[:, 0])
    errs["decode"] = max(rel_err(tf[:, i], ref_steps_[:, i])
                         for i in range(1, NEW))
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
@pytest.mark.parametrize("name", ARCHS)
def test_generate_teacher_forced_against_reference(name, adder):
    tree, toks, ref_steps_, *_ = reference_run(name, adder)
    cfg = port_cfg(name, adder)
    params = W.from_reference(tree, cfg, device=CPU, dtype=torch.bfloat16)
    tf = f32(teacher_forced_logits(params, cfg, toks, PROMPT))
    compared = 0
    for i in range(NEW):
        assert rel_err(tf[:, i], ref_steps_[:, i]) < TOL, i
        scale = np.maximum(1.0, np.abs(ref_steps_[:, i]).max(axis=-1))
        top2 = np.sort(ref_steps_[:, i], axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * TOL * scale
        np.testing.assert_array_equal(tf[:, i].argmax(-1)[sure],
                                      toks[sure, PROMPT + i])
        compared += int(sure.sum())
    print(f"{name} {adder}: tokens compared at {compared} of "
          f"{NEW * toks.shape[0]} steps")
    assert compared > 0
    # the port's own greedy run returns the logits of its own
    # teacher-forced run, and its tokens are their argmax
    got, logits = generate(params, cfg, {"tokens": toks[:, :PROMPT]}, NEW,
                           return_logits=True)
    assert got.dtype == torch.int32 and got.shape == toks.shape
    assert torch.equal(got[:, :PROMPT], torch.as_tensor(toks[:, :PROMPT]))
    assert torch.equal(logits, teacher_forced_logits(params, cfg, got,
                                                     PROMPT))
    assert torch.equal(got[:, PROMPT:], logits.argmax(-1).to(torch.int32))


def test_reference_generate_is_the_loop_held_against():
    """``repro.models.serving.generate`` gives the tokens of the loop the
    tests above hold the port against."""
    tree, toks, *_ = reference_run("qwen3-4b", "haloc_axa")
    rcfg = ref_get_smoke("qwen3-4b").with_approx(
        ref_ops.make_numerics("haloc_axa", "residual"))
    rp = jax.tree.map(jnp.asarray, tree)
    got = ref_serving.generate(rp, rcfg, {"tokens": jnp.asarray(
        toks[:, :PROMPT])}, NEW, temperature=0.0)
    np.testing.assert_array_equal(np.asarray(got), toks)


@pytest.mark.parametrize("name,seed", [(n, s) for n in DENSE
                                       for s in (1, 2, 3, 4)]
                         + [(n, 1) for n in MOE])
def test_haloc_axa_logits_equal_reference(name, seed):
    """Under haloc_axa the adder turns a one-ulp difference of an operand
    into up to 2^m units, so the CPU products must round as XLA:CPU's:
    full-mode and teacher-forced logits equal, bit for bit."""
    tree, toks, ref_steps_, _, ref_full, _ = (
        reference_run(name, "haloc_axa") if seed == 1
        else reference_run(name, "haloc_axa", seed))
    cfg = port_cfg(name, "haloc_axa")
    params = W.from_reference(tree, cfg, device=CPU)
    full, _, _ = T.forward(params, cfg, {"tokens": toks[:, :-1]})
    np.testing.assert_array_equal(f32(full), ref_full)
    tf = teacher_forced_logits(params, cfg, toks, PROMPT)
    np.testing.assert_array_equal(f32(tf), ref_steps_)


@pytest.mark.parametrize("name,seed", [(n, s) for n in (
    "gemma3-27b", "recurrentgemma-9b") for s in (1, 2, 3, 4)])
def test_exact_add_logits_equal_reference_with_a_suffix(name, seed):
    """With exact adds a suffix block's last residual sum reaches the
    final norm unrounded (XLA fuses them; the pattern's scan carry is
    rounded), and so does each suffix block's into the next one's first
    norm: full-mode and teacher-forced logits equal, bit for bit (ROADMAP
    Queue C 2, closed)."""
    tree, toks, ref_steps_, _, ref_full, _ = (
        reference_run(name, "off") if seed == 1
        else reference_run(name, "off", seed))
    cfg = port_cfg(name, "off")
    params = W.from_reference(tree, cfg, device=CPU)
    full, _, _ = T.forward(params, cfg, {"tokens": toks[:, :-1]})
    np.testing.assert_array_equal(f32(full), ref_full)
    tf = teacher_forced_logits(params, cfg, toks, PROMPT)
    np.testing.assert_array_equal(f32(tf), ref_steps_)


@pytest.mark.parametrize("adder", ("off", "haloc_axa"))
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_parity_on_the_port(name, adder):
    """``tests/test_models_smoke.py::test_smoke_prefill_decode_parity``,
    run on the port (its parameters from the port's own generator; MoE
    at capacity factor 8 and one sequence chunk, within 0.08, as
    there)."""
    cfg = port_cfg(name, adder)
    tol = TOL
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, seq_chunks=1))
        tol = MOE_TOL
    params = T.init_params(1, cfg, device=CPU)
    b, s = 2, 24
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    full, _, _ = T.forward(params, cfg, {"tokens": tokens}, mode="full")
    pre, cache = steps.make_prefill_step(cfg, s)(
        params, {"tokens": tokens[:, :s - 1]})
    dec, _ = steps.make_decode_step(cfg)(
        params, {"tokens": tokens[:, s - 1:]}, s - 1, cache)
    scale = max(1.0, float(full[:, s - 1].float().abs().max()))
    assert float((full[:, s - 2] - pre[:, 0]).float().abs().max()) / scale \
        < tol
    assert float((full[:, s - 1] - dec[:, 0]).float().abs().max()) / scale \
        < tol


def test_sampling_is_seeded_and_in_vocab():
    cfg = port_cfg("gemma3-27b", "haloc_axa")
    params = T.init_params(2, cfg, device=CPU, dtype=torch.bfloat16)
    prompt = {"tokens": np.arange(10, dtype=np.int32)[None].repeat(3, 0)}
    a = generate(params, cfg, prompt, 12, temperature=0.8, seed=5)
    b = generate(params, cfg, prompt, 12, temperature=0.8, seed=5)
    c = generate(params, cfg, prompt, 12, temperature=0.8, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.padded_vocab
    assert a.shape == (3, 22)
    g = generate(params, cfg, prompt, 12)
    assert torch.equal(g, generate(params, cfg, prompt, 12))
    assert generate(params, cfg, prompt, 0).shape == (3, 10)


@pytest.mark.parametrize("argv", (
    ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
     "--new-tokens", "6"],
    ["--arch", "gemma3-27b", "--smoke", "--device", "cpu", "--adder",
     "haloc_axa", "--batch", "2", "--prompt-len", "20", "--new-tokens",
     "4", "--temperature", "0"],
    ["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu", "--adder",
     "haloc_axa", "--batch", "2", "--prompt-len", "8", "--new-tokens",
     "3"]))
def test_launch_serve_main_on_the_cpu(argv, capsys):
    serve.main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv \
        else "qwen3-4b"
    name = f"{arch}-smoke"
    new = int(argv[argv.index("--new-tokens") + 1])
    plen = int(argv[argv.index("--prompt-len") + 1])
    assert out.startswith(f"{name}: (2, {plen + new}); ")
    assert f"({new} steps x batch 2 in " in out and " tok/s " in out
    assert throughput_report(4, 2.0, 3) == "6 tok/s (4 steps x batch 3 in 2.00s)"
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return [_shapes(v) for v in tree]


def _unstacked(tree, repeats):
    """A reference shape tree with each pattern entry as ``repeats``
    per-block shape trees."""
    out = {k: v for k, v in tree.items() if k != "pattern"}
    out["pattern"] = [[jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), p)] * repeats
        for p in tree["pattern"]]
    return out


def test_params_and_cache_shapes_follow_the_reference():
    for name in ARCHS:
        cfg, rcfg = get_config(name), ref_get_config(name)
        got = steps.params_shapes(cfg)
        want = ref_steps.params_shapes(rcfg)
        assert T.param_count(got) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(want))
        assert got["embed"]["table"].device.type == "meta"
        assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                            _unstacked(want, rcfg.repeats)) == _shapes(got), \
            name
        cs = steps.cache_shapes(cfg, 4, 160)
        rcs = _unstacked(ref_steps.cache_shapes(rcfg, 4, 160), rcfg.repeats)
        for c, rc in zip(T.blocks_in_order(cfg, cs),
                         T.blocks_in_order(cfg, rcs), strict=True):
            assert _shapes(c) == {k: (tuple(v.shape), str(v.dtype))
                                  for k, v in rc.items()}


def test_init_params_seeded_bf16_and_distributed_as_reference():
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"), d_model=128,
                              d_ff=512)
    a = T.init_params(3, cfg, device=CPU, dtype=torch.bfloat16)
    b = T.init_params(3, cfg, device=CPU, dtype=torch.bfloat16)
    assert torch.equal(a["pattern"][0][1]["mlp"]["wo"]["w"],
                       b["pattern"][0][1]["mlp"]["wo"]["w"])
    blk = a["pattern"][0][0]
    assert blk["mlp"]["wi"]["w"].dtype == torch.bfloat16
    assert blk["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(blk["mixer"]["wq"]["b"],
                       torch.zeros(cfg.q_dim, dtype=torch.bfloat16))
    assert not torch.equal(a["pattern"][0][0]["mlp"]["wi"]["w"],
                           a["pattern"][0][1]["mlp"]["wi"]["w"])
    for w, d_in in ((blk["mlp"]["wi"]["w"], 128), (blk["mlp"]["wo"]["w"], 512),
                    (a["embed"]["table"], 128)):
        std = float(w.float().std())
        assert abs(std * d_in ** 0.5 - 1) < 0.05, std


def test_defaults_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-4b")
    for fn in (lambda: ops.make_numerics("haloc_axa", "residual").engine,
               lambda: T.init_params(0, cfg),
               lambda: T.init_cache(cfg, 1, 8),
               lambda: serve.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    # a default (cuda) numerics config never runs on CPU tensors: it asks
    # for the card
    on = cfg.with_approx(ops.make_numerics("haloc_axa", "residual"))
    params = T.init_params(0, cfg, device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.forward(params, on, {"tokens": np.zeros((1, 3), np.int32)})
