"""Batched serving: greedy/sampled generation on top of prefill/decode
(the port of ``repro.models.serving``).

The loop runs eagerly, one decode step a token.  Greedy decoding is the
argmax of the last logits; sampling draws from the softmax of
``logits / temperature`` with a ``torch.Generator`` seeded by ``seed``
on the logits' device (not the reference's ``jax.random`` stream).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _tokens(params, batch) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=T.params_device(params)) \
        .to(torch.int32)


def generate(params, cfg: ModelConfig, batch: Dict, max_new_tokens: int,
             *, temperature: float = 0.0, seed: int = 0,
             ctx_budget: Optional[int] = None, return_logits: bool = False):
    """batch: {"tokens": (B, S_prompt)} (+ a vision model's "vision",
    which the prefill reads and the decode steps, through the cross
    attention cache, do not).  Returns the (B, S+new) int32 tokens on the
    parameters' device; with ``return_logits`` also the (B, new, V)
    logits each new token was chosen from."""
    tokens = _tokens(params, batch)
    b, s = tokens.shape
    ctx = ctx_budget or (s + max_new_tokens)
    prefill = make_prefill_step(cfg, ctx)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, dict(batch, tokens=tokens))
    out, steps = [tokens], []
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=tokens.device)
        gen.manual_seed(seed)
    for i in range(max_new_tokens):
        last = logits[:, -1]
        if return_logits:
            steps.append(last)
        if temperature <= 0:
            nxt = torch.argmax(last, dim=-1)
        else:
            probs = torch.softmax(last.to(torch.float32) / temperature, -1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        nxt = nxt.to(torch.int32)[:, None]
        out.append(nxt)
        if i == max_new_tokens - 1:
            break
        logits, cache = decode(params, {"tokens": nxt}, s + i, cache)
    toks = torch.cat(out, dim=1)
    if return_logits:
        return toks, (torch.stack(steps, dim=1) if steps else
                      logits[:, :0])
    return toks


def teacher_forced_logits(params, cfg: ModelConfig, tokens, prompt_len: int,
                          *, ctx_budget: Optional[int] = None,
                          vision=None):
    """The (B, T - prompt_len, V) logits that prefill and decode give for
    each token after the prompt, with the given tokens fed in (not the
    model's own choices): what :func:`generate`'s ``return_logits`` would
    give had it chosen exactly ``tokens`` (a vision model's prefill reads
    ``vision``)."""
    tokens = _tokens(params, {"tokens": tokens})
    b, t = tokens.shape
    prefill = make_prefill_step(cfg, ctx_budget or t)
    decode = make_decode_step(cfg)
    first = {"tokens": tokens[:, :prompt_len]}
    if vision is not None:
        first["vision"] = vision
    logits, cache = prefill(params, first)
    steps = [logits[:, -1]]
    for p in range(prompt_len, t - 1):
        logits, cache = decode(params, {"tokens": tokens[:, p:p + 1]}, p,
                               cache)
        steps.append(logits[:, -1])
    return torch.stack(steps, dim=1)


def throughput_report(n_tokens: int, seconds: float, batch: int) -> str:
    tps = n_tokens * batch / max(seconds, 1e-9)
    return f"{tps:,.0f} tok/s ({n_tokens} steps x batch {batch} in {seconds:.2f}s)"
