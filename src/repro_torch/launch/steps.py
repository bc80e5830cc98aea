"""Step functions: train_step / prefill_step / decode_step and the
train state (the port of ``repro.launch.steps``).

The reference's steps are what ``jax.jit`` lowers; the port's run
eagerly (autograd for the gradient, no donation: the train step updates
the state's tensors in place, :func:`repro_torch.optim.adamw.update`).
``state_shapes``, ``params_shapes`` and ``cache_shapes`` build the trees
on the meta device: shapes and dtypes, no allocation.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten

State = Dict[str, Any]


def init_state(seed, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
               device=None) -> State:
    """fp32 parameters drawn from ``seed`` (:func:`transformer.init_params`)
    on ``device`` (``None``: the card), zero AdamW states, step 0."""
    params = T.init_params(seed, cfg, device=device)
    dev = T.params_device(params)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(params, cfg: ModelConfig, batch, batch_axes=None,
                   mesh=None):
    """((loss, parts), grads): :func:`transformer.loss_fn` and its
    gradient with respect to every leaf of ``params`` (fp32, a tree of
    the same structure; zeros for a leaf the loss does not reach), as
    ``jax.value_and_grad(..., has_aux=True)`` gives them.  ``params``
    itself is left as it is."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, parts = T.loss_fn(unflatten(params, flat), cfg, batch,
                            batch_axes=batch_axes, mesh=mesh)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            unflatten(params, grads))


def _microbatch(batch, i: int, n: int):
    return {k: v[i * (len(v) // n):(i + 1) * (len(v) // n)]
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    batch_axes=None, grad_transform=None,
                    microbatches: int = 1, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``: the forward and
    backward of :func:`transformer.loss_fn`, then one AdamW update.

    ``microbatches > 1`` is gradient accumulation: the global batch is
    split along dim 0 and run in turn, the gradients, losses and parts
    summed from zero in that order and divided by the count, as the
    reference's ``lax.scan`` does.  ``grad_transform`` (e.g.
    :func:`repro_torch.optim.compression.make_grad_transform`'s) maps the
    gradients before the update.  A mesh raises (ROADMAP Queue A item
    5)."""
    T._no_sharding(batch_axes, mesh)

    def train_step(state: State, batch):
        if microbatches == 1:
            (loss, parts), grads = value_and_grad(state["params"], cfg, batch)
        else:
            acc = None
            for i in range(microbatches):
                (l, pa), g = value_and_grad(
                    state["params"], cfg, _microbatch(batch, i, microbatches))
                acc = (g, l, pa) if acc is None else (
                    tree_map(torch.add, acc[0], g), acc[1] + l,
                    {k: acc[2][k] + pa[k] for k in pa})
            grads = tree_map(lambda g: g / microbatches, acc[0])
            loss = acc[1] / microbatches
            parts = {k: v / microbatches for k, v in acc[2].items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt, om = adamw.update(
            opt_cfg, grads, state["opt"], state["params"])
        metrics = {"loss": loss, **parts, **om}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, ctx_len: int, batch_axes=None):
    """``prefill_step(params, batch) -> (last logits, cache)``: a fresh
    cache of ``ctx_len`` positions on the parameters' device, filled
    (batch: ``tokens`` or an audio model's ``frames``, and a vision
    model's ``vision``; a non-causal model returns every position's
    logits)."""
    T._no_sharding(batch_axes, None)

    def prefill_step(params, batch):
        b = len(batch["tokens"] if "tokens" in batch else batch["frames"])
        cache = T.init_cache(cfg, b, ctx_len,
                             device=T.params_device(params))
        logits, cache, _ = T.forward(params, cfg, batch, mode="prefill",
                                     cache=cache)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, batch_axes=None):
    """``decode_step(params, batch, pos, cache) -> (logits, cache)``: one
    token per sequence at absolute position ``pos``; the cache is updated
    in place."""
    T._no_sharding(batch_axes, None)

    def decode_step(params, batch, pos, cache):
        logits, cache, _ = T.forward(params, cfg, batch, mode="decode",
                                     cache=cache, pos=pos)
        return logits, cache

    return decode_step


def state_shapes(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, seed=0):
    """The full train state on the meta device — NO allocation."""
    return init_state(seed, cfg, opt_cfg, device="meta")


def params_shapes(cfg: ModelConfig, seed=0):
    """The parameter tree on the meta device (fp32, as the reference's
    ``eval_shape``) — NO allocation."""
    return T.init_params(seed, cfg, device="meta")


def cache_shapes(cfg: ModelConfig, batch: int, ctx_len: int):
    """The cache tree on the meta device — NO allocation."""
    return T.init_cache(cfg, batch, ctx_len, device="meta")
