"""Step functions: train_step / prefill_step / decode_step and the
train state (the port of ``repro.launch.steps``).

The reference's steps are what ``jax.jit`` lowers; the port's run
eagerly (autograd for the gradient, no donation: the train step updates
the state's tensors in place, :func:`repro_torch.optim.adamw.update`).
``state_shapes``, ``params_shapes`` and ``cache_shapes`` build the trees
on the meta device: shapes and dtypes, no allocation.

On a mesh (``mesh=``, a ``DeviceMesh``; ``batch_axes``, its batch axes)
the steps are the sharded ones: the state's leaves are DTensors with the
rules' placements (:func:`repro_torch.sharding.rules.place_state`), so
each rank holds exactly the reference's shard; the batch (the whole
global batch, the same on every rank) is cut to this rank's rows
(:func:`split_batch`); each block's leaves are gathered just before it
runs; each gradient leaf is summed over the batch axes and cut back to
its placement (a reduce-scatter); AdamW runs on the local shards.  On a
mesh with model > 1 the self-attention mixers, the dense MLPs, the
embedding and the head (in training with the CE) compute tensor-parallel
over "model" where the rules shard their leaves there, in every step
(``models.transformer``'s module docstring): such a leaf is gathered
over the other mesh dims only, and in training its gradient stays on
its "model" shard, reduced over the batch axes only; a replicated leaf
gets the same full gradient on every "model" rank.  The prefill and
decode steps return the whole batch's logits (the vocabulary gathered
over "model", the rows over the batch axes) and the rank's cache: a
tree of plain tensors on its device holding its batch rows and, in each
tensor-parallel self-attention block, its KV/m heads, as
``CACHE_RULES`` places them (``transformer.cache_shardings``); the other
mixers' caches are whole on every "model" rank.  Decode updates that
cache in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R
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


def split_batch(batch, mesh, batch_axes):
    """(this rank's rows of ``batch``, the batch axes they are split
    over): every input's first dim cut by the batch axes
    (:func:`repro_torch.sharding.rules.data_sharding`); the whole batch
    and None when the axes do not divide it, or there are none."""
    if mesh is None or not batch_axes:
        return batch, None
    specs = R.data_sharding(batch, mesh)
    split = [k for k in batch if specs[k] and specs[k][0] is not None]
    if len(split) != len(batch):
        return batch, None
    rows = R.row_slice(mesh, batch_axes, len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}, tuple(batch_axes)


def value_and_grad(params, cfg: ModelConfig, batch, batch_axes=None,
                   mesh=None):
    """((loss, parts), grads): :func:`transformer.loss_fn` and its
    gradient with respect to every leaf of ``params`` (fp32, a tree of
    the same structure; zeros for a leaf the loss does not reach), as
    ``jax.value_and_grad(..., has_aux=True)`` gives them.  ``params``
    itself is left as it is.

    On a mesh ``batch`` is this rank's rows of a batch split over
    ``batch_axes`` (None: not split): the loss and parts are the whole
    batch's mean (all-reduced) and the gradients DTensors placed as
    ``params`` (a tensor-parallel leaf's each "model" rank's own
    shard's)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, parts = T.loss_fn(unflatten(params, flat), cfg, batch,
                            batch_axes=batch_axes, mesh=mesh)
    shards = R.batch_size(mesh, batch_axes) if mesh is not None else 1
    grads = torch.autograd.grad(loss / shards if shards > 1 else loss, flat,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    if shards > 1:   # the whole batch's means: one all-reduce
        vals = R.sum_over(torch.stack([loss, *parts.values()]), mesh,
                          batch_axes) / shards
        loss, parts = vals[0], dict(zip(parts, vals[1:].unbind()))
    return (loss, parts), unflatten(params, grads)


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
    gradients before the update.

    With ``mesh`` the step is the sharded one (the module docstring): the
    state as :func:`repro_torch.sharding.rules.place_state` holds it, the
    whole batch on every rank (each takes its rows; the microbatches cut
    those)."""
    if mesh is not None:
        R.device_mesh(mesh)

    def train_step(state: State, batch):
        batch, axes = split_batch(batch, mesh, batch_axes)

        def vg(b):
            return value_and_grad(state["params"], cfg, b, axes, mesh)

        if microbatches == 1:
            (loss, parts), grads = vg(batch)
        else:
            acc = None
            for i in range(microbatches):
                (l, pa), g = vg(_microbatch(batch, i, microbatches))
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


def _whole(logits, mesh, axes):
    return logits if axes is None else R.gather_rows(logits, mesh, axes)


def make_prefill_step(cfg: ModelConfig, ctx_len: int, batch_axes=None,
                      mesh=None):
    """``prefill_step(params, batch) -> (last logits, cache)``: a fresh
    cache of ``ctx_len`` positions on the parameters' device, filled
    (batch: ``tokens`` or an audio model's ``frames``, and a vision
    model's ``vision``; a non-causal model returns every position's
    logits).  On a mesh: the rank's cache (its rows, and its heads of
    each tensor-parallel attention block: ``transformer.init_cache`` with
    ``transformer.cache_tensor_parallel``), the whole batch's logits."""

    def prefill_step(params, batch):
        batch, axes = split_batch(batch, mesh, batch_axes)
        b = len(batch["tokens"] if "tokens" in batch else batch["frames"])
        cache = T.init_cache(cfg, b, ctx_len,
                             device=T.params_device(params),
                             tp=T.cache_tensor_parallel(params, cfg, mesh))
        logits, cache, _ = T.forward(params, cfg, batch, mode="prefill",
                                     cache=cache, batch_axes=axes,
                                     mesh=mesh)
        return _whole(logits, mesh, axes), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, batch_axes=None, mesh=None):
    """``decode_step(params, batch, pos, cache) -> (logits, cache)``: one
    token per sequence at absolute position ``pos``; the cache is updated
    in place.  On a mesh ``batch`` is the whole batch's tokens and
    ``cache`` the rank's (:func:`make_prefill_step`'s)."""

    def decode_step(params, batch, pos, cache):
        batch, axes = split_batch(batch, mesh, batch_axes)
        logits, cache, _ = T.forward(params, cfg, batch, mode="decode",
                                     cache=cache, pos=pos, batch_axes=axes,
                                     mesh=mesh)
        return _whole(logits, mesh, axes), cache

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
