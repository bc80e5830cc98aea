"""Step functions: prefill_step / decode_step (the port of
``repro.launch.steps``; ``train_step`` and ``init_state`` belong to the
training slice).

The reference's steps are what ``jax.jit`` lowers; the port's run
eagerly.  ``params_shapes`` and ``cache_shapes`` build the trees on the
meta device: shapes and dtypes, no allocation.
"""

from __future__ import annotations

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


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


def params_shapes(cfg: ModelConfig, seed=0):
    """The parameter tree on the meta device (fp32, as the reference's
    ``eval_shape``) — NO allocation."""
    return T.init_params(seed, cfg, device="meta")


def cache_shapes(cfg: ModelConfig, batch: int, ctx_len: int):
    """The cache tree on the meta device — NO allocation."""
    return T.init_cache(cfg, batch, ctx_len, device="meta")
