"""Self/cross-attention residual mixers with KV-cache support (the port
of ``repro.models.attention``).

Cache layouts (lockstep batched serving):
  global attn : {"k","v": (B, S_ctx, Hkv, Dh) bf16, "pos": (S_ctx,) int32}
  local  attn : ring buffer of size W (slot = pos % W), same fields
  cross  attn : {"k","v": (B, Sv, Hkv, Dh)}  (static after prefill)

``pos`` stores the absolute position held by each slot, -1 = empty; masks
are computed from these absolute positions (``layers._mask_bias``), which
makes the ring buffer and the linear cache share one code path.

Under tensor parallelism over "model" a self-attention cache holds the
rank's KV/m heads, (B, S_ctx, Hkv/m, Dh), as ``CACHE_RULES`` places
``k``/``v`` and the reference's partitioned steps hold them: the
prefill fills them with the rank's heads, a decode step writes one slot
of them (the reference's ``dynamic-update-slice`` on the local heads)
and reads only them; ``pos`` is replicated, every rank writing the same
slot.

The port writes a decode step's k/v/pos into the cache it is given, in
place (the reference returns a new cache), and so does a prefill shorter
than the cache; the returned cache is that same dict.  A decode position
past the end of a global layer's cache is clamped to the last slot, and a
negative one counts from the end, as ``jax.lax.dynamic_update_slice``
does.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig


def attn_init(init, cfg: ModelConfig, spec: BlockSpec):
    """Parameters of one attention mixer, drawn by ``init`` (a
    ``transformer.Init``)."""
    p = {
        "wq": init.dense(cfg.d_model, cfg.q_dim, bias=cfg.qkv_bias),
        "wk": init.dense(cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias),
        "wv": init.dense(cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias),
        "wo": init.dense(cfg.q_dim, cfg.d_model),
    }
    if cfg.qk_norm:
        p["qn"] = init.norm(cfg.head_dim)
        p["kn"] = init.norm(cfg.head_dim)
    return p


def _qkv(p, cfg: ModelConfig, x, positions, spec: BlockSpec, rope=None,
         tp=None):
    """q, k, v of ``x``, RoPE applied; ``rope`` is the (cos, sin) tables of
    ``positions`` when the caller has them already.  Under tensor
    parallelism (``tp``) each projection is column-parallel
    (:func:`layers.dense_column`): this rank's q and kv heads."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = L.dense_column(p["wq"], x, tp).reshape(b, s, -1, dh)
    k = L.dense_column(p["wk"], x, tp).reshape(b, s, -1, dh)
    v = L.dense_column(p["wv"], x, tp).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = L.rms_norm(p["qn"], q, cfg.norm_eps)
        k = L.rms_norm(p["kn"], k, cfg.norm_eps)
    cos, sin = rope if rope is not None else L.rope_tables(
        positions, cfg.head_dim, spec.rope_base)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    return q, k, v


def _check_split(cfg: ModelConfig, tp) -> None:
    """A ``ValueError`` when the q or kv heads do not split over ``tp``'s
    model ranks (``layers._repeat_kv`` maps q head h to kv head
    h // (H/KV), so a contiguous q shard reads exactly its contiguous kv
    shard only when KV % m == 0)."""
    if tp is not None and (cfg.num_heads % tp.size
                           or cfg.num_kv_heads % tp.size):
        raise ValueError(
            f"{cfg.name}: {cfg.num_heads} q / {cfg.num_kv_heads} kv heads "
            f"do not split over {tp.size} model ranks")


def attn_apply(p, cfg: ModelConfig, spec: BlockSpec, x, positions,
               rope=None, tp=None):
    """Full-sequence self attention (scoring). positions: (S,).

    Under tensor parallelism (``tp``: ``p`` holds this rank's "model"
    shards, :func:`repro_torch.sharding.rules.model_shard`) the rank
    computes its H/m q heads and KV/m kv heads (:func:`_check_split`).
    The q/k norms and RoPE act per head; ``wo`` is row-parallel (one sum
    over "model", :func:`layers.dense_row`)."""
    _check_split(cfg, tp)
    q, k, v = _qkv(p, cfg, x, positions, spec, rope, tp)
    out = L.attention_any(
        q, k, v, positions, positions, causal=cfg.causal,
        window=spec.window, kv_chunk=cfg.attn_kv_chunk)
    b, s = x.shape[:2]
    return L.dense_row(p["wo"], out.reshape(b, s, -1), tp)


def attn_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                    ctx_len: int, dtype=torch.bfloat16, device=None,
                    heads=None):
    """An empty cache of ``heads`` kv heads (``None``: all of them; under
    tensor parallelism the rank's KV/m)."""
    size = min(ctx_len, spec.window) if spec.window > 0 else ctx_len
    shape = (batch, size, cfg.num_kv_heads if heads is None else heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def attn_prefill(p, cfg: ModelConfig, spec: BlockSpec, x, positions, cache,
                 rope=None, tp=None):
    """Prefill: full-sequence attention + populate the cache.

    The cache covers the LAST ``size`` positions (ring layout for windowed
    layers: slot = pos % size, which for a prefill of length S >= size is
    a roll of the tail).  Under tensor parallelism (``tp``, as
    :func:`attn_apply`'s) the rank computes and caches its KV/m kv heads
    (the cache :func:`attn_cache_init` made with them) and ``wo`` is
    row-parallel."""
    _check_split(cfg, tp)
    q, k, v = _qkv(p, cfg, x, positions, spec, rope, tp)
    out = L.attention_any(
        q, k, v, positions, positions, causal=cfg.causal,
        window=spec.window, kv_chunk=cfg.attn_kv_chunk)
    size = cache["k"].shape[1]
    s = x.shape[1]
    if s >= size:
        tailpos = positions[s - size:]              # (size,)
        inv = torch.argsort(tailpos % size)          # slot -> tail index
        cache = {
            "k": k[:, s - size:].index_select(1, inv).to(cache["k"].dtype),
            "v": v[:, s - size:].index_select(1, inv).to(cache["v"].dtype),
            "pos": tailpos.index_select(0, inv).to(torch.int32),
        }
    else:
        slots = positions % size
        cache["k"][:, slots] = k.to(cache["k"].dtype)
        cache["v"][:, slots] = v.to(cache["v"].dtype)
        cache["pos"][slots] = positions.to(torch.int32)
    b = x.shape[0]
    return L.dense_row(p["wo"], out.reshape(b, s, -1), tp), cache


def decode_slot(pos: int, size: int, window: int) -> int:
    """The cache slot a decode step at absolute position ``pos`` writes:
    ``pos % size`` for a windowed layer's ring, else ``pos``, with the
    reference's ``dynamic_update_slice`` rule (a negative start counts
    from the end, then the start is clamped into the cache)."""
    slot = pos % size if window > 0 else pos
    if slot < 0:
        slot += size
    return min(max(slot, 0), size - 1)


def attn_decode(p, cfg: ModelConfig, spec: BlockSpec, x, pos: int, cache,
                positions=None, rope=None, tp=None):
    """One decode step. x: (B,1,D); pos: the absolute position (an int);
    ``positions`` (``[pos]`` as an int32 tensor on x's device) and
    ``rope`` (its tables), when the caller has them already.  Under
    tensor parallelism (``tp``) the rank writes and reads its KV/m kv
    heads at the slot every rank writes (``pos`` is the same on all),
    and ``wo`` is row-parallel."""
    _check_split(cfg, tp)
    if positions is None:
        positions = torch.arange(pos, pos + 1, dtype=torch.int32,
                                 device=x.device)
    if rope is None:
        rope = L.rope_tables(range(pos, pos + 1), cfg.head_dim,
                             spec.rope_base, x.device)
    q, k, v = _qkv(p, cfg, x, positions, spec, rope, tp)
    size = cache["k"].shape[1]
    slot = decode_slot(pos, size, spec.window)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = pos
    out = L.plain_attention(
        q, cache["k"], cache["v"], positions, cache["pos"],
        causal=cfg.causal, window=spec.window)
    b = x.shape[0]
    return L.dense_row(p["wo"], out.reshape(b, 1, -1), tp), cache


# ----------------------------------------------------------- cross attn --

def cross_attn_init(init, cfg: ModelConfig, spec: BlockSpec):
    """Parameters of one cross-attention mixer: the projections without
    bias, the q and k norms, and Llama-3.2's tanh gate (an fp32 scalar,
    zero at init: the block starts as the identity)."""
    return {
        "wq": init.dense(cfg.d_model, cfg.q_dim),
        "wk": init.dense(cfg.d_model, cfg.kv_dim),
        "wv": init.dense(cfg.d_model, cfg.kv_dim),
        "wo": init.dense(cfg.q_dim, cfg.d_model),
        "kn": init.norm(cfg.head_dim),
        "qn": init.norm(cfg.head_dim),
        "gate": torch.zeros((), dtype=torch.float32, device=init.device),
    }


def cross_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    shape = (batch, cfg.vision.seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_kv(p, cfg: ModelConfig, vis):
    """vis: projected vision embeddings (B, Sv, D) -> k (normed), v."""
    b, sv, _ = vis.shape
    k = L.dense(p["wk"], vis).reshape(b, sv, cfg.num_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], vis).reshape(b, sv, cfg.num_kv_heads, cfg.head_dim)
    return L.rms_norm(p["kn"], k, cfg.norm_eps), v


def tanh_gates(gates) -> torch.Tensor:
    """``tanh`` of each fp32 scalar gate (XLA:CPU's, :func:`layers.
    xla_tanh32`, on every device: some hundred small kernels a call on the
    card, so :func:`transformer.cross_tanh_gates` takes every cross
    block's gates in one call) rounded to bf16, the activations' dtype, as
    a (n,) tensor."""
    return L.xla_tanh32(torch.stack([g.float() for g in gates])).to(
        torch.bfloat16)


class _Gate(torch.autograd.Function):
    """The gated product with the reference's backward: its cotangent
    bf16 (the reference's product is), ``out``'s gradient ``g * t`` in
    bf16, and the gate's the sum of the bf16 products ``g * out`` as
    XLA:CPU reduces them (:func:`layers.bf16_sum`: a bf16 accumulator;
    on the card torch's fp32 sum)."""

    @staticmethod
    def forward(ctx, t, out, keep_fp32):
        ctx.save_for_backward(t, out)
        if keep_fp32:
            return t.float() * out.float()
        return t.to(out.dtype) * out

    @staticmethod
    def backward(ctx, g):
        t, out = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        gt = gout = None
        if ctx.needs_input_grad[0]:
            gt = L.bf16_sum((g * out.to(g.dtype)).float())
        if ctx.needs_input_grad[1]:
            gout = g * t.to(g.dtype)
        return gt, gout, None


def gate(t, out, *, keep_fp32: bool = False):
    """A gate's bf16 ``tanh`` ``t`` (:func:`tanh_gates`) times ``out``.
    ``keep_fp32``: the product in fp32, unrounded, as XLA's fusion hands
    it to an approximate residual add (an exact add reads it rounded).
    Its backward is the reference's (:class:`_Gate`)."""
    return _Gate.apply(t, out, keep_fp32)


def cross_attn_apply(p, cfg: ModelConfig, spec: BlockSpec, x, kv,
                     tanh_gate, *, keep_fp32: bool = False):
    """Attention of x's queries over the vision k/v (no mask: every query
    position and kv position is 0), gated by ``tanh_gate``, the bf16
    ``tanh(p["gate"])`` (:func:`tanh_gates`, :func:`gate`)."""
    k, v = kv
    b, s, _ = x.shape
    q = L.dense(p["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    q = L.rms_norm(p["qn"], q, cfg.norm_eps)
    qpos = torch.zeros((s,), dtype=torch.int32, device=x.device)
    kvpos = torch.zeros((k.shape[1],), dtype=torch.int32, device=x.device)
    out = L.plain_attention(q, k, v, qpos, kvpos, causal=False, window=0)
    out = L.dense(p["wo"], out.reshape(b, s, cfg.q_dim))
    return gate(tanh_gate, out, keep_fp32=keep_fp32)
