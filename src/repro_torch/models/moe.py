"""Mixture-of-Experts MLP (token-choice top-k, capacity-based, dropping):
the port of ``repro.models.moe``.

Dispatch is sort-based and gather-formulated: per batch row, tokens'
(token, k-slot) pairs are ranked within their expert queue; the first C
per expert are gathered into a dense (B, E, C, D) buffer, the expert
FFNs run as stacked batched products over E, and each (token, k) slot's
result is gathered back and weighted by its gate.

The sequence is processed in ``seq_chunks`` sequential chunks (a loop in
place of the reference's ``lax.scan``), bounding the dispatch buffers for
wide expert counts (DeepSeek-V2: 160 experts).  Decode (S == 1) merges
the batch into one dispatch group, so expert capacity stays ~B*k/E
instead of one slot per (row, expert).

The reference's expert-parallel ``shard_map`` dispatch needs a mesh;
without one it runs :func:`moe_apply`, and so does the port's
:func:`moe_apply_shard_map`.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def moe_init(init, cfg: ModelConfig):
    """Parameters of one MoE MLP, drawn by ``init`` (a
    ``transformer.Init``): the router, stacked expert matrices
    ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d), and ``shared`` (a SwiGLU)
    when the config has shared experts."""
    mc = cfg.moe
    e, d, f = mc.num_experts, cfg.d_model, mc.d_ff
    p = {"router": init.dense(d, e),
         "wi": init.normal((e, d, f), d ** -0.5),
         "wg": init.normal((e, d, f), d ** -0.5),
         "wo": init.normal((e, f, d), f ** -0.5)}
    if mc.num_shared_experts:
        width = mc.shared_d_ff or mc.d_ff * mc.num_shared_experts
        p["shared"] = init.swiglu(d, width)
    return p


def _capacity(tokens: int, mc) -> int:
    c = int(tokens * mc.experts_per_token * mc.capacity_factor
            / mc.num_experts)
    return max(4, -(-c // 4) * 4)  # >=4, multiple of 4


def _dispatch_indices(ids, gates, num_experts: int, capacity: int):
    """ids/gates: (B, T, k).  Returns (src_tok (B, E, C): the token filling
    each expert slot, T where empty; (src (B, E, C) flat (token, k) index,
    T*k where empty; dest (B, T*k) slot per (token, k), ``capacity`` when
    dropped; keep (B, T*k)))."""
    b, t, k = ids.shape
    dev = ids.device
    flat = ids.reshape(b, t * k).to(torch.int64)
    order = torch.argsort(flat, dim=-1, stable=True)            # (B, Tk)
    sorted_ids = torch.take_along_dim(flat, order, dim=-1)
    counts = (sorted_ids[:, :, None]
              == torch.arange(num_experts, device=dev)).sum(dim=1)
    seg_start = torch.cumsum(counts, dim=-1) - counts           # (B, E)
    rank_sorted = (torch.arange(t * k, device=dev)[None, :]
                   - torch.take_along_dim(seg_start, sorted_ids, dim=-1))
    # scatter ranks back to unsorted (token, k) order (order is a
    # permutation: no two writes meet)
    rank = torch.zeros_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < capacity
    dest = torch.where(keep, rank, capacity)                    # (B, Tk)
    # src[b, e, c] = flat (token, k) index filling slot (e, c); sentinel
    # t*k.  Every dropped pair writes column ``capacity`` of its expert,
    # which is sliced off: the kept slots each get exactly one write.
    lin = flat * (capacity + 1) + dest
    src = torch.full((b, num_experts * (capacity + 1)), t * k,
                     dtype=torch.int64, device=dev)
    src.scatter_(1, lin, torch.arange(t * k, device=dev).expand(b, t * k))
    src = src.reshape(b, num_experts, capacity + 1)[:, :, :capacity]
    src_tok = torch.clamp(src // k, max=t)                      # token index
    return src_tok, (src, dest, keep)


def _expert_ffn(p, xin):
    """xin: (B, E, C, D) -> (B, E, C, D), per-expert SwiGLU.  Each product
    is taken transposed, W^T x^T with W held as [in, out], as the
    reference's compiled step takes it."""
    wg, wi, wo = (p[n].to(xin.dtype).transpose(1, 2)
                  for n in ("wg", "wi", "wo"))
    b, e, c, d = xin.shape
    xt = xin.permute(1, 3, 0, 2).reshape(e, d, b * c)           # (E, D, B*C)
    h = (L.silu(L.matmul(wg, xt, lhs_t=True))
         * L.matmul(wi, xt, lhs_t=True))                        # (E, F, B*C)
    y = L.matmul(wo, h, lhs_t=True)                             # (E, D, B*C)
    return y.reshape(e, d, b, c).permute(2, 0, 3, 1)


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax(x):
    """``jax.nn.softmax`` over the last axis, op for op."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def gate(logits, k: int):
    """Router logits (B, T, E) -> (fp32 probabilities, top-k gates
    renormalized to sum 1 (B, T, k), expert ids (B, T, k))."""
    probs = softmax(logits.to(torch.float32))
    gates, ids = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def route(p, cfg: ModelConfig, x):
    """:func:`gate` of the router's logits for x."""
    return gate(L.dense(p["router"], x), cfg.moe.experts_per_token)


def aux_loss(probs, ids, num_experts: int):
    """The Switch-style load-balancing loss: E * sum(mean prob * share of
    routed (token, k) pairs), per expert."""
    me = probs.mean(dim=(0, 1))
    n = ids.numel()
    ce = torch.zeros_like(me).index_add_(
        0, ids.reshape(-1), torch.ones(n, dtype=torch.float32,
                                       device=ids.device)) / n
    return num_experts * torch.sum(me * ce)


def _moe_chunk(p, cfg: ModelConfig, x):
    """x: (B, T, D) one sequence chunk -> (out (B, T, D), aux)."""
    mc = cfg.moe
    b, t, d = x.shape
    probs, gates, ids = route(p, cfg, x)
    cap = _capacity(t, mc)
    src_tok, (_, dest, keep) = _dispatch_indices(ids, gates,
                                                 mc.num_experts, cap)
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xin = xpad[torch.arange(b, device=x.device)[:, None, None], src_tok]
    yout = _expert_ffn(p, xin)                                  # (B,E,C,D)
    # combine: gather each (token, k) slot's result, weight by its gate
    ybuf = yout.reshape(b, mc.num_experts * cap, d)
    lin = ids.reshape(b, -1).to(torch.int64) * cap + torch.clamp(
        dest, max=cap - 1)
    gathered = torch.take_along_dim(ybuf, lin[:, :, None], dim=1)
    w = (gates.reshape(b, -1) * keep.to(gates.dtype))[:, :, None]
    terms = (gathered.to(torch.float32) * w).reshape(
        b, t, mc.experts_per_token, d)
    out = terms[:, :, 0]
    for j in range(1, mc.experts_per_token):   # XLA's reduce: in k order
        out = out + terms[:, :, j]
    return out.to(x.dtype), aux_loss(probs, ids, mc.num_experts)


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  With shared
    experts under an approximate adder ``out`` is the fp32 sum of the
    routed and shared outputs (each rounded to x's dtype), for the
    residual add to round; with exact adds it is that sum rounded."""
    mc = cfg.moe
    b, s, d = x.shape
    if s == 1:
        out, aux = _moe_chunk(p, cfg, x.reshape(1, b, d))
        out = out.reshape(b, 1, d)
    elif mc.seq_chunks > 1 and s % mc.seq_chunks == 0:
        t = s // mc.seq_chunks
        outs, auxs = zip(*(_moe_chunk(p, cfg, x[:, i * t:(i + 1) * t])
                           for i in range(mc.seq_chunks)))
        out = torch.cat(outs, dim=1)
        aux = torch.stack(auxs).mean()
    else:
        out, aux = _moe_chunk(p, cfg, x)
    if "shared" in p:
        # XLA adds the two bf16 outputs in fp32; an approximate residual
        # add's quantize reads that sum unrounded (its fusion keeps it),
        # an exact residual add reads it rounded to x's dtype
        out = out.float() + L.swiglu(p["shared"], x).float()
        if not cfg.approx.enabled:
            out = out.to(x.dtype)
    return out, aux


def moe_apply_shard_map(p, cfg: ModelConfig, x, batch_axes=None, mesh=None):
    """The reference's expert-parallel dispatch over a mesh's "model"
    axis.  Without a mesh it is :func:`moe_apply`, as in the reference;
    the mesh path belongs to the sharding slice."""
    if mesh is None or batch_axes is None:
        return moe_apply(p, cfg, x)
    raise NotImplementedError(
        "moe_apply_shard_map over a mesh is not ported to repro_torch yet: "
        "ROADMAP.md Queue A item 5 (sharding on a DeviceMesh)")
