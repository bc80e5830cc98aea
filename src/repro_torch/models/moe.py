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

On a mesh (``launch.steps``' sharded steps) x holds this rank's rows of
a batch split over ``batch_axes``; the load-balancing loss is the whole
batch's (its sums all-reduced over the batch axes), and a decode step
dispatches every row of the batch as one group, as the reference's
global arrays do.  :func:`moe_apply_shard_map` is the reference's
expert-parallel dispatch over the mesh's "model" axis: each model rank
runs its own experts on the slots routed to them and the partial
outputs are summed with one all-reduce.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules as R


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


def split_axes(mesh, batch_axes):
    """The batch axes x's rows are split over, or None when there is one
    batch shard."""
    if mesh is None or not batch_axes \
            or R.batch_size(mesh, batch_axes) == 1:
        return None
    return tuple(batch_axes)


def aux_loss(probs, ids, num_experts: int, mesh=None, axes=None):
    """The Switch-style load-balancing loss: E * sum(mean prob * share of
    routed (token, k) pairs), per expert; over the whole batch when the
    rows are split over ``axes`` of ``mesh`` (both sums all-reduced)."""
    n = ids.numel()
    counts = torch.zeros_like(probs[0, 0]).index_add_(
        0, ids.reshape(-1), torch.ones(n, dtype=torch.float32,
                                       device=ids.device))
    if axes is None:
        return num_experts * torch.sum(probs.mean(dim=(0, 1)) * (counts / n))
    shards = R.batch_size(mesh, axes)
    rows = probs.shape[0] * probs.shape[1] * shards
    me = R.sum_over_batch(probs.sum(dim=(0, 1)), mesh, axes) / rows
    ce = R.sum_over(counts, mesh, axes) / (n * shards)
    return num_experts * torch.sum(me * ce)


def _moe_chunk(p, cfg: ModelConfig, x, mesh=None, axes=None):
    """x: (B, T, D) one sequence chunk -> (out (B, T, D), aux; the whole
    batch's when the rows are split over ``axes``)."""
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
    return out.to(x.dtype), aux_loss(probs, ids, mc.num_experts, mesh,
                                     axes)


def _with_shared(p, cfg: ModelConfig, out, x):
    if "shared" in p:
        # XLA adds the two bf16 outputs in fp32; an approximate residual
        # add's quantize reads that sum unrounded (its fusion keeps it),
        # an exact residual add reads it rounded to x's dtype
        out = out.float() + L.swiglu(p["shared"], x).float()
        if not cfg.approx.enabled:
            out = out.to(x.dtype)
    return out


def moe_apply(p, cfg: ModelConfig, x, batch_axes=None, mesh=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  With shared
    experts under an approximate adder ``out`` is the fp32 sum of the
    routed and shared outputs (each rounded to x's dtype), for the
    residual add to round; with exact adds it is that sum rounded.  On a
    mesh, x is this rank's rows of a batch split over ``batch_axes``."""
    mc = cfg.moe
    b, s, d = x.shape
    axes = split_axes(mesh, batch_axes)
    if s == 1:
        # decode: the whole batch is one dispatch group
        xs = x if axes is None else R.gather_rows(x, mesh, axes)
        out, aux = _moe_chunk(p, cfg, xs.reshape(1, -1, d))
        out = out.reshape(-1, 1, d)
        if axes is not None:
            out = out[R.row_slice(mesh, axes, out.shape[0])]
    elif mc.seq_chunks > 1 and s % mc.seq_chunks == 0:
        t = s // mc.seq_chunks
        outs, auxs = zip(*(_moe_chunk(p, cfg, x[:, i * t:(i + 1) * t], mesh,
                                      axes)
                           for i in range(mc.seq_chunks)))
        out = torch.cat(outs, dim=1)
        aux = torch.stack(auxs).mean()
    else:
        out, aux = _moe_chunk(p, cfg, x, mesh, axes)
    return _with_shared(p, cfg, out, x), aux


def _local_experts_chunk(cfg: ModelConfig, xc, router, w, rank: int,
                         e_local: int):
    """One sequence chunk (B, T, D) through this model rank's experts
    ``w`` (``wg``/``wi``/``wo``, E / model of them): the reference's
    ``shard_map`` body.  Every rank routes every (token, k) pair; it
    gathers only its own experts' slots and combines only the pairs
    routed to them (the others' gates masked to 0)."""
    mc = cfg.moe
    b, t, d = xc.shape
    _, gates, ids = gate(L.dense({"w": router}, xc),
                         mc.experts_per_token)
    cap = _capacity(t, mc)
    src_tok, (_, dest, keep) = _dispatch_indices(ids, gates,
                                                 mc.num_experts, cap)
    lo = rank * e_local
    src_loc = src_tok[:, lo:lo + e_local]
    xpad = torch.cat([xc, xc.new_zeros((b, 1, d))], dim=1)
    xin = xpad[torch.arange(b, device=xc.device)[:, None, None], src_loc]
    ybuf = _expert_ffn(w, xin).reshape(b, e_local * cap, d)
    flat_ids = ids.reshape(b, -1).to(torch.int64)
    is_local = (flat_ids // e_local) == rank
    lin = (flat_ids - lo) * cap + torch.clamp(dest, max=cap - 1)
    lin = torch.clamp(lin, 0, e_local * cap - 1)
    gathered = torch.take_along_dim(ybuf, lin[:, :, None], dim=1)
    weight = (gates.reshape(b, -1) * keep.to(gates.dtype)
          * is_local.to(gates.dtype))[:, :, None]
    terms = (gathered.to(torch.float32) * weight).reshape(
        b, t, mc.experts_per_token, d)
    part = terms[:, :, 0]
    for j in range(1, mc.experts_per_token):   # XLA's reduce: in k order
        part = part + terms[:, :, j]
    return part.to(xc.dtype)


#: The expert matrices, (E, ...) leaves sharded over "model" along E.
EXPERT_LEAVES = ("wg", "wi", "wo")


def expert_parallel(cfg: ModelConfig, s: int, batch_axes, mesh) -> bool:
    """Whether :func:`moe_apply_shard_map` dispatches over "model" for a
    sequence of ``s`` (else it falls back to :func:`moe_apply`)."""
    sizes = R.mesh_shape(mesh) if mesh is not None else {}
    return (mesh is not None and batch_axes is not None
            and "model" in sizes and s != 1
            and cfg.moe.num_experts % sizes["model"] == 0)


def moe_apply_shard_map(p, cfg: ModelConfig, x, batch_axes=None, mesh=None):
    """The reference's expert-parallel dispatch over the mesh's "model"
    axis.  Activations are replicated over "model", so each model rank
    gathers ITS OWN experts' (B, E / model, C, D) buffer with no
    communication, runs their FFNs, combines partially (the other ranks'
    gates masked) and the partial outputs are summed with ONE all-reduce
    over "model" (in x's dtype, as the reference's ``psum``).  The
    load-balancing loss is recomputed from the router over the whole
    batch, as the reference's.

    Falls back to :func:`moe_apply` where the reference does
    (:func:`expert_parallel`): no mesh, no batch axes, no "model" axis,
    at decode (S == 1), or when the experts do not divide over "model".
    The expert matrices are sharded over "model" along E
    (``PARAM_RULES``); given as DTensors (the sharded step's blocks) they
    are gathered over the other mesh dims only and each rank reads its
    own experts (:func:`repro_torch.sharding.rules.model_shard`), so its
    expert gradients are its own shard's; full tensors are sliced.  The
    router's and x's gradients are summed over "model"
    (:func:`repro_torch.sharding.rules.replica_input`)."""
    mc = cfg.moe
    s = x.shape[1]
    if not expert_parallel(cfg, s, batch_axes, mesh):
        return moe_apply(p, cfg, x, batch_axes, mesh)
    model = ("model",)
    e_local = mc.num_experts // R.mesh_shape(mesh)["model"]
    rank = mesh.get_local_rank("model")
    lo = rank * e_local
    w = {n: R.model_shard(p[n], batch_axes) if R.is_dtensor(p[n])
         else p[n][lo:lo + e_local] for n in EXPERT_LEAVES}
    xr = R.replica_input(x, mesh, model)
    router = R.replica_input(p["router"]["w"], mesh, model)
    chunks = mc.seq_chunks if s % max(1, mc.seq_chunks) == 0 else 1
    t = s // chunks
    part = torch.cat([_local_experts_chunk(cfg, xr[:, i * t:(i + 1) * t],
                                           router, w, rank, e_local)
                      for i in range(chunks)], dim=1)
    out = R.sum_over_replicas(part, mesh, model)   # THE one collective
    # router aux loss (a global recompute, for logging parity)
    probs, _, ids = route(p, cfg, x)
    aux = aux_loss(probs, ids, mc.num_experts, mesh,
                   split_axes(mesh, batch_axes))
    return _with_shared(p, cfg, out, x), aux
