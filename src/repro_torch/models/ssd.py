"""Mamba-2 SSD (state-space duality) block (the port of
``repro.models.ssd``).

Chunked SSD algorithm (Dao & Gu, 2024): the sequence is split into chunks
of length Q; within a chunk the dual quadratic form is a batched product,
chunk boundary states are combined with a short scan (a loop here, the
reference's ``lax.scan``).  All recurrences are in fp32; the token mixing
output is gated (silu(z)) and RMS-normed before the output projection.

State update:  h_t = a_t h_{t-1} + dt_t * (B_t (x) x_t),  a_t = exp(dt_t A)
Output:        y_t = C_t . h_t + D * x_t

Numerics follow the reference's compiled step on the CPU: ``exp``,
``softplus`` and the state updates through ``layers``' fp32 functions
(:func:`layers.exp32`, :func:`layers.fma32`); the cumulative decay in
XLA:CPU's order of summation (:func:`cumsum`); each three-operand einsum
as ``jnp.einsum``'s contraction path splits it (a pair, rounded to bf16,
then the third operand); ``y * silu(z)`` handed to the norm unrounded,
as XLA's fusion hands it.

Cache: {"state": (B,H,N,P) fp32, "conv_x": (B,cw-1,U), "conv_bc": (B,cw-1,2N)}.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.rglru import causal_conv

#: XLA:CPU sums a cumulative sum longer than this in blocks of this many.
CUMSUM_BLOCK = 16


def _dims(cfg):
    sc = cfg.ssd
    assert sc.n_groups == 1, "group-shared B/C only (all assigned archs)"
    return sc, sc.d_inner // sc.head_dim


def ssd_init(init, cfg: ModelConfig, spec: BlockSpec):
    """Parameters of one SSD mixer, drawn by ``init`` (a
    ``transformer.Init``); ``a_log`` and ``dt_bias`` stay fp32 in any
    ``init.dtype`` (``d_skip`` is cast to the activations at use, as the
    reference casts it)."""
    sc, heads = _dims(cfg)
    d = cfg.d_model
    cw = sc.conv_width

    def conv(width):
        return {"w": init.normal((cw, width), cw ** -0.5),
                "b": init.zeros((width,))}

    dev = init.device
    log_dt = init.uniform((heads,), float(torch.log(torch.tensor(1e-3))),
                          float(torch.log(torch.tensor(1e-1))))
    return {
        "in_z": init.dense(d, sc.d_inner),
        "in_x": init.dense(d, sc.d_inner),
        "in_bc": init.dense(d, 2 * sc.d_state),
        "in_dt": init.dense(d, heads),
        "conv_x": conv(sc.d_inner),
        "conv_bc": conv(2 * sc.d_state),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads,
                                          dtype=torch.float32, device=dev)),
        "d_skip": torch.ones((heads,), dtype=init.dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "norm": init.norm(sc.d_inner),
        "out_proj": init.dense(sc.d_inner, d),
    }


def cumsum(x, dim: int):
    """``jnp.cumsum`` along ``dim`` in XLA:CPU's order: up to
    CUMSUM_BLOCK elements one sequential fp32 sum; past that, the axis
    zero-padded to blocks of CUMSUM_BLOCK, a sequential sum inside each
    block, an exclusive sum of the block totals (in this order again), and
    each block's offset added once."""
    x = x.float().movedim(dim, -1)
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        out = torch.empty_like(x)
        acc = x[..., 0]
        out[..., 0] = acc
        for j in range(1, n):
            acc = acc + x[..., j]
            out[..., j] = acc
        return out.movedim(-1, dim)
    nb = -(-n // CUMSUM_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * CUMSUM_BLOCK - n)).reshape(
        *x.shape[:-1], nb, CUMSUM_BLOCK)
    inner = cumsum(xb, -1)
    totals = inner[..., -1]
    offsets = torch.cat([torch.zeros_like(totals[..., :1]),
                         cumsum(totals[..., :-1], -1)], dim=-1)
    out = (inner + offsets[..., None]).reshape(*x.shape[:-1], -1)[..., :n]
    return out.movedim(-1, dim)


def _project(p, cfg, x, conv_x_state=None, conv_bc_state=None):
    """Returns z, xh (B,S,H,P), bh/ch (B,S,N), dt, log_decay, conv states."""
    sc, heads = _dims(cfg)
    z = L.dense(p["in_z"], x)
    xin = L.dense(p["in_x"], x)
    bc = L.dense(p["in_bc"], x)
    dt_raw = L.dense(p["in_dt"], x)
    xin, cxs = causal_conv(xin, p["conv_x"]["w"], p["conv_x"]["b"],
                           state=conv_x_state)
    bc, cbs = causal_conv(bc, p["conv_bc"]["w"], p["conv_bc"]["b"],
                          state=conv_bc_state)
    xin, bc = L.silu(xin), L.silu(bc)
    bsz, s = xin.shape[:2]
    xh = xin.reshape(bsz, s, heads, sc.head_dim)
    bh, ch = torch.chunk(bc, 2, dim=-1)             # (B,S,N) each
    dt = L.softplus32(dt_raw.float() + p["dt_bias"].float())
    log_decay = dt * -L.exp32(p["a_log"].float())   # (B,S,H)
    return z, xh, bh, ch, dt, log_decay, cxs, cbs


def _gated_out(p, cfg, y, z):
    # XLA hands the norm the fp32 product of the two bf16 factors unrounded
    y = y.float() * L.silu(z).float()
    y = L.rms_norm(p["norm"], y, cfg.norm_eps).to(z.dtype)
    return L.dense(p["out_proj"], y)


def ssd_apply(p, cfg: ModelConfig, spec: BlockSpec, x, state0=None):
    """x: (B,S,D). Returns (out, (state_last, conv_x_state, conv_bc_state))."""
    sc, heads = _dims(cfg)
    z, xh, bh, ch, dt, log_decay, cxs, cbs = _project(p, cfg, x)
    bsz, s = xh.shape[:2]
    q = min(sc.chunk, s)
    if s % q:
        # remainder handling: run the divisible head, then the tail as one
        # short chunk, threading the boundary state through
        split = (s // q) * q
        y1, h_mid = _ssd_core(cfg, xh[:, :split], bh[:, :split],
                              ch[:, :split], dt[:, :split],
                              log_decay[:, :split], q, state0)
        y2, h_last = _ssd_core(cfg, xh[:, split:], bh[:, split:],
                               ch[:, split:], dt[:, split:],
                               log_decay[:, split:], s - split, h_mid)
        y = torch.cat([y1, y2], dim=1)
    else:
        y, h_last = _ssd_core(cfg, xh, bh, ch, dt, log_decay, q, state0)
    y = y + xh * p["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(bsz, s, sc.d_inner)
    return _gated_out(p, cfg, y, z), (h_last, cxs, cbs)


def _ssd_core(cfg, xh, bh, ch, dt, log_decay, q, state0):
    """Chunked SSD over a divisible segment. Returns (y (B,S,H,P), h_last).

    The products are held as the reference's compiled step holds them:
    C B^T with B as [k, n]; y_intra as x^T att (per head: [p, k] @ [k, q]);
    the states as (w x)^T B; y_inter as h^T C^T (per chunk: [(h p), n] @
    [n, q])."""
    sc, heads = _dims(cfg)
    bsz, s = xh.shape[:2]
    nc = s // q
    dtype = xh.dtype

    def r(t, *shape):
        return t.reshape(bsz, nc, q, *shape)

    xq = r(xh, heads, sc.head_dim)
    bq, cq = r(bh, sc.d_state), r(ch, sc.d_state)
    dtq = r(dt, heads)
    cum = cumsum(r(log_decay, heads), dim=2)        # (B,nc,Q,H)
    # intra-chunk: att[q,k] = (C_q.B_k) exp(cum_q - cum_k) dt_k,  k <= q
    cb = L.matmul(cq, bq.transpose(-1, -2), rhs_t=True)     # (B,nc,Q,K)
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xh.device))
    att = cb.float()[..., None] * L.exp32(
        delta.masked_fill(~mask[None, None, ..., None], float("-inf")))
    att = (att * dtq[:, :, None, :, :]).to(dtype)
    # (B,nc,H,P,K) @ (B,nc,H,K,Q) -> (B,nc,H,P,Q)
    y_intra = L.matmul(xq.permute(0, 1, 3, 4, 2), att.permute(0, 1, 4, 3, 2))
    y_intra = y_intra.permute(0, 1, 4, 2, 3)                 # (B,nc,Q,H,P)
    # chunk states: S_c = sum_k exp(cum_last - cum_k) dt_k  B_k (x) x_k,
    # the pair (wk, x) first, then B
    wk = (L.exp32(cum[:, :, -1:, :] - cum) * dtq).to(dtype)  # (B,nc,Q,H)
    wx = wk[..., None] * xq                                   # (B,nc,Q,H,P)
    wx = wx.permute(0, 1, 3, 4, 2).reshape(bsz, nc, heads * sc.head_dim, q)
    states = L.matmul(wx, bq)                          # (B,nc,(H P),N)
    states = states.reshape(bsz, nc, heads, sc.head_dim, sc.d_state) \
        .transpose(-1, -2)                             # (B,nc,H,N,P)
    chunk_decay = L.exp32(cum[:, :, -1, :])            # (B,nc,H)

    h = (torch.zeros((bsz, heads, sc.d_state, sc.head_dim),
                     dtype=torch.float32, device=xh.device)
         if state0 is None else state0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = L.fma32(chunk_decay[:, c, :, None, None], h,
                    states[:, c].float())
    h_prevs = torch.stack(h_prevs, dim=1).to(dtype)    # (B,nc,H,N,P)
    # y_inter: (h^T C^T) first, rounded, then times exp(cum)
    hp = h_prevs.transpose(-1, -2).reshape(bsz, nc, heads * sc.head_dim,
                                           sc.d_state)
    hc = L.matmul(hp, cq.transpose(-1, -2), rhs_t=True)   # (B,nc,(H P),Q)
    hc = hc.reshape(bsz, nc, heads, sc.head_dim, q).permute(0, 1, 4, 2, 3)
    y_inter = hc * L.exp32(cum).to(dtype)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, heads, sc.head_dim)
    return y, h


def ssd_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None):
    sc, heads = _dims(cfg)
    cw = sc.conv_width
    return {
        "state": torch.zeros((batch, heads, sc.d_state, sc.head_dim),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cw - 1, sc.d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, cw - 1, 2 * sc.d_state), dtype=dtype,
                               device=device),
    }


def ssd_prefill(p, cfg, spec, x, cache):
    out, (h_last, cxs, cbs) = ssd_apply(p, cfg, spec, x,
                                        state0=cache["state"])
    return out, {"state": h_last,
                 "conv_x": cxs.to(cache["conv_x"].dtype),
                 "conv_bc": cbs.to(cache["conv_bc"].dtype)}


def ssd_decode(p, cfg: ModelConfig, spec: BlockSpec, x, cache):
    """x: (B,1,D) single token."""
    sc, heads = _dims(cfg)
    z, xh, bh, ch, dt, log_decay, cxs, cbs = _project(
        p, cfg, x, conv_x_state=cache["conv_x"].to(x.dtype),
        conv_bc_state=cache["conv_bc"].to(x.dtype))
    dec = L.exp32(log_decay[:, 0])                  # (B,H)
    # upd = (B (x) dt) (x) x, the pair first as the einsum's path takes it
    bdt = bh[:, 0].float()[:, None, :] * dt[:, 0][:, :, None]   # (B,H,N)
    upd = bdt[..., None] * xh[:, 0].float()[:, :, None, :]       # (B,H,N,P)
    h = L.fma32(dec[..., None, None], cache["state"], upd)
    y = _state_read(ch[:, 0].float(), h)            # (B,H,P)
    y = y.to(x.dtype) + xh[:, 0] * p["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(x.shape[0], 1, sc.d_inner)
    out = _gated_out(p, cfg, y, z)
    return out, {"state": h,
                 "conv_x": cxs.to(cache["conv_x"].dtype),
                 "conv_bc": cbs.to(cache["conv_bc"].dtype)}


def _state_read(c, h):
    """y[b, h, p] = sum_n c[b, n] h[b, h, n, p] in fp32 (operands not
    bf16-valued): on the CPU one sequential chain over n, each step one
    FMA, as XLA:CPU's matrix-vector product adds them; on the card one
    fp32 product."""
    if h.device.type != "cpu":
        return torch.einsum("bn,bhnp->bhp", c, h)
    y = torch.zeros_like(h[:, :, 0])
    for n in range(h.shape[2]):
        y = L.fma32(c[:, n, None, None], h[:, :, n], y)
    return y
