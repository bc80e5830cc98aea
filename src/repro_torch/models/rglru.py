"""RecurrentGemma / Griffin real-gated LRU residual block (the port of
``repro.models.rglru``).

    x ->  proj_x -> causal conv(4) -> RG-LRU  \\
                                               * -> proj_out
    x ->  proj_gate -> GELU                   /

RG-LRU:  r_t = sigmoid(W_a u_t + b_a)         (recurrence gate)
         i_t = sigmoid(W_i u_t + b_i)         (input gate)
         log a_t = -c * softplus(Lambda) * r_t
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill runs ``jax.lax.associative_scan``'s combine tree over time
(:func:`associative_scan`); decode is one step.  The recurrence is exact
float math in fp32 (the approximate adders stay in the residual stream).

Numerics follow the reference's compiled step on the CPU: the gates,
decays and states through ``layers``' fp32 ``exp32``/``log1p32`` and
``fma32`` where XLA contracts a multiply-add; ``1 - a^2`` as
``1 - exp(2 log a)`` (XLA rewrites exp(x) * exp(x) so); the input term
``i * u`` reads the conv's last sum (``conv + b``) unrounded, as XLA's
fusion does, while the gates read it rounded to bf16.

Cache: {"h": (B, U) fp32, "conv": (B, cw-1, U) bf16}.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig

_SQRT_EPS = 1e-6


def rglru_init(init, cfg: ModelConfig, spec: BlockSpec):
    """Parameters of one RG-LRU mixer, drawn by ``init`` (a
    ``transformer.Init``); ``lam`` stays fp32 in any ``init.dtype``."""
    rc = cfg.rglru
    u, d, nb = rc.width, cfg.d_model, cfg.num_heads
    bd = u // nb
    # Lambda so that a ~ U(0.9, 0.999) at r = 1 (Griffin appendix)
    lam = init.uniform((u,), 0.9, 0.999)
    lam_raw = torch.log(torch.expm1(-torch.log(lam) / rc.c_exponent))

    def blockdiag():
        return {"w": init.normal((nb, bd, bd), bd ** -0.5),
                "b": init.zeros((nb, bd))}

    return {
        "proj_x": init.dense(d, u),
        "proj_gate": init.dense(d, u),
        "conv_w": init.normal((rc.conv_width, u), rc.conv_width ** -0.5),
        "conv_b": init.zeros((u,)),
        "wa": blockdiag(),
        "wi": blockdiag(),
        "lam": lam_raw,
        "proj_out": init.dense(u, d),
    }


def _blockdiag_apply(p, x):
    """x: (..., U) bf16 -> (..., U) through a block-diagonal matrix, each
    block's product taken as XLA takes it (W^T x^T, W held as [in, out])."""
    nb, bd, _ = p["w"].shape
    lead = x.shape[:-1]
    xt = x.reshape(-1, nb, bd).permute(1, 2, 0)              # (nb, bd, T)
    w = p["w"].to(x.dtype).transpose(1, 2)                    # (nb, out, in)
    y = L.matmul(w, xt, lhs_t=True).permute(2, 0, 1)          # (T, nb, bd)
    y = y + p["b"].to(x.dtype)
    return y.reshape(*lead, nb * bd)


def causal_conv(x, w, b, state=None, *, unrounded_bias=False):
    """Depthwise causal conv. x: (B,S,U); w: (cw,U); state: (B,cw-1,U).

    Returns (y, new_state).  The taps' products and sums round to x's
    dtype one by one; with ``unrounded_bias`` the last add (``+ b``) is
    kept in fp32, as the reference's fusions keep it where the sum goes
    straight on into fp32 math."""
    cw = w.shape[0]
    if state is not None:
        x = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x = torch.nn.functional.pad(x, (0, 0, cw - 1, 0))
    s_out = x.shape[1] - (cw - 1)
    w = w.to(x.dtype)
    y = x[:, :s_out] * w[0]
    for j in range(1, cw):
        y = y + x[:, j:j + s_out] * w[j]
    bias = b.to(x.dtype)
    y = y.float() + bias.float() if unrounded_bias else y + bias
    return y, x[:, -(cw - 1):]


def _gates(p, cfg, u_conv, u_f32):
    """(a, the input term) in fp32 from the conv output rounded (u_conv,
    the gates' input) and unrounded (u_f32)."""
    rc = cfg.rglru
    r = L.sigmoid32(_blockdiag_apply(p["wa"], u_conv).float())
    i = L.sigmoid32(_blockdiag_apply(p["wi"], u_conv).float())
    log_a = (L.softplus32(p["lam"].float()) * -rc.c_exponent) * r
    a = L.exp32(log_a)
    # XLA rewrites a * a = exp(log_a) * exp(log_a) into exp(2 log_a)
    beta = L.sqrt32(torch.clamp_min(1.0 - L.exp32(log_a + log_a),
                                    _SQRT_EPS))
    return a, beta * (i * u_f32)


def associative_scan(a, b, axis: int = 1):
    """The linear recurrence h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over
    ``axis``, in the combine tree of ``jax.lax.associative_scan``: adjacent
    pairs combined, the scan of the pairs by recursion, then the even
    elements from it, the two interleaved.  Each combine is
    (a1 * a2, fma(a2, b1, b2)), the form XLA compiles it to.  Returns h."""

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def combine(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return a1 * a2, L.fma32(a2, b1, b2)

    def interleave(even, odd):
        n = even.shape[axis] + odd.shape[axis]
        shape = list(even.shape)
        shape[axis] = n
        out = even.new_empty(shape)
        idx = [slice(None)] * even.ndim
        idx[axis] = slice(0, None, 2)
        out[tuple(idx)] = even
        idx[axis] = slice(1, None, 2)
        out[tuple(idx)] = odd
        return out

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = combine([sl(e, 0, -1, 2) for e in elems],
                          [sl(e, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([sl(e, 0, -1) for e in odd],
                           [sl(e, 2, None, 2) for e in elems])
        else:
            even = combine(odd, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [interleave(e, o) for e, o in zip(even, odd)]

    return scan([a.float(), b.float()])[1]


def _branches(p, x, state=None):
    """The two input branches: (the conv output rounded and unrounded, the
    GELU gate, the conv state)."""
    ub = L.dense(p["proj_x"], x)
    gate = L.gelu_tanh(L.dense(p["proj_gate"], x))
    u32, conv_state = causal_conv(ub, p["conv_w"], p["conv_b"], state,
                                  unrounded_bias=True)
    return u32.to(x.dtype), u32, gate, conv_state


def rglru_apply(p, cfg: ModelConfig, spec: BlockSpec, x, h0=None):
    """x: (B,S,D). Returns (out, (h_last, conv_state))."""
    u_conv, u32, gate, conv_state = _branches(p, x)
    a, bterm = _gates(p, cfg, u_conv, u32)
    if h0 is not None:
        # fold the initial state into the first step: b_0 += a_0 * h0
        bterm = bterm.clone()
        bterm[:, 0] = L.fma32(a[:, 0], h0.float(), bterm[:, 0])
    h = associative_scan(a, bterm, axis=1)
    out = L.dense(p["proj_out"], h.to(x.dtype) * gate)
    return out, (h[:, -1], conv_state)


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    rc = cfg.rglru
    return {
        "h": torch.zeros((batch, rc.width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, rc.conv_width - 1, rc.width),
                            dtype=dtype, device=device),
    }


def rglru_prefill(p, cfg, spec, x, cache):
    out, (h_last, conv_state) = rglru_apply(p, cfg, spec, x, h0=cache["h"])
    return out, {"h": h_last, "conv": conv_state.to(cache["conv"].dtype)}


def rglru_decode(p, cfg: ModelConfig, spec: BlockSpec, x, cache):
    """x: (B,1,D)."""
    u_conv, u32, gate, conv_state = _branches(p, x, cache["conv"])
    a, bterm = _gates(p, cfg, u_conv, u32)
    h = L.fma32(a[:, 0], cache["h"], bterm[:, 0])
    out = L.dense(p["proj_out"], h[:, None].to(x.dtype) * gate)
    return out, {"h": h, "conv": conv_state.to(cache["conv"].dtype)}
