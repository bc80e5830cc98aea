"""DeepSeek-V2 Multi-head Latent Attention (MLA): the port of
``repro.models.mla``.

The KV cache stores the COMPRESSED latent c_kv (kv_lora_rank) plus the
shared RoPE key (rope_head_dim), the memory win that defines MLA:

  {"ckv": (B, S_ctx, r), "krope": (B, S_ctx, dr) bf16,
   "pos": (S_ctx,) int32, -1 = empty}

Two decode paths (``cfg.mla.decode_mode``):
  "decompress" — expand the whole latent cache to per-head K/V each step;
  "absorbed"   — fold W^UK into the query and W^UV into the output and
                 attend directly in latent space.

As the port's attention does, prefill and decode write the cache they are
given in place and return it; a decode position past the end of the cache
is clamped to its last slot (``dynamic_update_slice``'s rule).
``rope``, where a function takes it, is the (cos, sin) tables of
``positions`` at ``rope_head_dim`` when the caller has them already.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import decode_slot
from repro_torch.models.config import BlockSpec, ModelConfig


def mla_init(init, cfg: ModelConfig, spec: BlockSpec):
    """Parameters of one MLA mixer, drawn by ``init`` (a
    ``transformer.Init``)."""
    m = cfg.mla
    h = cfg.num_heads
    dq = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": init.dense(cfg.d_model, m.q_lora_rank),
        "q_ln": init.norm(m.q_lora_rank),
        "wq_b": init.dense(m.q_lora_rank, h * dq),
        "wkv_a": init.dense(cfg.d_model, m.kv_lora_rank + m.rope_head_dim),
        "kv_ln": init.norm(m.kv_lora_rank),
        "wkv_b": init.dense(m.kv_lora_rank,
                            h * (m.nope_head_dim + m.v_head_dim)),
        "wo": init.dense(h * m.v_head_dim, cfg.d_model),
    }


def _tables(cfg, positions, spec, rope):
    return rope if rope is not None else L.rope_tables(
        positions, cfg.mla.rope_head_dim, spec.rope_base)


def _queries(p, cfg, x, positions, spec, rope=None):
    m = cfg.mla
    b, s, _ = x.shape
    cq = L.rms_norm(p["q_ln"], L.dense(p["wq_a"], x), cfg.norm_eps)
    q = L.dense(p["wq_b"], cq).reshape(
        b, s, cfg.num_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    cos, sin = _tables(cfg, positions, spec, rope)
    return q_nope, L.apply_rope(q_rope, cos, sin)


def _latents(p, cfg, x, positions, spec, rope=None):
    m = cfg.mla
    c_kv, k_rope = L.dense(p["wkv_a"], x).split(
        [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = L.rms_norm(p["kv_ln"], c_kv, cfg.norm_eps)
    cos, sin = _tables(cfg, positions, spec, rope)
    k_rope = L.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def _expand_kv(p, cfg, c_kv):
    """latent (B,S,r) -> per-head k_nope, v (B,S,H,*)."""
    m = cfg.mla
    b, s, _ = c_kv.shape
    kv = L.dense(p["wkv_b"], c_kv).reshape(
        b, s, cfg.num_heads, m.nope_head_dim + m.v_head_dim)
    return kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)


def _full_attention(p, cfg, spec, q_nope, q_rope, c_kv, k_rope, positions,
                    kvpos):
    m = cfg.mla
    b, s = q_nope.shape[:2]
    k_nope, v = _expand_kv(p, cfg, c_kv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = L.attention_any(q, k, v, positions, kvpos, causal=True,
                          window=spec.window, kv_chunk=cfg.attn_kv_chunk)
    return L.dense(p["wo"], out.reshape(b, s, cfg.num_heads * m.v_head_dim))


def mla_apply(p, cfg: ModelConfig, spec: BlockSpec, x, positions,
              rope=None):
    """Full-sequence MLA (scoring). positions: (S,)."""
    q_nope, q_rope = _queries(p, cfg, x, positions, spec, rope)
    c_kv, k_rope = _latents(p, cfg, x, positions, spec, rope)
    return _full_attention(p, cfg, spec, q_nope, q_rope, c_kv, k_rope,
                           positions, positions)


def mla_cache_init(cfg: ModelConfig, batch: int, ctx_len: int,
                   dtype=torch.bfloat16, device=None):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, ctx_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, ctx_len, m.rope_head_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((ctx_len,), -1, dtype=torch.int32, device=device),
    }


def mla_prefill(p, cfg, spec, x, positions, cache, rope=None):
    """Prefill: full-sequence MLA + the latents of positions [0, S) into
    the cache."""
    q_nope, q_rope = _queries(p, cfg, x, positions, spec, rope)
    c_kv, k_rope = _latents(p, cfg, x, positions, spec, rope)
    out = _full_attention(p, cfg, spec, q_nope, q_rope, c_kv, k_rope,
                          positions, positions)
    s = x.shape[1]
    cache["ckv"][:, :s] = c_kv.to(cache["ckv"].dtype)
    cache["krope"][:, :s] = k_rope.to(cache["krope"].dtype)
    cache["pos"][:s] = positions.to(torch.int32)
    return out, cache


def mla_decode(p, cfg: ModelConfig, spec: BlockSpec, x, pos: int, cache,
               positions=None, rope=None):
    """One decode step. x: (B,1,D); pos: the absolute position (an int);
    ``positions`` (``[pos]`` as an int32 tensor on x's device) when the
    caller has it already."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    if positions is None:
        positions = torch.arange(pos, pos + 1, dtype=torch.int32,
                                 device=x.device)
    if rope is None:
        rope = L.rope_tables(range(pos, pos + 1), m.rope_head_dim,
                             spec.rope_base, x.device)
    q_nope, q_rope = _queries(p, cfg, x, positions, spec, rope)
    c_kv_t, k_rope_t = _latents(p, cfg, x, positions, spec, rope)
    slot = decode_slot(pos, cache["ckv"].shape[1], 0)
    cache["ckv"][:, slot] = c_kv_t[:, 0].to(cache["ckv"].dtype)
    cache["krope"][:, slot] = k_rope_t[:, 0].to(cache["krope"].dtype)
    cache["pos"][slot] = pos
    kvpos = cache["pos"]
    ckv = cache["ckv"].to(x.dtype)                  # (B,S,r)
    krope = cache["krope"].to(x.dtype)              # (B,S,dr)
    if m.decode_mode == "decompress":
        return _full_attention(p, cfg, spec, q_nope, q_rope, ckv, krope,
                               positions, kvpos), cache

    # --- absorbed path: attend in latent space -----------------------------
    # each product is the reference's einsum taken as its compiled step
    # takes it: transposed (the latent or weight side as the rows), the
    # cache held as [S, r] (hence ``lhs_t`` for the context product)
    r, dn, dv = m.kv_lora_rank, m.nope_head_dim, m.v_head_dim
    wkv_b = p["wkv_b"]["w"].to(x.dtype).reshape(r, h, dn + dv)
    w_uk = wkv_b[..., :dn].transpose(0, 1)          # (H, r, dn)
    w_uv = wkv_b[..., dn:].permute(1, 2, 0)         # (H, dv, r)
    # q_lat[b,1,h,r] = q_nope . W^UK  ("bqhn,rhn->bqhr"), as (H, r, B)
    q_lat = L.matmul(w_uk, q_nope[:, 0].permute(1, 2, 0))
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    # "bqhr,bkr->bhqk" and "bqhd,bkd->bhqk", as (B, S, H)
    s_lat = L.matmul(ckv, q_lat.permute(2, 1, 0))
    s_rope = L.matmul(krope, q_rope[:, 0].transpose(1, 2))
    scores = (s_lat + s_rope).transpose(1, 2)[:, :, None].to(
        torch.float32) * scale                      # (B, H, 1, S)
    bias = L._mask_bias(positions, kvpos, causal=True, window=spec.window)
    probs = torch.softmax(scores + bias[None, None], dim=-1)
    # "bhqk,bkr->bqhr", as (B, r, H)
    ctx_lat = L.matmul(ckv.transpose(1, 2),
                       probs[:, :, 0].to(x.dtype).transpose(1, 2),
                       lhs_t=True)
    # "bqhr,rhv->bqhv", as (H, dv, B)
    out = L.matmul(w_uv, ctx_lat.permute(2, 1, 0))
    out = L.dense(p["wo"], out.permute(2, 0, 1).reshape(b, 1, h * dv))
    return out, cache
