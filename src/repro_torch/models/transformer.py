"""Model assembly: embeddings and frontends, residual blocks, the block
loop and the training loss (the port of ``repro.models.transformer``;
every family of the registry).

Layout of a parameter tree (all plain dicts of tensors):

  {"embed": {"table"} | "frontend": {"w", "b"}, ["vis_adapter": {"w"},]
   "prefix": [block...], "pattern": [[block...]...], "suffix": [block...],
   "final_norm": {...}, "lm_head": {...}}

An audio model (hubert-xlarge) takes ``frames`` through ``frontend`` in
place of token ids; a vision model (llama-3.2-vision-11b) also takes
``vision`` embeddings through ``vis_adapter`` at prefill, which its cross
attention blocks read (their k/v are cached for decode).

``pattern`` holds one entry per pattern POSITION, as the reference's
does; where the reference's entry is one block tree whose leaves carry a
leading ``repeats`` axis (consumed by ``lax.scan``), the port's is a list
of ``repeats`` block trees, run one after the other.  A cache has the same
layout.  Norm scales are fp32; the matrices, biases and the embedding may
be held in bf16 for serving (``init_params(..., dtype=torch.bfloat16)``),
which gives the same results: ``dense`` casts its weight to the bf16
activations on every call and the embedding is gathered into bf16.

The paper's technique enters through ``cfg.approx``: when enabled, both
residual-stream adds of every block run through the configured
approximate adder in fixed point (``cfg.approx.residual_add`` -> the
port's engine, the ``approx_add`` kernel on the card).

Self attention (global or windowed), Llama-3.2's gated cross attention,
DeepSeek's latent attention (MLA), RecurrentGemma's RG-LRU and Mamba-2's
SSD, with a SwiGLU, GELU or MoE MLP or none, are ported, and so is the
loss (:func:`loss_fn`), which autograd differentiates as ``jax.grad``
differentiates the reference's (``models.layers``' emulations carry
jax's derivative rules).

On a mesh (``batch_axes``/``mesh``: ``launch.steps``' sharded steps) the
batch holds this rank's rows of a batch split over ``batch_axes``, and a
parameter leaf may be a DTensor holding this rank's shard: each block's
leaves (and the embedding's, the final norm's and the head's) are
gathered just before they are used (:func:`repro_torch.sharding.rules.gather`),
their gradients summed over the batch axes and cut back to each leaf's
placement.

On a mesh whose "model" axis has more than one rank, compute over
"model" is tensor-parallel where the rules shard the leaves over it, in
the training loss and at prefill and decode alike, as the reference's
GSPMD-partitioned steps compute: a self-attention mixer (its H/m q and
KV/m kv heads; at prefill and decode its cache holds those kv heads,
:func:`init_cache`) and a dense MLP (its d_ff/m shard) keep their
"model" shards (:func:`repro_torch.sharding.rules.model_shard`, gathered
over the other mesh dims only), the column-parallel products read the
block's input whole and the row-parallel ones' bf16 partials are summed
over "model" in fp32 and rounded once (``layers.dense_row``); the
embedding looks up its vocabulary shard (other ids give 0, summed over
"model"); in training the head and CE compute on the rank's vocabulary
shard, the max, the sum of exponentials and the gold logit combined over
"model" (:func:`loss_fn`); at prefill and decode the head's columns are
the rank's and are gathered over "model" in vocabulary order (no value
changes), or, where the vocabulary stays whole but FSDP shards the
head's rows over "data", the head is row-parallel over "model"
(:func:`head_rows_split`).  Read from the reference's compiled (1, 2)
and (2, 2) train, prefill and decode steps: every "model" all-reduce
there sums bf16-rounded partials of a product (promoted to fp32,
rounded once), or fp32 sums of the CE and of the q/k norm scales'
gradients; no leaf computed tensor-parallel is gathered over "model".
In hubert-xlarge-smoke's (1, 2) step the GELU MLP's output bias is added
after its sum, once: rounded to bf16 and added in fp32, the sum left
unrounded for the approximate residual add that reads it
(``layers.dense_row``'s ``sum32``); a column-parallel bias (``wi.b``,
qwen1.5's ``wq.b``/``wk.b``/``wv.b``) is sliced with its matrix's
columns.  With exact adds a block whose MLP is tensor-parallel hands the
next norm its last residual sum rounded to bf16, not the unrounded
carry of the unsharded step (read from gemma3-27b-smoke's (1, 2) steps,
prefill, decode and the training forward alike; :func:`block_apply`).
A leaf the rules leave replicated over "model" (a vocabulary or width
the axis does not divide) is computed whole on every rank, as the
reference's is; so are the other mixers (cross attention, MLA, RG-LRU,
SSD, whose caches each rank holds whole) and the MoE's router and shared
experts.  The expert-parallel MoE (``moe.use_shard_map``) reads its own
experts (:func:`repro_torch.models.moe.moe_apply_shard_map`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.ax.backends import get_backend
from repro_torch.ax.engine import resolve_device as _resolve_device
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mla as MLAm
from repro_torch.models import moe as MOEm
from repro_torch.models import rglru as RGm
from repro_torch.models import ssd as SSDm
from repro_torch.models.config import (
    ATTN, CROSS, GELU, MLA, MOE, NONE, RGLRU, SSD, SWIGLU,
    BlockSpec, ModelConfig,
)
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_map

Params = Dict[str, Any]
Device = Union[str, torch.device, None]


#: The ported mixers: (init, full, prefill, decode).  The attention
#: mixers take positions and RoPE tables; the recurrent ones take none.
_MIXERS = {
    ATTN: (ATT.attn_init, ATT.attn_apply, ATT.attn_prefill, ATT.attn_decode),
    MLA: (MLAm.mla_init, MLAm.mla_apply, MLAm.mla_prefill, MLAm.mla_decode),
    RGLRU: (RGm.rglru_init, RGm.rglru_apply, RGm.rglru_prefill,
            RGm.rglru_decode),
    SSD: (SSDm.ssd_init, SSDm.ssd_apply, SSDm.ssd_prefill, SSDm.ssd_decode),
}
_RECURRENT = (RGLRU, SSD)


def check_ported(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` validated: every mixer (``BlockSpec`` admits no other) and
    input of the registry is ported."""
    return cfg.validate()


def _gathered(tree, batch_axes, mesh):
    """``tree``'s DTensor leaves as full tensors on a mesh
    (:func:`repro_torch.sharding.rules.gather`); ``tree`` off one."""
    return tree if mesh is None else R.gather(tree, batch_axes or ())


def _sharded(t) -> bool:
    return R.model_dim(t) is not None


def _local(tree, batch_axes, partial=()):
    """``tree``'s leaves for tensor-parallel compute: a leaf sharded over
    "model" as this rank's shard (:func:`repro_torch.sharding.rules.model_shard`),
    the others gathered, their gradients summed over the batch axes and
    ``partial`` too."""
    if isinstance(tree, dict):
        return {k: _local(v, batch_axes, partial) for k, v in tree.items()}
    if _sharded(tree):
        return R.model_shard(tree, batch_axes or ())
    return R.gather(tree, batch_axes or (), partial)


#: The leaves of a tensor-parallel attention mixer that stay whole on
#: every "model" rank but whose gradients are partial there (summed over
#: "model"): the q/k norm scales, which each rank applies to its own heads.
MODEL_PARTIAL_LEAVES = frozenset({"qn", "kn"})


def tensor_parallel_parts(cfg: ModelConfig, spec: BlockSpec, sharded,
                          m: int):
    """(mixer, MLP): whether a block's self-attention mixer and its dense
    MLP compute tensor-parallel over m > 1 "model" ranks.  ``sharded``
    is the block's tree with, for each leaf, whether it is sharded over
    "model": the mixer when its q, k, v and o matrices are and its q and
    kv heads split over m, a SwiGLU or GELU MLP when its matrices are."""
    mix = sharded["mixer"]
    attn = (spec.mixer == ATTN
            and all(mix[k]["w"] for k in ("wq", "wk", "wv", "wo"))
            and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0)
    mlp = spec.mlp in (SWIGLU, GELU) and all(
        v["w"] for v in sharded["mlp"].values())
    return attn, mlp


def block_tensor_parallel(p, cfg: ModelConfig, spec: BlockSpec, mesh):
    """(the mixer's, the MLP's) :class:`repro_torch.sharding.rules.TensorParallel`
    for a block on ``mesh``, or None each (:func:`tensor_parallel_parts`):
    only on a mesh with model > 1, in every mode."""
    tp = R.tensor_parallel(mesh)
    if tp is None:
        return None, None
    attn, mlp = tensor_parallel_parts(cfg, spec, tree_map(_sharded, p),
                                      tp.size)
    return (tp if attn else None), (tp if mlp else None)


def cache_tensor_parallel(params, cfg: ModelConfig, mesh) -> list:
    """Each block's mixer's tensor parallelism on ``mesh``
    (:func:`block_tensor_parallel`), in block order: what
    :func:`init_cache` reads, so that a tensor-parallel attention block's
    cache holds the rank's KV/m heads."""
    return [block_tensor_parallel(p, cfg, spec, mesh)[0]
            for p, spec in zip(blocks_in_order(cfg, params),
                               cfg.all_blocks(), strict=True)]


def _block_gathered(p, cfg, spec, s, mode, batch_axes, mesh, tp=(None, None)):
    """A block's leaves for :func:`block_apply` on a mesh: gathered
    (:func:`_gathered`), but the tensor-parallel mixer's and MLP's
    (``tp``, :func:`block_tensor_parallel`) as this rank's "model" shards
    (:func:`_local`; the q/k norm scales, which each rank applies to its
    own heads, with their gradients summed over "model"), and for the
    expert-parallel MoE the expert matrices, which stay DTensors sharded
    over "model": each rank reads only its own experts
    (:func:`repro_torch.models.moe.moe_apply_shard_map`)."""
    if mesh is None:
        return p
    tp_mix, tp_mlp = tp
    ep = spec.mlp == MOE and cfg.moe.use_shard_map and mode != "decode" \
        and MOEm.expert_parallel(cfg, s, batch_axes, mesh)
    if tp_mix is None and tp_mlp is None and not ep:
        return _gathered(p, batch_axes, mesh)
    split = {k: v for k, v in p.items()
             if not (k == "mixer" and tp_mix) and not (k == "mlp" and tp_mlp)}
    if ep:
        split["mlp"] = {k: v for k, v in p["mlp"].items()
                        if k not in MOEm.EXPERT_LEAVES}
    out = _gathered(split, batch_axes, mesh)
    if ep:
        out["mlp"].update({k: p["mlp"][k] for k in MOEm.EXPERT_LEAVES})
    if tp_mix is not None:
        mix = p["mixer"]
        out["mixer"] = {k: _local(v, batch_axes, ("model",) if k in
                                  MODEL_PARTIAL_LEAVES else ())
                        for k, v in mix.items()}
    if tp_mlp is not None:
        out["mlp"] = _local(p["mlp"], batch_axes)
    return out


def resolve_device(device: Device = None) -> torch.device:
    """``None`` is the card; raises without one, naming the CPU spelling
    (the engine's rule)."""
    return _resolve_device(get_backend("torch"), device)


def params_device(params: Params) -> torch.device:
    """The device of a parameter tree (every tree has a final norm)."""
    return params["final_norm"]["scale"].device


# ------------------------------------------------------------------ init --

class Init:
    """The reference's initializers drawn from one ``torch.Generator`` on
    the target device: matrices N(0, 1) * d_in^-0.5 in ``dtype``, zero
    biases, unit norm scales (fp32).  On the meta device nothing is
    drawn (shapes and dtypes only)."""

    def __init__(self, seed: Union[int, torch.Generator], device: Device,
                 dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "meta":
            self.gen = None
        elif isinstance(seed, torch.Generator):
            self.gen = seed
        else:
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def normal(self, shape, scale: float) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (w * scale).to(self.dtype)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """U(lo, hi) in fp32, whatever ``dtype`` is (leaves the reference
        keeps in fp32)."""
        if self.gen is None:
            return torch.empty(shape, dtype=torch.float32,
                               device=self.device)
        u = torch.rand(shape, generator=self.gen, dtype=torch.float32,
                       device=self.device)
        return u * (hi - lo) + lo

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def dense(self, d_in: int, d_out: int, *, bias: bool = False):
        p = {"w": self.normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = self.zeros((d_out,))
        return p

    def norm(self, dim: int):
        return {"scale": torch.ones((dim,), dtype=torch.float32,
                                    device=self.device)}

    def swiglu(self, d_model: int, d_ff: int):
        return {"wi": self.dense(d_model, d_ff),
                "wg": self.dense(d_model, d_ff),
                "wo": self.dense(d_ff, d_model)}


def block_init(init: Init, cfg: ModelConfig, spec: BlockSpec) -> Params:
    mixer_init = ATT.cross_attn_init if spec.mixer == CROSS \
        else _MIXERS[spec.mixer][0]
    p: Params = {"ln1": init.norm(cfg.d_model),
                 "mixer": mixer_init(init, cfg, spec)}
    if spec.mlp != NONE:
        p["ln2"] = init.norm(cfg.d_model)
        if spec.mlp == SWIGLU:
            p["mlp"] = init.swiglu(cfg.d_model, cfg.d_ff)
        elif spec.mlp == MOE:
            p["mlp"] = MOEm.moe_init(init, cfg)
        else:
            p["mlp"] = {"wi": init.dense(cfg.d_model, cfg.d_ff, bias=True),
                        "wo": init.dense(cfg.d_ff, cfg.d_model, bias=True)}
    if spec.mixer == CROSS:
        # the MLP's own tanh gate, an fp32 scalar (zero at init)
        p["gate_mlp"] = torch.zeros((), dtype=torch.float32,
                                    device=init.device)
    return p


def init_params(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
                device: Device = None, dtype=torch.float32) -> Params:
    """The reference's parameter tree and distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card).  The numbers are not ``jax.random``'s; carry the reference's
    own parameters across with :func:`repro_torch.models.weights.from_reference`.
    ``dtype`` is the matrices', biases' and embedding's (bf16 for
    serving); norm scales and the leaves the reference uses in fp32 (the
    RG-LRU's ``lam``, the SSD's ``a_log`` and ``dt_bias``, the cross
    attention's ``gate`` and ``gate_mlp``) stay fp32.  An audio model
    has ``frontend`` (``feat_dim`` -> d_model, with bias) in place of
    ``embed``; a vision model adds ``vis_adapter`` (no bias)."""
    check_ported(cfg)
    init = Init(seed, resolve_device(device), dtype)
    d = cfg.d_model
    p: Params = {}
    if cfg.audio is not None:
        p["frontend"] = init.dense(cfg.audio.feat_dim, d, bias=True)
    else:
        p["embed"] = {"table": init.normal((cfg.padded_vocab, d),
                                           d ** -0.5)}
    if cfg.vision is not None:
        p["vis_adapter"] = init.dense(cfg.vision.embed_dim, d)
    p["prefix"] = [block_init(init, cfg, s) for s in cfg.prefix]
    p["suffix"] = [block_init(init, cfg, s) for s in cfg.suffix]
    p["pattern"] = [[block_init(init, cfg, s) for _ in range(cfg.repeats)]
                    for s in cfg.pattern]
    p["final_norm"] = init.norm(d)
    p["lm_head"] = init.dense(d, cfg.padded_vocab)
    return p


def param_count(params: Params) -> int:
    """Number of parameters in a tree (any nesting of dicts and lists)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(v) for v in items)


# --------------------------------------------------------------- caches --

def block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     ctx_len: int, dtype=torch.bfloat16,
                     device: Device = None, tp=None) -> Params:
    if spec.mixer == MLA:
        return MLAm.mla_cache_init(cfg, batch, ctx_len, dtype, device)
    if spec.mixer == RGLRU:
        return RGm.rglru_cache_init(cfg, batch, dtype, device)
    if spec.mixer == SSD:
        return SSDm.ssd_cache_init(cfg, batch, dtype, device)
    if spec.mixer == CROSS:
        return ATT.cross_cache_init(cfg, batch, dtype, device)
    heads = None if tp is None else cfg.num_kv_heads // tp.size
    return ATT.attn_cache_init(cfg, spec, batch, ctx_len, dtype, device,
                               heads)


def init_cache(cfg: ModelConfig, batch: int, ctx_len: int,
               dtype=torch.bfloat16, device: Device = None,
               tp: Optional[list] = None) -> Params:
    """An empty cache for ``batch`` sequences of up to ``ctx_len``
    positions, on ``device`` (``None``: the card).  ``tp``: each block's
    mixer's tensor parallelism in block order (:func:`cache_tensor_parallel`):
    a tensor-parallel self-attention block's ``k``/``v`` hold the rank's
    KV/m heads, as ``CACHE_RULES`` places them over "model"; every other
    leaf is whole (its mixer computes gathered over "model")."""
    check_ported(cfg)
    dev = resolve_device(device)
    specs = cfg.all_blocks()
    tps = [None] * len(specs) if tp is None else tp
    return _cache_layout(cfg, [
        block_cache_init(cfg, s, batch, ctx_len, dtype, dev, t)
        for s, t in zip(specs, tps, strict=True)])


def _cache_layout(cfg: ModelConfig, flat: list) -> Params:
    """:func:`blocks_layout` in a cache's key order."""
    tree = blocks_layout(cfg, flat)
    return {k: tree[k] for k in ("prefix", "suffix", "pattern")}


def cache_shardings(cache, cfg: ModelConfig, mesh,
                    attn_tp: Optional[list] = None) -> Params:
    """Each leaf's placement on ``mesh`` of the cache a rank of the
    sharded serving steps holds (``cache``: the whole batch's, e.g.
    ``launch.steps.cache_shapes``): ``CACHE_RULES``' (the batch axes'
    rows), with "model" kept only in the blocks whose self-attention
    computes tensor-parallel (``attn_tp``: a flag a block in block order,
    ``launch.dryrun.tensor_parallel_blocks``; their ``k``/``v`` heads,
    :func:`init_cache` with :func:`cache_tensor_parallel`)."""
    blocks = blocks_in_order(cfg, cache)
    flags = [False] * len(blocks) if attn_tp is None else attn_tp
    return _cache_layout(cfg, [R.cache_shardings(c, mesh, model=t)
                               for c, t in zip(blocks, flags, strict=True)])


# ---------------------------------------------------------------- blocks --

def blocks_in_order(cfg: ModelConfig, tree: Params) -> list:
    """The blocks of a parameter or cache tree in execution order (that of
    ``cfg.all_blocks()``): the prefix, the pattern repeat by repeat, the
    suffix."""
    return (list(tree["prefix"])
            + [tree["pattern"][i][r] for r in range(cfg.repeats)
               for i in range(len(cfg.pattern))]
            + list(tree["suffix"]))


def blocks_layout(cfg: ModelConfig, flat: list) -> Params:
    """The inverse of :func:`blocks_in_order`."""
    n0, n1 = len(cfg.prefix), len(cfg.pattern)
    mid = flat[n0:n0 + n1 * cfg.repeats]
    return {"prefix": flat[:n0],
            "pattern": [mid[i::n1] for i in range(n1)],
            "suffix": flat[n0 + n1 * cfg.repeats:]}


def _rope_dim(cfg: ModelConfig, spec: BlockSpec) -> int:
    """The dims a block's RoPE rotates: MLA's rope head dim, else the
    head dim."""
    return cfg.mla.rope_head_dim if spec.mixer == MLA else cfg.head_dim


def cross_tanh_gates(cfg: ModelConfig, blocks: list) -> list:
    """Each block's gates' bf16 tanh, in block order: (the mixer's, the
    MLP's) for a cross block, None for the others; every gate of the
    model in one call (:func:`attention.tanh_gates`)."""
    specs = cfg.all_blocks()
    cross = [p for p, spec in zip(blocks, specs) if spec.mixer == CROSS]
    if not cross:
        return [None] * len(specs)
    tanhs = iter(ATT.tanh_gates([g for p in cross for g in (
        p["mixer"]["gate"], p["gate_mlp"])]).unbind())
    return [(next(tanhs), next(tanhs)) if spec.mixer == CROSS else None
            for spec in specs]


class _ExactResidual(torch.autograd.Function):
    """An exact residual add as XLA fuses the reference's: the sum in
    fp32, returned rounded to x's dtype (the stream) and unrounded (what
    the next norm reads); its backward the reference's, where the norm's
    input is the rounded sum: the two cotangents, each in x's dtype,
    added and rounded to it, for both operands."""

    @staticmethod
    def forward(ctx, x, y):
        s = x.float() + y.float()
        ctx.dtypes = (x.dtype, y.dtype)
        return s.to(x.dtype), s

    @staticmethod
    def backward(ctx, g_x, g_s):
        dt, dty = ctx.dtypes
        g = g_x if g_s is None else (g_s.to(dt).float() + g_x.float()).to(dt)
        return g, g.to(dty)


def block_apply(p: Params, cfg: ModelConfig, spec: BlockSpec, x, ctx,
                cache: Optional[Params], mode: str, batch_axes=None,
                mesh=None, *, carry=None, tanh_gates=None, tp=(None, None)):
    """mode: 'full' | 'prefill' | 'decode'. Returns (x, new_cache, aux,
    sum32); aux is the MoE MLP's load-balancing loss, None for the other
    MLPs; sum32 the block's last residual sum, unrounded fp32, with exact
    adds (None under an approximate adder).

    ``carry``: the previous block's sum32, which the first norm reads in
    place of x (:func:`forward` hands it on inside a pattern repeat).
    ``tanh_gates``: a cross block's two gates' bf16 tanh
    (:func:`cross_tanh_gates`).  On a mesh the MoE MLP takes
    ``batch_axes`` and ``mesh`` (its load-balancing loss over the whole
    batch; the expert-parallel dispatch); ``tp``: the mixer's and the
    MLP's tensor parallelism (:func:`block_tensor_parallel`), ``p``
    holding their "model" shards."""
    h = L.rms_norm(p["ln1"], x if carry is None else carry,
                   cfg.norm_eps).to(x.dtype)
    new_cache = cache
    if spec.mixer == CROSS:
        t_mix, t_mlp = tanh_gates
        if mode == "decode":
            kv = (cache["k"].to(h.dtype), cache["v"].to(h.dtype))
        else:
            kv = ATT.cross_kv(p["mixer"], cfg, ctx["vis"])
            if mode == "prefill":
                new_cache = {"k": kv[0].to(cache["k"].dtype),
                             "v": kv[1].to(cache["v"].dtype)}
        # an approximate add reads the gated product unrounded (XLA's
        # fusion), an exact one rounded
        mix = ATT.cross_attn_apply(p["mixer"], cfg, spec, h, kv, t_mix,
                                   keep_fp32=cfg.approx.enabled)
    elif spec.mixer in _RECURRENT:
        _, apply, prefill, decode = _MIXERS[spec.mixer]
        if mode == "full":
            mix, _ = apply(p["mixer"], cfg, spec, h)
        elif mode == "prefill":
            mix, new_cache = prefill(p["mixer"], cfg, spec, h, cache)
        else:
            mix, new_cache = decode(p["mixer"], cfg, spec, h, cache)
    else:
        _, apply, prefill, decode = _MIXERS[spec.mixer]
        rope = ctx.get("rope", {}).get((spec.rope_base,
                                        _rope_dim(cfg, spec)))
        tp_mix = {} if tp[0] is None else {"tp": tp[0]}
        if mode == "full":
            mix = apply(p["mixer"], cfg, spec, h, ctx["positions"], rope,
                        **tp_mix)
        elif mode == "prefill":
            mix, new_cache = prefill(p["mixer"], cfg, spec, h,
                                     ctx["positions"], cache, rope, **tp_mix)
        else:
            mix, new_cache = decode(p["mixer"], cfg, spec, h, ctx["pos"],
                                    cache, ctx["positions"], rope, **tp_mix)

    if cfg.approx.enabled:
        x = norm_in = cfg.approx.residual_add(
            x, mix if spec.mixer == CROSS else mix.to(x.dtype))
    else:
        # XLA adds in fp32 and hands the unrounded sum to the norm that
        # reads it; the stream (the second add's operand) is rounded
        x, norm_in = _ExactResidual.apply(x, mix.to(x.dtype))
    aux = None
    if spec.mlp != NONE:
        h2 = L.rms_norm(p["ln2"], norm_in, cfg.norm_eps).to(x.dtype)
        if spec.mlp == MOE:
            if cfg.moe.use_shard_map and mode != "decode":
                out, aux = MOEm.moe_apply_shard_map(
                    p["mlp"], cfg, h2, batch_axes=batch_axes, mesh=mesh)
            else:
                out, aux = MOEm.moe_apply(p["mlp"], cfg, h2,
                                          batch_axes=batch_axes, mesh=mesh)
        elif spec.mlp == SWIGLU:
            out = L.swiglu(p["mlp"], h2, tp[1])
        else:
            # an approximate add reads the output bias sum unrounded
            out = L.gelu_mlp(p["mlp"], h2, sum32=cfg.approx.enabled,
                             tp=tp[1])
        if spec.mixer == CROSS:
            out = ATT.gate(t_mlp, out, keep_fp32=cfg.approx.enabled)
        if cfg.approx.enabled:
            x = cfg.approx.residual_add(x, out).to(x.dtype)
        else:
            x, norm_in = _ExactResidual.apply(x, out)
    # under a tensor-parallel MLP XLA rounds the block's last sum (its
    # all-reduced output added to the stream) before the next norm reads it
    carried = not cfg.approx.enabled and (spec.mlp == NONE or tp[1] is None)
    return x, new_cache, aux, norm_in if carried else None


# --------------------------------------------------------------- forward --

def _reads_carry(cfg: ModelConfig, i: int) -> bool:
    """Whether block ``i``'s first norm (the final norm for i = the
    number of blocks) reads the previous block's exact residual sum
    unrounded, as XLA fuses it: everywhere but across the boundaries of
    the pattern's layer scan, whose carry is the rounded stream (the
    first block of each repeat, and the first block after the scan)."""
    n0, n1 = len(cfg.prefix), len(cfg.pattern)
    scan_step = n1 and n0 <= i <= n0 + n1 * cfg.repeats and (i - n0) % n1 == 0
    return i > 0 and not scan_step


def embed_input(params, cfg: ModelConfig, batch, need_vision: bool = True,
                tp=None):
    """batch: {"tokens": (B, S) ints} or {"frames": (B, S, feat_dim)}
    (+ "vision": (B, Sv, embed_dim)) -> (bf16 activations, ctx).  Token
    ids outside the vocabulary are clamped into it (a negative id counts
    from the end first), as the reference's gather does; frames go
    through ``frontend`` and the vision embeddings through
    ``vis_adapter`` (into ``ctx["vis"]``), both cast to bf16 first.  A
    decode step (``need_vision=False``) takes no vision input.

    ``tp``: the table is this rank's vocabulary shard (its rows of the
    padded vocabulary, in rank order); an id is clamped into the whole
    vocabulary first, ids outside the shard give 0, and the rows are
    summed over "model" (one rank holds each)."""
    check_ported(cfg)

    def input_on(name, w):
        return torch.as_tensor(batch[name], device=w.device)

    if cfg.audio is not None:
        frames = input_on("frames", params["frontend"]["w"])
        x = L.dense(params["frontend"], frames.to(torch.bfloat16))
    else:
        table = params["embed"]["table"]
        rows = table.shape[0]
        n = rows * (1 if tp is None else tp.size)
        tokens = input_on("tokens", table)
        ids = torch.where(tokens < 0, tokens + n, tokens).clamp(0, n - 1)
        if tp is None:
            x = table[ids].to(torch.bfloat16)
        else:
            ids = ids - tp.rank * rows
            inside = ((ids >= 0) & (ids < rows))[..., None]
            x = table[ids.clamp(0, rows - 1)].to(torch.bfloat16)
            x = tp.sum(torch.where(inside, x, torch.zeros(
                (), dtype=x.dtype, device=x.device)))
    ctx = {}
    if cfg.vision is not None and need_vision:
        vis = input_on("vision", params["vis_adapter"]["w"])
        ctx["vis"] = L.dense(params["vis_adapter"], vis.to(torch.bfloat16))
    return x, ctx


def forward(params, cfg: ModelConfig, batch, *, mode: str = "full",
            cache: Optional[Params] = None, pos=None, batch_axes=None,
            mesh=None, return_prelogits: bool = False):
    """Returns (logits, new_cache, aux_sum).

    mode "full" scores every position; "prefill" fills ``cache`` and
    "decode" (one token at absolute position ``pos``) updates it, both
    returning the last position's logits only (a non-causal model's
    prefill returns every position's).  ``aux_sum`` is the fp32
    sum of the MoE layers' load-balancing losses in block order (0 without
    MoE layers).  ``return_prelogits``: the final norm's output in place
    of the logits (what :func:`loss_fn` hands to the head).

    On a mesh the batch is this rank's rows of a batch split over
    ``batch_axes`` (the module docstring): the reference's sharding
    constraints on the activations (``_shard_act``, with ``seq_shard``
    their sequence dim over "model") change no value and have no
    counterpart."""
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(f"bad forward mode {mode!r}")
    if mode != "full" and cache is None:
        raise ValueError(f"mode {mode!r} needs a cache (init_cache)")
    tp = R.tensor_parallel(mesh)
    vocab_tp = tp if tp is not None and "embed" in params \
        and _sharded(params["embed"]["table"]) else None
    inputs = {k: params[k] for k in ("embed", "frontend", "vis_adapter")
              if k in params}
    if vocab_tp is not None:
        inputs = dict(_gathered({k: v for k, v in inputs.items()
                                 if k != "embed"}, batch_axes, mesh),
                      embed=_local(inputs["embed"], batch_axes))
    else:
        inputs = _gathered(inputs, batch_axes, mesh)
    x, ctx = embed_input(inputs, cfg, batch, need_vision=mode != "decode",
                         tp=vocab_tp)
    b, s = x.shape[:2]
    if mode == "decode":
        ctx["pos"] = int(pos)
        span = range(ctx["pos"], ctx["pos"] + 1)
    else:
        span = range(s)
    ctx["positions"] = torch.arange(span.start, span.stop, dtype=torch.int32,
                                    device=x.device)
    # one pair of RoPE tables per (base, rotated dims), shared by the
    # blocks that rotate (the recurrent and cross mixers do not)
    specs = cfg.all_blocks()
    ctx["rope"] = {key: L.rope_tables(span, key[1], key[0], x.device)
                   for key in {(spec.rope_base, _rope_dim(cfg, spec))
                               for spec in specs
                               if spec.mixer not in _RECURRENT + (CROSS,)}}

    caches = blocks_in_order(cfg, cache) if cache is not None \
        else [None] * len(specs)
    blocks = blocks_in_order(cfg, params)
    gates = cross_tanh_gates(cfg, [
        _gathered({"mixer": {"gate": p["mixer"]["gate"]},
                   "gate_mlp": p["gate_mlp"]}, batch_axes, mesh)
        if spec.mixer == CROSS else None
        for p, spec in zip(blocks, specs)])
    new = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sum32 = None
    for i, (p, spec, c, g) in enumerate(zip(blocks, specs, caches, gates,
                                            strict=True)):
        carry = sum32 if _reads_carry(cfg, i) else None
        tps = block_tensor_parallel(p, cfg, spec, mesh)
        x, nc, a, sum32 = block_apply(
            _block_gathered(p, cfg, spec, x.shape[1], mode, batch_axes,
                            mesh, tps), cfg, spec, x, ctx, c, mode,
            batch_axes, mesh, carry=carry, tanh_gates=g, tp=tps)
        new.append(nc)
        if a is not None:
            aux = aux + a

    last = x if sum32 is None or not _reads_carry(cfg, len(specs)) else sum32
    x = L.rms_norm(_gathered(params["final_norm"], batch_axes, mesh), last,
                   cfg.norm_eps).to(x.dtype)
    if mode in ("prefill", "decode") and cfg.causal:
        x = x[:, -1:]  # only the last position's logits are needed
    new_cache = blocks_layout(cfg, new) if cache is not None else None
    if return_prelogits:
        return x, new_cache, aux
    return _serving_head(params["lm_head"], x, batch_axes, mesh), \
        new_cache, aux


def head_rows_split(d_model: int, row_shards: int, m: int) -> bool:
    """Whether the reference's partitioned prefill and decode steps
    compute a head the rules leave whole over "model" row-parallel there
    (each "model" rank its D/m rows of the head and of x, the bf16
    partials summed over "model" in fp32 and rounded once): where the
    rules shard its d_model rows ``row_shards`` ways (FSDP over "data")
    and each "model" rank's rows lie in one such shard (m a multiple of
    ``row_shards``), as GSPMD moves the rows over rather than gather
    them.  Read from the reference's compiled prefill and decode steps
    (``tests/torch_head_reference.py``): qwen3-4b-smoke (509 words) on
    (2, 2), (2, 16), (4, 8), (4, 16), (8, 8), (16, 16) and (2, 16, 16)
    row-parallel, the partials rounded to bf16 before the fp32 sum, and
    on (4, 2), (8, 4) and (16, 8) (``row_shards`` > m) the rows gathered
    and the product whole; mamba2-1.3b (50280 words) and hubert-xlarge
    (504) at full width, one repeat, on (16, 16) and (2, 16, 16)
    row-parallel as the predicate says (granite-moe-1b-a400m's vocabulary
    pads to 51200, which "model" splits: columns).  Not read: a d_model
    that m does not divide."""
    return row_shards > 1 and m % row_shards == 0 and d_model % m == 0


def _serving_head(head, x, batch_axes, mesh):
    """The head's logits of the final norm's output ``x`` (every rank's
    rows whole, as the unsharded path returns them; a padded
    vocabulary's slots kept).  On a mesh with model > 1: vocabulary-parallel
    where the rules shard the vocabulary over "model" (the rank's columns,
    gathered over "model" in vocabulary order: no value changes);
    row-parallel over d_model where :func:`head_rows_split`; else whole."""
    tp = R.tensor_parallel(mesh)
    if tp is not None and _sharded(head["w"]):
        return tp.gather(L.dense_column(_local(head, batch_axes), x, tp))
    if tp is not None and head_rows_split(
            head["w"].shape[0], R.shards_of_dim(head["w"], 0), tp.size):
        w = _gathered(head, batch_axes, mesh)["w"]
        n = w.shape[0] // tp.size
        rows = slice(tp.rank * n, (tp.rank + 1) * n)
        return L.dense_row({"w": w[rows]}, x[..., rows], tp)
    return L.dense(_gathered(head, batch_axes, mesh), x)


# ------------------------------------------------------------------ loss --

def _exp_sum(x, amax):
    """(the sum over the last axis of ``exp(x - amax)``, amax squeezed):
    ``amax`` x's maximum over that axis (keepdim), a non-finite one
    taken as 0, as jax's ``logsumexp`` takes it; XLA:CPU's ``exp`` and
    order of sums on the CPU (:func:`layers.exp32`,
    :func:`layers.row_sum`), torch's on the card."""
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return L.row_sum(L.exp32(x - amax)), amax[..., 0]


def logsumexp32(x):
    """``jax.nn.logsumexp`` over the last axis of fp32 ``x``: on the CPU
    its max, shift and sum (:func:`_exp_sum`); on the card torch's
    one-kernel ``logsumexp``.  The max carries no gradient, as jax's
    does not."""
    if x.device.type != "cpu":
        return torch.logsumexp(x, dim=-1)
    total, amax = _exp_sum(x, x.amax(dim=-1, keepdim=True).detach())
    return torch.log(total) + amax


def softmax_cross_entropy(logits, labels, tp=None):
    """Per-position CE of fp32 logits (..., V) against integer labels:
    logsumexp minus the gold logit (a gather: the same value as the
    reference's iota compare and masked sum, which adds only zeros to
    it).

    ``tp``: ``logits`` are this rank's vocabulary shard (V/m columns, in
    rank order), as the reference's GSPMD-partitioned CE computes them:
    the local max's maximum over "model", then each rank's sum of
    exponentials and gold logit (0 outside its shard), summed over
    "model" in fp32 in one all-reduce."""
    logits = logits.to(torch.float32)
    if tp is None:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logsumexp32(logits) - gold
    n = logits.shape[-1]
    ids = labels.long() - tp.rank * n
    inside = (ids >= 0) & (ids < n)
    gold = torch.where(inside, torch.gather(
        logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0],
        torch.zeros((), dtype=logits.dtype, device=logits.device))
    total, amax = _exp_sum(logits, tp.max(logits.amax(dim=-1, keepdim=True)))
    total, gold = tp.sum(torch.stack([total, gold]))
    return torch.log(total) + amax - gold


def _head_loss(cfg: ModelConfig, head, x, labels, tp=None):
    """The head and the mean CE; ``tp``: ``head`` is this rank's
    vocabulary shard (column-parallel), the padded slots masked by their
    global index."""
    logits = L.dense_column(head, x, tp)
    if cfg.padded_vocab != cfg.vocab_size:
        # padded vocab slots masked to -inf (exact CE over the true vocab)
        n = logits.shape[-1]
        lo = 0 if tp is None else tp.rank * n
        viota = torch.arange(lo, lo + n, device=logits.device)
        logits = torch.where(viota < cfg.vocab_size, logits,
                             torch.full((), L.NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    return softmax_cross_entropy(logits, labels, tp).mean()


def loss_fn(params, cfg: ModelConfig, batch, batch_axes=None, mesh=None):
    """The reference's training loss: the full forward to the final norm,
    then the head and the CE under activation checkpointing (the (B, S,
    V) logits and the softmax internals are recomputed in the backward,
    as under the reference's ``jax.checkpoint``; so are the CE's
    collectives over "model"), plus 0.01 times the MoE load-balancing
    loss.  Returns (loss, {"ce", "aux"}), fp32 scalars.  On a mesh with
    model > 1 whose rules shard the head's vocabulary, the head and CE
    are vocabulary-parallel (:func:`softmax_cross_entropy`)."""
    x, _, aux = forward(params, cfg, batch, mode="full",
                        batch_axes=batch_axes, mesh=mesh,
                        return_prelogits=True)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    tp = R.tensor_parallel(mesh)
    if tp is not None and _sharded(params["lm_head"]["w"]):
        head = _local(params["lm_head"], batch_axes)
    else:
        tp = None
        head = _gathered(params["lm_head"], batch_axes, mesh)
    ce = checkpoint(_head_loss, cfg, head, x, labels, tp,
                    use_reentrant=False)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
