"""AdamW with global-norm clipping, fp32 states (the port of
``repro.optim.adamw``).

The states ``m`` and ``v`` are fp32 trees of the parameters' structure
(the port's: dicts and lists, the pattern unstacked); weight decay
applies to the leaves with ``ndim >= 2`` in the reference's layout,
where a pattern position's blocks are stacked along one more dim: so
every leaf under ``pattern`` of at least one dim decays (its blocks'
norm scales and biases too), and outside it only matrices and up.
:func:`update` writes the new
parameters and states into the tensors it is given and returns them: the
reference's train loop donates its state to the step, and at full width
a second copy of the parameters, ``m`` and ``v`` does not fit the card.

On the CPU the arithmetic is what XLA:CPU compiles for the reference's
jitted update (read from its optimized HLO and machine code, jax 0.9.0,
x86-64): divisions by constants taken as products with their fp32
reciprocals, ``mh / (sqrt(vh) + eps)`` taken as ``m / (b1c * (sqrt(v /
b2c) + eps))``, the C library's ``cosf`` and ``powf``, and the
multiply-adds LLVM contracts done as one rounding (``layers.fma32``).
The global norm's sums of squares follow XLA:CPU's reductions
(:func:`xla_sum_of_squares`), so given the same gradients and states the
update equals the reference's bit for bit, clipped or not.  On the card
the same expressions run as torch kernels (``fma32`` is ``addcmul``
there) and each leaf's sum of squares is one ``torch.sum``.

On a mesh (``launch.steps``' sharded step) the parameters, gradients,
``m`` and ``v`` are DTensors with one placement each: the update runs
elementwise on each rank's local shards, and the global norm sums each
leaf's local squares, then all-reduces them over the mesh dims the leaf
is sharded on, so the clip scale is the same on every rank (its order of
summation differs from the unsharded norm's by a few ulps).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.sharding import rules as R
from repro_torch.tree import leaves, leaves_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _libm_powf():
    fn = L._libm().powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return fn


def _schedule_host(cfg: AdamWConfig, step: int) -> float:
    """The reference's schedule at one step, in fp32 as XLA:CPU computes
    it (a host scalar)."""
    f = np.float32
    s = f(step)
    if s < f(cfg.warmup_steps):
        val = s * f(_f32(1.0 / max(1.0, cfg.warmup_steps)))
    else:
        prog = (s + f(-cfg.warmup_steps)) * f(_f32(
            1.0 / max(1.0, cfg.total_steps - cfg.warmup_steps)))
        prog = min(f(1.0), max(f(0.0), prog))
        c = f(L._libm().cosf(float(prog * f(math.pi))))
        val = L._fma32_host(c + f(1.0),
                            (1 - cfg.min_lr_ratio) * 0.5, cfg.min_lr_ratio)
    return float(val * f(cfg.lr))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_ratio *
    lr`` at ``total_steps``: an fp32 scalar tensor (on ``step``'s device
    when it is a tensor)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    return torch.tensor(_schedule_host(cfg, int(step)), dtype=torch.float32,
                        device=dev)


def init(params) -> Dict[str, Any]:
    """Zero fp32 ``m`` and ``v`` beside ``params``, and an int32 count."""
    zeros = functools.partial(tree_map, lambda p: torch.zeros_like(
        p, dtype=torch.float32))
    dev = R.local(leaves(params)[0]).device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _sum_sharded(flat, sqs):
    """Each DTensor leaf's local sum of squares summed over the mesh dims
    it is sharded on: one all-reduce of the stacked sums a mesh dim."""
    from torch.distributed.tensor import Shard
    sharded = [g for g in flat if R.is_dtensor(g)]
    if not sharded:
        return sqs
    mesh = sharded[0].device_mesh
    stacked = torch.stack(sqs)
    for i, name in enumerate(mesh.mesh_dim_names):
        mask = torch.tensor([R.is_dtensor(g) and isinstance(
            g.placements[i], Shard) for g in flat], device=stacked.device)
        if mesh.size(i) > 1 and bool(mask.any()):
            summed = R.sum_over(stacked.clone(), mesh, (name,))
            stacked = torch.where(mask, summed, stacked)
    return list(stacked.unbind())


def _fma_square_chain(x: np.ndarray) -> np.float32:
    """sum of x[i]^2 over x (fp32, row-major) from zero, each square and
    add one FMA rounding: the fp64 sum rounded to fp32, and where that
    double rounding can miss (an fp64 sum halfway between two fp32
    values, or a result below the smallest normal) the exact
    :func:`layers._fma32`."""
    acc = np.float32(0)
    for v in x.astype(np.float32):
        s = np.float64(v) * np.float64(v) + np.float64(acc)
        r = np.float32(s)
        if (int(s.view(np.int64)) & 0x1FFFFFFF) == 0x10000000 or (
                abs(r) < L.MIN_NORMAL and s != 0):
            r = L._fma32_host(v, v, acc)
        acc = r
    return acc


def xla_sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """The fp32 ``jnp.sum(g.astype(f32) ** 2)`` of one leaf as XLA:CPU
    computes it inside the reference's jitted update (jax 0.9.0, x86-64,
    read from its optimized HLO and machine code; ``python
    tools/xla_reduce_order.py`` holds this against XLA).  A leaf with
    every dim at most XLA_REDUCE_WINDOW long is one fusion: each square an
    FMA into one running sum from zero, row-major.  A longer leaf is
    squared and rounded first, then reduced in windows of
    XLA_REDUCE_WINDOW along each longer dim (the shorter dims whole), each
    window one sequential sum in row-major order, again until no dim is
    longer, and the windows' sums last in row-major order.  (Not followed:
    LLVM vectorizes a window pass, the last reduction or a short leaf's
    chain over its next-to-last dim when the last is 2-8 long and the
    next 2, 4, 8 or 16-32; ROADMAP Queue C 20.)"""
    x = g.detach().float().reshape(g.shape or (1,))
    if max(x.shape) <= L.XLA_REDUCE_WINDOW:
        return torch.tensor(_fma_square_chain(x.reshape(-1).numpy()))
    x = (x * x)[..., None]
    while max(x.shape[:-1]) > L.XLA_REDUCE_WINDOW:
        x = L._sequential_sum(L._windows(x).transpose(-1, -2))
    return L._sequential_sum(x.reshape(-1))


def _reference_leaves(tree):
    """The leaves in the reference's order and shapes: a pattern
    position's blocks stacked along a leading dim, as ``repro`` holds
    them (the port keeps them unstacked, ``params["pattern"][i][r]``)."""
    if not (isinstance(tree, dict) and isinstance(tree.get("pattern"), list)):
        return leaves(tree)
    out = []
    for k in sorted(tree):
        if k != "pattern":
            out += leaves(tree[k])
            continue
        for reps in tree[k]:
            for path, _ in leaves_with_paths(reps[0]):
                out.append(torch.stack([_at(r, path) for r in reps]))
    return out


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's fp32 sum
    of squares.  A tree on the CPU, unsharded, in the reference's order:
    its leaves (:func:`_reference_leaves`), each sum XLA:CPU's
    (:func:`xla_sum_of_squares`), added left to right as Python's
    ``sum``.  On the card, or sharded, one ``torch.sum`` a leaf, a
    sharded leaf's summed over its shards (:func:`_sum_sharded`)."""
    flat = leaves(tree)
    if not any(R.is_dtensor(g) for g in flat) \
            and all(g.device.type == "cpu" for g in flat):
        total = None
        for g in _reference_leaves(tree):
            sq = xla_sum_of_squares(g)
            total = sq if total is None else total + sq
        return L.sqrt32(total)
    return torch_global_norm(tree)


def torch_global_norm(tree) -> torch.Tensor:
    """:func:`global_norm` as the card and a sharded tree take it (one
    ``torch.sum`` a leaf, in the port's leaf order), on any device."""
    flat = leaves(tree)
    sqs = []
    for g in flat:
        g = R.local(g).float()
        sqs.append(torch.sum(g * g))
    total = None
    for sq in _sum_sharded(flat, sqs):
        total = sq if total is None else total + sq
    return L.sqrt32(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step: returns (params, opt_state, {"grad_norm", "lr"}),
    the parameters and ``m``/``v`` updated in place (see the module
    docstring), ``count`` a new scalar."""
    count = int(opt_state["count"]) + 1
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(
        gnorm, _f32(1e-9)), 1.0)
    lr = _schedule_host(cfg, count)
    f = np.float32
    b1c = float(f(1) - f(_libm_powf()(cfg.b1, float(count))))
    b2c = float(f(1) - f(_libm_powf()(cfg.b2, float(count))))

    def const(x):
        return torch.tensor(_f32(x), dtype=torch.float32, device=dev)

    b1, b2, b1r, b2r = (const(x) for x in
                        (cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2))
    wd, neg_lr = const(cfg.weight_decay), const(-lr)

    def upd(path, ndim, p, g, m, v):
        gs = g.float() * scale
        m.copy_(L.fma32(m, b1, gs * b1r))
        v.copy_(L.fma32(v, b2, (gs * b2r) * gs))
        step = m / (b1c * (L.sqrt32(v / b2c) + _f32(cfg.eps)))
        if ndim + (path[:1] == ("pattern",)) >= 2:
            step = L.fma32(p, wd, step)
        p.copy_(L.fma32(neg_lr, step, p))

    for (path, p), g, m, v in zip(
            leaves_with_paths(params), leaves(grads), leaves(opt_state["m"]),
            leaves(opt_state["v"]), strict=True):
        ndim = p.ndim    # the full leaf's, as the reference decays by it
        p, g, m, v = (R.local(t) for t in (p, g, m, v))
        upd(path, ndim, p, g, m, v)
    new_opt = {"m": opt_state["m"], "v": opt_state["v"],
               "count": torch.tensor(count, dtype=torch.int32, device=dev)}
    return params, new_opt, {"grad_norm": gnorm,
                             "lr": torch.tensor(lr, device=dev)}
