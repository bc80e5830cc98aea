"""Gradient compression for cross-pod reduction (the port of
``repro.optim.compression``).

- top-k sparsification WITH error feedback: the residual of the
  sparsifier is carried into the next step, so the compressed optimizer
  still converges;
- int8 stochastic quantization (per-tensor scale) emulating a quantized
  all-reduce: values are scaled to 127 steps, rounded with uniform noise
  in [-0.5, 0.5), clipped to int8 and dequantized.

Both are plain-torch transforms of a gradient tree, plugged into the
train step through ``grad_transform``.

The reference draws each leaf's int8 noise from a key folded from
Python's ``hash`` of the leaf's path, which changes from process to
process (string hashing is salted), so its values cannot be reproduced.
The port draws from a ``torch.Generator`` on the leaf's device, seeded
from (seed, the leaf's path) through SHA-256: the same noise in every
process.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Tuple

import torch

from repro_torch.tree import leaves_with_paths, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"           # none | topk_ef | int8
    topk_ratio: float = 0.01     # fraction of entries kept (topk_ef)


def init_error_feedback(params) -> Any:
    return tree_map(torch.zeros_like, params)


def topk_sparsify_with_ef(grads, ef, ratio: float) -> Tuple[Any, Any]:
    """Returns (compressed grads, new error feedback): each leaf plus its
    carried residual, its entries of magnitude at least the k-th largest
    (k = max(1, int(size * ratio))) kept, the rest carried."""

    def one(g, e):
        g = g + e
        flat = g.reshape(-1)
        k = max(1, int(flat.numel() * ratio))
        thresh = torch.topk(flat.abs(), k).values[-1]
        kept = (flat * (flat.abs() >= thresh).to(g.dtype)).reshape(g.shape)
        return kept, g - kept

    pairs = tree_map(one, grads, ef)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))


def leaf_seed(seed: int, path) -> int:
    """A 63-bit generator seed from (seed, a leaf's path), the same in
    every process."""
    key = f"{seed}:{'/'.join(map(str, path))}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def int8_quantize_dequantize(grads, seed: int = 0):
    """Emulated int8 all-reduce: stochastic-round each leaf to int8 on
    a per-tensor scale (max |g| / 127), then back."""

    def one(path, g):
        gen = torch.Generator(device=g.device)
        gen.manual_seed(leaf_seed(seed, path))
        scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
        noise = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                           device=g.device) - 0.5
        q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(
            torch.int8)
        return q.to(g.dtype) * scale

    return unflatten(grads, [one(p, g) for p, g in leaves_with_paths(grads)])


def make_grad_transform(cfg: CompressionConfig, ef_state=None):
    """Returns transform(grads) -> grads, or None for ``kind="none"``.
    For ``topk_ef`` the caller threads the error feedback through the
    train state with :func:`topk_sparsify_with_ef`."""
    if cfg.kind == "none":
        return None
    if cfg.kind == "int8":
        return lambda g: int8_quantize_dequantize(g)
    raise ValueError(f"use topk_sparsify_with_ef directly for {cfg.kind}")
