"""Carry the reference's parameters and caches across to the port.

The reference keeps a pattern position's blocks stacked, every leaf with
a leading ``repeats`` axis; the port keeps a list of ``repeats`` blocks
(``transformer``'s layout).  These functions take the reference's trees
as numpy arrays (``jax.tree.map(np.asarray, tree)``; a bf16 leaf is
numpy's ``bfloat16`` extension dtype, read through its bits) and return
the port's.

    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            device="cpu")
    state = state_from_reference(jax.tree.map(np.asarray, ref_state), cfg,
                                 device="cpu")
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy array (bf16 included, by its bits) as a tensor on
    ``device``, cast to ``dtype`` when one is given."""
    a = np.array(x)   # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path) for v in tree]
    return fn(tree, path)


def _unstack(tree, repeats: int):
    """A stacked block tree -> a list of ``repeats`` block trees."""
    return [_map(tree, lambda a, _p, r=r: np.asarray(a)[r])
            for r in range(repeats)]


#: Leaves the reference uses in fp32 (norm scales; the RG-LRU's ``lam``;
#: the SSD's ``a_log`` and ``dt_bias``; the cross attention's tanh gates
#: ``gate`` and ``gate_mlp``): kept fp32 in a tree of any dtype.  The
#: other leaves are cast to the activations' dtype at use, so a bf16 copy
#: computes the same.
FP32_LEAVES = ("scale", "lam", "a_log", "dt_bias", "gate", "gate_mlp")


def from_reference(tree: Any, cfg: ModelConfig, *, device,
                   dtype=torch.float32):
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device``: ``pattern`` unstacked into one block per repeat, the
    matrices, biases and embedding in ``dtype``, the FP32_LEAVES fp32."""

    def leaf(a, path):
        keep_fp32 = path and path[-1] in FP32_LEAVES
        return to_tensor(a, device, torch.float32 if keep_fp32 else dtype)

    out = {k: v for k, v in tree.items() if k != "pattern"}
    out["pattern"] = [_unstack(p, cfg.repeats) for p in tree["pattern"]]
    return _map(out, leaf)


def cache_from_reference(tree: Any, cfg: ModelConfig, *, device):
    """The reference's cache (numpy leaves) as the port's, on ``device``,
    dtypes kept (bf16 k/v, cross k/v and conv states, int32 pos, fp32
    recurrent states ``h``/``state``)."""
    out = {"prefix": tree["prefix"], "suffix": tree["suffix"],
           "pattern": [_unstack(c, cfg.repeats) for c in tree["pattern"]]}
    return _map(out, lambda a, _p: to_tensor(a, device))


def state_from_reference(tree: Any, cfg: ModelConfig, *, device):
    """The reference's train state (``params``, ``opt`` with ``m``, ``v``
    and ``count``, and ``step``; numpy leaves) as the port's, on
    ``device``: every float tree fp32 with the pattern unstacked, the
    counters int32 scalars."""

    def count(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)

    opt = tree["opt"]
    return {"params": from_reference(tree["params"], cfg, device=device),
            "opt": {"m": from_reference(opt["m"], cfg, device=device),
                    "v": from_reference(opt["v"], cfg, device=device),
                    "count": count(opt["count"])},
            "step": count(tree["step"])}
