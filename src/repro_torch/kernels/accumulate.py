"""Weighted K-term approximate fold: kernel and plain version.

Replaces ``accumulate_pallas`` (``src/repro/kernels/accumulate.py``).
Each of the K stacked terms is scaled exactly by a static integer weight
mod 2^N, then the terms are folded LEFT TO RIGHT through the approximate
adder mod 2^N; the fold order is part of the result.

The CUDA kernel is ``csrc/accumulate.cu``.  It is bound by device
memory: K int32 reads and one write per element, against some 30
integer operations per term.  So it reads the (K, M) stack in place,
flattened, with no padding (the kernel masks its own ragged end), folds
each element's K terms in registers, and takes 16-byte loads when M is
a multiple of 4.  The weights (K <= 16) and the adder ride in a struct
passed by value.

:func:`accumulate` routes by where the tensor lives: a CPU tensor takes
:func:`accumulate_plain`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.adders import approx_add_mod
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, check_cuda, on_cpu,
                                            stream_ptr, to_int32, u32_lanes)


def norm_weights(weights, k: int):
    ws = tuple(int(w) for w in weights) if weights is not None else (1,) * k
    if len(ws) != k:
        raise ValueError(f"{len(ws)} weights for {k} stacked terms")
    return ws


def scale_mod(term: torch.Tensor, w: int, n_bits: int) -> torch.Tensor:
    """Exact ``term * w`` mod 2^N on int64 lanes holding a 32-bit pattern:
    the plain form of the reference's ``scale_mod_u32`` (a uint32
    multiply by ``w & 0xFFFFFFFF``, masked to N bits).  A weight of
    exactly 1 passes the term through unmasked, as there.  The weight is
    split into 16-bit limbs so that no int64 product overflows."""
    if w == 1:
        return term
    wm = w & 0xFFFFFFFF
    lo, hi = wm & 0xFFFF, wm >> 16
    return (term * lo + (((term * hi) & 0xFFFF) << 16)) & ((1 << n_bits) - 1)


def accumulate_plain(terms: torch.Tensor, spec: AdderSpec, weights=None,
                     fast: bool = False, add=None) -> torch.Tensor:
    """The plain version: int32 (K, ...) containers in, int32 (...) out,
    computed on int64 lanes on any device.  ``add(acc, term)`` is the
    lane-level approximate add mod 2^N (default: the registered adder;
    the lut strategy passes its table gather)."""
    if add is None:
        def add(x, y):
            return approx_add_mod(x, y, spec, fast=fast)
    ws = norm_weights(weights, terms.shape[0])
    acc = None
    for i, w in enumerate(ws):
        term = scale_mod(u32_lanes(terms[i]), w, spec.n_bits)
        acc = term if acc is None else add(acc, term)
    return to_int32(acc)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def accumulate(terms: torch.Tensor, spec: AdderSpec, *, weights=None,
               fast: bool = False) -> torch.Tensor:
    """Weighted approximate fold of the K int32 containers stacked on
    axis 0 of ``terms``; returns int32 of shape ``terms.shape[1:]``.
    CPU tensor: the plain version.  CUDA tensor: the kernel."""
    if terms.ndim < 1 or terms.shape[0] < 1:
        raise ValueError(f"stack the terms on axis 0: got shape "
                         f"{tuple(terms.shape)}")
    ws = norm_weights(weights, terms.shape[0])
    if on_cpu("accumulate", terms):
        return accumulate_plain(terms, spec, ws, fast)
    check_cuda("accumulate", terms)
    args = adder_args(spec, fast)
    k = len(ws)
    if k > _build.MAX_TERMS:
        raise ValueError(f"the accumulate kernel folds at most "
                         f"{_build.MAX_TERMS} "
                         f"terms; got {k}")
    out = torch.empty(terms.shape[1:], dtype=torch.int32,
                      device=terms.device)
    if out.numel() == 0:
        return out
    wts = (ctypes.c_uint * k)(*(w & 0xFFFFFFFF for w in ws))
    unit = sum(1 << j for j, w in enumerate(ws) if w == 1)
    fn = _build.bind("accumulate", "accumulate_launch", _ARGTYPES)
    with torch.cuda.device(terms.device):
        err = fn(terms.data_ptr(), out.data_ptr(), out.numel(), k,
                 ctypes.cast(wts, ctypes.c_void_p), unit, *args,
                 stream_ptr(terms.device))
    _build.check(err, "accumulate")
    accumulate.launches += 1
    return out


#: Kernel launches made by :func:`accumulate` (reset by setting to 0).
accumulate.launches = 0
