"""Weighted K-term approximate fold: kernel and plain versions.

Replaces ``accumulate_pallas`` (``src/repro/kernels/accumulate.py``).
Each of the K terms is scaled exactly by a static integer weight mod
2^N, then the terms are folded LEFT TO RIGHT through the approximate
adder mod 2^N; the fold order is part of the result.

Two entries, one CUDA kernel (``csrc/accumulate.cu``):

- :func:`accumulate`: K N-bit containers stacked on axis 0, read in
  place (the engine's ``accumulate``);
- :func:`accumulate_signed`: K signed int32 terms of one shape, each
  read where it lies through its own plane, row and column strides (no
  ``torch.stack``), masked to the container's N bits on load, folded,
  sign-extended and rounded right by ``shift`` in the same launch (the
  engine's ``accumulate_signed`` and ``scaled_add``).

The kernel is bound by device memory (K int32 reads and one write per
element), so it is a template on the adder and on K (2 and 4, the K the
main paths launch; a general instance takes any other K up to
:data:`MAX_TERMS`), issues every term's load before the first fold, and
reads four outputs a thread with 16-byte loads where the layout allows.
:func:`accumulate_route` makes that choice; the C entry refuses a route
that does not fit its arguments.

:func:`accumulate` and :func:`accumulate_signed` route by where the
tensors live: CPU tensors take the plain versions, CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.adders import approx_add_mod
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, check_cuda, on_cpu,
                                            stream_ptr, to_int32, u32_lanes)

MAX_TERMS = _build.MAX_TERMS
#: The K with an instance of their own: scaled_add's 2, downsample2x's 4.
TEMPLATED_K = (2, 4)


def norm_weights(weights, k: int):
    ws = tuple(int(w) for w in weights) if weights is not None else (1,) * k
    if len(ws) != k:
        raise ValueError(f"{len(ws)} weights for {k} stacked terms")
    return ws


def check_shift(shift) -> int:
    """A rounding shift the int32 result can take: an int in [0, 31]."""
    if isinstance(shift, bool) or not isinstance(shift, int) \
            or not 0 <= shift <= 31:
        raise ValueError(f"accumulate_signed shift must be an int in "
                         f"[0, 31]; got {shift!r}")
    return shift


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


def accumulate_signed_plain(terms: Sequence[torch.Tensor], spec: AdderSpec,
                            n_bits: int, weights=None, shift: int = 0,
                            fast: bool = False, add=None) -> torch.Tensor:
    """The plain version of the signed fold, the reference engine's
    composition: each signed term masked to its ``n_bits``-bit container,
    one weighted fold (:func:`accumulate_plain`), sign extension from
    ``n_bits`` and the rounding shift ``(s + 2^(shift-1)) >> shift``, its
    add wrapping in int32."""
    check_shift(shift)
    mask, sign = (1 << n_bits) - 1, 1 << (n_bits - 1)
    s = accumulate_plain(torch.stack([t & mask for t in terms]), spec,
                         weights, fast, add)
    s = (s ^ sign) - sign
    if shift:
        s = (s + (1 << (shift - 1))) >> shift
    return s


def accumulate_route(k: int, numel: int, aligned: bool) -> Tuple[int, int]:
    """The kernel's route as (K instance, outputs a thread): K = 2 and 4
    have instances of their own, any other K up to :data:`MAX_TERMS` the
    general one (0); four outputs a thread with 16-byte loads when the
    row length ``numel`` is a multiple of 4 and every term is ``aligned``
    (16-byte base, unit column stride, row and plane strides multiples
    of 4), else one."""
    if not 1 <= k <= MAX_TERMS:
        raise ValueError(f"the accumulate kernel folds 1 to {MAX_TERMS} "
                         f"terms; got {k}")
    return (k if k in TEMPLATED_K else 0,
            4 if aligned and numel % 4 == 0 else 1)


def term_layout(terms: Sequence[torch.Tensor]):
    """The terms as the kernel reads them: (planes, height, width, views,
    strides), each view a (planes, height, width) reshape of its term (a
    view where the leading dims collapse, else a copy) and ``strides``
    its (plane, row, column) strides in elements, 0 on a dim of size 1.
    A term of fewer than two dims has height (and width) 1."""
    shape = tuple(terms[0].shape)
    if any(tuple(t.shape) != shape for t in terms):
        raise ValueError(f"accumulate_signed: the terms' shapes differ: "
                         f"{[tuple(t.shape) for t in terms]}")
    width = shape[-1] if len(shape) >= 1 else 1
    height = shape[-2] if len(shape) >= 2 else 1
    planes = 1
    for d in shape[:-2]:
        planes *= d
    views = [t.reshape(planes, height, width) for t in terms]
    strides = [tuple(0 if n == 1 else s for n, s in zip(v.shape, v.stride()))
               for v in views]
    return planes, height, width, views, strides


def vec_aligned(ptrs: Sequence[int], strides: Sequence[Tuple[int, int, int]]
                ) -> bool:
    """Whether 16-byte loads fit every term: a 16-byte aligned base, unit
    column stride, row and plane strides that keep rows aligned."""
    return all(p % 16 == 0 and cs == 1 and rs % 4 == 0 and ps % 4 == 0
               for p, (ps, rs, cs) in zip(ptrs, strides))


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _launch(ptrs: List[int], strides, out: torch.Tensor, planes: int,
            height: int, width: int, ws, spec: AdderSpec, fast: bool,
            container_bits: int, shift: int) -> None:
    """One launch of ``accumulate_launch`` on the route
    :func:`accumulate_route` picks for these terms."""
    k = len(ptrs)
    kt, vec = accumulate_route(k, width,
                               vec_aligned(ptrs, strides)
                               and out.data_ptr() % 16 == 0)
    args = adder_args(spec, fast)
    bases = (ctypes.c_void_p * k)(*ptrs)
    flat = (ctypes.c_longlong * (3 * k))(*(s for st in strides for s in st))
    wts = (ctypes.c_uint * k)(*(w & 0xFFFFFFFF for w in ws))
    fn = _build.bind("accumulate", "accumulate_launch", _ARGTYPES)
    with torch.cuda.device(out.device):
        err = fn(ctypes.cast(bases, ctypes.c_void_p),
                 ctypes.cast(flat, ctypes.c_void_p), out.data_ptr(), planes,
                 height, width, k, ctypes.cast(wts, ctypes.c_void_p),
                 container_bits, shift, kt, vec, *args,
                 stream_ptr(out.device))
    _build.check(err, "accumulate")


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
    adder_args(spec, fast)
    k = len(ws)
    accumulate_route(k, 1, False)  # raises for K > MAX_TERMS
    out = torch.empty(terms.shape[1:], dtype=torch.int32,
                      device=terms.device)
    m = out.numel()
    if m == 0:
        return out
    # The stack as K flat terms of one row each, term j at j * m.
    ptrs = [terms.data_ptr() + 4 * j * m for j in range(k)]
    _launch(ptrs, [(0, 0, 1)] * k, out, 1, 1, m, ws, spec, fast, 0, 0)
    accumulate.launches += 1
    return out


def accumulate_signed(terms: Sequence[torch.Tensor], spec: AdderSpec,
                      n_bits: int, *, weights=None, shift: int = 0,
                      fast: bool = False) -> torch.Tensor:
    """The signed fixed-point fold of K signed terms of one shape held in
    ``n_bits``-bit containers: mask, weighted approximate fold, sign
    extension, rounding shift; int32 of the terms' shape out.  CPU
    tensors: the plain version.  CUDA tensors: one kernel launch that
    reads every int32 term where it lies (any strides)."""
    terms = tuple(terms)
    if not terms:
        raise ValueError("accumulate_signed needs at least one term")
    ws = norm_weights(weights, len(terms))
    check_shift(shift)
    if on_cpu("accumulate_signed", *terms):
        return accumulate_signed_plain(terms, spec, n_bits, ws, shift, fast)
    dev = terms[0].device
    for t in terms:
        if t.device != dev:
            raise ValueError(f"accumulate_signed: every term must be on one "
                             f"CUDA device; got {[str(x.device) for x in terms]}")
        if t.dtype != torch.int32:
            raise TypeError(f"accumulate_signed: int32 containers expected; "
                            f"got {t.dtype}")
    adder_args(spec, fast)
    if not 1 <= n_bits <= 31:
        raise ValueError(f"accumulate_signed sign-extends in int32 "
                         f"containers; n_bits={n_bits} is outside [1, 31]")
    accumulate_route(len(ws), 1, False)  # raises for K > MAX_TERMS
    planes, height, width, views, strides = term_layout(terms)
    if planes >= 2 ** 31 or height >= 2 ** 31:
        raise ValueError(f"accumulate_signed: {tuple(terms[0].shape)} "
                         f"exceeds the kernel's int32 planes and rows")
    out = torch.empty(terms[0].shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _launch([v.data_ptr() for v in views], strides, out, planes, height,
            width, ws, spec, fast, n_bits, shift)
    accumulate.launches += 1
    return out


#: Kernel launches made by :func:`accumulate` and
#: :func:`accumulate_signed` (reset by setting to 0).
accumulate.launches = 0
