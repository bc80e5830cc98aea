"""One radix-2 FFT butterfly stage on fixed point: kernel and plain
version.

Replaces ``butterfly_pallas`` (``src/repro/kernels/butterfly.py``), one
stage of the paper's image FFT: ``t = W * b`` with exact Q1.14 twiddle
multiplies rounded to nearest, then ``top = a + t`` and ``bot = a - t``
through the approximate adder (subtract = exact two's-complement negate
plus an approximate add), each mod 2^N; inverse stages halve with
``(x + 1) >> 1``.

The semantics are those of ``butterfly_pallas`` and the reference's
``"jax"`` backend at every N: int32 lanes, each add reduced mod 2^N and
returned as the N-bit residue (so at N < 32 an output is a non-negative
pattern, and an inverse stage halves that pattern), and the halving's
``+ 1`` wraps in 32 bits.

The CUDA kernel is ``csrc/butterfly.cu``: one thread per (row, column)
pair, twiddles indexed by column, the four products in int64.  It takes
the stage's input planes as strided (rows, half) views (row stride free,
column stride 1), so the FFT hands it the even/odd halves of a stage
without copying them.

:func:`butterfly` routes by where its tensors live: CPU tensors take
:func:`butterfly_plain`, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.adders import approx_add_mod
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, on_cpu, signed32,
                                            stream_ptr, to_int32)

TWIDDLE_FRAC = 14

_U32 = 0xFFFFFFFF


def butterfly_plain(a_re, a_im, b_re, b_im, w_re, w_im, spec: AdderSpec, *,
                    inverse: bool = False, fast: bool = False):
    """The plain version: int32 (rows, half) planes and int32 (half,)
    Q1.14 twiddles in; (top_re, top_im, bot_re, bot_im) int32 out,
    computed on int64 lanes on any device."""
    half = 1 << (TWIDDLE_FRAC - 1)
    wr, wi = w_re.to(torch.int64), w_im.to(torch.int64)
    br, bi = b_re.to(torch.int64), b_im.to(torch.int64)

    def mul(x, w):
        return ((x * w + half) >> TWIDDLE_FRAC) & _U32

    def add(x, y):
        return approx_add_mod(x & _U32, y & _U32, spec, fast=fast)

    rr, ri, ir, ii = mul(br, wr), mul(br, wi), mul(bi, wr), mul(bi, wi)
    ar, ai = a_re.to(torch.int64), a_im.to(torch.int64)
    t_re, t_im = add(rr, -ii), add(ri, ir)
    outs = (add(ar, t_re), add(ai, t_im), add(ar, -t_re), add(ai, -t_im))
    if inverse:
        outs = tuple(signed32(x + 1) >> 1 for x in outs)
    return tuple(to_int32(x) for x in outs)


_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 4
             + (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) * 2
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


def _check_planes(planes, w_re, w_im):
    """Four int32 (rows, half) CUDA planes with column stride 1 and two
    contiguous int32 (half,) twiddles, all on one device."""
    dev = planes[0].device
    shape = tuple(planes[0].shape)
    if len(shape) != 2:
        raise ValueError(f"butterfly: (rows, half) planes expected; got "
                         f"shape {shape}")
    for t in planes + (w_re, w_im):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("butterfly: every operand must be on one CUDA "
                             "device")
        if t.dtype != torch.int32:
            raise TypeError(f"butterfly: int32 operands expected; got "
                            f"{t.dtype}")
    for t in planes:
        if tuple(t.shape) != shape:
            raise ValueError(f"butterfly: plane shapes differ: "
                             f"{[tuple(p.shape) for p in planes]}")
        if shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("butterfly: planes need column stride 1")
    for w in (w_re, w_im):
        if tuple(w.shape) != (shape[1],) or not w.is_contiguous():
            raise ValueError(f"butterfly: contiguous ({shape[1]},) twiddles "
                             f"expected; got {tuple(w.shape)}")


def butterfly(a_re, a_im, b_re, b_im, w_re, w_im, spec: AdderSpec, *,
              inverse: bool = False, fast: bool = False):
    """One butterfly stage: int32 (rows, half) planes ``a`` (even) and
    ``b`` (odd), int32 (half,) Q1.14 twiddles; returns (top_re, top_im,
    bot_re, bot_im), int32 (rows, half).  CPU tensors: the plain version.
    CUDA tensors: the kernel."""
    planes = (a_re, a_im, b_re, b_im)
    if on_cpu("butterfly", *planes, w_re, w_im):
        return butterfly_plain(*planes, w_re, w_im, spec, inverse=inverse,
                               fast=fast)
    _check_planes(planes, w_re, w_im)
    args = adder_args(spec, fast)
    rows, half = a_re.shape
    outs = tuple(torch.empty((rows, half), dtype=torch.int32,
                             device=a_re.device) for _ in range(4))
    if rows * half == 0:
        return outs
    fn = _build.bind("butterfly", "butterfly_launch", _ARGTYPES)
    with torch.cuda.device(a_re.device):
        err = fn(*(p.data_ptr() for p in planes),
                 *(p.stride(0) for p in planes),
                 w_re.data_ptr(), w_im.data_ptr(),
                 *(o.data_ptr() for o in outs), rows, half, *args,
                 int(bool(inverse)), stream_ptr(a_re.device))
    _build.check(err, "butterfly")
    butterfly.launches += 1
    return outs


#: Kernel launches made by :func:`butterfly` (reset by setting to 0).
butterfly.launches = 0
