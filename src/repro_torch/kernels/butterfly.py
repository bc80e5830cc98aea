"""Radix-2 FFT butterflies on fixed point: one stage, or every stage of
an axis, each a kernel with its plain version.

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

The CUDA kernels are in ``csrc/butterfly.cu``, on the compile-time
adder:

- :func:`butterfly`, ONE stage (``engine.butterfly``): one thread per
  (row, column) pair, twiddles indexed by column, the four products in
  int64.  It takes the stage's input planes as strided (rows, half) views
  (row stride free, column stride 1).
- :func:`fft_axis`, EVERY stage of a batch of length-n transforms in one
  launch: transform g = (outer o, inner i) starts at ``o * s_outer + i *
  s_inner`` and its elements lie ``s_elem`` apart (an
  :class:`AxisLayout`), so an image's rows, its columns and its block
  tiles are transformed where they lie.  A block loads its transforms in
  bit-reversed order into shared memory, runs the stages there with the
  per-stage arithmetic, and stores in natural order (:func:`axis_plan`
  picks its shape).  Its plain version gathers the transforms, reverses
  their bits and runs :func:`butterfly_plain` stage by stage.

Each wrapper routes by where its tensors live: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
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


# ------------------------------------------------ every stage of an axis --

#: Elements (of each of re and im) one block of the axis kernel holds at
#: most: 32 KB of shared memory in all (``csrc/butterfly.cu``'s
#: MAX_LOG_ELEMS).  So the longest transform it runs is this long.
AXIS_MAX_ELEMS = 4096
#: Elements a block takes when its transforms are short: T = this // n.
AXIS_ELEMS = 1024
#: Transforms a block takes at least when neighbouring transforms are
#: neighbouring addresses (t_fast): 8 int32, one 32-byte sector a load.
AXIS_MIN_RUN = 8


@functools.lru_cache(maxsize=None)
def stage_twiddles(half: int, inverse: bool,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q1.14 twiddles of a stage, int32 (half,) on ``device``: numpy
    float64 ``cos``/``sin`` and ``np.round`` on the host, as the
    reference computes them (a device ``cos`` one ulp off could round a
    .5 the other way)."""
    sgn = 1.0 if inverse else -1.0
    ang = sgn * 2.0 * np.pi * np.arange(half) / (2 * half)
    wr = np.round(np.cos(ang) * (1 << TWIDDLE_FRAC)).astype(np.int32)
    wi = np.round(np.sin(ang) * (1 << TWIDDLE_FRAC)).astype(np.int32)
    return (torch.as_tensor(wr, device=device),
            torch.as_tensor(wi, device=device))


@functools.lru_cache(maxsize=None)
def axis_twiddles(n: int, inverse: bool,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every stage's twiddles of a length-n transform in one int32
    (n - 1,) table each: stage half h at offset h - 1."""
    halves = [1 << s for s in range(n.bit_length() - 1)]
    parts = [stage_twiddles(h, inverse, torch.device("cpu")) for h in halves]
    return tuple(torch.cat([p[i] for p in parts]).to(device)
                 for i in range(2))


class AxisLayout(NamedTuple):
    """Where the length-n transforms of one axis lie in a contiguous
    tensor: transform (o, i), o < n_outer, i < n_inner, has its element e
    at ``o * s_outer + i * s_inner + e * s_elem``."""

    n: int
    n_outer: int
    n_inner: int
    s_outer: int
    s_inner: int
    s_elem: int

    @property
    def transforms(self) -> int:
        return self.n_outer * self.n_inner

    def view(self, x: torch.Tensor) -> torch.Tensor:
        """The transforms of ``x`` as an (n_outer, n_inner, n) view."""
        return x.as_strided((self.n_outer, self.n_inner, self.n),
                            (self.s_outer, self.s_inner, self.s_elem))


def last_axis_layout(shape) -> AxisLayout:
    """Transforms along the last axis of a contiguous tensor."""
    n = shape[-1]
    return AxisLayout(n, int(np.prod(shape[:-1], dtype=np.int64)), 1, n, 0, 1)


def divider(d: int) -> Tuple[int, int]:
    """(magic, shift) with ``g // d == (umulhi(g, magic) + g) >> shift``
    for every 0 <= g < 2^31, umulhi the high 32 bits of a 32 x 32 product:
    the kernel's split of a transform index into (outer, inner)."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


class AxisPlan(NamedTuple):
    """How the axis kernel covers a layout: 2^log_per_block transforms a
    block, loaded and stored transform-fast (``t_fast``) or element-fast,
    ``blocks`` blocks."""

    log_n: int
    log_per_block: int
    t_fast: bool
    blocks: int


def axis_plan(layout: AxisLayout) -> AxisPlan:
    """The axis kernel's shape for ``layout``: about AXIS_ELEMS elements a
    block; where neighbouring transforms are neighbouring addresses
    (columns), at least AXIS_MIN_RUN of them a block, so that a warp's
    load is whole 32-byte sectors."""
    n = layout.n
    t_fast = layout.s_inner == 1 and layout.n_inner > 1 \
        and layout.s_elem != 1
    per_block = max(AXIS_ELEMS // n, 1)
    if t_fast:
        per_block = max(per_block, min(AXIS_MIN_RUN, AXIS_MAX_ELEMS // n))
    log_per_block = per_block.bit_length() - 1
    blocks = -(-layout.transforms // per_block)
    return AxisPlan(n.bit_length() - 1, log_per_block, t_fast, blocks)


def check_layout(layout: AxisLayout, numel: int) -> None:
    """A layout the axis kernel takes on a contiguous tensor of ``numel``
    elements: 2 <= n <= AXIS_MAX_ELEMS a power of two, fewer than 2^31
    transforms, non-negative strides, every element inside the tensor."""
    n = layout.n
    if n < 2 or n & (n - 1) or n > AXIS_MAX_ELEMS:
        raise ValueError(f"fft_axis: transform length must be a power of "
                         f"two in [2, {AXIS_MAX_ELEMS}]; got {n}")
    if layout.n_outer < 0 or layout.n_inner < 1 \
            or layout.transforms >= 2 ** 31:
        raise ValueError(f"fft_axis: {layout.n_outer} x {layout.n_inner} "
                         f"transforms do not fit the kernel's index")
    if min(layout.s_outer, layout.s_inner, layout.s_elem) < 0:
        raise ValueError(f"fft_axis: negative strides in {layout}")
    if layout.transforms:
        last = ((layout.n_outer - 1) * layout.s_outer
                + (layout.n_inner - 1) * layout.s_inner
                + (n - 1) * layout.s_elem)
        if last >= numel:
            raise ValueError(f"fft_axis: {layout} reaches element {last} of "
                             f"a tensor of {numel}")


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int, device: torch.device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.as_tensor(rev, device=device)


def fft_stages(x_re, x_im, inverse: bool, stage):
    """THE per-stage FFT on rows of int32 containers: the bit-reversal
    gather, then for half = 1, 2, ..., n/2 one ``stage(a_re, a_im, b_re,
    b_im, w_re, w_im)`` on the even and odd halves of each group of 2 *
    half, its (top_re, top_im, bot_re, bot_im) placed back in order."""
    n = x_re.shape[-1]
    shape = x_re.shape
    perm = _bit_reverse_perm(n, x_re.device)
    re, im = x_re.index_select(-1, perm), x_im.index_select(-1, perm)
    for s in range(1, n.bit_length()):
        half = 1 << (s - 1)
        w_re, w_im = stage_twiddles(half, inverse, x_re.device)
        g_re, g_im = re.reshape(-1, 2 * half), im.reshape(-1, 2 * half)
        top_re, top_im, bot_re, bot_im = stage(
            g_re[:, :half], g_im[:, :half], g_re[:, half:], g_im[:, half:],
            w_re, w_im)
        re = torch.cat([top_re, bot_re], dim=-1).reshape(shape)
        im = torch.cat([top_im, bot_im], dim=-1).reshape(shape)
    return re, im


def layout_stages(re, im, layout: AxisLayout, inverse: bool, stage,
                  out=None):
    """:func:`fft_stages` on the transforms of ``layout``: gathered as
    rows, transformed with ``stage``, written back into ``out`` (new
    tensors like ``re`` unless given; may be ``re`` and ``im``
    themselves)."""
    rows = [layout.view(x).reshape(-1, layout.n) for x in (re, im)]
    y = fft_stages(*rows, inverse, stage)
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    for o, v in zip(out, y):
        layout.view(o).copy_(v.reshape(layout.n_outer, layout.n_inner,
                                       layout.n))
    return tuple(out)


def fft_axis_plain(re, im, layout: AxisLayout, spec: AdderSpec, *,
                   inverse: bool = False, fast: bool = False, out=None):
    """The plain version: the transforms of ``layout`` bit-reversed and
    run through :func:`butterfly_plain` stage by stage
    (:func:`layout_stages`)."""
    def stage(*planes):
        return butterfly_plain(*planes, spec, inverse=inverse, fast=fast)

    return layout_stages(re, im, layout, inverse, stage, out)


_AXIS_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,)
                  + (ctypes.c_longlong,) * 3
                  + (ctypes.c_int, ctypes.c_uint) + (ctypes.c_int,) * 4
                  + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 6
                  + (ctypes.c_void_p,))


def fft_axis(re, im, layout: AxisLayout, spec: AdderSpec, *,
             inverse: bool = False, fast: bool = False, out=None):
    """Every radix-2 DIT stage of the length-n transforms of ``layout``
    in contiguous int32 containers ``re``/``im``: bit-reversed load, the
    stages (halving when ``inverse``), natural-order result, written into
    ``out`` (new tensors unless given; ``(re, im)`` transforms in place).
    Returns ``out``.  CPU tensors: the plain version.  CUDA tensors: one
    kernel launch."""
    out_given = out is not None
    tensors = (re, im) + (tuple(out) if out_given else ())
    if on_cpu("fft_axis", *tensors):
        return fft_axis_plain(re, im, layout, spec, inverse=inverse,
                              fast=fast, out=out)
    for t in tensors:
        if t.device != re.device or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.shape != re.shape:
            raise ValueError("fft_axis: contiguous int32 CUDA tensors of one "
                             "shape on one device expected")
    check_layout(layout, re.numel())
    args = adder_args(spec, fast)
    if not out_given:
        out = (torch.empty_like(re), torch.empty_like(im))
    if layout.transforms == 0:
        return tuple(out)
    plan = axis_plan(layout)
    magic, shift = divider(layout.n_inner)
    w_re, w_im = axis_twiddles(layout.n, bool(inverse), re.device)
    fn = _build.bind("butterfly", "butterfly_axis_launch", _AXIS_ARGTYPES)
    with torch.cuda.device(re.device):
        err = fn(re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), layout.transforms, layout.s_outer,
                 layout.s_inner, layout.s_elem, layout.n_inner, magic, shift,
                 plan.log_n, plan.log_per_block, int(plan.t_fast),
                 w_re.data_ptr(), w_im.data_ptr(), *args,
                 int(bool(inverse)), stream_ptr(re.device))
    _build.check(err, "fft_axis")
    fft_axis.launches += 1
    return tuple(out)


#: Kernel launches made by :func:`fft_axis` (reset by setting to 0).
fft_axis.launches = 0
