"""2D MAC convolution on signed values: kernel and plain version.

Replaces ``conv2d_mac_pallas`` (``src/repro/kernels/mac.py``).  For a
static kernel of odd (kh, kw) integer weights, every tap's product runs
the approximate multiplier as one gather from that tap's column table
(:func:`repro_torch.ax.mul.tap_tables`, indexed by ``|x|``, the sign
restored after), the products are masked to N bits and folded through
the approximate adder mod 2^N in ``conv_taps``' row-major order, and
the sum is sign-extended and rounded right by ``shift``.  Edges are
replicated.  Inputs must satisfy ``|q| < 2^w`` (w = the multiplier's
operand width): both versions raise ``ValueError`` otherwise, as the
reference's ``numpy`` backend does.

The CUDA kernel is ``csrc/conv2d_mac.cu``.  It is bound by the
operations (T - 1 approximate adds per pixel), so a tap is one gather
from :func:`signed_tap_tables` (each tap's product of every signed v,
masked to N bits) and an add; each block stages a :data:`TILE` of the
image and its halo in shared memory as table indices (16-byte loads
inside the image, clamped loads on its border), and each thread slides
a window of indices down :data:`ROWS` output rows in registers.
:func:`conv_route` picks the instance (3 x 3, 5 x 5, or the general one)
and where the tables go (shared memory when they fit beside the tile in
:data:`MAX_SMEM`, else global memory).

:func:`conv2d_mac` routes by where the tensor lives: a CPU tensor takes
:func:`conv2d_mac_plain`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.ax.backends import check_conv_kernel, conv_taps
from repro_torch.ax.mul import lut as mul_lut_lib
from repro_torch.ax.mul.specs import MulSpec
from repro_torch.core.specs import AdderSpec
from repro_torch.integrity.digests import record_upload
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, approx_add_plain,
                                            check_cuda, on_cpu, signed32,
                                            stream_ptr, to_int32, u32_lanes)
from repro_torch.obs.caches import register_lru as _register_lru


#: Output rows a thread computes, and a block's output tile (rows,
#: columns): ``csrc/conv2d_mac.cu``'s ROWS and (TH, TW).
ROWS = 8
TILE = (8 * ROWS, 32)
#: Square kernel sizes with an instance of their own.
TEMPLATED = (3, 5)
#: Shared memory one block may use on sm_90 (bytes).
MAX_SMEM = 232448


def frame_cols(kw: int) -> int:
    """Columns the shared tile holds left and right of the output tile:
    the kernel's half width rounded up to 4, so that its rows start
    16-byte aligned."""
    return 4 * -(-(kw // 2) // 4)


def tile_bytes(kh: int, kw: int) -> int:
    """Shared memory of one block's input tile: the output tile plus
    the kernel's halo rows and :func:`frame_cols` on each side."""
    return 4 * (TILE[0] + kh - 1) * (TILE[1] + 2 * frame_cols(kw))


def conv_route(kh: int, kw: int, entries: int) -> Tuple[int, str]:
    """The kernel's route as (instance, table place): ``"shared"`` when
    the signed tables (``kh * kw`` of ``2 * entries`` int32) fit beside
    the tile in :data:`MAX_SMEM`, and then instance 3 or 5 for a 3 x 3 or
    5 x 5 kernel, 0 (the general one) for any other odd size; else
    ``"global"`` on the general instance."""
    if tile_bytes(kh, kw) > MAX_SMEM:
        raise ValueError(f"conv2d_mac: a {kh} x {kw} kernel's tile needs "
                         f"{tile_bytes(kh, kw)} bytes of shared memory; at "
                         f"most {MAX_SMEM}")
    if 2 * entries * kh * kw >= 2 ** 31:
        raise ValueError(f"conv2d_mac: {kh * kw} tables of {2 * entries} "
                         f"entries exceed int32 indices")
    if tile_bytes(kh, kw) + 4 * 2 * entries * kh * kw > MAX_SMEM:
        return 0, "global"
    return (kh if kh == kw and kh in TEMPLATED else 0), "shared"


def _signed_rows(tab: np.ndarray, n_bits: int) -> np.ndarray:
    """The host build of :func:`signed_tap_tables` from the tap tables
    ``tab``."""
    tab = tab.astype(np.int64)
    entries = tab.shape[1]
    v = np.arange(-entries, entries)
    prod = tab[:, np.minimum(np.abs(v), entries - 1)]
    prod = np.where(v < 0, -prod, prod) & ((1 << n_bits) - 1)
    prod[:, 0] = 0  # v = -2^w is outside the input range
    return np.ascontiguousarray(prod.T).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _signed_tables(mul_spec: MulSpec, weights: Tuple[int, ...], n_bits: int,
                   device: torch.device) -> torch.Tensor:
    return record_upload(
        "kernels.conv2d_mac.signed_taps", (mul_spec, weights, n_bits, device),
        "ax.mul.lut.taps", (mul_spec, weights),
        mul_lut_lib.tap_tables(mul_spec, weights),
        lambda rows: torch.from_numpy(rows).to(device),
        functools.partial(mul_lut_lib._tap_tables_nocache, mul_spec, weights),
        transform=functools.partial(_signed_rows, n_bits=n_bits))


_register_lru("kernels.conv2d_mac.signed_taps", _signed_tables)


def signed_tap_tables(mul_spec: MulSpec, weights, n_bits: int,
                      device) -> torch.Tensor:
    """The kernel's tables: int32 (2^(w+1), T), row ``v + 2^w`` and
    column t holding tap t's product of v as the plain version takes it,
    ``(sign(v) * tap_tables[t][|v|]) & ones(N)``, for every |v| < 2^w
    (row 0, v = -2^w, is 0).  So a tap is one gather at flat index
    ``(v + 2^w) * T + t``.  Built once per (canonical multiplier,
    weights, N, device), and registered as a golden entry
    (``kernels.conv2d_mac.signed_taps``) that a scrub repairs in
    place."""
    return _signed_tables(mul_lut_lib._canonical(mul_spec),
                          tuple(int(w) for w in weights), int(n_bits),
                          torch.device(device))


def check_conv_input(q: torch.Tensor, mul_spec: MulSpec, shift: int) -> None:
    """(..., H, W) input whose values index the w-bit tap tables, and a
    rounding shift the int32 result can take."""
    if q.ndim < 2:
        raise ValueError(f"conv2d needs (..., H, W); got {tuple(q.shape)}")
    if isinstance(shift, bool) or not isinstance(shift, int) \
            or not 0 <= shift <= 31:
        raise ValueError(f"conv2d shift must be an int in [0, 31]; got "
                         f"{shift!r}")
    if q.numel():
        lo, hi = torch.aminmax(q)
        top = max(-int(lo), int(hi))
        if top >= 1 << mul_spec.n_bits:
            raise ValueError(
                f"conv2d inputs must satisfy |q| < 2^{mul_spec.n_bits} "
                f"(the multiplier operand width); got {top}")


def conv2d_mac_plain(q: torch.Tensor, spec: AdderSpec, mul_spec: MulSpec,
                     kernel, shift: int = 0, fast: bool = False,
                     add=None) -> torch.Tensor:
    """The plain version: signed integer (..., H, W) in, int32 of the same
    shape out, on any device.  ``add(acc, term)`` folds two int32
    containers (default: the registered adder mod 2^N; the lut strategy
    passes its gather add)."""
    kh, kw, weights = check_conv_kernel(kernel)
    check_conv_input(q, mul_spec, shift)
    if add is None:
        def add(x, y):
            return approx_add_plain(x, y, spec, fast)
    tables = mul_lut_lib.device_tap_tables(mul_spec, weights, q.device)
    mask = (1 << spec.n_bits) - 1
    sign = 1 << (spec.n_bits - 1)
    acc = None
    for t, view in enumerate(conv_taps(q.to(torch.int32), kh, kw)):
        p = tables[t][view.abs().to(torch.int64)]
        p = torch.where(view < 0, -p, p)
        u = to_int32(p.to(torch.int64) & mask)
        acc = u if acc is None else add(acc, u)
    s = (u32_lanes(acc) ^ sign) - sign
    if shift:
        # The rounding add wraps in int32, as the reference's does.
        s = signed32(s + (1 << (shift - 1))) >> shift
    return s.to(torch.int32)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def conv2d_mac(q: torch.Tensor, spec: AdderSpec, mul_spec: MulSpec, kernel,
               *, shift: int = 0, fast: bool = False) -> torch.Tensor:
    """The MAC convolution of a signed int32 (..., H, W) tensor; int32 of
    the same shape out.  CPU tensor: the plain version.  CUDA tensor: the
    ``|q| < 2^w`` check (one reduction, read on the host), then one
    kernel launch."""
    if on_cpu("conv2d_mac", q):
        return conv2d_mac_plain(q, spec, mul_spec, kernel, shift, fast)
    check_conv_input(q, mul_spec, shift)
    return launch_conv2d_mac(q, spec, mul_spec, kernel, shift=shift,
                             fast=fast)


def launch_conv2d_mac(q: torch.Tensor, spec: AdderSpec, mul_spec: MulSpec,
                      kernel, *, shift: int = 0,
                      fast: bool = False) -> torch.Tensor:
    """The kernel's launch alone, for a contiguous int32 CUDA tensor whose
    values the caller has checked (``|q| < 2^w``, as :func:`conv2d_mac`
    does): no host synchronisation, so its time is the kernel's."""
    check_cuda("conv2d_mac", q)
    kh, kw, weights = check_conv_kernel(kernel)
    args = adder_args(spec, fast)
    entries = 1 << mul_spec.n_bits
    shape, place = conv_route(kh, kw, entries)
    h, w = q.shape[-2:]
    planes = q.numel() // (h * w) if h * w else 0
    tiles = planes * -(-h // TILE[0]) * -(-w // TILE[1])
    if tiles >= 2 ** 31 or (h + TILE[0]) * w >= 2 ** 31:
        raise ValueError(f"conv2d_mac: {tuple(q.shape)} exceeds the "
                         f"kernel's int32 indices")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    tables = signed_tap_tables(mul_spec, weights, spec.n_bits, q.device)
    fn = _build.bind("conv2d_mac", "conv2d_mac_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), tables.data_ptr(), out.data_ptr(), planes, h,
                 w, kh, kw, entries, shift, shape, int(place == "shared"),
                 *args, stream_ptr(q.device))
    _build.check(err, "conv2d_mac")
    conv2d_mac.launches += 1
    return out


#: Kernel launches made by :func:`conv2d_mac` (reset by setting to 0).
conv2d_mac.launches = 0
