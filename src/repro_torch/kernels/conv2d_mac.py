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

The CUDA kernel is ``csrc/conv2d_mac.cu``: one thread per output pixel
(four per thread, 8 rows apart), replicate-clamped neighbours read from
device memory, the tap tables in shared memory when they fit in 48 KB.
It is bound by the operations (T - 1 approximate adds per pixel).

:func:`conv2d_mac` routes by where the tensor lives: a CPU tensor takes
:func:`conv2d_mac_plain`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.ax.backends import check_conv_kernel, conv_taps
from repro_torch.ax.mul import lut as mul_lut_lib
from repro_torch.ax.mul.specs import MulSpec
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, approx_add_plain,
                                            check_cuda, on_cpu, signed32,
                                            stream_ptr, to_int32, u32_lanes)


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
             ctypes.c_void_p)


def conv2d_mac(q: torch.Tensor, spec: AdderSpec, mul_spec: MulSpec, kernel,
               *, shift: int = 0, fast: bool = False) -> torch.Tensor:
    """The MAC convolution of a signed int32 (..., H, W) tensor; int32 of
    the same shape out.  CPU tensor: the plain version.  CUDA tensor: one
    kernel launch."""
    if on_cpu("conv2d_mac", q):
        return conv2d_mac_plain(q, spec, mul_spec, kernel, shift, fast)
    kh, kw, weights = check_conv_kernel(kernel)
    check_cuda("conv2d_mac", q)
    check_conv_input(q, mul_spec, shift)
    args = adder_args(spec, fast)
    tables = mul_lut_lib.device_tap_tables(mul_spec, weights, q.device)
    h, w = q.shape[-2:]
    planes = q.numel() // (h * w) if h * w else 0
    if planes > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"conv2d_mac: {tuple(q.shape)} exceeds one "
                         f"launch's grid (at most 65535 planes)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.bind("conv2d_mac", "conv2d_mac_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), tables.data_ptr(), out.data_ptr(), planes, h,
                 w, kh, kw, tables.shape[1], shift, *args,
                 stream_ptr(q.device))
    _build.check(err, "conv2d_mac")
    conv2d_mac.launches += 1
    return out


#: Kernel launches made by :func:`conv2d_mac` (reset by setting to 0).
conv2d_mac.launches = 0
