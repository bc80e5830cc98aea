"""Lut-strategy elementwise approximate add mod 2^N: kernel and plain
version.

Replaces ``lut_add_pallas`` (``src/repro/kernels/lut_add.py``).  The
compiled ``2^m x 2^m`` low-part table (:mod:`repro_torch.ax.lut`) turns
the adder's bit-level emulation into one gather and one exact high add::

    s = ((a >> m) + (b >> m)) << m  +  table[(a_low << m) | b_low]   (mod 2^N)

The CUDA kernel is ``csrc/lut_add.cu``: one streaming pass like
``approx_add.cu`` (4 elements a thread, 16-byte loads), with the table
read through the read-only data path.  It is bound by device memory: two
int32 reads and one write per element; the table (2 MiB at m=10,
128 KiB at m=8) stays in the 50 MB L2 after the first touches.

:func:`lut_add` routes by where its tensors live: CPU tensors take
:func:`lut_add_plain`, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.ax import lut as lut_lib
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (check_cuda, on_cpu, stream_ptr,
                                            to_int32, u32_lanes)


def lut_gather_add(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
                   spec: AdderSpec) -> torch.Tensor:
    """The lut add mod 2^N on int64 lanes holding 32-bit patterns
    (:func:`repro_torch.ax.lut.lut_gather_full`, masked to N bits)."""
    return lut_lib.lut_gather_full(a, b, table, spec) \
        & ((1 << spec.n_bits) - 1)


def lut_add_plain(a: torch.Tensor, b: torch.Tensor,
                  spec: AdderSpec) -> torch.Tensor:
    """The plain version: int32 containers in, int32 out, computed on
    int64 lanes on any device."""
    table = lut_lib.device_table(spec, a.device)
    return to_int32(lut_gather_add(u32_lanes(a), u32_lanes(b), table, spec))


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def lut_add(a: torch.Tensor, b: torch.Tensor,
            spec: AdderSpec) -> torch.Tensor:
    """Lut-strategy approximate add mod 2^N of two int32 containers of one
    shape.  CPU tensors: the plain version.  CUDA tensors: the kernel.
    ``spec`` must be a non-exact kind with ``lsm_bits <=
    MAX_LUT_LSM_BITS`` (exact kinds take the plain add)."""
    if a.shape != b.shape:
        raise ValueError(f"lut_add: shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if on_cpu("lut_add", a, b):
        return lut_add_plain(a, b, spec)
    check_cuda("lut_add", a, b)
    if spec.n_bits > 32:
        raise ValueError(f"the kernels run uint32 lanes; N={spec.n_bits} "
                         f"exceeds 32")
    table = lut_lib.device_table(spec, a.device)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = _build.bind("lut_add", "lut_add_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                 out.data_ptr(), a.numel(), spec.n_bits, spec.lsm_bits,
                 stream_ptr(a.device))
    _build.check(err, "lut_add")
    lut_add.launches += 1
    return out


#: Kernel launches made by :func:`lut_add` (reset by setting to 0).
lut_add.launches = 0
