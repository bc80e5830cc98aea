"""Elementwise approximate multiply: kernel and plain version.

Replaces ``mul_elementwise_pallas`` (``src/repro/kernels/mac.py``): the
full approximate product of two N-bit unsigned operands, in one of three
bit-identical forms (the ``strategy``): ``"reference"`` (the registered
formula), ``"fused"`` (its fused form) or ``"lut"`` (one gather from the
compiled ``2^N x 2^N`` product table of :mod:`repro_torch.ax.mul.lut`).
An exact multiplier has no table and takes its plain product.

The CUDA kernel is ``csrc/mul.cu`` with the formulas of
``csrc/muls.cuh`` on uint32 lanes: one streaming pass like
``approx_add.cu`` (4 elements a thread, 16-byte loads).  It is bound by
device memory: two int32 reads and one write per element against at
most some 50 integer operations of the widest formula.

:func:`mul` routes by where its tensors live: CPU tensors take
:func:`mul_plain`, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.ax.mul import lut as mul_lut_lib
from repro_torch.ax.mul.impls import approx_mul
from repro_torch.ax.mul.specs import MulSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (check_cuda, on_cpu, stream_ptr,
                                            to_int32, u32_lanes)

#: Strategy -> the kernel's form id.
FORMS = {"reference": 0, "fused": 1, "lut": 2}


def _form(mul_spec: MulSpec, strategy: str) -> int:
    """The form to run: an exact multiplier has no table, so its lut
    strategy is the plain product (as on the reference's backends)."""
    if strategy not in FORMS:
        raise ValueError(f"unknown strategy {strategy!r}; one of "
                         f"{tuple(FORMS)}")
    if strategy == "lut" and mul_spec.is_exact:
        return FORMS["reference"]
    return FORMS[strategy]


def mul_lanes(a: torch.Tensor, b: torch.Tensor, mul_spec: MulSpec,
              strategy: str = "reference") -> torch.Tensor:
    """THE approximate product on int64 lanes holding unsigned operand
    patterns: the registered formula (reference or fused form), or one
    gather from the product table (masked back to its uint16 pattern
    when the table is 16-bit)."""
    form = _form(mul_spec, strategy)
    if form == FORMS["lut"]:
        table = mul_lut_lib.device_mul_table(mul_spec, a.device)
        entry = torch.take(table, mul_lut_lib.mul_lut_index(
            a, b, mul_spec.n_bits)).to(torch.int64)
        return entry & 0xFFFF if table.dtype == torch.int16 else entry
    return approx_mul(a, b, mul_spec, fast=form == FORMS["fused"])


def mul_plain(a: torch.Tensor, b: torch.Tensor, mul_spec: MulSpec,
              strategy: str = "reference") -> torch.Tensor:
    """The plain version: int32 containers in, the int32 product out,
    computed on int64 lanes on any device."""
    return to_int32(mul_lanes(u32_lanes(a), u32_lanes(b), mul_spec,
                              strategy))


def mul_args(mul_spec: MulSpec):
    """(kind id, N, effective trunc bits, effective row bits) for the
    device functions; raises for a kind that has none."""
    kid = _build.MUL_DEVICE_KINDS.get(mul_spec.kind)
    if kid is None:
        raise NotImplementedError(
            f"multiplier kind {mul_spec.kind!r} has no CUDA device function "
            f"(csrc/muls.cuh holds {sorted(_build.MUL_DEVICE_KINDS)}); run "
            f"it on the 'torch' backend")
    return (kid, mul_spec.n_bits, mul_spec.effective_trunc_bits,
            mul_spec.effective_row_bits)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def mul(a: torch.Tensor, b: torch.Tensor, mul_spec: MulSpec, *,
        strategy: str = "reference") -> torch.Tensor:
    """Elementwise approximate product of two int32 containers of one
    shape holding N-bit unsigned operands; int32 out.  CPU tensors: the
    plain version.  CUDA tensors: the kernel."""
    if a.shape != b.shape:
        raise ValueError(f"mul: shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if on_cpu("mul", a, b):
        return mul_plain(a, b, mul_spec, strategy)
    check_cuda("mul", a, b)
    form = _form(mul_spec, strategy)
    args = mul_args(mul_spec)
    table, bits = None, 0
    if form == FORMS["lut"]:
        table = mul_lut_lib.device_mul_table(mul_spec, a.device)
        bits = 8 * table.element_size()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = _build.bind("mul", "mul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if table is None else table.data_ptr(), out.data_ptr(),
                 a.numel(), *args, form, bits, stream_ptr(a.device))
    _build.check(err, "mul")
    mul.launches += 1
    return out


#: Kernel launches made by :func:`mul` (reset by setting to 0).
mul.launches = 0
