"""Elementwise approximate add mod 2^N: kernel and plain version.

Replaces ``approx_add_pallas`` (``src/repro/kernels/approx_add.py``).
The CUDA kernel is ``csrc/approx_add.cu``: uint32 lanes, one thread per
4 elements with 16-byte loads.  It is bound by device memory (two int32
reads and one write per element against 15-30 integer operations), so
its design is a single streaming pass with wide loads; the adder runs
in registers.

:func:`approx_add` routes by where its tensors live: CPU tensors take
:func:`approx_add_plain`, CUDA tensors launch the kernel (or raise).
There is no fallback from one to the other.

The lane helpers here (:func:`u32_lanes`, :func:`to_int32`,
:func:`signed32`, :func:`adder_args`) are shared with the other kernel
modules.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.adders import approx_add_mod
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build

_U32 = 0xFFFFFFFF


def u32_lanes(x: torch.Tensor) -> torch.Tensor:
    """int32 container -> int64 lanes holding its unsigned 32-bit pattern
    (the plain versions' stand-in for a uint32 bitcast: torch's CPU
    ``uint32`` has no add, shift or compare)."""
    return x.to(torch.int64) & _U32


def to_int32(s: torch.Tensor) -> torch.Tensor:
    """int64 lanes -> int32 container holding the low 32 bits, made
    explicit (values >= 2^31 become negative, as a bitcast would)."""
    s = s & _U32
    return (s - ((s >> 31) << 32)).to(torch.int32)


def signed32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes -> the int32 value of their low 32 bits, kept as int64
    (so that a following shift is arithmetic, as on int32)."""
    x = x & _U32
    return x - ((x >> 31) << 32)


def adder_args(spec: AdderSpec, fast: bool):
    """(kind id, N, m, k, fast) for a device function; raises for a kind
    that has none rather than running another path."""
    kid = _build.DEVICE_KINDS.get(spec.kind)
    if kid is None:
        raise NotImplementedError(
            f"adder kind {spec.kind!r} has no CUDA device function "
            f"(csrc/adders.cuh holds {sorted(_build.DEVICE_KINDS)}); run it on "
            f"the 'torch' backend")
    if spec.n_bits > 32:
        raise ValueError(f"the kernels run uint32 lanes; N={spec.n_bits} "
                         f"exceeds 32")
    return (kid, spec.n_bits, spec.lsm_bits, spec.const_bits, int(bool(fast)))


def check_cuda(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous int32 CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every operand must be on one CUDA "
                             f"device; got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: int32 containers expected; got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: contiguous tensors expected")


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain version runs);
    False when none is; raises on a mix."""
    cpu = [t.device.type == "cpu" for t in tensors]
    if all(cpu):
        return True
    if any(cpu):
        raise ValueError(f"{what}: operands on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    return False


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def approx_add_plain(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec,
                     fast: bool = False) -> torch.Tensor:
    """The plain version: int32 containers in, int32 out, computed on
    int64 lanes on any device."""
    return to_int32(approx_add_mod(u32_lanes(a), u32_lanes(b), spec,
                                   fast=fast))


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def approx_add(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec, *,
               fast: bool = False) -> torch.Tensor:
    """Elementwise approximate add mod 2^N of two int32 containers of one
    shape.  CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if a.shape != b.shape:
        raise ValueError(f"approx_add: shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if on_cpu("approx_add", a, b):
        return approx_add_plain(a, b, spec, fast)
    check_cuda("approx_add", a, b)
    args = adder_args(spec, fast)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = _build.bind("approx_add", "approx_add_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                 *args, stream_ptr(a.device))
    _build.check(err, "approx_add")
    approx_add.launches += 1
    return out


#: Kernel launches made by :func:`approx_add` (reset by setting to 0).
approx_add.launches = 0
