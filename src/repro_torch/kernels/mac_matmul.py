"""Signed MAC GEMM with approximate inter-tile accumulation: kernel and
plain version.

Replaces ``mac_matmul_pallas`` (``src/repro/kernels/mac.py``).  Every
product of ``a (M, K) @ b (K, N)`` is one gather from the signed
sign-magnitude product table (:func:`repro_torch.ax.mul.signed_mul_table`,
indexed by ``((a & mask) << w) | (b & mask)``); the products of one K
tile of ``bk`` sum exactly mod 2^32, and the approximate adder folds the
tiles' partials, at the multiples of ``bk`` counted from k = 0.  One tile
returns the raw partial; more return the last fold's N-bit container
(sign-extended int32 only when N = 32).  ``bk`` is part of the result.

The CUDA kernel is ``csrc/mac_matmul.cu``: persistent blocks walk the
64 x 64 output tiles and loop over every K tile in one launch, with
uint32 accumulators in registers; the inter-tile fold runs the
compile-time adder.  It is bound by the gathers, one a product.
:func:`mac_route` picks where the table lies: an int16 copy in shared
memory up to 8-bit operands (``"shared"``, 128 KiB at w = 8, staged once
a block), else the int32 table in global memory (``"global"``).

:func:`mac_matmul` routes by where its tensors live: CPU tensors take
:func:`mac_matmul_plain`, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.ax.mul import lut as mul_lut_lib
from repro_torch.ax.mul.specs import MulSpec
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, approx_add_plain,
                                            check_cuda, on_cpu, stream_ptr,
                                            to_int32)


def check_gemm(what: str, a: torch.Tensor, b: torch.Tensor, bk: int) -> None:
    """(M, K) @ (K, N) with K >= 1 and a K tile ``bk >= 1``."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: (M, K) @ (K, N) expected; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] < 1:
        raise ValueError(f"{what}: K must be at least 1")
    if isinstance(bk, bool) or not isinstance(bk, int) or bk < 1:
        raise ValueError(f"{what}: the K tile bk must be an int >= 1; got "
                         f"{bk!r}")


def fold_tiles(k: int, bk: int, partial, add) -> torch.Tensor:
    """THE inter-tile fold: ``partial(k0, k1)`` is the exact int32 partial
    of K tile [k0, k1); the first is taken as it is, each next one is
    added to the running container with ``add``."""
    acc = None
    for k0 in range(0, k, bk):
        part = partial(k0, min(k0 + bk, k))
        acc = part if acc is None else add(acc, part)
    return acc


def mac_matmul_plain(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec,
                     mul_spec: MulSpec, bk: int = 128, fast: bool = False,
                     add=None) -> torch.Tensor:
    """The plain version: signed integer (M, K) and (K, N) in, int32 (M, N)
    out, on any device; each K tile's partial summed on int64 lanes, one k
    at a time.  ``add(acc, part)`` folds two int32 containers (default: the
    registered adder mod 2^N; the lut strategy passes its gather add)."""
    check_gemm("mac_matmul", a, b, bk)
    if add is None:
        def add(x, y):
            return approx_add_plain(x, y, spec, fast)
    w = mul_spec.n_bits
    mask = (1 << w) - 1
    table = mul_lut_lib.device_signed_table(mul_spec, a.device)
    hi = (a.to(torch.int64) & mask) << w
    lo = b.to(torch.int64) & mask

    def partial(k0, k1):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                           device=a.device)
        for kk in range(k0, k1):
            part += table[hi[:, kk:kk + 1] | lo[kk:kk + 1, :]]
        return to_int32(part)

    return fold_tiles(a.shape[1], bk, partial, add)


_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 11
             + (ctypes.c_void_p,))

#: Output tile edge of one block (``csrc/mac_matmul.cu``'s TILE).
TILE = 64
#: Widest operands whose table the shared route stages: 2 x 4^8 bytes =
#: 128 KiB of int16 (``csrc/mac_matmul.cu``'s SHARED_MAX_BITS).
SHARED_TABLE_BITS = 8


def mac_route(w: int, fits_int16: bool = True) -> str:
    """Where the kernel gathers w-bit products from: ``"shared"`` (the
    int16 table in shared memory) when w <= SHARED_TABLE_BITS and every
    entry fits int16, else ``"global"`` (the int32 table in global
    memory)."""
    return "shared" if w <= SHARED_TABLE_BITS and fits_int16 else "global"


def mac_matmul(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec,
               mul_spec: MulSpec, *, bk: int = 128,
               fast: bool = False) -> torch.Tensor:
    """MAC GEMM of int32 ``a (M, K)`` and ``b (K, N)`` holding w-bit
    signed values (w = ``mul_spec.n_bits``), K tiles of ``bk``; int32
    (M, N) out.  CPU tensors: the plain version.  CUDA tensors: the
    kernel."""
    check_gemm("mac_matmul", a, b, bk)
    if on_cpu("mac_matmul", a, b):
        return mac_matmul_plain(a, b, spec, mul_spec, bk, fast)
    check_cuda("mac_matmul", a, b)
    args = adder_args(spec, fast)
    (m, k), n = a.shape, b.shape[1]
    if -(-m // TILE) * -(-n // TILE) >= 2 ** 31 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"mac_matmul: ({m}, {k}) @ ({k}, {n}) exceeds "
                         f"one launch's grid")
    w = mul_spec.n_bits
    route = mac_route(w, mul_lut_lib.signed_table_fits_int16(mul_spec))
    table = (mul_lut_lib.device_signed_table16 if route == "shared"
             else mul_lut_lib.device_signed_table)(mul_spec, a.device)
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.bind("mac_matmul", "mac_matmul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                 out.data_ptr(), m, n, k, min(bk, k), w,
                 int(route == "shared"), *args, stream_ptr(a.device))
    _build.check(err, "mac_matmul")
    mac_matmul.launches += 1
    return out


#: Kernel launches made by :func:`mac_matmul` (reset by setting to 0).
mac_matmul.launches = 0
