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

The CUDA kernel is ``csrc/mac_matmul.cu``: one block per 64 x 64 output
tile loops over every K tile in one launch, with uint32 accumulators in
registers and the table gathered through ``__ldg``.  It is bound by the
operations (an index, a gather and an add per product).

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


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

#: Output tile edge of one block (``csrc/mac_matmul.cu``'s TILE).
TILE = 64


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
    if -(-m // TILE) > 65535 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"mac_matmul: ({m}, {k}) @ ({k}, {n}) exceeds "
                         f"one launch's grid")
    table = mul_lut_lib.device_signed_table(mul_spec, a.device)
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.bind("mac_matmul", "mac_matmul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                 out.data_ptr(), m, n, k, min(bk, k), mul_spec.n_bits,
                 *args, stream_ptr(a.device))
    _build.check(err, "mac_matmul")
    mac_matmul.launches += 1
    return out


#: Kernel launches made by :func:`mac_matmul` (reset by setting to 0).
mac_matmul.launches = 0
