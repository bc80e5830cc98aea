"""int8 GEMM with approximate inter-tile accumulation: kernel and plain
version.

Replaces ``approx_matmul_pallas`` (``src/repro/kernels/approx_matmul.py``),
the paper's MAC-array placement on a matrix unit: each K tile's int8 dot
is exact (int32, mod 2^32) and the approximate adder folds the tiles'
partials, at the multiples of ``bk`` counted from k = 0, keeping the N-bit
residue as the reference's ``jax`` and ``pallas`` backends do (its
``numpy`` oracle keeps the carry-out instead; below N = 32 the two
differ).  One tile returns the raw dot.  ``bk`` is part of the result.

The CUDA kernel is ``csrc/approx_matmul.cu``.  Its bound is the 7 folds
per output (at 1024^3, bk 128) on the int32 lanes; the dot itself is
about 1 us on the tensor cores.  So the dot runs there (``mma.sync``
m16n8k32 s8, wrapping s32 sums), B is first transposed into an (N, K)
scratch so that both operands are K-major, K is staged in 64-byte chunks
through a three-buffer ``cp.async`` ring, and each 64 x 64 output tile
keeps its partial and its folded sums in registers, folding with the
compile-time adder (``csrc/adders.cuh``).  :func:`staging_route` picks the
16-byte staging or the general one (any ``bk``, K and alignment, zero-
filled past each tile's end).

:func:`approx_matmul` takes int8 tensors, as ``approx_matmul_pallas``
does, and routes by where they live: CPU tensors take
:func:`approx_matmul_plain`, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.approx_add import (adder_args, approx_add_plain,
                                            on_cpu, stream_ptr, to_int32)
from repro_torch.kernels.mac_matmul import check_gemm, fold_tiles

_U32 = 0xFFFFFFFF
#: The kernel's output tile (rows, columns) and K chunk in bytes
#: (``csrc/approx_matmul.cu``'s TM, TN and KC).
TILE, KC = (64, 64), 64


def approx_matmul_plain(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec,
                        bk: int = 128, fast: bool = False,
                        add=None) -> torch.Tensor:
    """The plain version: integer (M, K) and (K, N) of any dtype in (taken
    as int32, as the reference's ``jax`` backend does), int32 (M, N) out,
    on any device; each K tile's dot summed on int64 lanes one k at a
    time, every product cut to 32 bits so that no sum overflows.
    ``add(acc, part)`` folds two int32 containers (default: the registered
    adder mod 2^N)."""
    check_gemm("approx_matmul", a, b, bk)
    if add is None:
        def add(x, y):
            return approx_add_plain(x, y, spec, fast)
    a64 = a.to(torch.int32).to(torch.int64)
    b64 = b.to(torch.int32).to(torch.int64)

    def partial(k0, k1):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                           device=a.device)
        for kk in range(k0, k1):
            part += (a64[:, kk:kk + 1] * b64[kk:kk + 1, :]) & _U32
        return to_int32(part)

    return fold_tiles(a.shape[1], bk, partial, add)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def staging_route(k: int, bk: int, a_ptr: int) -> str:
    """How the kernel stages K: ``"fast"`` (16-byte ``cp.async`` pieces)
    when A's address is 16-byte aligned, ``k % 16 == 0`` (a piece lies
    wholly inside K or wholly past it) and every K tile is whole chunks
    of :data:`KC` (``bk % KC == 0``, or one tile: ``bk >= k``); else
    ``"general"`` (byte staging, zero-filled past each tile's end).  Both
    walk K in the same chunks and fold at the same places."""
    bk = min(bk, k)
    if a_ptr % 16 == 0 and k % 16 == 0 and (bk % KC == 0 or bk == k):
        return "fast"
    return "general"


def approx_matmul(a: torch.Tensor, b: torch.Tensor, spec: AdderSpec, *,
                  bk: int = 128, fast: bool = False) -> torch.Tensor:
    """int8 ``a (M, K) @ b (K, N)``, K tiles of ``bk``; int32 (M, N) out.
    Anything but int8 raises ``TypeError``.  CPU tensors: the plain
    version.  CUDA tensors: the kernel."""
    check_gemm("approx_matmul", a, b, bk)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"approx_matmul takes int8 operands, as "
                        f"approx_matmul_pallas does; got {a.dtype} @ "
                        f"{b.dtype}")
    if on_cpu("approx_matmul", a, b):
        return approx_matmul_plain(a, b, spec, bk, fast)
    if a.device != b.device or not (a.is_contiguous()
                                    and b.is_contiguous()):
        raise ValueError("approx_matmul: contiguous operands on one CUDA "
                         "device expected")
    args = adder_args(spec, fast)
    (m, k), n = a.shape, b.shape[1]
    if -(-m // TILE[0]) > 65535 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"approx_matmul: ({m}, {k}) @ ({k}, {n}) exceeds "
                         f"one launch's grid")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    b_t = torch.empty((n, k), dtype=torch.int8, device=a.device)
    fast_route = staging_route(k, bk, a.data_ptr()) == "fast"
    fn = _build.bind("approx_matmul", "approx_matmul_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), b_t.data_ptr(), out.data_ptr(),
                 m, n, k, min(bk, k), int(fast_route), *args,
                 stream_ptr(a.device))
    _build.check(err, "approx_matmul")
    approx_matmul.launches += 1
    return out


#: Kernel launches made by :func:`approx_matmul` (reset by setting to 0).
approx_matmul.launches = 0
