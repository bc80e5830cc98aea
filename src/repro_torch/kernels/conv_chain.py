"""Multi-stage separable filter chain: kernel and plain version.

Replaces ``filter_chain_pallas`` (``src/repro/kernels/conv_chain.py``).
Each :class:`~repro_torch.ax.backends.FilterStage` takes replicate-edge
taps along axis -1 or -2 of its own input, scales them exactly, folds
them through the approximate adder, sign-extends and applies its exact
rounding shift; the chain equals stage-by-stage ``accumulate_signed``.

The Pallas kernel keeps a whole plane in VMEM.  A 1024 x 1024 int32
plane is 4 MiB, beyond the 227 KB of shared memory a block can use, so
the CUDA kernel (``csrc/conv_chain.cu``) tiles the plane and keeps every
stage's values in shared memory, so the chain moves one read and one
write per pixel.  Its bound is the integer arithmetic (40 instructions
per pixel for the gaussian chain, 8 per haloc_axa add), as long as that
traffic, so the kernel is a template on the adder's kind and form (masks
hoisted, no kind switch per add) with a 2-D thread layout (no division
per output).
:func:`chain_route` picks one of two routes:

- ``"sep2"``, the operators' chains (two stages, one per axis, at most 3
  taps in [-1, 1]): 32 x 128 tiles loaded with a one-pixel frame, 16-byte
  loads and no clamps inside the image, replicate-clamped loads at its
  border; no clamp after the load.
- ``"general"``, every other chain: 32 x 64 tiles plus the chain's summed
  halo (clipped to the image), each stage's taps clamped to the image
  against its own input.

Both keep the reference's per-stage replicate edges at the image border.

:func:`filter_chain` routes by where the tensor lives: a CPU tensor
takes :func:`filter_chain_plain`, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.ax.backends import FilterStage, run_stages
from repro_torch.core.specs import AdderSpec
from repro_torch.kernels import _build
from repro_torch.kernels.accumulate import accumulate_plain
from repro_torch.kernels.approx_add import (adder_args, check_cuda, on_cpu,
                                            stream_ptr)

MAX_STAGES, MAX_TAPS = _build.MAX_STAGES, _build.MAX_TAPS
#: Output tile of one block (rows, columns) on the general route.
TILE = (32, 64)
#: Output tile of one block on the sep2 route (``csrc/conv_chain.cu``'s
#: S_TH, S_TW); its shared tile holds a one-pixel frame around it.
SEP2_TILE = (32, 128)
#: Shared memory one block may use on sm_90 (bytes).
MAX_SMEM = 232448


def norm_stages(stages, ndim: int) -> Tuple[FilterStage, ...]:
    """Validate the chain and normalize every axis to -1/-2."""
    if ndim < 2:
        raise ValueError(f"filter_chain needs (..., H, W); got {ndim} dims")
    norm = []
    for st in stages:
        st = FilterStage(*st)
        ax = st.axis - ndim if st.axis >= 0 else st.axis
        if ax not in (-1, -2):
            raise ValueError(
                f"the chain kernel taps the image plane only (axis "
                f"-1/-2); got axis {st.axis}")
        if len(st.offsets) != len(st.weights) or not st.offsets:
            raise ValueError(f"{len(st.weights)} weights for "
                             f"{len(st.offsets)} taps")
        norm.append(FilterStage(ax, tuple(int(o) for o in st.offsets),
                                tuple(int(w) for w in st.weights),
                                int(st.shift)))
    return tuple(norm)


def filter_chain_plain(q: torch.Tensor, spec: AdderSpec, stages,
                       fast: bool = False) -> torch.Tensor:
    """The plain version: the per-stage chain with each stage's fold on
    int64 lanes (:func:`accumulate_plain`), on any device."""
    stages = norm_stages(stages, q.ndim)
    return run_stages(q, spec, stages,
                      lambda taps, ws: accumulate_plain(taps, spec, ws, fast))


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def chain_route(stages) -> str:
    """The kernel's route for a normalized chain: ``"sep2"`` for two
    stages on different axes with at most 3 taps each, every offset in
    [-1, 1] (the operators' box, gaussian and sobel chains); else
    ``"general"``."""
    if (len(stages) == 2 and stages[0].axis != stages[1].axis
            and all(len(st.offsets) <= 3
                    and all(-1 <= o <= 1 for o in st.offsets)
                    for st in stages)):
        return "sep2"
    return "general"


def _stage_arrays(stages):
    """The stages as the flat int and weight arrays the C entry takes:
    per stage (axis, n_taps, shift, offsets[MAX_TAPS]) and
    weights[MAX_TAPS] as ``w & 0xFFFFFFFF``."""
    ints, wts = [], []
    for st in stages:
        pad = MAX_TAPS - len(st.offsets)
        ints += [0 if st.axis == -1 else 1, len(st.offsets), st.shift]
        ints += list(st.offsets) + [0] * pad
        wts += [w & 0xFFFFFFFF for w in st.weights] + [0] * pad
    n = max(len(ints), 1)
    return (ctypes.c_int * n)(*ints), (ctypes.c_uint * max(len(wts), 1))(*wts)


def _smem_bytes(stages) -> int:
    halo = {-1: 0, -2: 0}
    for st in stages:
        halo[st.axis] += max(-min(st.offsets), 0) + max(max(st.offsets), 0)
    return 2 * 4 * (TILE[0] + halo[-2]) * (TILE[1] + halo[-1])


def filter_chain(q: torch.Tensor, spec: AdderSpec, stages, *,
                 fast: bool = False) -> torch.Tensor:
    """The chained filter on signed int32 (..., H, W) containers of
    ``spec.n_bits`` significant bits; same shape out.  CPU tensor: the
    plain version.  CUDA tensor: one kernel launch for the whole chain."""
    stages = norm_stages(stages, q.ndim)
    if on_cpu("filter_chain", q):
        return filter_chain_plain(q, spec, stages, fast)
    check_cuda("filter_chain", q)
    args = adder_args(spec, fast)
    if spec.n_bits > 31:
        raise ValueError(f"filter_chain sign-extends in int32 containers; "
                         f"N={spec.n_bits} exceeds 31")
    if len(stages) > MAX_STAGES or any(len(st.offsets) > MAX_TAPS
                                       for st in stages):
        raise ValueError(f"the chain kernel takes at most {MAX_STAGES} "
                         f"stages of at most {MAX_TAPS} taps")
    sep2 = chain_route(stages) == "sep2"
    if not sep2 and _smem_bytes(stages) > MAX_SMEM:
        raise ValueError(f"the chain's halo needs {_smem_bytes(stages)} "
                         f"bytes of shared memory; at most {MAX_SMEM}")
    h, w = q.shape[-2:]
    planes = q.numel() // (h * w) if h * w else 0
    if planes > 65535:
        raise ValueError(f"at most 65535 planes per launch; got {planes}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    ints, wts = _stage_arrays(stages)
    fn = _build.bind("conv_chain", "filter_chain_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), out.data_ptr(), planes, h, w, int(sep2),
                 TILE[0], TILE[1], len(stages),
                 ctypes.cast(ints, ctypes.c_void_p),
                 ctypes.cast(wts, ctypes.c_void_p), *args,
                 stream_ptr(q.device))
    _build.check(err, "filter_chain")
    filter_chain.launches += 1
    return out


#: Kernel launches made by :func:`filter_chain` (reset by setting to 0).
filter_chain.launches = 0
