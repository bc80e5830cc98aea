"""Fixed-point radix-2 FFT/IFFT through the approximate adder family (the
port of ``repro.image.fft``).

This is the paper's application (Section IV): image reconstruction
through FFT -> IFFT with ACCURATE multipliers and APPROXIMATE adders.

Number format
-------------
Signed two's-complement fixed point stored mod 2^N (N = the adder width,
paper: 32) in int32 tensors on the engine's device, each holding the
N-bit pattern.  Twiddle factors are exact Q1.14 fixed point, and
multiplies are exact (accurate multipliers); every ADD and SUB inside
the butterflies goes through the configured approximate adder (SUB =
exact two's-complement negation + approximate add).

Scaling: the FORWARD transform is unscaled, so spectral magnitudes
dominate the approximate LSM error; INVERSE butterflies halve their
outputs (overall 1/n per axis).

Routes
------
:func:`fft_route` picks how one axis of transforms runs:

- ``"axis"`` (N = 32, n <= ``AXIS_MAX_ELEMS``): every stage of the axis in
  one :func:`repro_torch.kernels.butterfly.fft_axis` call, one kernel
  launch on the ``"cuda"`` backend.  The butterfly's int32 lanes hold the
  whole 32-bit pattern, so it equals the reference's stages bit for bit.
  The transforms are addressed where they lie (an ``AxisLayout``): the
  rows, the columns and the block tiles of an image need no transpose,
  tiling copy, concatenation or bit-reversal gather.
- ``"stages"`` (N = 32, longer transforms, which one block of the axis
  kernel cannot hold): one :meth:`AxEngine.butterfly` call per stage.
- ``"adds"`` (N < 32): the butterfly returns unsigned N-bit residues and
  halves them unsigned, which is not the reference FFT's arithmetic;
  there each stage runs the reference's own route, exact products on
  sign-extended values and six :meth:`AxEngine.add` calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.specs import AdderSpec
from repro_torch.kernels.approx_add import to_int32
from repro_torch.kernels.butterfly import (AXIS_MAX_ELEMS, TWIDDLE_FRAC,
                                           AxisLayout, last_axis_layout,
                                           layout_stages)


@dataclasses.dataclass(frozen=True)
class FixedFFTConfig:
    """Transform config: adder spec, data Q-format, execution backend and
    device (``None``: the ``"cuda"`` backend on the card, as
    :func:`repro_torch.ax.make_engine`).

    The FFT manages its own fixed-point containers, so the engine is
    format-free; every butterfly add/sub routes through it."""

    spec: AdderSpec
    frac_bits: int = 6
    backend: Optional[str] = None
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.spec.n_bits > 32:
            raise ValueError(f"the FFT runs int32 containers; N="
                             f"{self.spec.n_bits} exceeds 32")

    @property
    def n_bits(self) -> int:
        return self.spec.n_bits

    @property
    def engine(self):
        from repro_torch.ax import make_engine
        return make_engine(self.spec, backend=self.backend,
                           device=self.device)


def _mask(n_bits: int) -> int:
    return (1 << n_bits) - 1


def _signed(u: torch.Tensor, n_bits: int) -> torch.Tensor:
    """N-bit pattern -> its signed value, int64."""
    sign = 1 << (n_bits - 1)
    return ((u.to(torch.int64) & _mask(n_bits)) ^ sign) - sign


def _container(q: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int64 values -> int32 containers holding their N-bit pattern."""
    return to_int32(q & _mask(n_bits))


def to_fixed(x, cfg: FixedFFTConfig) -> torch.Tensor:
    """Real values -> Q(N-f).f containers on the engine's device
    (``torch.round`` rounds half to even, as ``np.round`` does).  A uint8
    image whose largest value, 255 * 2^f, is a non-negative container
    value is exactly ``x << f``, two kernels on the card."""
    x = torch.as_tensor(x, device=cfg.engine.device)
    f = cfg.frac_bits
    if x.dtype == torch.uint8 and 255 << f < 1 << min(cfg.n_bits, 31):
        return x.to(torch.int32) << f
    q = torch.round(x.to(torch.float64) * (1 << f)).to(torch.int64)
    return _container(q, cfg.n_bits)


def from_fixed(u: torch.Tensor, cfg: FixedFFTConfig) -> torch.Tensor:
    """Containers -> float64 values (an int32 container of N = 32 is its
    own signed value)."""
    if cfg.n_bits == 32 and u.dtype == torch.int32:
        return u.to(torch.float64) / (1 << cfg.frac_bits)
    return _signed(u, cfg.n_bits).to(torch.float64) / (1 << cfg.frac_bits)


def _stage_by_adds(eng, a_re, a_im, b_re, b_im, w_re, w_im,
                   inverse: bool):
    """One stage as the reference computes it at any N: exact rounded
    products of the sign-extended odd half, then six approximate adds
    (subtract = negate mod 2^N, then add); inverse stages halve the
    signed value with round-to-nearest."""
    n = eng.spec.n_bits
    rnd = 1 << (TWIDDLE_FRAC - 1)
    wr, wi = w_re.to(torch.int64), w_im.to(torch.int64)
    sbr, sbi = _signed(b_re, n), _signed(b_im, n)

    def mul(x, w):
        return _container((x * w + rnd) >> TWIDDLE_FRAC, n)

    def neg(x):
        return _container(-x.to(torch.int64), n)

    t_re = eng.add(mul(sbr, wr), neg(mul(sbi, wi)))
    t_im = eng.add(mul(sbr, wi), mul(sbi, wr))
    outs = (eng.add(a_re, t_re), eng.add(a_im, t_im),
            eng.add(a_re, neg(t_re)), eng.add(a_im, neg(t_im)))
    if inverse:
        outs = tuple(_container((_signed(x, n) + 1) >> 1, n) for x in outs)
    return outs


def fft_route(n: int, n_bits: int) -> str:
    """How one axis of length-n transforms runs at adder width N:
    ``"adds"`` below N = 32, else ``"axis"`` when one block of the axis
    kernel holds a transform (n <= AXIS_MAX_ELEMS), else ``"stages"``."""
    if n_bits < 32:
        return "adds"
    return "axis" if n <= AXIS_MAX_ELEMS else "stages"


def _axis(eng, re, im, layout: AxisLayout, inverse: bool, out=None):
    """One axis of transforms of contiguous containers ``re``/``im``,
    written into ``out`` (new tensors unless given; may be ``re``/``im``)
    by the route :func:`fft_route` picks."""
    route = fft_route(layout.n, eng.spec.n_bits)
    if route == "axis" and layout.n > 1:
        return eng.backend.fft_axis(re, im, layout, eng.spec,
                                    inverse=inverse, out=out)

    def stage(*planes):  # n = 1 runs no stage
        if route == "adds":
            return _stage_by_adds(eng, *planes, inverse)
        return eng.butterfly(*planes, inverse=inverse)

    return layout_stages(re, im, layout, inverse, stage, out)


def _check_length(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"length must be a power of two; got {n}")


def fft_fixed(re, im, cfg: FixedFFTConfig,
              inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative radix-2 DIT FFT along the LAST axis (batched over the
    leading axes) of int32 containers.  Forward: unscaled.  Inverse:
    each stage halves (overall 1/n)."""
    eng = cfg.engine
    re, im = eng.tensor(re).contiguous(), eng.tensor(im).contiguous()
    _check_length(re.shape[-1])
    return _axis(eng, re, im, last_axis_layout(re.shape), inverse)


def image_layouts(shape, block: Optional[int] = None):
    """The row and column layouts of the 2-D transforms of a contiguous
    (..., H, W) tensor: over the whole of each (H, W) plane, or over each
    of its ``block`` x ``block`` tiles, where they lie."""
    *lead, h, w = shape
    planes = math.prod(lead)
    bh, bw = (block, block) if block else (h, w)
    if h % bh or w % bw:
        raise ValueError(f"{block} x {block} tiles do not cover a "
                         f"{h} x {w} plane")
    rows = AxisLayout(bw, planes * h * (w // bw), 1, bw, 0, 1)
    cols = AxisLayout(bh, planes * (h // bh), w, bh * w, 1, w)
    return rows, cols


def transform2d(re, im, cfg: FixedFFTConfig, inverse: bool = False,
                block: Optional[int] = None):
    """The 2-D FFT (IFFT when ``inverse``) of each (H, W) plane of
    ``re``/``im``, or of each of its ``block`` x ``block`` tiles: the rows,
    then the columns in place.  Contiguous (..., H, W) containers out."""
    eng = cfg.engine
    re, im = eng.tensor(re).contiguous(), eng.tensor(im).contiguous()
    rows, cols = image_layouts(tuple(re.shape), block)
    _check_length(rows.n)
    _check_length(cols.n)
    out = _axis(eng, re, im, rows, inverse)
    return _axis(eng, *out, cols, inverse, out=out)


def fft2_fixed(re, im, cfg: FixedFFTConfig):
    return transform2d(re, im, cfg)


def ifft2_fixed(re, im, cfg: FixedFFTConfig):
    return transform2d(re, im, cfg, inverse=True)
