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

Stage route
-----------
At N = 32 each stage is ONE :meth:`AxEngine.butterfly` call (one kernel
launch on the ``"cuda"`` backend): the butterfly's int32 lanes hold the
whole 32-bit pattern, so it equals the reference's stage bit for bit.
At N < 32 the butterfly returns unsigned N-bit residues and halves them
unsigned, which is not the reference FFT's arithmetic; there the stage
runs the reference's own route: exact products on sign-extended values
and six :meth:`AxEngine.add` calls.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.specs import AdderSpec
from repro_torch.kernels.approx_add import to_int32

TWIDDLE_FRAC = 14


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
    (``torch.round`` rounds half to even, as ``np.round`` does)."""
    x = torch.as_tensor(x, device=cfg.engine.device).to(torch.float64)
    q = torch.round(x * (1 << cfg.frac_bits)).to(torch.int64)
    return _container(q, cfg.n_bits)


def from_fixed(u: torch.Tensor, cfg: FixedFFTConfig) -> torch.Tensor:
    """Containers -> float64 values."""
    return _signed(u, cfg.n_bits).to(torch.float64) / (1 << cfg.frac_bits)


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int, device: torch.device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.as_tensor(rev, device=device)


@functools.lru_cache(maxsize=None)
def stage_twiddles(half: int, inverse: bool,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q1.14 twiddles of a stage, int32 (half,) on ``device``: numpy
    float64 ``cos``/``sin`` and ``np.round`` on the host, as the
    reference computes them (a device ``cos`` one ulp off could round a
    .5 the other way)."""
    sgn = 1.0 if inverse else -1.0
    ang = sgn * 2.0 * np.pi * np.arange(half) / (2 * half)
    wr = np.round(np.cos(ang) * (1 << TWIDDLE_FRAC)).astype(np.int32)
    wi = np.round(np.sin(ang) * (1 << TWIDDLE_FRAC)).astype(np.int32)
    return (torch.as_tensor(wr, device=device),
            torch.as_tensor(wi, device=device))


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


def fft_fixed(re, im, cfg: FixedFFTConfig,
              inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative radix-2 DIT FFT along the LAST axis (batched over the
    leading axes) of int32 containers.  Forward: unscaled.  Inverse:
    each stage halves (overall 1/n)."""
    eng = cfg.engine
    re, im = eng.tensor(re), eng.tensor(im)
    n = re.shape[-1]
    if n & (n - 1):
        raise ValueError(f"length must be a power of two; got {n}")
    shape = re.shape
    perm = _bit_reverse_perm(n, eng.device)
    re, im = re.index_select(-1, perm), im.index_select(-1, perm)
    for s in range(1, n.bit_length()):
        half = 1 << (s - 1)
        w_re, w_im = stage_twiddles(half, inverse, eng.device)
        x_re, x_im = re.reshape(-1, 2 * half), im.reshape(-1, 2 * half)
        planes = (x_re[:, :half], x_im[:, :half], x_re[:, half:],
                  x_im[:, half:])
        if cfg.n_bits == 32:
            top_re, top_im, bot_re, bot_im = eng.butterfly(
                *planes, w_re, w_im, inverse=inverse)
        else:
            top_re, top_im, bot_re, bot_im = _stage_by_adds(
                eng, *planes, w_re, w_im, inverse)
        re = torch.cat([top_re, bot_re], dim=-1).reshape(shape)
        im = torch.cat([top_im, bot_im], dim=-1).reshape(shape)
    return re, im


def fft2_fixed(re, im, cfg: FixedFFTConfig):
    re, im = fft_fixed(re, im, cfg)                      # rows
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)
    re, im = fft_fixed(re, im, cfg)                      # cols
    return re.transpose(-1, -2), im.transpose(-1, -2)


def ifft2_fixed(re, im, cfg: FixedFFTConfig):
    re, im = fft_fixed(re, im, cfg, inverse=True)
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)
    re, im = fft_fixed(re, im, cfg, inverse=True)
    return re.transpose(-1, -2), im.transpose(-1, -2)
