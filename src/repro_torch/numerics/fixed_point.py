"""Fixed-point representation used by the approximate dataflows (the
port of ``repro.numerics.fixed_point``).

Signed two's-complement Q(i.f) values live in int32 containers.  The
approximate adders operate on the raw N-bit pattern (N = i + f + 1 sign),
exactly as the hardware would; conversions here are exact and cheap.

N is limited to 30 for int32 containers: the (N+1)-bit sum plus headroom
must fit the container before the mod-2^N reduction.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Q-format: ``n_bits`` total (incl. sign), ``frac_bits`` fractional."""

    n_bits: int = 16
    frac_bits: int = 8

    def __post_init__(self):
        if not (2 <= self.n_bits <= 30):
            raise ValueError("n_bits must be in [2, 30] for int32 containers")
        if not (0 <= self.frac_bits < self.n_bits):
            raise ValueError("frac_bits must be in [0, n_bits)")

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def max_int(self) -> int:
        return (1 << (self.n_bits - 1)) - 1

    @property
    def min_int(self) -> int:
        return -(1 << (self.n_bits - 1))

    @property
    def mask(self) -> int:
        return (1 << self.n_bits) - 1


def quantize(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """float -> signed fixed point (int32 container): the product is
    taken in float32 and rounded half to even (as ``jnp.round`` does),
    then saturated."""
    q = torch.round(x.to(torch.float32) * fmt.scale)
    q = torch.clamp(q, fmt.min_int, fmt.max_int)
    return q.to(torch.int32)


def dequantize(q: torch.Tensor, fmt: FixedPointFormat,
               dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) / fmt.scale).to(dtype)


def signed_to_container(q: torch.Tensor, fmt: FixedPointFormat):
    """Signed int32 -> raw N-bit pattern in [0, 2^N) (int32 container)."""
    return q & fmt.mask


def container_to_signed(u: torch.Tensor, fmt: FixedPointFormat):
    """Raw N-bit pattern -> signed int32 (sign extension)."""
    sign_bit = 1 << (fmt.n_bits - 1)
    return (u ^ sign_bit) - sign_bit
