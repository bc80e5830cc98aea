"""Multiplier and MAC configuration records (the port's own copy of
``repro.ax.mul.specs``).

:class:`MulSpec` is the multiplier-side sibling of
:class:`repro_torch.core.specs.AdderSpec`: a frozen, hashable description
of one hardware configuration, validated against the multiplier registry
(:mod:`repro_torch.ax.mul.registry`) so plugin kinds take part in
validation exactly like the builtins.

:class:`MacSpec` pairs one adder spec with one multiplier spec: the unit
of configuration for the MAC datapaths (``engine.conv2d`` and the
``mul_spec=`` matmul path).

Field semantics per kind:

======================  ==========================  ====================
kind                    ``trunc_bits``              ``row_bits``
======================  ==========================  ====================
``accurate``            ignored                     ignored
``truncated``           partial-product cells with  ignored
                        column ``i + j < t`` are
                        dropped
``broken_array``        horizontal break length     vertical break
                        (HBL): cell (row *i*,       length (VBL): the
                        column *j*) dropped when    low ``row_bits``
                        ``i + j < t`` …             multiplicand bits
                                                    are dropped from
                                                    every row
``mitchell``            low ``t`` bits of both      ignored
                        operands zeroed before
                        the logarithmic path
======================  ==========================  ====================

(The broken-array keep rule combines both: cell ``(i, j)`` survives iff
``j >= max(row_bits, trunc_bits - i)``.)

Operand width is capped at 15 bits so the full 2N+1-bit product
(Mitchell's ``2*q`` intermediate needs one headroom bit) fits the
uint32 lanes of the CUDA kernels.
"""

from __future__ import annotations

import dataclasses

from repro_torch.ax.mul.registry import get_multiplier
from repro_torch.core.specs import AdderSpec

# Product + headroom must fit 32-bit lanes: 2*15 + 1 = 31 bits.
MAX_MUL_BITS = 15


@dataclasses.dataclass(frozen=True)
class MulSpec:
    """One approximate-multiplier hardware configuration."""

    kind: str
    n_bits: int = 8
    trunc_bits: int = 0
    row_bits: int = 0

    def __post_init__(self):
        from repro_torch.ax.registry import _check_uint_range
        try:
            entry = get_multiplier(self.kind)
        except KeyError:
            raise ValueError(
                f"unknown multiplier kind {self.kind!r}; registered: "
                f"{_registered()}") from None
        _check_uint_range(self.n_bits, 2, MAX_MUL_BITS, "n_bits",
                          context="2N+1-bit products must fit 32-bit lanes")
        _check_uint_range(
            self.trunc_bits, 0,
            self.n_bits - (entry.trunc_margin if entry.uses_trunc else 0),
            "trunc_bits", context=f"{self.kind} at n_bits={self.n_bits}")
        _check_uint_range(self.row_bits, 0, self.n_bits, "row_bits")
        if self.row_bits and not entry.uses_rows:
            raise ValueError(
                f"row_bits is only meaningful for row-pruning kinds "
                f"(got kind={self.kind!r})")

    # -------------------------------------------------- derived views --

    @property
    def is_exact(self) -> bool:
        return get_multiplier(self.kind).is_exact

    @property
    def effective_trunc_bits(self) -> int:
        """``trunc_bits`` when the kind honors it, else 0.

        Canonical form for table caching: two specs with the same
        effective fields compile to the same LUT.
        """
        return self.trunc_bits if get_multiplier(self.kind).uses_trunc \
            else 0

    @property
    def effective_row_bits(self) -> int:
        return self.row_bits if get_multiplier(self.kind).uses_rows else 0

    @property
    def product_bits(self) -> int:
        """Width of the full product bus."""
        return 2 * self.n_bits

    @property
    def short_name(self) -> str:
        tag = f"{self.kind}-n{self.n_bits}"
        if get_multiplier(self.kind).uses_trunc:
            tag += f"t{self.trunc_bits}"
        if get_multiplier(self.kind).uses_rows:
            tag += f"v{self.row_bits}"
        return tag


@dataclasses.dataclass(frozen=True)
class MacSpec:
    """A multiply-accumulate configuration: products through ``mul``,
    accumulations through ``adder``."""

    adder: AdderSpec
    mul: MulSpec

    def __post_init__(self):
        if not isinstance(self.adder, AdderSpec):
            raise TypeError(f"adder must be an AdderSpec, got "
                            f"{type(self.adder).__name__}")
        if not isinstance(self.mul, MulSpec):
            raise TypeError(f"mul must be a MulSpec, got "
                            f"{type(self.mul).__name__}")

    @property
    def short_name(self) -> str:
        return f"{self.adder.short_name}+{self.mul.short_name}"


def default_mul_spec(kind: str, n_bits: int = 8) -> MulSpec:
    """A mid-accuracy configuration for ``kind`` at ``n_bits`` (the
    resolution applied when ``make_engine(..., mul="truncated")`` is given
    a bare kind string)."""
    entry = get_multiplier(kind)
    if entry.is_exact:
        return MulSpec(kind=kind, n_bits=n_bits)
    trunc = n_bits // 2 if entry.uses_trunc else 0
    if entry.trunc_margin:
        # Mitchell: the operand-truncation knob defaults off — the
        # logarithmic approximation itself already carries the error.
        trunc = 0
    rows = n_bits // 4 if entry.uses_rows else 0
    return MulSpec(kind=kind, n_bits=n_bits, trunc_bits=trunc,
                   row_bits=rows)


def _registered() -> tuple:
    from repro_torch.ax.mul.registry import registered_multipliers
    return registered_multipliers()
