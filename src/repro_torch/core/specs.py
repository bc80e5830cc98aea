"""Adder specifications (the port's own copy of ``repro.core.specs``).

An :class:`AdderSpec` fully determines the bit-level behaviour of one of the
static approximate adders studied by the paper (plus the accurate baseline).

The set of legal ``kind`` values — and the per-kind structural constraints
(minimum LSM width, constant-section headroom) — are derived from the
adder registry (:mod:`repro_torch.ax.registry`), so adders registered by any
module validate and enumerate here without edits to core.  ``ALL_KINDS``,
``TABLE1_KINDS`` and ``CONST_KINDS`` are computed on attribute access
(PEP 562) and therefore always reflect the live registry.

Paper defaults (Section IV): N=32, m=10 (approximate LSM width), k=5
(constant-one section width) — "consistent with [15] and [16]".
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Adder kinds, in the order used by the paper's Table I.
ACCURATE = "accurate"
LOA = "loa"
LOAWA = "loawa"
OLOCA = "oloca"
HERLOA = "herloa"
M_HERLOA = "m_herloa"
HALOC_AXA = "haloc_axa"
# Bonus baseline from the background section (Zhu et al. [11]).
ETA = "eta"

#: Derived from the adder registry on access (see module docstring):
#:   ALL_KINDS     every registered kind, Table-I order first
#:   TABLE1_KINDS  kinds compared in the paper's Table I
#:   CONST_KINDS   kinds whose LSM has a constant-one lower section
_REGISTRY_DERIVED = ("ALL_KINDS", "TABLE1_KINDS", "CONST_KINDS")


def __getattr__(name: str):
    if name in _REGISTRY_DERIVED:
        from repro_torch.ax import registry
        if name == "ALL_KINDS":
            return registry.registered_kinds()
        if name == "TABLE1_KINDS":
            return registry.table1_kinds()
        return frozenset(registry.const_kinds())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _entry(kind: str):
    """Registry entry for ``kind``; ValueError when unregistered."""
    from repro_torch.ax.registry import get_adder
    try:
        return get_adder(kind)
    except KeyError:
        raise ValueError(f"unknown adder kind {kind!r}") from None


@dataclasses.dataclass(frozen=True)
class AdderSpec:
    """Static approximate adder configuration.

    Attributes:
      kind: one of :data:`ALL_KINDS` (i.e. any registered adder).
      n_bits: total adder width N (operands are N-bit unsigned; the sum has
        N+1 significant bits).
      lsm_bits: approximate LSM width m. The MSM (exact part) is N-m bits.
      const_bits: constant-one section width k (only meaningful for kinds
        registered with ``const_section=True``; ignored for the others).
    """

    kind: str
    n_bits: int = 32
    lsm_bits: int = 10
    const_bits: int = 5

    def __post_init__(self):
        from repro_torch.ax.registry import _check_uint_range
        entry = _entry(self.kind)
        if entry.is_exact:
            return
        _check_uint_range(self.lsm_bits, 1, self.n_bits, "lsm_bits",
                          context=f"m of an N={self.n_bits} adder")
        k = self.const_bits if entry.const_section else 0
        _check_uint_range(k, 0, self.lsm_bits, "const_bits",
                          context=f"k of an m={self.lsm_bits} LSM")
        if self.lsm_bits < entry.min_lsm_bits:
            raise ValueError(
                f"{self.kind} needs lsm_bits >= {entry.min_lsm_bits}")
        if entry.const_margin and k > self.lsm_bits - entry.const_margin:
            raise ValueError(
                f"{self.kind} needs const_bits <= lsm_bits - "
                f"{entry.const_margin} (two HA / error-reduction "
                f"positions); got k={k}, m={self.lsm_bits}"
            )

    @property
    def effective_const_bits(self) -> int:
        return self.const_bits if _entry(self.kind).const_section else 0

    @property
    def msm_bits(self) -> int:
        return self.n_bits - (0 if _entry(self.kind).is_exact
                              else self.lsm_bits)

    def replace(self, **kw) -> "AdderSpec":
        return dataclasses.replace(self, **kw)

    @property
    def short_name(self) -> str:
        entry = _entry(self.kind)
        if entry.is_exact:
            return f"{self.kind}{self.n_bits}"
        k = self.effective_const_bits
        return f"{self.kind}-n{self.n_bits}m{self.lsm_bits}" + (
            f"k{k}" if entry.const_section else ""
        )


def paper_spec(kind: str, n_bits: int = 32, lsm_bits: int = 10,
               const_bits: int = 5) -> AdderSpec:
    """Spec with the paper's Section-IV parameters (N=32, m=10, k=5)."""
    return AdderSpec(kind=kind, n_bits=n_bits, lsm_bits=lsm_bits,
                     const_bits=const_bits if _entry(kind).const_section
                     else 0)


def table1_specs() -> Tuple[AdderSpec, ...]:
    """The seven adders of the paper's Table I at N=32, m=10, k=5."""
    from repro_torch.ax.registry import table1_kinds
    return tuple(paper_spec(kind) for kind in table1_kinds())
