"""Multiplier registry: the single source of truth for which approximate
multipliers exist (the port's own copy of ``repro.ax.mul.registry``).

Mirrors the adder registry (:mod:`repro_torch.ax.registry`): every
multiplier kind is registered exactly once via
:func:`register_multiplier`, pairing a *reference* implementation (the
bit-level oracle, written with portable operators so the same code runs
on numpy arrays and torch int64 tensors) with an optional *fast*
implementation (algebraically fused, bit-identical).  The CUDA device
functions of ``repro_torch/csrc/muls.cuh`` are the builtin kinds'
formulas on uint32 lanes; a kind registered from Python has none, and
the kernels' wrappers raise for it.

New multipliers plug in from any module::

    from repro_torch.ax.mul import register_multiplier

    @register_multiplier("my_mul", order=100, uses_trunc=True)
    def my_mul(a, b, spec):
        ...

:class:`~repro_torch.ax.mul.specs.MulSpec` validation is computed from
this registry, exactly as ``AdderSpec``'s is from the adder one.

This module must stay dependency-free (no ``repro_torch.*`` imports at
module level): it is imported by ``repro_torch.ax.mul.impls`` during
registration.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MulImpl:
    """One registered multiplier kind.

    Attributes:
      kind: registry key (``spec.kind``).
      impl: reference implementation ``f(a, b, spec) -> product`` taking
        N-bit unsigned operands in a container dtype with at least 2N+1
        bits of room and returning the (possibly approximate) full
        product.
      fast_impl: optional bit-identical fused variant (hot-path form).
      order: sort key for the derived kind tuples (stable display order).
      is_exact: the accurate baseline (zero error).
      uses_trunc: whether ``spec.trunc_bits`` is meaningful (pruned
        partial-product columns for the array kinds; operand truncation
        for the logarithmic kind).
      uses_rows: whether ``spec.row_bits`` is meaningful (the vertical
        break of the broken-array family: low multiplicand bits ignored
        in every row).
      trunc_margin: require ``trunc_bits <= n_bits - trunc_margin``
        (1 for Mitchell, which must keep each operand's MSB).
      low_delta: the error ``approx(a,b) - a*b`` is a pure function of
        ``(a mod 2^t, b mod 2^t)`` with ``t = effective_trunc_bits``
        whenever ``effective_row_bits == 0`` — what unlocks the
        factorized closed-form MRED (the reference's analytics).
    """

    kind: str
    impl: Callable
    fast_impl: Optional[Callable] = None
    order: int = 1000
    is_exact: bool = False
    uses_trunc: bool = False
    uses_rows: bool = False
    trunc_margin: int = 0
    low_delta: bool = False

    def select(self, fast: bool) -> Callable:
        """The implementation to run: fused when requested and available."""
        if fast and self.fast_impl is not None:
            return self.fast_impl
        return self.impl


_MULS: Dict[str, MulImpl] = {}
_LOCK = threading.Lock()
_BUILTINS_LOADED = False


def register_multiplier(kind: str, *, fast_impl: Optional[Callable] = None,
                        order: int = 1000, is_exact: bool = False,
                        uses_trunc: bool = False, uses_rows: bool = False,
                        trunc_margin: int = 0, low_delta: bool = False):
    """Decorator registering a reference multiplier implementation.

    Returns the decorated function unchanged, so the module keeps its
    plain callables (``truncated_mul`` etc.) alongside the registry
    entry.
    """

    def deco(fn: Callable) -> Callable:
        entry = MulImpl(
            kind=kind, impl=fn, fast_impl=fast_impl, order=order,
            is_exact=is_exact, uses_trunc=uses_trunc, uses_rows=uses_rows,
            trunc_margin=trunc_margin, low_delta=low_delta)
        with _LOCK:
            prev = _MULS.get(kind)
            if prev is not None and prev.impl is not fn:
                raise ValueError(
                    f"multiplier kind {kind!r} already registered")
            _MULS[kind] = entry
        return fn

    return deco


def _ensure_builtins() -> None:
    """Load the builtin multiplier family on first registry access.

    The builtin implementations live in ``repro_torch.ax.mul.impls``;
    importing that module runs their ``@register_multiplier``
    decorators.  Deferred so this module stays import-light (same
    pattern as the adder registry).
    """
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    # Flag set only AFTER a successful import (see the adder registry
    # for why _LOCK must not be held across the import).
    import repro_torch.ax.mul.impls  # noqa: F401  (registers on import)
    _BUILTINS_LOADED = True


def get_multiplier(kind: str) -> MulImpl:
    """Registry entry for ``kind``; raises KeyError when unknown."""
    _ensure_builtins()
    return _MULS[kind]


def registered_multipliers() -> Tuple[str, ...]:
    """Every registered multiplier kind, in display order."""
    _ensure_builtins()
    return tuple(k for k, _ in sorted(
        _MULS.items(), key=lambda kv: (kv[1].order, kv[0])))


def unregister_multiplier(kind: str) -> None:
    """Remove a registered kind (test/plugin teardown helper)."""
    with _LOCK:
        _MULS.pop(kind, None)
