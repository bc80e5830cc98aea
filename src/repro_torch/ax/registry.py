"""Adder registry: the single source of truth for which approximate
adders exist (the port's own copy of ``repro.ax.registry``).

A kind registered here runs on the ``"torch"`` backend at once; the
``"cuda"`` backend runs only the kinds that have a device function in
``repro_torch/csrc/adders.cuh`` and raises ``NotImplementedError`` for
any other.

Every adder kind is registered exactly once via :func:`register_adder`,
pairing a *reference* implementation (the bit-level oracle, written with
portable operators so the same code runs on numpy arrays and torch
tensors) with an
optional *fast* implementation (algebraically fused, bit-identical — used
on hot paths and cross-checked against the reference by the test suite).

The registry replaces the old closed ``_IMPLS`` dict in
``repro_torch.core.adders``: new adders — including heterogeneous block-based
configurations from the wider literature — plug in from any module
without editing core::

    from repro_torch.ax import register_adder

    @register_adder("my_adder", order=100)
    def my_add(a, b, spec):
        ...

``ALL_KINDS`` / ``TABLE1_KINDS`` / ``CONST_KINDS`` in
``repro_torch.core.specs`` are *derived* from this registry, as is
:class:`~repro_torch.core.specs.AdderSpec` validation (via the per-entry
``min_lsm_bits`` / ``const_margin`` constraints).

This module must stay dependency-free (no ``repro_torch.*`` imports at module
level): it is imported by ``repro_torch.core.adders`` during registration.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AdderImpl:
    """One registered adder kind.

    Attributes:
      kind: registry key (``spec.kind``).
      impl: reference implementation ``f(a, b, spec) -> sum`` returning the
        full (N+1)-bit unsigned sum in the container dtype.
      fast_impl: optional bit-identical fused variant (hot-path form).
      const_section: whether ``spec.const_bits`` (k) is meaningful.
      table1: whether the kind appears in the paper's Table I.
      order: sort key for the derived kind tuples (stable display order).
      is_exact: the accurate baseline (no LSM, zero error).
      min_lsm_bits: minimum legal ``lsm_bits`` (2 for the two-half-adder
        families).
      const_margin: require ``const_bits <= lsm_bits - const_margin``
        (2 for M-HERLOA / HALOC-AxA, whose top two LSM bits are special).
    """

    kind: str
    impl: Callable
    fast_impl: Optional[Callable] = None
    const_section: bool = False
    table1: bool = False
    order: int = 1000
    is_exact: bool = False
    min_lsm_bits: int = 1
    const_margin: int = 0

    def select(self, fast: bool) -> Callable:
        """The implementation to run: fused when requested and available."""
        if fast and self.fast_impl is not None:
            return self.fast_impl
        return self.impl


_ADDERS: Dict[str, AdderImpl] = {}
_LOCK = threading.Lock()
_BUILTINS_LOADED = False


def _check_uint_range(value, lo: int, hi: int, what: str,
                      context: str = "") -> int:
    """Validate an integral knob against an inclusive ``[lo, hi]`` range.

    THE shared range check of the spec layer (adder/multiplier spec
    validation, fault-injection bit positions): it rejects
    non-integral values and out-of-range integers with one actionable
    message instead of letting them silently wrap in the bit
    arithmetic downstream.  Returns the value as a plain ``int``.
    Lives here because this module is dependency-free (importable by
    ``repro_torch.core`` and ``repro_torch.resilience`` alike).
    """
    if isinstance(value, bool) or not isinstance(value, (int,)):
        raise ValueError(
            f"{what} must be an integer in [{lo}, {hi}]; got "
            f"{value!r}" + (f" ({context})" if context else ""))
    if not lo <= value <= hi:
        raise ValueError(
            f"{what} must be in [{lo}, {hi}]; got {value}"
            + (f" ({context})" if context else ""))
    return int(value)


def register_adder(kind: str, *, fast_impl: Optional[Callable] = None,
                   const_section: bool = False, table1: bool = False,
                   order: int = 1000, is_exact: bool = False,
                   min_lsm_bits: int = 1, const_margin: int = 0):
    """Decorator registering a reference adder implementation.

    Returns the decorated function unchanged, so the module keeps its
    plain callables (``loa_add`` etc.) alongside the registry entry.
    """

    def deco(fn: Callable) -> Callable:
        entry = AdderImpl(
            kind=kind, impl=fn, fast_impl=fast_impl,
            const_section=const_section, table1=table1, order=order,
            is_exact=is_exact, min_lsm_bits=min_lsm_bits,
            const_margin=const_margin)
        with _LOCK:
            prev = _ADDERS.get(kind)
            if prev is not None and prev.impl is not fn:
                raise ValueError(f"adder kind {kind!r} already registered")
            _ADDERS[kind] = entry
        return fn

    return deco


def _ensure_builtins() -> None:
    """Load the paper's adder family on first registry access.

    The builtin implementations live in ``repro_torch.core.adders`` (they are
    the paper's contribution, not plumbing); importing that module runs
    their ``@register_adder`` decorators.  Deferred to break the
    core <-> ax import cycle.
    """
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    # Flag is set only AFTER a successful import: a failed first import
    # must propagate its real error on retry, and a concurrent caller
    # must not skip past a still-running registration (Python's import
    # lock serializes the import itself; _LOCK cannot be held here or
    # the register_adder calls inside the import would deadlock).
    import repro_torch.core.adders  # noqa: F401  (registers on import)
    _BUILTINS_LOADED = True


def get_adder(kind: str) -> AdderImpl:
    """Registry entry for ``kind``; raises KeyError when unknown."""
    _ensure_builtins()
    return _ADDERS[kind]


def registered_kinds() -> Tuple[str, ...]:
    """Every registered kind, in display order (paper's Table I first)."""
    _ensure_builtins()
    return tuple(k for k, _ in sorted(
        _ADDERS.items(), key=lambda kv: (kv[1].order, kv[0])))


def table1_kinds() -> Tuple[str, ...]:
    """Kinds compared in the paper's Table I, in the paper's order."""
    _ensure_builtins()
    return tuple(e.kind for e in sorted(
        (e for e in _ADDERS.values() if e.table1),
        key=lambda e: (e.order, e.kind)))


def const_kinds() -> Tuple[str, ...]:
    """Kinds whose LSM has a constant-one lower section of width k."""
    _ensure_builtins()
    return tuple(e.kind for e in sorted(
        (e for e in _ADDERS.values() if e.const_section),
        key=lambda e: (e.order, e.kind)))


def unregister_adder(kind: str) -> None:
    """Remove a registered kind (test/plugin teardown helper)."""
    with _LOCK:
        _ADDERS.pop(kind, None)
