"""Hardware fault injection for the approximate-adder datapath (the port
of ``repro.resilience.faults``).

One :class:`FaultSpec` drives three layers:

1. **Compiled-table corruption** (:func:`corrupt_lut`,
   :func:`faulted_delta_table`): deterministic corruption of a packed
   low-part LUT, built through the NON-cached variant
   (:func:`repro_torch.ax.lut.compile_lut_nocache`) so the shared
   :func:`~repro_torch.ax.lut.compile_lut` cache (and its device
   copies) is never polluted.
2. **Output-bus masks** (:func:`apply_fault`): AND/OR/XOR masks that the
   engine applies to every ``add``/``accumulate``/``filter_chain``
   output when a fault is installed (``make_engine(..., fault=...)``),
   on tensors on any device.  On the card this is plain
   torch after the kernel: one XOR (bit flips) or one AND or OR
   (stuck-at) an output.
3. **Seeded counter-based transient flips**
   (:func:`transient_flip_mask`): a splitmix-style 32-bit hash of
   ``(element index, seed, bit)`` decides each flip, so the flip pattern
   is a pure function of the spec — reproducible campaigns, bit-identical
   across backends.

The flip-site counter runs over the trailing two (image) axes only
(:func:`_site_index`), so a whole batch and any one image of it see the
same sites.  The mask a bit-flip fault XORs in depends only on those two
dimensions, the fault, the dtype and the device: it is built once per
such key (an LRU registered with :mod:`repro_torch.obs.caches` as
``resilience.faults.flip_mask``).

The hash runs on int64 lanes holding the 32-bit pattern (torch's CPU
``uint32`` has no multiply, shift or compare): every product is taken in
16-bit limbs and masked to 32 bits, so no int64 product overflows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.ax.lut import _delta_from_packed, compile_lut_nocache
from repro_torch.ax.registry import _check_uint_range
from repro_torch.core.specs import AdderSpec
from repro_torch.obs.caches import register_lru as _register_lru

#: Legal fault models.  ``stuck_at_0``/``stuck_at_1`` are permanent
#: (every targeted bit forced on every operation); ``bit_flip`` is
#: transient (each (element, bit) site flips with probability ``rate``,
#: decided by the counter hash).
FAULT_KINDS = ("stuck_at_0", "stuck_at_1", "bit_flip")

_GOLDEN_GAMMA = 0x9E3779B9  # splitmix odd increment
_MIX1, _MIX2 = 0x21F0AAAD, 0x735A2D97
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected hardware fault.

    Attributes:
      kind: one of :data:`FAULT_KINDS`.
      bits: targeted output-bus bit positions (validated against the
        datapath width at every injection entry point).
      rate: per-(element, bit) flip probability for ``bit_flip``;
        ignored by the permanent stuck-at kinds.
      seed: the counter-hash key for transient flips (varying the seed
        re-rolls the flip sites; stuck-at faults ignore it).
    """

    kind: str
    bits: Tuple[int, ...]
    rate: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of "
                             f"{FAULT_KINDS}")
        bits = tuple(self.bits) if not isinstance(self.bits, int) \
            else (self.bits,)
        object.__setattr__(self, "bits", bits)
        if not bits:
            raise ValueError("a FaultSpec needs at least one target bit")
        for b in bits:
            _check_uint_range(b, 0, 63, "fault bit position")
        if len(set(bits)) != len(bits):
            raise ValueError(f"duplicate fault bit positions: {bits}")
        rate = float(self.rate)
        if not 0.0 < rate <= 1.0 or rate != rate:
            raise ValueError(
                f"fault rate must be in (0, 1]; got {self.rate!r} "
                f"(negative or zero rates inject nothing — drop the "
                f"FaultSpec instead)")
        object.__setattr__(self, "rate", rate)
        _check_uint_range(self.seed, 0, (1 << 32) - 1, "fault seed")

    @property
    def mask(self) -> int:
        """OR of the targeted bit positions."""
        return functools.reduce(lambda m, b: m | (1 << b), self.bits, 0)

    @property
    def short_name(self) -> str:
        tag = {"stuck_at_0": "sa0", "stuck_at_1": "sa1",
               "bit_flip": "flip"}[self.kind]
        bits = ",".join(str(b) for b in self.bits)
        if self.kind == "bit_flip":
            return f"{tag}[{bits}]r{self.rate:g}s{self.seed}"
        return f"{tag}[{bits}]"


def validate_fault(fault: Optional["FaultSpec"], n_bits: int,
                   what: str = "datapath") -> Optional["FaultSpec"]:
    """Entry-point validation: every targeted bit must lie inside the
    ``n_bits``-wide output bus (out-of-range positions would silently
    vanish in the mod-2^N arithmetic instead of injecting)."""
    if fault is None:
        return None
    if not isinstance(fault, FaultSpec):
        raise ValueError(f"fault must be a FaultSpec or None; got "
                         f"{type(fault).__name__}")
    for b in fault.bits:
        _check_uint_range(b, 0, n_bits - 1, "fault bit position",
                          context=f"N={n_bits} {what}")
    return fault


# --------------------------------------------------- transient flips --

def _mul32(x, c: int):
    """``x * c`` mod 2^32 on int64 lanes holding 32-bit values: the
    constant in 16-bit limbs, so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _splitmix32(x):
    """The reference's splitmix-style avalanche on 32-bit values held in
    int64 lanes (tensors or numpy int64 arrays)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 15)
    return x


def transient_flip_mask(idx, fault: FaultSpec):
    """The XOR mask per element counter ``idx``: int64 lanes holding the
    reference's uint32 mask (a tensor for a tensor ``idx``, else a numpy
    int64 array).

    Counter-based: flip bit ``b`` of element ``i`` iff
    ``hash(i, seed, b) < rate * 2^32``, a pure function of
    ``(idx, fault)`` — no RNG state."""
    if isinstance(idx, torch.Tensor):
        idx = idx.to(torch.int64) & _U32
        mask = torch.zeros_like(idx)
        where = torch.where
    else:
        idx = np.asarray(idx).astype(np.int64) & _U32
        mask = np.zeros_like(idx)
        where = np.where
    # rate = 1.0 maps to threshold 2^32 - 1: P(flip) = 1 - 2^-32, the
    # closest a 32-bit comparison can get to certainty.
    thresh = min(int(fault.rate * (1 << 32)), (1 << 32) - 1)
    for b in fault.bits:
        key = ((fault.seed * 2 + 1) * _GOLDEN_GAMMA + b * _MIX1) & _U32
        h = _splitmix32(_mul32(idx, _GOLDEN_GAMMA) ^ key)
        mask = mask | where(h < thresh, (1 << b) & _U32, 0)
    return mask


def _trail(shape) -> Tuple[int, ...]:
    return tuple(shape[-2:] if len(shape) >= 2 else shape)


def _site_index(trail: Tuple[int, ...], device) -> torch.Tensor:
    """The flip-site counter for an output whose trailing (image) dims
    are ``trail``: positions over those dims, broadcast across leading
    batch dims — a fixed spatial hardware mapping."""
    n = 1
    for s in trail:
        n *= int(s)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(trail)


def _pattern(value: int, dtype: torch.dtype) -> int:
    """``value`` two's-complement-wrapped to ``dtype``'s width (the
    reference's ``_const``): bit 31 on int32 lanes, and bit N-1 or the
    all-ones mask at N equal to the container width, keep their bits
    instead of overflowing."""
    width = torch.iinfo(dtype).bits
    value &= (1 << width) - 1
    if dtype.is_signed and value >= (1 << (width - 1)):
        value -= 1 << width
    return value


def _wrap_lanes(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 lanes -> ``dtype`` holding their low bits, wrapped
    explicitly (numpy's ``astype`` of the uint32 mask)."""
    if dtype == torch.int64:
        return v
    width = torch.iinfo(dtype).bits
    v = v & ((1 << width) - 1)
    if dtype.is_signed:
        v = v - ((v >> (width - 1)) << width)
    return v.to(dtype)


@functools.lru_cache(maxsize=256)
def _flip_mask(trail: Tuple[int, ...], fault: FaultSpec, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return _wrap_lanes(transient_flip_mask(_site_index(trail, device), fault),
                       dtype)


_register_lru("resilience.faults.flip_mask", _flip_mask)


def flip_mask(shape, fault: FaultSpec, dtype: torch.dtype,
              device) -> torch.Tensor:
    """The XOR mask of a bit-flip ``fault`` for an output of ``shape``,
    as ``dtype`` on ``device``: the trailing two dims' mask, broadcast
    over the leading ones.  Built once per (trailing dims, fault, dtype,
    device)."""
    return _flip_mask(_trail(shape), fault, dtype, torch.device(device))


def apply_fault(x: torch.Tensor, fault: FaultSpec, n_bits: int,
                signed: bool = False) -> torch.Tensor:
    """Inject ``fault`` into the N-bit output bus values ``x`` (an integer
    tensor on any device; the result has its dtype).

    ``signed=True`` treats ``x`` as two's-complement N-bit containers held
    in a wider signed dtype (the ``filter_chain`` Q-domain): the value is
    reduced to its N low bits, faulted, and sign-extended back.  Every
    constant is wrapped to the container (:func:`_pattern`), so bit 31 of
    int32 lanes and bit N-1 at N equal to the container width work."""
    dt = x.dtype
    width = torch.iinfo(dt).bits
    full = _pattern((1 << n_bits) - 1, dt)
    u = (x & full) if signed else x
    if fault.kind == "stuck_at_1":
        u = u | _pattern(fault.mask, dt)
    elif fault.kind == "stuck_at_0":
        u = u & _pattern(((1 << n_bits) - 1) ^ fault.mask, dt)
    else:  # bit_flip
        u = u ^ flip_mask(x.shape, fault, dt, x.device)
    if signed:
        u = u - ((u & _pattern(1 << (n_bits - 1), dt)) << 1)
    elif fault.kind == "stuck_at_1" and n_bits < width:
        u = u & full  # targeted bits are in range, but keep the contract
    return u


# ---------------------------------------------------- LUT corruption --

def corrupt_lut(spec: AdderSpec, fault: FaultSpec) -> np.ndarray:
    """The packed low-part table of ``spec`` with ``fault`` burned in.

    Every entry's low ``m`` sum bits (and, if targeted, the
    speculated-carry bit at position ``m``) pass through the fault
    masks; for ``bit_flip`` the table index is the counter, so the
    corruption is a frozen sample of the transient fault.  Built through
    :func:`repro_torch.ax.lut.compile_lut_nocache`: the shared table is
    never touched."""
    m = spec.lsm_bits
    for b in fault.bits:
        _check_uint_range(b, 0, m, "fault bit position",
                          context=f"packed LUT entries carry m+1="
                                  f"{m + 1} bits (low sum | carry)")
    table = compile_lut_nocache(spec).copy()
    width = m + 1
    if fault.kind == "bit_flip":
        idx = np.arange(table.size, dtype=np.int64)
        table ^= transient_flip_mask(idx, fault).astype(np.uint16)
    elif fault.kind == "stuck_at_1":
        table |= np.uint16(fault.mask)
    else:
        table &= np.uint16(((1 << width) - 1) ^ fault.mask)
    table.flags.writeable = False
    return table


def faulted_delta_table(spec: AdderSpec, fault: FaultSpec) -> np.ndarray:
    """Signed full-sum error of the FAULTED datapath per low-bit pair —
    the corrupted twin of :func:`repro_torch.ax.lut.error_delta_table`
    (fault bits above ``lsm_bits`` live in the exact MSM and are not
    representable in a low-part table)."""
    return _delta_from_packed(corrupt_lut(spec, fault), spec.lsm_bits)


def faulted_mean_abs_error(spec: AdderSpec, fault: FaultSpec) -> float:
    """Exact per-add mean |error| of the faulted config under uniform
    operands — what :class:`repro_torch.obs.drift.DriftMonitor` compares
    against the healthy budget, so ``faulted_mean_abs_error >
    monitor.threshold`` predicts the trip."""
    return float(np.mean(np.abs(
        faulted_delta_table(spec, fault).astype(np.float64))))
