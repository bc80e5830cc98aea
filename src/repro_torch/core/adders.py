"""Bit-exact behavioral models of the paper's approximate adders.

Each adder registers itself with the :mod:`repro_torch.ax` adder registry
(``@register_adder``), pairing the reference form with its fused variant
where one exists; :func:`approx_add` dispatches through that registry,
and call sites outside core consume these models through
``repro_torch.ax.make_engine``.  This module is the port's own copy of
``repro.core.adders`` (the port imports nothing of the reference package).

Every function below is written with *operators only* (``& | ^ >> << + *``)
so the SAME code path runs on

- ``numpy`` arrays (uint64), and
- ``torch`` int64 tensors holding the unsigned pattern — the plain
  versions of the port's kernels (torch's CPU ``uint32`` has no add,
  shift or compare, so the lanes are int64).

The CUDA device functions in ``repro_torch/csrc/adders.cuh`` are the
same formulas on ``uint32`` lanes, one per registered kind.

Semantics
---------
Operands ``a`` and ``b`` are N-bit unsigned values stored in a container
dtype with at least N+1 bits (the sum has N+1 significant bits).  For
two's-complement fixed-point use the same functions apply bit-identically;
interpret the low N bits of the result modulo 2^N.

The adder family (paper Section II/III), with m = LSM width, k = constant
section width, H = high parts ``a >> m``:

  accurate   S = a + b
  LOA        S[m-1:0] = A|B;                         Cin = A[m-1]&B[m-1]
  LOAWA      S[m-1:0] = A|B;                         Cin = 0
  OLOCA      S[k-1:0] = 1; S[m-1:k] = A|B;           Cin = A[m-1]&B[m-1]
  ETA        left-to-right: exact until first (1,1) pair, then all-1s; Cin=0
  HERLOA     S[m-1] = P1|G2; S[m-2] = X2|(P1&G2); S[m-3:0] = A|B; Cin = G1
  M-HERLOA   HERLOA with S[k-1:0] = 1
  HALOC-AxA  S[m-1] = P1|G2; S[m-2] = X2; S[m-3:k] = A|B; S[k-1:0] = 1;
             Cin = G1                                 (paper Section III)

where  G1 = A[m-1]&B[m-1], P1 = A[m-1]^B[m-1],
       G2 = A[m-2]&B[m-2], X2 = A[m-2]^B[m-2].

Model validation (see tests + EXPERIMENTS.md): all four LSM treatments of
the two MSBs reproduce the paper's Fig 3 truth table exactly, including the
single HALOC-AxA error case (11+01 -> 010) — this pins S[m-1] to the
OR-merge of the second half-adder's carry (an XOR-merge would give 000 and
a ~52% higher MED than Table I).  With these models the Table-I error
metrics are reproduced to <0.5% for LOA/LOAWA/OLOCA/HALOC-AxA and ~2-3%
for HERLOA/M-HERLOA (whose exact lower-bit error-compensation scheme is
reconstructed from the reference papers; the alternative "force lower bits
to 1 on the error case" variant lands ~10% BELOW Table I, so the
no-forcing variant is used).
"""

from __future__ import annotations

from repro_torch.ax.registry import get_adder, register_adder
from repro_torch.core import specs as specs_lib
from repro_torch.core.specs import AdderSpec


def _ones(width: int) -> int:
    return (1 << width) - 1


def _split_bits(a, b, m: int):
    """Top-two-LSM-bit signals G1, P1, G2, X2 (each 0/1 valued)."""
    a1 = (a >> (m - 1)) & 1
    b1 = (b >> (m - 1)) & 1
    a2 = (a >> (m - 2)) & 1
    b2 = (b >> (m - 2)) & 1
    g1 = a1 & b1
    p1 = a1 ^ b1
    g2 = a2 & b2
    x2 = a2 ^ b2
    return g1, p1, g2, x2


@register_adder(specs_lib.ACCURATE, table1=True, order=0, is_exact=True)
def accurate_add(a, b, spec: AdderSpec):
    return a + b


def loa_add(a, b, spec: AdderSpec):
    m = spec.lsm_bits
    low_mask = _ones(m)
    cin = ((a >> (m - 1)) & (b >> (m - 1))) & 1
    low = (a | b) & low_mask
    high = (a >> m) + (b >> m) + cin
    return (high << m) | low


def loa_add_fast(a, b, spec: AdderSpec):
    """Fused LOA (bit-identical): clearing the low m-1 bits of each
    operand and adding once yields the MSM sum WITH the speculated
    carry-in G1 above bit m and P1 at bit m-1 (see haloc_axa_add_fast),
    so G1 is never extracted to bit 0; the stray P1 bit is cleared and
    the OR low part merged in place."""
    m = spec.lsm_bits
    lo = _ones(m - 1)
    t = (a - (a & lo)) + (b - (b & lo))
    return (t - (t & (1 << (m - 1)))) | ((a | b) & _ones(m))


def loawa_add(a, b, spec: AdderSpec):
    m = spec.lsm_bits
    low_mask = _ones(m)
    low = (a | b) & low_mask
    high = (a >> m) + (b >> m)
    return (high << m) | low


def loawa_add_fast(a, b, spec: AdderSpec):
    """Fused LOAWA (bit-identical): with no carry-in, clearing ALL low m
    bits makes the single add produce exactly the shifted MSM sum, so
    the whole adder is one add and one OR-merge."""
    m = spec.lsm_bits
    lo = _ones(m)
    return ((a - (a & lo)) + (b - (b & lo))) | ((a | b) & lo)


def oloca_add(a, b, spec: AdderSpec):
    m, k = spec.lsm_bits, spec.const_bits
    const_mask = _ones(k)
    or_mask = _ones(m) ^ const_mask  # bits k..m-1
    if m == k:
        cin = 0
        low = const_mask
    else:
        cin = ((a >> (m - 1)) & (b >> (m - 1))) & 1
        low = ((a | b) & or_mask) | const_mask
    high = (a >> m) + (b >> m) + cin
    return (high << m) | low


def oloca_add_fast(a, b, spec: AdderSpec):
    """Fused OLOCA (bit-identical): the LOA fusion with the constant-one
    section ORed in.  The degenerate m == k partition has no OR section
    and no carry-in, so it reduces to the LOAWA fusion."""
    m, k = spec.lsm_bits, spec.const_bits
    if m == k:
        lo = _ones(m)
        return ((a - (a & lo)) + (b - (b & lo))) | _ones(k)
    lo = _ones(m - 1)
    t = (a - (a & lo)) + (b - (b & lo))
    or_mask = _ones(m) ^ _ones(k)
    return (t - (t & (1 << (m - 1)))) | ((a | b) & or_mask) | _ones(k)


register_adder(specs_lib.LOA, fast_impl=loa_add_fast, table1=True,
               order=1)(loa_add)
register_adder(specs_lib.LOAWA, fast_impl=loawa_add_fast, table1=True,
               order=2)(loawa_add)
register_adder(specs_lib.OLOCA, fast_impl=oloca_add_fast, table1=True,
               order=3, const_section=True)(oloca_add)


@register_adder(specs_lib.ETA, order=7)
def eta_add(a, b, spec: AdderSpec):
    """Error-tolerant adder (Zhu et al. [11]) — bonus baseline.

    The LSM is scanned from MSB to LSB: positions add exactly with NO carry
    propagation until the first (1,1) operand pair; from that position down
    every sum bit is forced to 1.  Vectorized: a position is "poisoned" iff
    any position >= it (within the LSM) has a (1,1) pair.
    """
    m = spec.lsm_bits
    low_mask = _ones(m)
    both = a & b & low_mask
    # poison[i] = OR of both[j] for j >= i  — suffix-OR via bit smearing:
    # smear the generate bits downward (toward LSB).
    poison = both
    shift = 1
    while shift < m:
        poison = poison | (poison >> shift)
        shift <<= 1
    poison = poison & low_mask
    exact_low = (a ^ b) & low_mask  # no-carry addition of clean positions
    low = (exact_low & ~poison) | poison
    high = (a >> m) + (b >> m)
    return (high << m) | low


@register_adder(specs_lib.HERLOA, table1=True, order=4, min_lsm_bits=2)
def herloa_add(a, b, spec: AdderSpec):
    m = spec.lsm_bits
    g1, p1, g2, x2 = _split_bits(a, b, m)
    err = p1 & g2
    s_m1 = p1 | g2
    s_m2 = x2 | err
    rest_mask = _ones(m - 2)
    rest = (a | b) & rest_mask
    low = (s_m1 << (m - 1)) | (s_m2 << (m - 2)) | rest
    high = (a >> m) + (b >> m) + g1
    return (high << m) | low


@register_adder(specs_lib.M_HERLOA, table1=True, order=5, const_section=True,
                min_lsm_bits=2, const_margin=2)
def m_herloa_add(a, b, spec: AdderSpec):
    m, k = spec.lsm_bits, spec.const_bits
    g1, p1, g2, x2 = _split_bits(a, b, m)
    err = p1 & g2
    s_m1 = p1 | g2
    s_m2 = x2 | err
    const_mask = _ones(k)
    rest_mask = _ones(m - 2) ^ const_mask  # bits k..m-3
    rest = ((a | b) & rest_mask) | const_mask
    low = (s_m1 << (m - 1)) | (s_m2 << (m - 2)) | rest
    high = (a >> m) + (b >> m) + g1
    return (high << m) | low


def haloc_axa_add(a, b, spec: AdderSpec):
    """The proposed adder (paper Section III, Fig 2).

    Two half-adders on the LSM's two MSB pairs; the (m-2) HA carry is
    propagated into S[m-1]; the (m-1) HA carry is the MSM carry-in.  Bits
    k..m-3 are bitwise OR; bits k-1..0 are constant 1.
    """
    m, k = spec.lsm_bits, spec.const_bits
    g1, p1, g2, x2 = _split_bits(a, b, m)
    s_m1 = p1 | g2
    s_m2 = x2
    const_mask = _ones(k)
    or_mask = _ones(m - 2) ^ const_mask  # bits k..m-3
    low = (
        (s_m1 << (m - 1))
        | (s_m2 << (m - 2))
        | ((a | b) & or_mask)
        | const_mask
    )
    high = (a >> m) + (b >> m) + g1
    return (high << m) | low


def haloc_axa_add_fast(a, b, spec: AdderSpec):
    """Algebraically fused HALOC-AxA (bit-identical, ~30% fewer vector ops).

    Key identity: masking both operands' low m-1 bits and adding once
    produces the MSM sum WITH the speculated carry-in AND the P1 bit:

        t = (a & ~ones(m-1)) + (b & ~ones(m-1))
          = (high_a + high_b + G1) << m  |  P1 << (m-1)

    so the per-bit extractions of G1/P1 disappear; G2/X2 are computed in
    place at bit m-2 (no shifts to bit 0 and back).  Used on the model/
    kernel hot path; the reference form above stays as the oracle."""
    m, k = spec.lsm_bits, spec.const_bits
    lo = _ones(m - 1)
    # x - (x & lo) clears the low m-1 bits without a negative-literal mask
    # (container may be an unsigned numpy dtype).
    t = (a - (a & lo)) + (b - (b & lo))
    bit_m2 = 1 << (m - 2)
    g2b = (a & b) & bit_m2
    x2b = (a ^ b) & bit_m2
    or_mask = _ones(m - 2) ^ _ones(k)
    return (t | (g2b << 1) | x2b | ((a | b) & or_mask)) | _ones(k)


# The proposed adder registers its reference/fused pair once both forms
# are defined; every other entry registers at its decorator above.
register_adder(specs_lib.HALOC_AXA, fast_impl=haloc_axa_add_fast,
               table1=True, order=6, const_section=True, min_lsm_bits=2,
               const_margin=2)(haloc_axa_add)


def approx_add(a, b, spec: AdderSpec, fast: bool = False):
    """Dispatch on ``spec.kind`` via the adder registry.  Works for numpy
    arrays and torch integer tensors.

    ``a``/``b`` must hold N-bit unsigned values in a container with at least
    N+1 bits.  The full (N+1)-bit sum is returned in the container dtype.
    ``fast=True`` selects the registered algebraically-fused variant where
    one exists (bit-identical; fewer vector ops — see haloc_axa_add_fast).
    """
    try:
        entry = get_adder(spec.kind)
    except KeyError:  # pragma: no cover - guarded by AdderSpec validation
        raise ValueError(f"unknown adder kind {spec.kind!r}") from None
    # Degenerate LSM widths fall back cleanly: the HERLOA/HALOC families
    # require m >= 2 (enforced by AdderSpec); LOA/OLOCA work for any m >= 1.
    return entry.select(fast)(a, b, spec)


def approx_add_mod(a, b, spec: AdderSpec, fast: bool = False):
    """Approximate add reduced modulo 2^N (drops the carry-out).

    This is the right primitive for two's-complement fixed-point dataflows
    (FFT butterflies, residual streams) where operands are signed and the
    container dtype is wider than N.  When N equals the container width
    the reduction is the container's natural wraparound.
    """
    s = approx_add(a, b, spec, fast=fast)
    width = 8 * s.dtype.itemsize if hasattr(s, "dtype") else 64
    if spec.n_bits < width:
        return s & _ones(spec.n_bits)
    return s


def lsm_error_bound(spec: AdderSpec) -> int:
    """A (loose) static bound on |approx - exact|.

    All LSM families only err in the low-m-plus-carry region: the exact and
    approximate sums agree above bit m except for the speculated carry-in,
    so |ED| < 2^(m+1).  (Tightened per-kind bounds are exercised by the
    property tests.)
    """
    if spec.kind == specs_lib.ACCURATE:
        return 0
    return 1 << (spec.lsm_bits + 1)
