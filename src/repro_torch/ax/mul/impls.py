"""Builtin approximate multiplier implementations (the port's own copy
of ``repro.ax.mul.impls``).

Same portability contract as :mod:`repro_torch.core.adders`: every
function uses only operators (``& | ^ + - * >> <<`` and comparisons)
plus static Python loops over bit positions, so the identical code runs
on numpy uint64 containers (the table builders of
:mod:`repro_torch.ax.mul.lut`) and on torch int64 tensors holding the
unsigned pattern (the plain versions of the port's kernels; torch's CPU
``uint32`` has no arithmetic).  Operands are N-bit unsigned values in a
container with at least ``2*N + 1`` bits of room; the return value is
the full (approximate) product.  ``repro_torch/csrc/muls.cuh`` holds the
same formulas on uint32 lanes for the CUDA kernels.

Three families:

* ``truncated`` — drop every partial-product cell in the low ``t``
  columns (cell at row *i*, multiplicand bit *j* is dropped when
  ``i + j < t``).  Classic fixed-width truncation.
* ``broken_array`` — BAM-style horizontal+vertical break: cell
  ``(i, j)`` survives iff ``j >= max(row_bits, trunc_bits - i)``.
  With ``row_bits=0`` it degenerates to ``truncated``.
* ``mitchell`` — Mitchell's logarithmic multiplier: linear
  interpolation of log2 between powers of two, add in the log domain,
  linear antilog.  Integer-exact formulation below (no floats); an
  optional operand truncation ``t`` zeroes each operand's low bits
  first.

Every kind returns 0 when either operand is 0: the MAC datapaths rely
on this to zero-pad ragged K tiles without changing results.  All three
approximate kinds *underestimate*: ``approx(a,b) <= a*b``.
"""

from __future__ import annotations

from repro_torch.ax.mul.registry import get_multiplier, register_multiplier


def _ones(width: int) -> int:
    return (1 << width) - 1


# ------------------------------------------------------------ accurate --

@register_multiplier("accurate", order=0, is_exact=True)
def accurate_mul(a, b, spec):
    """Exact array multiplier (the baseline)."""
    return a * b


# ----------------------------------------------------------- truncated --

def truncated_mul_fast(a, b, spec):
    """Fused truncation: exact product minus the dropped low triangle.

    ``d = sum_{i<t} ((a mod 2^{t-i}) * b_i) << i`` is exactly the mass
    of the dropped cells, so ``a*b - d`` is bit-identical to the
    cell-by-cell reference — but the loop runs ``t`` times, not ``n``.
    """
    t = spec.effective_trunc_bits
    d = a ^ a
    al = a & _ones(t)
    for i in range(t):
        d = d + (((al & _ones(t - i)) * ((b >> i) & 1)) << i)
    return a * b - d


@register_multiplier("truncated", order=1, uses_trunc=True,
                     fast_impl=truncated_mul_fast, low_delta=True)
def truncated_mul(a, b, spec):
    """Column-truncated array multiplier (reference form).

    Row ``i`` contributes ``(a with its low max(t-i, 0) bits cleared)
    * b_i << i`` — exactly the surviving cells of the pruned array.
    """
    n = spec.n_bits
    t = spec.effective_trunc_bits
    acc = a ^ a
    for i in range(n):
        keep = t - i if t > i else 0
        pp = ((a >> keep) << keep) * ((b >> i) & 1)
        acc = acc + (pp << i)
    return acc


# -------------------------------------------------------- broken array --

def broken_array_mul_fast(a, b, spec):
    """Fused BAM: clear the VBL multiplicand columns once, then subtract
    the remaining HBL triangle from the exact product of the cleared
    multiplicand."""
    hbl = spec.effective_trunc_bits
    vbl = spec.effective_row_bits
    ah = a - (a & _ones(vbl))
    d = a ^ a
    for i in range(hbl - vbl if hbl > vbl else 0):
        d = d + (((ah & _ones(hbl - i)) * ((b >> i) & 1)) << i)
    return ah * b - d


@register_multiplier("broken_array", order=2, uses_trunc=True,
                     uses_rows=True, fast_impl=broken_array_mul_fast,
                     low_delta=True)
def broken_array_mul(a, b, spec):
    """Broken-array multiplier (reference form): cell ``(i, j)``
    survives iff ``j >= max(vbl, hbl - i)``."""
    n = spec.n_bits
    hbl = spec.effective_trunc_bits
    vbl = spec.effective_row_bits
    acc = a ^ a
    for i in range(n):
        cut = hbl - i if hbl - i > vbl else vbl
        pp = ((a >> cut) << cut) * ((b >> i) & 1)
        acc = acc + (pp << i)
    return acc


# ------------------------------------------------------------ mitchell --

def _msb_isolate(x, n_bits):
    """Power-of-two floor of ``x`` (0 for x == 0), via a static bit
    smear — no priority encoder primitives needed."""
    s = x
    shift = 1
    while shift < n_bits:
        s = s | (s >> shift)
        shift <<= 1
    return s - (s >> 1)


def mitchell_mul_fast(a, b, spec):
    """Fused Mitchell: computes ``s1 = base + q`` with two multiplies
    and selects between ``s1`` (no mantissa carry) and ``2*(s1 - base)``
    (carry) — bit-identical to the reference four-term form."""
    n = spec.n_bits
    t = spec.effective_trunc_bits
    if t:
        a = a - (a & _ones(t))
        b = b - (b & _ones(t))
    msa = _msb_isolate(a, n)
    msb = _msb_isolate(b, n)
    base = msa * msb
    s1 = a * msb + (b - msb) * msa        # == base + q
    two_base = base + base
    lt = (s1 < two_base) * ((a ^ a) + 1)  # 1 where q < base, else 0
    # q < base: s1; else 2*(s1 - base).  The masked-out branch may wrap
    # in unsigned containers; multiplying by 0 discards it.
    return (s1 + s1 - two_base) + (two_base - s1) * lt


@register_multiplier("mitchell", order=3, uses_trunc=True,
                     trunc_margin=1, fast_impl=mitchell_mul_fast)
def mitchell_mul(a, b, spec):
    """Mitchell logarithmic multiplier, integer-exact formulation.

    With ``a = 2^ka (1 + xa)`` and ``b = 2^kb (1 + xb)`` (``xa, xb``
    the fractional mantissas), Mitchell computes
    ``2^(ka+kb) (1 + xa + xb)`` when ``xa + xb < 1`` and
    ``2^(ka+kb+1) (xa + xb)`` otherwise.  In integers, with
    ``msa = 2^ka``, ``ma = a - msa``:

    * ``base = msa * msb``  (``2^(ka+kb)``)
    * ``q = ma * msb + mb * msa``  (``base * (xa + xb)``)
    * result = ``base + q`` if ``q < base`` else ``2 * q``.

    Both branches are exact integers (the shifts implicit in the
    products), so the whole operator stays in the container domain.
    Zero operands give ``msa = ma = 0`` hence product 0.
    """
    n = spec.n_bits
    t = spec.effective_trunc_bits
    if t:
        a = a - (a & _ones(t))
        b = b - (b & _ones(t))
    msa = _msb_isolate(a, n)
    msb = _msb_isolate(b, n)
    ma = a - msa
    mb = b - msb
    base = msa * msb
    q = ma * msb + mb * msa
    lt = (q < base) * ((a ^ a) + 1)
    return (q + q) + (base - q) * lt


# ----------------------------------------------------------- dispatch --

def approx_mul(a, b, spec, fast: bool = False):
    """Apply the registered multiplier for ``spec`` to container
    operands — the multiplier-side twin of ``approx_add``."""
    return get_multiplier(spec.kind).select(fast)(a, b, spec)
