// Device functions of the approximate multiplier family: one per
// registered kind, each in its reference and fused form.
//
// Each is the formula of repro_torch/ax/mul/impls.py (and of the
// reference package's ax/mul/impls.py) on uint32 lanes: it takes two
// N-bit unsigned operands and returns the full approximate product.
// MAX_MUL_BITS = 15 keeps every intermediate inside 32 bits (Mitchell's
// 2q needs 2N + 1 <= 31), so the lanes never wrap on valid operands.
//
// The kind ids (MUL_KIND_*) come from the build's -D flags, set from the
// one table in repro_torch/kernels/_build.py.  A kind registered from
// Python has no device function, and the wrappers raise before they
// launch.
#pragma once

#include <cstdint>

#include "adders.cuh"

#if !defined(MUL_KIND_ACCURATE) || !defined(MUL_KIND_TRUNCATED) || \
    !defined(MUL_KIND_BROKEN_ARRAY) || !defined(MUL_KIND_MITCHELL)
#error "build with repro_torch/kernels/_build.py: it passes the -D tables"
#endif

namespace repro_torch {

// One multiplier: kind id, operand width N, the effective truncation
// (trunc_bits, or the HBL) and row break (VBL), and whether the fused
// form is selected (bit-identical).
struct MulParams {
  int kind;
  int n_bits;
  int trunc;
  int rows;
  int fast;
};

// Row i contributes (a with its low max(t - i, 0) bits cleared) * b_i << i.
__device__ __forceinline__ uint32_t truncated_mul(uint32_t a, uint32_t b,
                                                  int n, int t) {
  uint32_t acc = 0u;
  for (int i = 0; i < n; ++i) {
    int keep = t > i ? t - i : 0;
    uint32_t pp = ((a >> keep) << keep) * ((b >> i) & 1u);
    acc += pp << i;
  }
  return acc;
}

// The exact product minus the mass of the dropped low triangle.
__device__ __forceinline__ uint32_t truncated_mul_fast(uint32_t a, uint32_t b,
                                                       int t) {
  uint32_t d = 0u;
  uint32_t al = a & ones(t);
  for (int i = 0; i < t; ++i) {
    d += ((al & ones(t - i)) * ((b >> i) & 1u)) << i;
  }
  return a * b - d;
}

// Cell (i, j) survives iff j >= max(vbl, hbl - i).
__device__ __forceinline__ uint32_t broken_array_mul(uint32_t a, uint32_t b,
                                                     int n, int hbl,
                                                     int vbl) {
  uint32_t acc = 0u;
  for (int i = 0; i < n; ++i) {
    int cut = hbl - i > vbl ? hbl - i : vbl;
    uint32_t pp = ((a >> cut) << cut) * ((b >> i) & 1u);
    acc += pp << i;
  }
  return acc;
}

__device__ __forceinline__ uint32_t broken_array_mul_fast(uint32_t a,
                                                          uint32_t b, int hbl,
                                                          int vbl) {
  uint32_t ah = a - (a & ones(vbl));
  uint32_t d = 0u;
  for (int i = 0; i < (hbl > vbl ? hbl - vbl : 0); ++i) {
    d += ((ah & ones(hbl - i)) * ((b >> i) & 1u)) << i;
  }
  return ah * b - d;
}

// Power-of-two floor of x (0 for x == 0), by a bit smear over n bits.
__device__ __forceinline__ uint32_t msb_isolate(uint32_t x, int n) {
  uint32_t s = x;
  for (int shift = 1; shift < n; shift <<= 1) s |= s >> shift;
  return s - (s >> 1);
}

// Mitchell: base = msa * msb, q = ma * msb + mb * msa; base + q when
// q < base, else 2q.
__device__ __forceinline__ uint32_t mitchell_mul(uint32_t a, uint32_t b, int n,
                                                 int t) {
  if (t) {
    a -= a & ones(t);
    b -= b & ones(t);
  }
  uint32_t msa = msb_isolate(a, n), msb = msb_isolate(b, n);
  uint32_t ma = a - msa, mb = b - msb;
  uint32_t base = msa * msb;
  uint32_t q = ma * msb + mb * msa;
  uint32_t lt = q < base ? 1u : 0u;
  return (q + q) + (base - q) * lt;
}

__device__ __forceinline__ uint32_t mitchell_mul_fast(uint32_t a, uint32_t b,
                                                      int n, int t) {
  if (t) {
    a -= a & ones(t);
    b -= b & ones(t);
  }
  uint32_t msa = msb_isolate(a, n), msb = msb_isolate(b, n);
  uint32_t base = msa * msb;
  uint32_t s1 = a * msb + (b - msb) * msa;  // == base + q
  uint32_t two_base = base + base;
  uint32_t lt = s1 < two_base ? 1u : 0u;
  return (s1 + s1 - two_base) + (two_base - s1) * lt;
}

__device__ __forceinline__ uint32_t approx_mul(uint32_t a, uint32_t b,
                                               const MulParams& p) {
  switch (p.kind) {
    case MUL_KIND_TRUNCATED:
      return p.fast ? truncated_mul_fast(a, b, p.trunc)
                    : truncated_mul(a, b, p.n_bits, p.trunc);
    case MUL_KIND_BROKEN_ARRAY:
      return p.fast ? broken_array_mul_fast(a, b, p.trunc, p.rows)
                    : broken_array_mul(a, b, p.n_bits, p.trunc, p.rows);
    case MUL_KIND_MITCHELL:
      return p.fast ? mitchell_mul_fast(a, b, p.n_bits, p.trunc)
                    : mitchell_mul(a, b, p.n_bits, p.trunc);
    default:
      return a * b;
  }
}

inline MulParams make_mul(int kind, int n_bits, int trunc, int rows,
                          int fast) {
  MulParams p;
  p.kind = kind;
  p.n_bits = n_bits;
  p.trunc = trunc;
  p.rows = rows;
  p.fast = fast;
  return p;
}

}  // namespace repro_torch
