// Device functions of the paper's adder family: one per registered kind.
//
// Each is the formula of repro_torch/core/adders.py (and of the reference
// package's core/adders.py) on uint32 lanes: it takes two N-bit operands
// and returns their approximate sum mod 2^N.  The lanes are uint32, so a
// shift by 32 (m = N = 32) must give 0 as it does in XLA and numpy; the
// helpers below make every shift and mask safe at a width of 32.
//
// The kind ids (KIND_*) and the sizes of the kernels' parameter structs
// (MAX_TERMS, MAX_STAGES, MAX_TAPS) come from the build's -D flags, set
// from the one table in repro_torch/kernels/_build.py.  A kind registered
// from Python has no device function, and the wrappers raise before they
// launch.
#pragma once

#include <cstdint>

#if !defined(KIND_ACCURATE) || !defined(KIND_LOA) || !defined(KIND_LOAWA) || \
    !defined(KIND_OLOCA) || !defined(KIND_HERLOA) ||                        \
    !defined(KIND_M_HERLOA) || !defined(KIND_HALOC_AXA) ||                  \
    !defined(KIND_ETA) || !defined(MAX_TERMS) || !defined(MAX_STAGES) ||     \
    !defined(MAX_TAPS)
#error "build with repro_torch/kernels/_build.py: it passes the -D tables"
#endif

namespace repro_torch {

// One adder: kind id, width N, LSM width m, constant section k, and
// whether the registered fused form is selected (bit-identical).
struct AdderParams {
  int kind;
  int n_bits;
  int m;
  int k;
  int fast;
};

__device__ __forceinline__ uint32_t shl(uint32_t x, int s) {
  return s >= 32 ? 0u : x << s;
}

__device__ __forceinline__ uint32_t shr(uint32_t x, int s) {
  return s >= 32 ? 0u : x >> s;
}

__device__ __forceinline__ uint32_t ones(int w) {
  return w >= 32 ? 0xFFFFFFFFu : (1u << w) - 1u;
}

__device__ __forceinline__ uint32_t loa_add(uint32_t a, uint32_t b, int m) {
  uint32_t cin = (shr(a, m - 1) & shr(b, m - 1)) & 1u;
  uint32_t low = (a | b) & ones(m);
  uint32_t high = shr(a, m) + shr(b, m) + cin;
  return shl(high, m) | low;
}

__device__ __forceinline__ uint32_t loa_add_fast(uint32_t a, uint32_t b,
                                                 int m) {
  uint32_t lo = ones(m - 1);
  uint32_t t = (a - (a & lo)) + (b - (b & lo));
  return (t - (t & (1u << (m - 1)))) | ((a | b) & ones(m));
}

__device__ __forceinline__ uint32_t loawa_add(uint32_t a, uint32_t b, int m) {
  uint32_t low = (a | b) & ones(m);
  uint32_t high = shr(a, m) + shr(b, m);
  return shl(high, m) | low;
}

__device__ __forceinline__ uint32_t loawa_add_fast(uint32_t a, uint32_t b,
                                                   int m) {
  uint32_t lo = ones(m);
  return ((a - (a & lo)) + (b - (b & lo))) | ((a | b) & lo);
}

__device__ __forceinline__ uint32_t oloca_add(uint32_t a, uint32_t b, int m,
                                              int k) {
  uint32_t const_mask = ones(k);
  uint32_t or_mask = ones(m) ^ const_mask;
  uint32_t cin, low;
  if (m == k) {
    cin = 0u;
    low = const_mask;
  } else {
    cin = (shr(a, m - 1) & shr(b, m - 1)) & 1u;
    low = ((a | b) & or_mask) | const_mask;
  }
  uint32_t high = shr(a, m) + shr(b, m) + cin;
  return shl(high, m) | low;
}

__device__ __forceinline__ uint32_t oloca_add_fast(uint32_t a, uint32_t b,
                                                   int m, int k) {
  if (m == k) {
    uint32_t lo = ones(m);
    return ((a - (a & lo)) + (b - (b & lo))) | ones(k);
  }
  uint32_t lo = ones(m - 1);
  uint32_t t = (a - (a & lo)) + (b - (b & lo));
  uint32_t or_mask = ones(m) ^ ones(k);
  return (t - (t & (1u << (m - 1)))) | ((a | b) & or_mask) | ones(k);
}

// Error-tolerant adder: a position is poisoned iff some position at or
// above it (within the LSM) holds a (1,1) pair; the suffix OR is a
// downward bit smear.
__device__ __forceinline__ uint32_t eta_add(uint32_t a, uint32_t b, int m) {
  uint32_t low_mask = ones(m);
  uint32_t poison = a & b & low_mask;
  for (int shift = 1; shift < m; shift <<= 1) {
    poison |= poison >> shift;
  }
  poison &= low_mask;
  uint32_t exact_low = (a ^ b) & low_mask;
  uint32_t low = (exact_low & ~poison) | poison;
  uint32_t high = shr(a, m) + shr(b, m);
  return shl(high, m) | low;
}

// HERLOA (const_k = false) and M-HERLOA (const_k = true).
__device__ __forceinline__ uint32_t herloa_add(uint32_t a, uint32_t b, int m,
                                               int k, bool const_k) {
  uint32_t a1 = shr(a, m - 1) & 1u, b1 = shr(b, m - 1) & 1u;
  uint32_t a2 = (a >> (m - 2)) & 1u, b2 = (b >> (m - 2)) & 1u;
  uint32_t g1 = a1 & b1, p1 = a1 ^ b1, g2 = a2 & b2, x2 = a2 ^ b2;
  uint32_t err = p1 & g2;
  uint32_t s_m1 = p1 | g2;
  uint32_t s_m2 = x2 | err;
  uint32_t rest;
  if (const_k) {
    rest = ((a | b) & (ones(m - 2) ^ ones(k))) | ones(k);
  } else {
    rest = (a | b) & ones(m - 2);
  }
  uint32_t low = shl(s_m1, m - 1) | shl(s_m2, m - 2) | rest;
  uint32_t high = shr(a, m) + shr(b, m) + g1;
  return shl(high, m) | low;
}

__device__ __forceinline__ uint32_t haloc_axa_add(uint32_t a, uint32_t b,
                                                  int m, int k) {
  uint32_t a1 = shr(a, m - 1) & 1u, b1 = shr(b, m - 1) & 1u;
  uint32_t a2 = (a >> (m - 2)) & 1u, b2 = (b >> (m - 2)) & 1u;
  uint32_t g1 = a1 & b1, p1 = a1 ^ b1, g2 = a2 & b2, x2 = a2 ^ b2;
  uint32_t s_m1 = p1 | g2;
  uint32_t s_m2 = x2;
  uint32_t const_mask = ones(k);
  uint32_t or_mask = ones(m - 2) ^ const_mask;
  uint32_t low = shl(s_m1, m - 1) | shl(s_m2, m - 2) | ((a | b) & or_mask) |
                 const_mask;
  uint32_t high = shr(a, m) + shr(b, m) + g1;
  return shl(high, m) | low;
}

__device__ __forceinline__ uint32_t haloc_axa_add_fast(uint32_t a, uint32_t b,
                                                       int m, int k) {
  uint32_t lo = ones(m - 1);
  uint32_t t = (a - (a & lo)) + (b - (b & lo));
  uint32_t bit_m2 = 1u << (m - 2);
  uint32_t g2b = (a & b) & bit_m2;
  uint32_t x2b = (a ^ b) & bit_m2;
  uint32_t or_mask = ones(m - 2) ^ ones(k);
  return (t | (g2b << 1) | x2b | ((a | b) & or_mask)) | ones(k);
}

// The full sum in the uint32 container (the carry-out above bit 31 is
// dropped, as the uint32 lanes of the reference drop it).
__device__ __forceinline__ uint32_t approx_add(uint32_t a, uint32_t b,
                                               const AdderParams& p) {
  switch (p.kind) {
    case KIND_LOA:
      return p.fast ? loa_add_fast(a, b, p.m) : loa_add(a, b, p.m);
    case KIND_LOAWA:
      return p.fast ? loawa_add_fast(a, b, p.m) : loawa_add(a, b, p.m);
    case KIND_OLOCA:
      return p.fast ? oloca_add_fast(a, b, p.m, p.k)
                    : oloca_add(a, b, p.m, p.k);
    case KIND_HERLOA:
      return herloa_add(a, b, p.m, p.k, false);
    case KIND_M_HERLOA:
      return herloa_add(a, b, p.m, p.k, true);
    case KIND_HALOC_AXA:
      return p.fast ? haloc_axa_add_fast(a, b, p.m, p.k)
                    : haloc_axa_add(a, b, p.m, p.k);
    case KIND_ETA:
      return eta_add(a, b, p.m);
    default:
      return a + b;
  }
}

__device__ __forceinline__ uint32_t approx_add_mod(uint32_t a, uint32_t b,
                                                   const AdderParams& p) {
  uint32_t s = approx_add(a, b, p);
  return p.n_bits < 32 ? (s & ones(p.n_bits)) : s;
}

// Exact term * w mod 2^N (uint32 multiply wraps at 2^32, so only N < 32
// needs the mask).  A weight of exactly 1 passes the term through
// unmasked, as scale_mod_u32 in the reference does.
__device__ __forceinline__ uint32_t scale_mod(uint32_t term, uint32_t w,
                                              bool unit, int n_bits) {
  if (unit) return term;
  term *= w;
  return n_bits < 32 ? (term & ones(n_bits)) : term;
}

// Blocks for a grid-stride loop over n items, capped so that large
// inputs loop rather than launch millions of blocks.
inline unsigned int blocks_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536LL * 8) blocks = 65536LL * 8;
  return (unsigned int)(blocks < 1 ? 1 : blocks);
}

inline AdderParams make_adder(int kind, int n_bits, int m, int k, int fast) {
  AdderParams p;
  p.kind = kind;
  p.n_bits = n_bits;
  p.m = m;
  p.k = k;
  p.fast = fast;
  return p;
}

}  // namespace repro_torch
