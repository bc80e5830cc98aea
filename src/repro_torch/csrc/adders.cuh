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

#include <cuda_runtime.h>

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

// ---------------------------------------------------------------------
// Compile-time adders, for the kernels whose inner loops run the adder
// many times (approx_matmul.cu's folds, conv_chain.cu's taps).
//
// The runtime approx_add above switches on p.kind and p.fast for every
// add and recomputes each shift guard and mask.  Here the kind and form
// are template arguments, and every mask is computed once, on the host,
// into an AdderMasks that the kernel takes by value: the per-add work is
// the formula's own operations.  Each shift by m of the reference
// formulas becomes a mask: shl(shr(a, m) + shr(b, m) + cin, m) equals
// (a & hi) + (b & hi) + (cin << m) mod 2^32, and with hi = ~ones(m) = 0
// at m = 32 it gives 0 there, as a shift by 32 does in XLA and numpy.
// The carry-in bit is moved up from position m-1 with a shift by 1,
// which drops it at m = 32 for the same reason.  Every functor is
// bit-identical to approx_add_mod with the same parameters.
// ---------------------------------------------------------------------

__host__ __device__ inline uint32_t ones_or_0(int w) {
  return w <= 0 ? 0u : w >= 32 ? 0xFFFFFFFFu : (1u << w) - 1u;
}

__host__ __device__ inline uint32_t bit_or_0(int s) {
  return (s < 0 || s >= 32) ? 0u : 1u << s;
}

// The masks of one adder, hoisted out of every loop.
struct AdderMasks {
  uint32_t n_mask;    // ones(N): the residue mod 2^N
  uint32_t hi;        // ~ones(m): an operand's exact part
  uint32_t lsm;       // ones(m)
  uint32_t lo;        // the fused forms' low mask (ones(m - 1), or ones(m))
  uint32_t cin;       // bit m-1, the carry into the exact part (or 0)
  uint32_t bit2;      // bit m-2 (HERLOA, M-HERLOA, HALOC-AxA)
  uint32_t or_mask;   // the low section that is OR-ed
  uint32_t set_mask;  // the constant-one section ones(k) (or 0)
};

inline AdderMasks make_masks(const AdderParams& p) {
  const int m = p.m, k = p.k;
  AdderMasks c;
  c.n_mask = ones_or_0(p.n_bits);
  c.lsm = ones_or_0(m);
  c.hi = ~c.lsm;
  c.lo = ones_or_0(m - 1);
  c.cin = bit_or_0(m - 1);
  c.bit2 = bit_or_0(m - 2);
  c.or_mask = 0u;
  c.set_mask = 0u;
  switch (p.kind) {
    case KIND_LOAWA:
      c.lo = c.lsm;
      break;
    case KIND_OLOCA:
      if (m == k) {  // no OR-ed bits and no carry-in: all m bits are 1
        c.lo = c.lsm;
        c.cin = 0u;
      }
      c.or_mask = c.lsm ^ ones_or_0(k);
      c.set_mask = ones_or_0(k);
      break;
    case KIND_HERLOA:
      c.or_mask = ones_or_0(m - 2);
      break;
    case KIND_M_HERLOA:
    case KIND_HALOC_AXA:
      c.or_mask = ones_or_0(m - 2) ^ ones_or_0(k);
      c.set_mask = ones_or_0(k);
      break;
    default:
      break;
  }
  return c;
}

// One adder kind in one form: add(a, b) is approx_add_mod(a, b, p).
template <int KIND, bool FUSED>
struct Adder {
  AdderMasks c;

  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return sum(a, b) & c.n_mask;
  }

  __device__ __forceinline__ uint32_t sum(uint32_t a, uint32_t b) const {
    const uint32_t g = a & b, x = a ^ b, o = a | b;
    if constexpr (KIND == KIND_ACCURATE) {
      return a + b;
    } else if constexpr (KIND == KIND_LOA && !FUSED) {
      return ((a & c.hi) + (b & c.hi) + ((g & c.cin) << 1)) | (o & c.lsm);
    } else if constexpr (KIND == KIND_LOA) {
      const uint32_t t = (a & ~c.lo) + (b & ~c.lo);
      return (t & ~c.cin) | (o & c.lsm);
    } else if constexpr (KIND == KIND_LOAWA && !FUSED) {
      return ((a & c.hi) + (b & c.hi)) | (o & c.lsm);
    } else if constexpr (KIND == KIND_LOAWA) {
      return ((a & ~c.lo) + (b & ~c.lo)) | (o & c.lo);
    } else if constexpr (KIND == KIND_OLOCA && !FUSED) {
      return ((a & c.hi) + (b & c.hi) + ((g & c.cin) << 1)) |
             (o & c.or_mask) | c.set_mask;
    } else if constexpr (KIND == KIND_OLOCA) {
      const uint32_t t = (a & ~c.lo) + (b & ~c.lo);
      return (t & ~c.cin) | (o & c.or_mask) | c.set_mask;
    } else if constexpr (KIND == KIND_HERLOA || KIND == KIND_M_HERLOA) {
      // Bits m-1 and m-2 in place: s_{m-1} = p1 | g2, s_{m-2} = x2 | err
      // with err = p1 & g2; the generate of bit m-1 carries into bit m.
      const uint32_t p1 = x & c.cin, g2 = g & c.bit2;
      const uint32_t err = (p1 >> 1) & g2;
      return ((a & c.hi) + (b & c.hi) + ((g & c.cin) << 1)) | p1 |
             (g2 << 1) | (x & c.bit2) | err | (o & c.or_mask) | c.set_mask;
    } else if constexpr (KIND == KIND_HALOC_AXA && !FUSED) {
      return ((a & c.hi) + (b & c.hi) + ((g & c.cin) << 1)) |
             (x & (c.cin | c.bit2)) | ((g & c.bit2) << 1) |
             (o & c.or_mask) | c.set_mask;
    } else if constexpr (KIND == KIND_HALOC_AXA) {
      const uint32_t t = (a & ~c.lo) + (b & ~c.lo);
      return t | ((g & c.bit2) << 1) | (x & c.bit2) | (o & c.or_mask) |
             c.set_mask;
    } else {
      static_assert(KIND == KIND_ETA, "a kind without a compile-time adder");
      // The downward smear of the (1,1) pairs over all 32 bits: a shift
      // of m or more adds nothing to bits below m.
      uint32_t poison = g & c.lsm;
      poison |= poison >> 1;
      poison |= poison >> 2;
      poison |= poison >> 4;
      poison |= poison >> 8;
      poison |= poison >> 16;
      return ((a & c.hi) + (b & c.hi)) | (x & c.lsm) | poison;
    }
  }
};

// Calls body(add) with the compile-time adder of p's kind and form, built
// on the host with its masks; the kinds without a fused form take their
// one form.  Returns body's result, or cudaErrorInvalidValue for a kind
// id with no device adder.
template <class Body>
inline int with_adder(const AdderParams& p, Body&& body) {
  const AdderMasks c = make_masks(p);
  switch (p.kind) {
    case KIND_ACCURATE:
      return body(Adder<KIND_ACCURATE, false>{c});
    case KIND_LOA:
      return p.fast ? body(Adder<KIND_LOA, true>{c})
                    : body(Adder<KIND_LOA, false>{c});
    case KIND_LOAWA:
      return p.fast ? body(Adder<KIND_LOAWA, true>{c})
                    : body(Adder<KIND_LOAWA, false>{c});
    case KIND_OLOCA:
      return p.fast ? body(Adder<KIND_OLOCA, true>{c})
                    : body(Adder<KIND_OLOCA, false>{c});
    case KIND_HERLOA:
      return body(Adder<KIND_HERLOA, false>{c});
    case KIND_M_HERLOA:
      return body(Adder<KIND_M_HERLOA, false>{c});
    case KIND_HALOC_AXA:
      return p.fast ? body(Adder<KIND_HALOC_AXA, true>{c})
                    : body(Adder<KIND_HALOC_AXA, false>{c});
    case KIND_ETA:
      return body(Adder<KIND_ETA, false>{c});
    default:
      return (int)cudaErrorInvalidValue;
  }
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
