// Weighted K-term approximate fold: the port of accumulate_pallas
// (src/repro/kernels/accumulate.py).
//
// out[i] = fold_left(approx_add_mod, [scale(t[k][i], w[k]) for k < K])
//
// The fold order is part of the result, so each thread folds its
// element's K terms left to right in registers.  Bound: device memory
// (K int32 reads and one write per element against about 30 integer
// operations per term).  Design: the (K, M) stack is read in place
// (flattened, no padding: the grid-stride loop masks the ragged end), 4
// elements per thread with 16-byte loads when M is a multiple of 4 and
// the pointers are aligned, and the weights and adder ride in a struct
// passed by value.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

struct AccParams {
  AdderParams adder;
  int k_terms;
  unsigned int unit_mask;  // bit j set: weight j is exactly 1
  uint32_t weights[MAX_TERMS];  // w & 0xFFFFFFFF
};

__device__ __forceinline__ uint32_t fold_one(uint32_t acc, uint32_t t, int j,
                                             const AccParams& p) {
  uint32_t u = scale_mod(t, p.weights[j], (p.unit_mask >> j) & 1u,
                         p.adder.n_bits);
  return j == 0 ? u : approx_add_mod(acc, u, p.adder);
}

__global__ void accumulate_vec4(const uint4* __restrict__ terms,
                                uint4* __restrict__ out, long long m4,
                                AccParams p) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m4;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < p.k_terms; ++j) {
      uint4 t = terms[j * m4 + i];
      acc.x = fold_one(acc.x, t.x, j, p);
      acc.y = fold_one(acc.y, t.y, j, p);
      acc.z = fold_one(acc.z, t.z, j, p);
      acc.w = fold_one(acc.w, t.w, j, p);
    }
    out[i] = acc;
  }
}

__global__ void accumulate_scalar(const uint32_t* __restrict__ terms,
                                  uint32_t* __restrict__ out, long long m,
                                  AccParams p) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t acc = 0u;
    for (int j = 0; j < p.k_terms; ++j) {
      acc = fold_one(acc, terms[j * m + i], j, p);
    }
    out[i] = acc;
  }
}

extern "C" int accumulate_launch(const void* terms, void* out, long long m,
                                 int k_terms, const unsigned int* weights,
                                 unsigned int unit_mask, int kind, int n_bits,
                                 int lsm, int k, int fast, void* stream) {
  if (k_terms < 1 || k_terms > MAX_TERMS) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  AccParams p;
  p.adder = make_adder(kind, n_bits, lsm, k, fast);
  p.k_terms = k_terms;
  p.unit_mask = unit_mask;
  for (int j = 0; j < MAX_TERMS; ++j) p.weights[j] = j < k_terms ? weights[j] : 0u;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  bool aligned = ((reinterpret_cast<uintptr_t>(terms) |
                   reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (aligned && m % 4 == 0) {
    long long m4 = m / 4;
    accumulate_vec4<<<blocks_for(m4, threads), threads, 0, s>>>(
        (const uint4*)terms, (uint4*)out, m4, p);
  } else {
    accumulate_scalar<<<blocks_for(m, threads), threads, 0, s>>>(
        (const uint32_t*)terms, (uint32_t*)out, m, p);
  }
  return (int)cudaGetLastError();
}
