// Elementwise approximate add mod 2^N: the port of approx_add_pallas
// (src/repro/kernels/approx_add.py).
//
// Bound: device memory.  Each element reads two int32 words and writes
// one, against some 15 to 30 integer operations of the adder, so the
// kernel is a streaming pass.  Design: one thread per 4 elements, with
// 16-byte loads and stores when the length is a multiple of 4 and the
// pointers are 16-byte aligned (a scalar kernel covers every other case),
// and a grid-stride loop.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

__global__ void approx_add_vec4(const uint4* __restrict__ a,
                                const uint4* __restrict__ b,
                                uint4* __restrict__ out, long long n4,
                                AdderParams p) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 x = a[i], y = b[i], s;
    s.x = approx_add_mod(x.x, y.x, p);
    s.y = approx_add_mod(x.y, y.y, p);
    s.z = approx_add_mod(x.z, y.z, p);
    s.w = approx_add_mod(x.w, y.w, p);
    out[i] = s;
  }
}

__global__ void approx_add_scalar(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, long long n,
                                  AdderParams p) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = approx_add_mod(a[i], b[i], p);
  }
}

extern "C" int approx_add_launch(const void* a, const void* b, void* out,
                                 long long n, int kind, int n_bits, int m,
                                 int k, int fast, void* stream) {
  if (n <= 0) return 0;
  AdderParams p = make_adder(kind, n_bits, m, k, fast);
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b) |
                   reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (aligned && n % 4 == 0) {
    long long n4 = n / 4;
    approx_add_vec4<<<blocks_for(n4, threads), threads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (uint4*)out, n4, p);
  } else {
    approx_add_scalar<<<blocks_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, p);
  }
  return (int)cudaGetLastError();
}
