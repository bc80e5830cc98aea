// Lut-strategy elementwise approximate add mod 2^N: the port of
// lut_add_pallas (src/repro/kernels/lut_add.py).
//
//   s = ((a >> m) + (b >> m)) << m  +  table[(a_low << m) | b_low]  (mod 2^N)
//
// Bound: device memory.  Each element reads two int32 words and writes
// one; the packed uint16 table (2^{2m} entries: 2 MiB at m=10, 128 KiB
// at m=8) is gathered through the read-only path (__ldg) and stays in
// the 50 MB L2 after its first touches.  Design: approx_add.cu's single
// streaming pass, 4 elements a thread with 16-byte loads and stores when
// the length is a multiple of 4 and the pointers are 16-byte aligned (a
// scalar kernel covers every other case), and a grid-stride loop.
//
// The table is read as uint16_t, so no entry is sign-extended.  At m = N
// (e.g. N = m = 8) the high part is zero; shl/shr give 0 for a shift by
// 32, so m = N = 32 would be safe too (MAX_LUT_LSM_BITS is 12).
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

__device__ __forceinline__ uint32_t lut_add_mod(uint32_t a, uint32_t b,
                                                const uint16_t* __restrict__ t,
                                                int n_bits, int m) {
  uint32_t low = ones(m);
  uint32_t entry = __ldg(t + ((shl(a & low, m)) | (b & low)));
  uint32_t s = shl(shr(a, m) + shr(b, m), m) + entry;
  return n_bits < 32 ? (s & ones(n_bits)) : s;
}

__global__ void lut_add_vec4(const uint4* __restrict__ a,
                             const uint4* __restrict__ b,
                             const uint16_t* __restrict__ t,
                             uint4* __restrict__ out, long long n4,
                             int n_bits, int m) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 x = a[i], y = b[i], s;
    s.x = lut_add_mod(x.x, y.x, t, n_bits, m);
    s.y = lut_add_mod(x.y, y.y, t, n_bits, m);
    s.z = lut_add_mod(x.z, y.z, t, n_bits, m);
    s.w = lut_add_mod(x.w, y.w, t, n_bits, m);
    out[i] = s;
  }
}

__global__ void lut_add_scalar(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               const uint16_t* __restrict__ t,
                               uint32_t* __restrict__ out, long long n,
                               int n_bits, int m) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = lut_add_mod(a[i], b[i], t, n_bits, m);
  }
}

extern "C" int lut_add_launch(const void* a, const void* b, const void* table,
                              void* out, long long n, int n_bits, int m,
                              void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const uint16_t* t = (const uint16_t*)table;
  bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b) |
                   reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (aligned && n % 4 == 0) {
    long long n4 = n / 4;
    lut_add_vec4<<<blocks_for(n4, threads), threads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, t, (uint4*)out, n4, n_bits, m);
  } else {
    lut_add_scalar<<<blocks_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, t, (uint32_t*)out, n, n_bits,
        m);
  }
  return (int)cudaGetLastError();
}
