// Elementwise approximate multiply, full product: the port of
// mul_elementwise_pallas (src/repro/kernels/mac.py).
//
// Three forms, selected by `form`: 0 the registered reference formula,
// 1 its fused form (both from muls.cuh, bit-identical), 2 a gather from
// the compiled full-product table T[(a << N) | b] (compile_mul_lut:
// uint16 when 2N <= 16, else uint32; 128 KiB at N=8, 4 MiB at N=10),
// read through the read-only path (__ldg).
//
// Bound: device memory.  Each element reads two int32 words and writes
// one; the widest formula (the reference truncated multiplier at N=8)
// runs some 50 integer operations an element, about as long on the card
// as the traffic, and the fused forms fewer.  Design: approx_add.cu's
// single streaming pass, 4 elements a thread with 16-byte loads and
// stores when the length is a multiple of 4 and the pointers are 16-byte
// aligned (a scalar kernel covers every other case), and a grid-stride
// loop.
#include <cuda_runtime.h>

#include "muls.cuh"

using namespace repro_torch;

struct MulLaunch {
  MulParams mul;
  int form;        // 0 reference, 1 fused, 2 lut
  int table_bits;  // 16 or 32 (lut form only)
};

__device__ __forceinline__ uint32_t mul_one(uint32_t a, uint32_t b,
                                            const void* __restrict__ table,
                                            const MulLaunch& p) {
  if (p.form == 2) {
    int n = p.mul.n_bits;
    uint32_t idx = ((a & ones(n)) << n) | (b & ones(n));
    return p.table_bits == 16
               ? (uint32_t)__ldg((const uint16_t*)table + idx)
               : __ldg((const uint32_t*)table + idx);
  }
  return approx_mul(a, b, p.mul);
}

__global__ void mul_vec4(const uint4* __restrict__ a,
                         const uint4* __restrict__ b,
                         const void* __restrict__ table,
                         uint4* __restrict__ out, long long n4, MulLaunch p) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 x = a[i], y = b[i], s;
    s.x = mul_one(x.x, y.x, table, p);
    s.y = mul_one(x.y, y.y, table, p);
    s.z = mul_one(x.z, y.z, table, p);
    s.w = mul_one(x.w, y.w, table, p);
    out[i] = s;
  }
}

__global__ void mul_scalar(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           const void* __restrict__ table,
                           uint32_t* __restrict__ out, long long n,
                           MulLaunch p) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = mul_one(a[i], b[i], table, p);
  }
}

extern "C" int mul_launch(const void* a, const void* b, const void* table,
                          void* out, long long n, int kind, int n_bits,
                          int trunc, int rows, int form, int table_bits,
                          void* stream) {
  if (n <= 0) return 0;
  MulLaunch p;
  p.mul = make_mul(kind, n_bits, trunc, rows, form == 1);
  p.form = form;
  p.table_bits = table_bits;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b) |
                   reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (aligned && n % 4 == 0) {
    long long n4 = n / 4;
    mul_vec4<<<blocks_for(n4, threads), threads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, table, (uint4*)out, n4, p);
  } else {
    mul_scalar<<<blocks_for(n, threads), threads, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, table, (uint32_t*)out, n, p);
  }
  return (int)cudaGetLastError();
}
