// One radix-2 FFT stage on fixed point: the port of butterfly_pallas
// (src/repro/kernels/butterfly.py).
//
//   t   = W * b              exact Q1.14 products, (x*w + 2^13) >> 14
//   top = a + t, bot = a - t  through the approximate adder (subtract =
//                             exact two's-complement negate + approximate
//                             add), each mod 2^N
//   inverse stages halve: (x + 1) >> 1 on the int32 value, with the +1
//   wrapping in 32 bits as the reference's int32 lanes wrap.
//
// Bound: device memory at the FFT's shapes.  Each (row, column) pair
// reads four int32 words, writes four, and reads its column's two
// twiddles (from L1/L2), against some 6 adds of ~17 operations, four
// int64 products and the negations.  Design: one thread per pair, a
// grid-stride loop over rows x half; the twiddle is indexed by column.
// The four input planes may be strided (rows, half) views with their
// own row strides, so the caller's even/odd halves of a stage need no
// copy; the four outputs are contiguous (rows, half).
//
// The products are taken in int64 (the Pallas kernel splits them into
// 16-bit limbs only because the TPU has no 64-bit lanes); the low 32
// bits of the rounded product are what both forms give.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

struct Planes {
  const int32_t* ar;
  const int32_t* ai;
  const int32_t* br;
  const int32_t* bi;
  long long ld_ar, ld_ai, ld_br, ld_bi;
};

__device__ __forceinline__ uint32_t mul_q14(int32_t x, int32_t w) {
  long long p = (long long)x * (long long)w + (1LL << 13);
  return (uint32_t)(p >> 14);
}

__device__ __forceinline__ int32_t halve(uint32_t x) {
  return ((int32_t)(x + 1u)) >> 1;
}

__global__ void butterfly_kernel(Planes in, const int32_t* __restrict__ w_re,
                                 const int32_t* __restrict__ w_im,
                                 int32_t* __restrict__ tr,
                                 int32_t* __restrict__ ti,
                                 int32_t* __restrict__ cr,
                                 int32_t* __restrict__ ci, long long rows,
                                 long long half, AdderParams p, int inverse) {
  long long n = rows * half;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i / half, c = i - r * half;
    uint32_t ar = (uint32_t)__ldg(in.ar + r * in.ld_ar + c);
    uint32_t ai = (uint32_t)__ldg(in.ai + r * in.ld_ai + c);
    int32_t br = __ldg(in.br + r * in.ld_br + c);
    int32_t bi = __ldg(in.bi + r * in.ld_bi + c);
    int32_t wr = __ldg(w_re + c), wi = __ldg(w_im + c);
    uint32_t rr = mul_q14(br, wr), ri = mul_q14(br, wi);
    uint32_t ir = mul_q14(bi, wr), ii = mul_q14(bi, wi);
    uint32_t t_re = approx_add_mod(rr, 0u - ii, p);
    uint32_t t_im = approx_add_mod(ri, ir, p);
    uint32_t top_re = approx_add_mod(ar, t_re, p);
    uint32_t top_im = approx_add_mod(ai, t_im, p);
    uint32_t bot_re = approx_add_mod(ar, 0u - t_re, p);
    uint32_t bot_im = approx_add_mod(ai, 0u - t_im, p);
    if (inverse) {
      tr[i] = halve(top_re);
      ti[i] = halve(top_im);
      cr[i] = halve(bot_re);
      ci[i] = halve(bot_im);
    } else {
      tr[i] = (int32_t)top_re;
      ti[i] = (int32_t)top_im;
      cr[i] = (int32_t)bot_re;
      ci[i] = (int32_t)bot_im;
    }
  }
}

extern "C" int butterfly_launch(const void* ar, const void* ai,
                                const void* br, const void* bi,
                                long long ld_ar, long long ld_ai,
                                long long ld_br, long long ld_bi,
                                const void* w_re, const void* w_im, void* tr,
                                void* ti, void* cr, void* ci, long long rows,
                                long long half, int kind, int n_bits, int m,
                                int k, int fast, int inverse, void* stream) {
  if (rows <= 0 || half <= 0) return 0;
  Planes in;
  in.ar = (const int32_t*)ar;
  in.ai = (const int32_t*)ai;
  in.br = (const int32_t*)br;
  in.bi = (const int32_t*)bi;
  in.ld_ar = ld_ar;
  in.ld_ai = ld_ai;
  in.ld_br = ld_br;
  in.ld_bi = ld_bi;
  AdderParams p = make_adder(kind, n_bits, m, k, fast);
  const int threads = 256;
  butterfly_kernel<<<blocks_for(rows * half, threads), threads, 0,
                     (cudaStream_t)stream>>>(
      in, (const int32_t*)w_re, (const int32_t*)w_im, (int32_t*)tr,
      (int32_t*)ti, (int32_t*)cr, (int32_t*)ci, rows, half, p, inverse);
  return (int)cudaGetLastError();
}
