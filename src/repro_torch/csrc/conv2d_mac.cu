// 2D MAC convolution on signed values: the port of conv2d_mac_pallas
// (src/repro/kernels/mac.py).
//
// For each output pixel, in conv_taps' row-major tap order: read the
// replicate-clamped neighbour v, gather the tap's product sign(w_t) *
// approx(|v|, |w_t|) from its column table (tap_tables: T x 2^w int32),
// restore v's sign, mask to N bits and fold through the approximate adder
// mod 2^N (the first tap is taken as it is, then T - 1 adds); then
// sign-extend from N bits and apply the exact rounding right shift in
// int32, whose add wraps as the reference's int32 add does.
//
// The Pallas kernel holds one whole plane per program.  Here one thread
// owns four output pixels of one column, 8 rows apart, and reads each
// one's T neighbours straight from device memory (they hit L1:
// neighbouring threads share them); every input is read from device
// memory about once.  The T tap tables go to shared
// memory when they fit in 48 KB (3 x 3 at w = 8 is 9 KiB) and are read
// from global memory through __ldg otherwise, so no kernel that the
// reference accepts is refused.  The wrapper checks |v| < 2^w before the
// launch, so no gather leaves its table.
//
// Bound: operations.  Per pixel the T-1 approximate adds (17 operations
// each in the fused form) dominate, plus per tap an abs, a gather, a sign
// restore and a mask, against one int32 read and one write.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int BX = 32, BY = 8, ROWS = 4;  // threads, rows a thread
constexpr int MAX_SMEM_TABLES = 48 * 1024;

struct ConvParams {
  AdderParams adder;
  int height, width;
  int kh, kw;
  int entries;  // 2^w: one tap table's length
  int shift;
};

}  // namespace

template <bool SMEM>
__device__ __forceinline__ int32_t conv_pixel(const int32_t* __restrict__ src,
                                              const int32_t* __restrict__ tab,
                                              int y, int x,
                                              const ConvParams& p) {
  const uint32_t mask = ones(p.adder.n_bits);
  const uint32_t sign = 1u << (p.adder.n_bits - 1);
  const int cy = p.kh / 2, cx = p.kw / 2;
  uint32_t acc = 0u;
  int t = 0;
  for (int dy = 0; dy < p.kh; ++dy) {
    const int yy = min(max(y + dy - cy, 0), p.height - 1);
    const int32_t* row = src + (long long)yy * p.width;
    for (int dx = 0; dx < p.kw; ++dx, ++t) {
      const int xx = min(max(x + dx - cx, 0), p.width - 1);
      const int32_t v = row[xx];
      const int32_t mag = v < 0 ? -v : v;
      const int32_t* col = tab + (long long)t * p.entries;
      int32_t prod = SMEM ? col[mag] : __ldg(col + mag);
      if (v < 0) prod = -prod;
      const uint32_t u = (uint32_t)prod & mask;
      acc = t == 0 ? u : approx_add_mod(acc, u, p.adder);
    }
  }
  int32_t s = (int32_t)((acc ^ sign) - sign);
  if (p.shift) s = (int32_t)((uint32_t)s + (1u << (p.shift - 1))) >> p.shift;
  return s;
}

// One block covers BX x (BY * ROWS) pixels, each thread ROWS of them one
// BY apart, so the tables staged in shared memory serve 1024 pixels.
template <bool SMEM>
__global__ void __launch_bounds__(BX * BY)
conv2d_mac_kernel(const int32_t* __restrict__ q,
                  const int32_t* __restrict__ tables,
                  int32_t* __restrict__ out, ConvParams p) {
  extern __shared__ int32_t smem_tables[];
  const int32_t* tab = tables;
  if (SMEM) {
    const int n = p.kh * p.kw * p.entries;
    const int tid = threadIdx.y * BX + threadIdx.x;
    for (int i = tid; i < n; i += BX * BY) smem_tables[i] = tables[i];
    __syncthreads();
    tab = smem_tables;
  }
  const int x = blockIdx.x * BX + threadIdx.x;
  if (x >= p.width) return;
  const long long plane = (long long)p.height * p.width;
  const int32_t* src = q + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;
  for (int r = 0; r < ROWS; ++r) {
    const int y = (blockIdx.y * ROWS + r) * BY + threadIdx.y;
    if (y >= p.height) return;
    dst[(long long)y * p.width + x] = conv_pixel<SMEM>(src, tab, y, x, p);
  }
}

extern "C" int conv2d_mac_launch(const void* q, const void* tables, void* out,
                                 int planes, int height, int width, int kh,
                                 int kw, int entries, int shift, int kind,
                                 int n_bits, int m, int k, int fast,
                                 void* stream) {
  if (planes <= 0 || height <= 0 || width <= 0) return 0;
  ConvParams p;
  p.adder = make_adder(kind, n_bits, m, k, fast);
  p.height = height;
  p.width = width;
  p.kh = kh;
  p.kw = kw;
  p.entries = entries;
  p.shift = shift;
  dim3 block(BX, BY);
  dim3 grid((width + BX - 1) / BX, (height + BY * ROWS - 1) / (BY * ROWS),
            planes);
  cudaStream_t s = (cudaStream_t)stream;
  long long smem = (long long)kh * kw * entries * 4;
  if (smem <= MAX_SMEM_TABLES) {
    conv2d_mac_kernel<true><<<grid, block, (size_t)smem, s>>>(
        (const int32_t*)q, (const int32_t*)tables, (int32_t*)out, p);
  } else {
    conv2d_mac_kernel<false><<<grid, block, 0, s>>>(
        (const int32_t*)q, (const int32_t*)tables, (int32_t*)out, p);
  }
  return (int)cudaGetLastError();
}
