// 2D MAC convolution on signed values: the port of conv2d_mac_pallas
// (src/repro/kernels/mac.py).
//
// For each output pixel, in conv_taps' row-major tap order: read the
// replicate-clamped neighbour v, take the tap's product sign(v) *
// approx(|v|, |w_t|) masked to N bits, and fold it through the
// approximate adder mod 2^N (the first tap is taken as it is, then T - 1
// adds); then sign-extend from N bits and apply the exact rounding right
// shift in int32, whose add wraps as the reference's int32 add does.
//
// Bound: operations.  Per pixel the T - 1 approximate adds (8
// instructions each for haloc_axa) are the work; the pass moves one
// int32 read and one write.  So the design takes everything else out of
// the tap loop:
// - the products come from "signed tables" the wrapper builds once per
//   (multiplier, kernel, N) (kernels/conv2d_mac.py, signed_tap_tables):
//   row v + 2^w, column t holds (sign(v) * table_t[|v|]) & ones(N), the
//   rows interleaved by tap, so a tap is one gather at (v + 2^w) * T + t
//   with no magnitude, no sign restore and no mask;
// - each block stages its output tile (TH x TW) plus the kernel's halo in
//   shared memory, already turned into table indices (v + 2^w) * T:
//   interior tiles with 16-byte loads and no clamps, border tiles with
//   clamped (replicate) coordinates; nothing is clamped past the load;
// - a thread owns ROWS consecutive output rows of one column and slides
//   its KH x KW window of indices down them in registers: each input
//   index is read from shared memory once per thread, not KH x KW times;
// - the kernel is a template on the adder (with_adder) and on the kernel
//   size for 3 x 3 (the conv3x3 workload) and 5 x 5; any other odd size
//   takes a general instance that reads its window from shared memory;
// - the tables sit in shared memory when they fit beside the tile in
//   what a block may have (227 KB: 5 x 5 at w = 10 is 200 KiB), and are
//   gathered from global memory through __ldg by the general instance
//   beyond that; the blocks are persistent (one wave, each walking many
//   tiles), so each stages its tables once.
// The wrapper checks |v| < 2^w before the launch, so no gather leaves its
// table, and picks the route (conv_route); this entry refuses a route
// that does not fit its arguments.
//
// The gather's index depends on the image: lanes whose v differ but agree
// mod 32 (T is odd) read one bank, so its cost is the image's; a constant
// image reads one word for every lane (a broadcast).
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int BX = 32, BY = 8;         // threads: a column each, BY rows
constexpr int ROWS = 8;                // output rows a thread computes
constexpr int TW = BX, TH = BY * ROWS; // a block's output tile
constexpr int THREADS = BX * BY;
constexpr int FIXED_XL = 4;            // frame columns of the 3x3 and 5x5
constexpr int MAX_SMEM = 232448;       // bytes a block may have on sm_90

struct ConvParams {
  int height, width;
  int kh, kw;     // the general instance's kernel size
  int xl;         // frame columns each side: 4 * ceil((kw / 2) / 4)
  int sw;         // row stride of the shared tile: TW + 2 * xl
  int entries;    // 2^w
  int tab_len;    // ints of tables staged in shared memory, or 0
  int vec;        // interior tiles load 16 bytes at a time
  int tiles_x, tiles_y, n_tiles;
  uint32_t sign, half;
  int shift;
};

__device__ __forceinline__ int32_t finish(uint32_t acc, const ConvParams& p) {
  const int32_t s = (int32_t)((acc ^ p.sign) - p.sign);
  return (int32_t)((uint32_t)s + p.half) >> p.shift;
}

// KH = KW = 0: the general instance (p.kh, p.kw).  SMEM_TAB: the signed
// tables are staged in shared memory (else gathered through __ldg).
// No __launch_bounds__: ptxas then budgets registers for blocks of up to
// 1024 threads (64 a thread) and keeps every value in them (47-56); with
// __launch_bounds__(256) it spilled loop-invariant values to reach 32-40,
// and with (256, 1) it took 69-118.
template <class Add, int KH, int KW, bool SMEM_TAB>
__global__ void conv2d_mac_kernel(const int32_t* __restrict__ q,
                  const int32_t* __restrict__ tabs,
                  int32_t* __restrict__ out, ConvParams p, Add add) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr bool FIXED = KH > 0;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int kh = FIXED ? KH : p.kh, kw = FIXED ? KW : p.kw;
  const int cy = kh / 2, cx = kw / 2;
  const int xl = FIXED ? FIXED_XL : p.xl;
  const int sw = FIXED ? TW + 2 * FIXED_XL : p.sw;
  const int rows = TH + kh - 1;
  const int taps = kh * kw;
  const int zero = p.entries * taps;  // the index of v = 0's row
  const int H = p.height, W = p.width;

  if (SMEM_TAB) {
    const int4* from = reinterpret_cast<const int4*>(tabs);
    int4* to = reinterpret_cast<int4*>(smem);
    for (int i = tid; i < p.tab_len / 4; i += THREADS) to[i] = __ldg(from + i);
  }
  int32_t* tile = smem + (SMEM_TAB ? p.tab_len : 0);

  for (int ti = blockIdx.x; ti < p.n_tiles; ti += gridDim.x) {
    // 32-bit division: a 64-bit one would be a call, with a stack frame.
    const int bx = ti % p.tiles_x, rest = ti / p.tiles_x;
    const int by = rest % p.tiles_y;
    const long long plane = (long long)(rest / p.tiles_y) * H * W;
    const int32_t* src = q + plane;
    int32_t* dst = out + plane;
    const int x0 = bx * TW, y0 = by * TH;
    const int gx0 = x0 - xl, gy0 = y0 - cy;  // the tile's (0, 0)
    __syncthreads();  // the last tile is read; the tables are staged

    if (gy0 >= 0 && gy0 + rows <= H && gx0 >= 0 && gx0 + sw <= W) {
      if (p.vec) {
        const int q4 = sw / 4;
        for (int i = tid; i < rows * q4; i += THREADS) {
          const int r = i / q4, c = (i - r * q4) * 4;
          const int4 v = *reinterpret_cast<const int4*>(
              src + (gy0 + r) * W + gx0 + c);
          *reinterpret_cast<int4*>(tile + r * sw + c) =
              make_int4(v.x * taps + zero, v.y * taps + zero,
                        v.z * taps + zero, v.w * taps + zero);
        }
      } else {
        for (int r = threadIdx.y; r < rows; r += BY)
          for (int c = threadIdx.x; c < sw; c += BX)
            tile[r * sw + c] = src[(gy0 + r) * W + gx0 + c] * taps + zero;
      }
    } else {
      for (int r = threadIdx.y; r < rows; r += BY) {
        const int32_t* row = src + min(max(gy0 + r, 0), H - 1) * W;
        for (int c = threadIdx.x; c < sw; c += BX)
          tile[r * sw + c] = row[min(max(gx0 + c, 0), W - 1)] * taps + zero;
      }
    }
    __syncthreads();

    // Output rows y0 + r0 .. y0 + r0 + ROWS - 1 at column x0 + c read the
    // shared rows r0 .. r0 + ROWS + kh - 2 from column c + xl - cx on.
    const int c = threadIdx.x, r0 = threadIdx.y * ROWS;
    const int32_t* win_at = tile + r0 * sw + c + xl - cx;
    const bool in_w = x0 + c < W;
    const int rows_left = H - y0 - r0;
    int32_t* o = dst + (y0 + r0) * W + x0 + c;
    if constexpr (FIXED) {
      // win[j % KH] holds shared row r0 + j of the window.
      int win[KH][KW];
#pragma unroll
      for (int j = 0; j < KH - 1; ++j)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) win[j][dx] = win_at[j * sw + dx];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
          win[(i + KH - 1) % KH][dx] = win_at[(i + KH - 1) * sw + dx];
        uint32_t acc = 0u;
#pragma unroll
        for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
          for (int dx = 0; dx < KW; ++dx) {
            const int t = dy * KW + dx;
            const int at = win[(i + dy) % KH][dx] + t;
            const uint32_t u = SMEM_TAB ? (uint32_t)smem[at]
                                        : (uint32_t)__ldg(tabs + at);
            acc = t == 0 ? u : add(acc, u);
          }
        }
        if (in_w && i < rows_left) o[i * W] = finish(acc, p);
      }
    } else {
      for (int i = 0; i < ROWS; ++i) {
        uint32_t acc = 0u;
        int t = 0;
        for (int dy = 0; dy < kh; ++dy) {
          const int32_t* row = win_at + (i + dy) * sw;
          for (int dx = 0; dx < kw; ++dx, ++t) {
            const int at = row[dx] + t;
            const uint32_t u = SMEM_TAB ? (uint32_t)smem[at]
                                        : (uint32_t)__ldg(tabs + at);
            acc = t == 0 ? u : add(acc, u);
          }
        }
        if (in_w && i < rows_left) o[i * W] = finish(acc, p);
      }
    }
  }
}

struct LaunchConv {
  const int32_t* q;
  const int32_t* tabs;
  int32_t* out;
  ConvParams p;
  int shape;  // 3 or 5: the square instance; 0: the general one
  bool smem_tab;
  int smem;   // dynamic shared memory, bytes
  cudaStream_t stream;

  template <class Add, int KH, int KW, bool S>
  int go(const Add& add) const {
    auto kernel = conv2d_mac_kernel<Add, KH, KW, S>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    // One wave of persistent blocks, each walking tiles.
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, THREADS, smem)) != cudaSuccess)
      return (int)e;
    int blocks = (per_sm > 0 ? per_sm : 1) * sms;
    if (blocks > p.n_tiles) blocks = p.n_tiles;
    kernel<<<blocks, dim3(BX, BY), smem, stream>>>(q, tabs, out, p,
                                                             add);
    return (int)cudaGetLastError();
  }

  // The 3 x 3 and 5 x 5 instances stage their tables; tables past
  // shared memory take the general instance.
  template <class Add>
  int operator()(const Add& add) const {
    if (!smem_tab) return go<Add, 0, 0, false>(add);
    if (shape == 3) return go<Add, 3, 3, true>(add);
    if (shape == 5) return go<Add, 5, 5, true>(add);
    return go<Add, 0, 0, true>(add);
  }
};

}  // namespace

// tables: int32 (2 * entries, kh * kw), row v + entries holding every
// tap's signed, N-bit masked product of v.  shape (3, 5 or 0) and
// smem_tables are the route conv_route chose.
extern "C" int conv2d_mac_launch(const void* q, const void* tables, void* out,
                                 int planes, int height, int width, int kh,
                                 int kw, int entries, int shift, int shape,
                                 int smem_tables, int kind, int n_bits, int m,
                                 int k, int fast, void* stream) {
  if (kh < 1 || kw < 1 || kh % 2 == 0 || kw % 2 == 0 || entries < 2 ||
      (entries & (entries - 1)) != 0 || n_bits < 1 || n_bits > 32 ||
      shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if ((shape != 0 && shape != 3 && shape != 5) ||
      (shape != 0 && (kh != shape || kw != shape || !smem_tables)))
    return (int)cudaErrorInvalidValue;
  const int taps = kh * kw;
  if ((long long)2 * entries * taps >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.height = height;
  p.width = width;
  p.kh = kh;
  p.kw = kw;
  p.xl = 4 * ((kw / 2 + 3) / 4);
  if (shape != 0 && p.xl != FIXED_XL) return (int)cudaErrorInvalidValue;
  p.sw = TW + 2 * p.xl;
  p.entries = entries;
  p.tab_len = smem_tables ? 2 * entries * taps : 0;
  const long long smem =
      4LL * ((long long)(TH + kh - 1) * p.sw + p.tab_len);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (planes <= 0 || height <= 0 || width <= 0) return 0;
  p.vec = (width % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15u) == 0);
  p.tiles_x = (width + TW - 1) / TW;
  p.tiles_y = (height + TH - 1) / TH;
  const long long n_tiles = (long long)planes * p.tiles_x * p.tiles_y;
  if (n_tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  p.sign = n_bits >= 32 ? 0x80000000u : 1u << (n_bits - 1);
  p.half = bit_or_0(shift - 1);
  p.shift = shift;
  LaunchConv launch{(const int32_t*)q, (const int32_t*)tables, (int32_t*)out,
                    p, shape, smem_tables != 0, (int)smem,
                    (cudaStream_t)stream};
  return with_adder(make_adder(kind, n_bits, m, k, fast), launch);
}
