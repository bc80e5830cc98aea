// int8 GEMM with approximate inter-tile accumulation: the port of
// approx_matmul_pallas (src/repro/kernels/approx_matmul.py).
//
//   out = fold over K tiles of bk:  acc = tile 0's exact int8 dot, then
//         acc = approx_add_mod(acc, tile t's exact dot) for t = 1, 2, ...
//
// The dot of each K tile is exact mod 2^32 (int8 x int8 -> int32), and the
// paper's adder sits on the accumulator that combines the tiles, at the
// multiples of bk counted from k = 0, keeping the N-bit residue as the
// reference's jax and Pallas backends do.  A single tile returns the raw
// dot.  k >= K counts as zero, so a ragged last tile adds nothing extra.
//
// Bound: operations.  At 1024^3 (bk 128) the int8 dot is 2.1 G operations,
// about 1 us on the tensor cores, and the 7 approximate folds per output
// (8 instructions each for haloc_axa) about 3.5 us on the int32 lanes;
// the bytes (6 MiB) take 2 us.
//
// Design.  The Pallas kernel feeds each tile to the MXU on a sequential
// grid and revisits the output block across K.  Here one block of four
// warps owns one 64 x 64 output tile and walks every K tile in one launch;
// each warp owns 32 x 32 outputs as 2 x 4 tensor-core tiles of 16 x 8.
// - The dot runs on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32,
//   without .satfinite, so the s32 sums wrap mod 2^32 exactly as the
//   reference's int32 dot does.  Fragments come from shared memory with
//   ldmatrix (the int8 fragment of m16n8k32 is the b16 fragment of an 8 x 8
//   matrix), 4 ldmatrix for 8 mma per warp and k-step of 32.
// - Both operands K-major: B arrives (K, N), so transpose_b first writes
//   it as (N, K) into a scratch tensor the wrapper allocates (one more
//   launch in the same call; 1 MiB at 1024^2).
// - K is staged in chunks of 64 bytes through a ring of three buffers with
//   cp.async, so the loads of chunk c+2 overlap the mma of chunk c; rows of
//   80 bytes keep ldmatrix free of bank conflicts.
// - The tile's partial sum (int32, wrapping) and the folded accumulator
//   stay in registers (32 + 32 a thread).  At the end of each K tile the
//   warp folds acc = add(acc, part) with the compile-time adder of
//   adders.cuh (masks hoisted, no kind switch).
// - The loop runs over K tiles, and inside a tile over its chunks, so the
//   fold sits outside the hot loop and no chunk straddles a tile's end.
// Two routes, two instantiations of one kernel, with one chunk schedule:
// FAST stages 16-byte cp.async pieces (A 16-byte aligned, K % 16 == 0,
// and bk % 64 == 0 or one tile), zero-filled past K and past M and N; the
// general route (any bk, K, alignment) stages each chunk byte by byte,
// zero-filled past the tile's end, past K and past M and N.  The wrapper
// chooses (kernels/approx_matmul.py, staging_route).
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int TM = 64, TN = 64;  // output tile (rows, columns)
constexpr int KC = 64;       // K chunk staged per ring buffer (bytes)
constexpr int LDS = KC + 16; // shared row stride (bytes): ldmatrix conflict-free
constexpr int STAGES = 3;    // ring buffers
constexpr int WN = TN / 32;  // warps along N; each warp owns 32 x 32 outputs
constexpr int THREADS = 32 * (TM / 32) * WN;
constexpr int TT = 64;       // transpose tile edge

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 sums wrapping.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + ROWS) x k [k0, k0 + KC) of a K-major (rows, K)
// int8 operand into dst[ROWS][LDS].
// FAST: 16-byte cp.async pieces, zero-filled past `rows` and past K
// (K % 16 == 0, so a piece is all in or all out).
// General: 4-byte words gathered byte by byte, zero past `rows` and past
// klim (the tile's end or K, whichever is first).
template <bool FAST, int ROWS>
__device__ __forceinline__ void stage_rows(int8_t (*dst)[LDS],
                                           const int8_t* __restrict__ src,
                                           int rows, int K, int r0, int k0,
                                           int klim) {
  static_assert(ROWS * KC % (16 * THREADS) == 0, "whole staging rounds");
  if constexpr (FAST) {
#pragma unroll
    for (int u = 0; u < ROWS * KC / 16 / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / (KC / 16), q = (i % (KC / 16)) * 16;
      const bool ok = r0 + r < rows && k0 + q < K;
      const int8_t* g = ok ? src + (long long)(r0 + r) * K + k0 + q : src;
      cp_async16(&dst[r][q], g, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int u = 0; u < ROWS * KC / 4 / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / (KC / 4), q = (i % (KC / 4)) * 4;
      uint32_t w = 0u;
      if (r0 + r < rows) {
        const int8_t* row = src + (long long)(r0 + r) * K;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = k0 + q + e;
          if (kk < klim) w |= (uint32_t)(uint8_t)row[kk] << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(&dst[r][q]) = w;
    }
  }
}

}  // namespace

// B (K, N) -> bt (N, K), 64 x 64 tiles through shared memory.  WIDE
// (K % 4 == 0, N % 4 == 0, both pointers 4-byte aligned): 4-byte loads
// coalesced along n, each thread transposes a 4 x 4 block of bytes in
// registers with __byte_perm, 4-byte stores coalesced along k.  Else byte
// loads and stores.
template <bool WIDE>
__global__ void __launch_bounds__(256)
transpose_b(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int K,
            int N) {
  __shared__ uint32_t w[TT][TT / 4 + 1];  // w[k][n / 4]
  __shared__ int8_t t[TT][TT + 4];
  const int n0 = blockIdx.x * TT;
  const int k_tiles = (K + TT - 1) / TT;
  for (int kt = blockIdx.y; kt < k_tiles; kt += gridDim.y) {
    const int k0 = kt * TT;
    if constexpr (WIDE) {
      for (int i = threadIdx.x; i < TT * TT / 4; i += 256) {
        const int r = i >> 4, q = i & 15;
        const int k = k0 + r, n = n0 + 4 * q;
        w[r][q] = (k < K && n < N)
                      ? *reinterpret_cast<const uint32_t*>(
                            b + (long long)k * N + n)
                      : 0u;
      }
      __syncthreads();
      {
        // Thread (nb, kb): the 4 x 4 block at n 4 nb, k 4 kb.
        const int kb = threadIdx.x & 15, nb = threadIdx.x >> 4;
        const uint32_t r0 = w[4 * kb][nb], r1 = w[4 * kb + 1][nb];
        const uint32_t r2 = w[4 * kb + 2][nb], r3 = w[4 * kb + 3][nb];
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
        const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
        const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
        const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410),
                               __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410),
                               __byte_perm(t2, t3, 0x7632)};
        const int k = k0 + 4 * kb;
        if (k < K) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + 4 * nb + j;
            if (n < N)
              *reinterpret_cast<uint32_t*>(bt + (long long)n * K + k) = o[j];
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < TT * TT; i += 256) {
        const int r = i >> 6, c = i & (TT - 1);
        const int k = k0 + r, n = n0 + c;
        t[r][c] = (k < K && n < N) ? b[(long long)k * N + n] : (int8_t)0;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < TT * TT; i += 256) {
        const int r = i >> 6, c = i & (TT - 1);
        const int n = n0 + r, k = k0 + c;
        if (n < N && k < K) bt[(long long)n * K + k] = t[c][r];
      }
    }
    __syncthreads();
  }
}

template <class Add, bool FAST>
__global__ void __launch_bounds__(THREADS)
approx_matmul_kernel(const int8_t* __restrict__ a,
                     const int8_t* __restrict__ bt, int32_t* __restrict__ out,
                     int M, int N, int K, int bk, Add add) {
  __shared__ __align__(128) int8_t as[STAGES][TM][LDS];
  __shared__ __align__(128) int8_t bs[STAGES][TN][LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / WN) * 32, wn = (warp % WN) * 32;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  // The chunk schedule, the same on both routes: K tile t (of bk) is
  // staged in cpt = ceil(bk / KC) chunks of KC, the last tile's cut at K.
  // (On the FAST route bk % KC == 0 or one tile covers K, so no chunk
  // crosses a tile's end, and the 16-byte staging zero-fills past K.)
  const int n_tiles = (K + bk - 1) / bk;
  const int cpt = (bk + KC - 1) / KC;
  const int n_chunks =
      (n_tiles - 1) * cpt + (K - (n_tiles - 1) * bk + KC - 1) / KC;
  int pt = 0, pj = 0;  // K tile, and chunk in it, of the next chunk staged
  auto stage_next = [&](int buf) {
    const int k0 = pt * bk + pj * KC;
    const int klim = min(k0 + KC, min(pt * bk + bk, K));
    stage_rows<FAST, TM>(as[buf], a, M, K, row0, k0, klim);
    stage_rows<FAST, TN>(bs[buf], bt, N, K, col0, k0, klim);
    if (++pj == cpt) {
      pj = 0;
      ++pt;
    }
  };

  int part[2][4][4];
  uint32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) stage_next(s);
    cp_async_commit();
  }
  int c = 0;
  for (int t = 0; t < n_tiles; ++t) {
    // The tile's chunks: the inner loop holds only the staging and the
    // tensor-core products.
    for (const int c_end = min(c + cpt, n_chunks); c < c_end; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      // The buffer refilled here was read in iteration c - 1, before the
      // barrier above.
      if (c + STAGES - 1 < n_chunks) stage_next((c + STAGES - 1) % STAGES);
      cp_async_commit();
      const int buf = c % STAGES;
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks) {
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[i], &as[buf][wm + i * 16 + (lane & 15)]
                                [ks * 32 + (lane >> 4) * 16]);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4(bf[p], &bs[buf][wn + p * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)]
                                [ks * 32 + ((lane >> 3) & 1) * 16]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_s8(part[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
      }
    }
    // The end of K tile t: the first tile's partial is taken raw, every
    // later one folds through the adder.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t p = (uint32_t)part[i][j][e];
          acc[i][j][e] = t == 0 ? p : add(acc[i][j][e], p);
          part[i][j][e] = 0;
        }
  }
  cp_async_wait<0>();

  // Accumulator element e of tile (i, j): row g (+8 for e >= 2), column
  // 2 t + (e & 1), g = lane / 4, t = lane % 4.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + i * 16 + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn + j * 8 + 2 * t4;
        int32_t* o = out + (long long)r * N + col;
        const int32_t v0 = (int32_t)acc[i][j][2 * h];
        const int32_t v1 = (int32_t)acc[i][j][2 * h + 1];
        if (col + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          if (col < N) o[0] = v0;
          if (col + 1 < N) o[1] = v1;
        }
      }
    }
}

namespace {

struct Launch {
  const int8_t* a;
  const int8_t* bt;
  int32_t* out;
  int M, N, K, bk, fast;
  cudaStream_t stream;

  template <class Add>
  int operator()(const Add& add) const {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    if (fast) {
      approx_matmul_kernel<Add, true>
          <<<grid, THREADS, 0, stream>>>(a, bt, out, M, N, K, bk, add);
    } else {
      approx_matmul_kernel<Add, false>
          <<<grid, THREADS, 0, stream>>>(a, bt, out, M, N, K, bk, add);
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace

// bt is (N, K) int8 scratch; route_fast selects the 16-byte staging,
// whose conditions (staging_route in kernels/approx_matmul.py: a 16-byte
// aligned, K % 16 == 0, bk % KC == 0 or one tile) are checked again here:
// past them a chunk would cross a tile's end and fold in the wrong place.
extern "C" int approx_matmul_launch(const void* a, const void* b, void* bt,
                                    void* out, int M, int N, int K, int bk,
                                    int route_fast, int kind, int n_bits,
                                    int m, int k, int fast, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || bk <= 0) return (int)cudaErrorInvalidValue;
  if (route_fast && ((((unsigned long long)a) & 15ull) != 0 || K % 16 != 0 ||
                     (bk % KC != 0 && bk < K)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int k_tiles = (K + TT - 1) / TT;
  dim3 tgrid((N + TT - 1) / TT, k_tiles < 65535 ? k_tiles : 65535);
  const bool wide = K % 4 == 0 && N % 4 == 0 &&
                    (((unsigned long long)b | (unsigned long long)bt) & 3) == 0;
  if (wide)
    transpose_b<true><<<tgrid, 256, 0, st>>>((const int8_t*)b, (int8_t*)bt,
                                             K, N);
  else
    transpose_b<false><<<tgrid, 256, 0, st>>>((const int8_t*)b, (int8_t*)bt,
                                              K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Launch launch{(const int8_t*)a, (const int8_t*)bt, (int32_t*)out, M, N, K,
                bk, route_fast, st};
  return with_adder(make_adder(kind, n_bits, m, k, fast), launch);
}
