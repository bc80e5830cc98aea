// Signed MAC GEMM: the port of mac_matmul_pallas (src/repro/kernels/mac.py).
//
//   out = fold over K tiles of bk:  acc = tile 0's partial, then
//         acc = approx_add_mod(acc, tile t's partial) for t = 1, 2, ...
//   partial[i][j] = sum over k in the tile of table[((a[i][k] & mask) << w)
//                                                   | (b[k][j] & mask)]
//
// Every product is a gather from the signed sign-magnitude table
// (signed_mul_table: 4^w int32 entries, 256 KiB at w = 8); the sums inside
// a K tile are exact mod 2^32 (uint32 lanes: the wrap is defined and
// associative, so the order inside the tile cannot matter) and the
// approximate adder runs only between tiles, at the multiples of bk counted
// from k = 0.  k >= K counts as a zero operand, whose table entry is 0, so
// the ragged last tile adds nothing extra.  A single tile returns the raw
// partial (the reference's convention).
//
// The Pallas kernel walks a sequential grid (M/bm, N/bn, K/bk) and revisits
// the output block across K.  Blocks here run in no order, so one block
// owns one 64 x 64 output tile and loops over every K tile inside the one
// launch, keeping its 4 x 4 accumulators per thread in registers.  Each
// K tile is staged through shared memory in chunks of 32 (A already masked
// and shifted into the index's high half, B masked), zero-filled past the
// tile's end and past K.  Results depend on bk, never on the 64 x 64 tile.
//
// Bound: operations.  Each product is an index OR, a gather and an add
// (the gather is what the kernel waits on: the 256 KiB table lives in
// L1/L2, not in shared memory); narrowing the w = 8 table to int16 so it
// fits in shared memory is left for a later change.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int TILE = 64;   // output tile edge
constexpr int KC = 32;     // K chunk staged in shared memory
constexpr int THREADS = 256;

}  // namespace

__global__ void __launch_bounds__(THREADS)
mac_matmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  const int32_t* __restrict__ table, int32_t* __restrict__ out,
                  int M, int N, int K, int bk, int w, AdderParams p) {
  __shared__ uint32_t as[TILE][KC + 1];  // ((a & mask) << w), row-major
  __shared__ uint32_t bs[KC][TILE + 1];  // (b & mask)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const uint32_t mask = ones(w);

  uint32_t acc[4][4], part[4][4];
  const int n_tiles = (K + bk - 1) / bk;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_lo = t * bk;
    const int k_hi = min(k_lo + bk, K);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0u;
    for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
      for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
        int r = e / KC, c = e % KC;
        int gr = row0 + r, gk = k0 + c;
        uint32_t v = (gr < M && gk < k_hi)
                         ? (uint32_t)a[(long long)gr * K + gk] : 0u;
        as[r][c] = (v & mask) << w;
      }
      for (int e = threadIdx.x; e < KC * TILE; e += THREADS) {
        int r = e / TILE, c = e % TILE;
        int gk = k0 + r, gc = col0 + c;
        uint32_t v = (gk < k_hi && gc < N)
                         ? (uint32_t)b[(long long)gk * N + gc] : 0u;
        bs[r][c] = v & mask;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t ai[4], bj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ai[i] = as[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bj[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] += (uint32_t)__ldg(table + (ai[i] | bj[j]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = t == 0 ? part[i][j]
                           : approx_add_mod(acc[i][j], part[i][j], p);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gc = col0 + tx + 16 * j;
      if (gc < N) out[(long long)gr * N + gc] = (int32_t)acc[i][j];
    }
  }
}

extern "C" int mac_matmul_launch(const void* a, const void* b,
                                 const void* table, void* out, int M, int N,
                                 int K, int bk, int w, int kind, int n_bits,
                                 int m, int k, int fast, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  AdderParams p = make_adder(kind, n_bits, m, k, fast);
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  mac_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)table,
      (int32_t*)out, M, N, K, bk, w, p);
  return (int)cudaGetLastError();
}
