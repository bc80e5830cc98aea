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
// The Pallas kernel feeds each tile to the MXU on a sequential grid and
// revisits the output block across K.  Here one block owns one 64 x 64
// output tile and loops over every K tile inside the one launch; each
// thread keeps 4 x 4 accumulators in registers.  K tiles are staged
// through shared memory in chunks of 32 int8 values, zero-filled past the
// tile's end and past K, with B transposed so that four consecutive k of
// one column form one 32-bit word; the dot runs on __dp4a (four int8
// products and their sum in one instruction).
//
// Bound: operations, but not these: the int8 dot would take about 1 us on
// the tensor cores at 1024^3, and the 7 approximate folds per output about
// 7 us on the int32 lanes.  __dp4a runs the dot on the int32 pipe instead,
// so this simple kernel is far from its bound; wgmma tiles are left for a
// later change.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int TILE = 64;   // output tile edge
constexpr int KC = 32;     // K chunk staged in shared memory (bytes)
constexpr int THREADS = 256;

}  // namespace

__global__ void __launch_bounds__(THREADS)
approx_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                     int32_t* __restrict__ out, int M, int N, int K, int bk,
                     AdderParams p) {
  // Rows of 32 k plus 4 bytes of padding: 36-byte rows keep the 32-bit
  // words aligned and spread the rows over the banks.
  __shared__ __align__(16) int8_t as[TILE][KC + 4];  // as[m][k]
  __shared__ __align__(16) int8_t bs[TILE][KC + 4];  // bs[n][k] = B[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;

  uint32_t acc[4][4];
  int part[4][4];
  const int n_tiles = (K + bk - 1) / bk;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_lo = t * bk;
    const int k_hi = min(k_lo + bk, K);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0;
    for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
      for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
        int r = e / KC, c = e % KC;
        int gr = row0 + r, gk = k0 + c;
        as[r][c] = (gr < M && gk < k_hi) ? a[(long long)gr * K + gk]
                                         : (int8_t)0;
      }
      for (int e = threadIdx.x; e < KC * TILE; e += THREADS) {
        int r = e / TILE, c = e % TILE;
        int gk = k0 + r, gc = col0 + c;
        bs[c][r] = (gk < k_hi && gc < N) ? b[(long long)gk * N + gc]
                                         : (int8_t)0;
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < KC / 4; ++k4) {
        int ai[4], bj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ai[i] = *reinterpret_cast<const int*>(&as[ty + 16 * i][4 * k4]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bj[j] = *reinterpret_cast<const int*>(&bs[tx + 16 * j][4 * k4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[i][j] = __dp4a(ai[i], bj[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = t == 0 ? (uint32_t)part[i][j]
                           : approx_add_mod(acc[i][j], (uint32_t)part[i][j],
                                            p);
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

extern "C" int approx_matmul_launch(const void* a, const void* b, void* out,
                                    int M, int N, int K, int bk, int kind,
                                    int n_bits, int m, int k, int fast,
                                    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  AdderParams p = make_adder(kind, n_bits, m, k, fast);
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  approx_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)out, M, N, K, bk, p);
  return (int)cudaGetLastError();
}
