// Signed MAC GEMM: the port of mac_matmul_pallas (src/repro/kernels/mac.py).
//
//   out = fold over K tiles of bk:  acc = tile 0's partial, then
//         acc = add(acc, tile t's partial) for t = 1, 2, ...  (mod 2^N)
//   partial[i][j] = sum over k in the tile of table[((a[i][k] & mask) << w)
//                                                   | (b[k][j] & mask)]
//
// Every product is a gather from the signed sign-magnitude table
// (signed_mul_table: 4^w entries); the sums inside a K tile are exact mod
// 2^32 (uint32 lanes: the wrap is defined and associative, so the order
// inside the tile cannot matter) and the approximate adder runs only
// between tiles, at the multiples of bk counted from k = 0.  k >= K counts
// as a zero operand, whose table entry is 0, so the ragged last tile adds
// nothing extra.  A single tile returns the raw partial (the reference's
// convention).  The adder is a template argument (adders.cuh's
// with_adder).
//
// Bound: the gathers.  No route avoids one table lookup a product, and
// shared memory serves 32 lanes a clock an SM; the index (one LOP3) and
// the sum (half an IADD3) are cheaper.  So the design puts the table in
// shared memory and keeps the gathers' bank conflicts as few as random
// indices allow:
// - route "shared" (w <= 8): an int16 copy of the table (every entry of
//   the four kinds fits int16; the wrapper checks it), 128 KiB at w = 8,
//   staged into dynamic shared memory once per block.  Blocks are
//   persistent (one wave, one block an SM at w = 8) and loop over the
//   64 x 64 output tiles, so the table is staged once an SM, not once a
//   tile.  A product is a LOP3 of two pre-shifted byte offsets and an
//   LDS.S16.
// - route "global" (w = 9, 10): the int32 table (up to 4 MiB) stays in
//   global memory and is gathered through the read-only cache.
// A warp owns one row of the tile at a time and 64 columns, two a lane,
// so the 32 lanes of a gather read 32 columns' entries of one table row:
// the bank a lane hits is set by its B operand alone, and two lanes of a
// warp never differ only in A.  Each K tile is staged through shared
// memory in chunks of 32 (A masked and shifted into the offset's high
// part, stored so that a thread's 8 rows are two 16-byte broadcast loads;
// B masked and shifted), zero-filled past the tile's end and past K.
// Results depend on bk, never on the 64 x 64 tile.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int TILE = 64;                 // output tile edge
constexpr int KC = 32;                   // K chunk staged in shared memory
constexpr int THREADS = 256;             // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = TILE / WARPS;       // rows a thread: warp + 8 i
constexpr int A_LD = TILE + 4;           // A chunk row, 16-byte aligned
constexpr int SHARED_MAX_BITS = 8;       // the shared route's widest table

// One block an SM at w = 8 (the table fills shared memory): the bounds
// say so, and ptxas may use the registers that leaves.
template <class Add, bool SMEM>
__global__ void __launch_bounds__(THREADS, 1)
mac_matmul_kernel(const int32_t* __restrict__ a,
                  const int32_t* __restrict__ b,
                  const void* __restrict__ table, int32_t* __restrict__ out,
                  int M, int N, int K, int bk, int w, int tiles_n,
                  int n_tiles, int table_words, Add add) {
  // Entries are 2 bytes in shared memory, 4 in global memory; the staged
  // operands are byte offsets, so a gather's address is one OR.
  constexpr int EB = SMEM ? 1 : 2;
  extern __shared__ __align__(16) uint32_t smem_tab[];
  __shared__ __align__(16) uint32_t as[KC][A_LD];  // slot i * 8 + warp
  __shared__ __align__(16) uint32_t bs[KC][TILE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t mask = ones(w);

  if (SMEM) {
    for (int i = threadIdx.x; i < table_words; i += THREADS)
      smem_tab[i] = __ldg((const uint32_t*)table + i);
    __syncthreads();
  }
  const char* tab = SMEM ? (const char*)smem_tab : (const char*)table;

  const int n_k_tiles = (K + bk - 1) / bk;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = (tile / tiles_n) * TILE, col0 = (tile % tiles_n) * TILE;
    uint32_t acc[ROWS][2], part[ROWS][2];
    for (int t = 0; t < n_k_tiles; ++t) {
      const int k_lo = t * bk;
      const int k_hi = min(k_lo + bk, K);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) part[i][0] = part[i][1] = 0u;
      for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
        for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
          const int r = e / KC, c = e % KC;
          const int gr = row0 + r, gk = k0 + c;
          const uint32_t v = (gr < M && gk < k_hi)
                                 ? (uint32_t)a[(long long)gr * K + gk] : 0u;
          as[c][(r % WARPS) * ROWS + r / WARPS] = (v & mask) << (w + EB);
        }
        for (int e = threadIdx.x; e < KC * TILE; e += THREADS) {
          const int r = e / TILE, c = e % TILE;
          const int gk = k0 + r, gc = col0 + c;
          const uint32_t v = (gk < k_hi && gc < N)
                                 ? (uint32_t)b[(long long)gk * N + gc] : 0u;
          bs[r][c] = (v & mask) << EB;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
          const uint4 a0 = *(const uint4*)&as[kk][warp * ROWS];
          const uint4 a1 = *(const uint4*)&as[kk][warp * ROWS + 4];
          const uint2 bj = *(const uint2*)&bs[kk][2 * lane];
          const uint32_t ai[ROWS] = {a0.x, a0.y, a0.z, a0.w,
                                     a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            if (SMEM) {
              part[i][0] += (uint32_t)(int32_t)(
                  *(const int16_t*)(tab + (ai[i] | bj.x)));
              part[i][1] += (uint32_t)(int32_t)(
                  *(const int16_t*)(tab + (ai[i] | bj.y)));
            } else {
              part[i][0] += (uint32_t)__ldg(
                  (const int32_t*)(tab + (ai[i] | bj.x)));
              part[i][1] += (uint32_t)__ldg(
                  (const int32_t*)(tab + (ai[i] | bj.y)));
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[i][j] = t == 0 ? part[i][j] : add(acc[i][j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int gr = row0 + warp + WARPS * i;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gc = col0 + 2 * lane + j;
        if (gc < N) out[(long long)gr * N + gc] = (int32_t)acc[i][j];
      }
    }
  }
}

struct LaunchMac {
  const int32_t* a;
  const int32_t* b;
  const void* table;
  int32_t* out;
  int M, N, K, bk, w, tiles_n, n_tiles;
  bool smem_table;
  cudaStream_t stream;

  template <class Add, bool S>
  int go(const Add& add) const {
    auto kernel = mac_matmul_kernel<Add, S>;
    const int table_bytes = S ? 2 << (2 * w) : 0;
    cudaError_t e;
    if (S && (e = cudaFuncSetAttribute(
                  kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  table_bytes)) != cudaSuccess)
      return (int)e;
    // One wave of persistent blocks, each walking output tiles.
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, THREADS, table_bytes)) != cudaSuccess)
      return (int)e;
    int blocks = (per_sm > 0 ? per_sm : 1) * sms;
    if (blocks > n_tiles) blocks = n_tiles;
    kernel<<<blocks, THREADS, table_bytes, stream>>>(
        a, b, table, out, M, N, K, bk, w, tiles_n, n_tiles, table_bytes / 4,
        add);
    return (int)cudaGetLastError();
  }

  template <class Add>
  int operator()(const Add& add) const {
    return smem_table ? go<Add, true>(add) : go<Add, false>(add);
  }
};

}  // namespace

// table: the int16 signed table (smem_table, w <= 8) or the int32 one,
// 4^w entries indexed by ((a & mask) << w) | (b & mask); smem_table is the
// route kernels/mac_matmul.py's mac_route chose.
extern "C" int mac_matmul_launch(const void* a, const void* b,
                                 const void* table, void* out, int M, int N,
                                 int K, int bk, int w, int smem_table,
                                 int kind, int n_bits, int m, int k, int fast,
                                 void* stream) {
  if (w < 1 || w > 10 || (smem_table && w > SHARED_MAX_BITS) || bk < 1 ||
      M < 0 || N < 0 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int tiles_n = (N + TILE - 1) / TILE;
  const long long n_tiles = (long long)((M + TILE - 1) / TILE) * tiles_n;
  if (n_tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  LaunchMac launch{(const int32_t*)a, (const int32_t*)b, table,
                   (int32_t*)out, M, N, K, bk, w, tiles_n, (int)n_tiles,
                   smem_table != 0, (cudaStream_t)stream};
  return with_adder(make_adder(kind, n_bits, m, k, fast), launch);
}
