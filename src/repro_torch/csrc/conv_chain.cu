// Multi-stage separable filter chain: the port of filter_chain_pallas
// (src/repro/kernels/conv_chain.py).
//
// Each stage taps its own input along W or H with replicate edges,
// scales the taps exactly, folds them left to right through the
// approximate adder mod 2^N, sign-extends, and applies an optional
// rounding shift.  Only the last stage's output leaves the chip.
//
// Bound: integer operations and bytes alike.  The chain moves one int32
// read and one write per pixel, and its function needs 40 instructions
// per pixel for the gaussian chain (8 per haloc_axa add on three-input
// LOP3/IADD3 and LEA, each tap's mask folded into the add, one IMAD per
// weight other than 1, a sign extension and a rounding shift per stage;
// chip_smoke.py's HALOC_AXA_ADD): at 64 int32 lanes per SM that takes as
// long as the traffic.  So the design spends its instructions on the
// adds and little else:
// - the adder is a template argument (adders.cuh's with_adder dispatches
//   once, on the host, over kind and form), its masks hoisted into the
//   kernel's parameters: no kind switch and no shift guard per add;
// - a tap's mask and scale are one multiply and one AND, (v * w) & ones(N),
//   which equals the reference's mask-then-scale for every weight;
// - threads are laid out in 2-D (threadIdx.x along W): no division per
//   output.
//
// Two routes, chosen by the wrapper (kernels/conv_chain.py, chain_route):
//
// "sep2", the operators' chains (box, gaussian, sobel): two stages, one
// on each axis, at most 3 taps each, offsets in [-1, 1].  A block owns a
// 32 x 128 output tile and loads the tile plus a one-pixel frame into
// shared memory once: interior blocks with 16-byte loads (when W % 4 == 0)
// and no clamps; blocks touching the border load every pixel at its
// clamped (replicate) coordinate.  The first stage then runs over the
// region the second reads (34 x 128, or 32 x 130 when the vertical stage
// is first) into a second shared buffer, and the second stage writes the
// tile.  No clamp is needed past the load: a stage along one axis
// computed at a row (column) outside the image from replicated input
// equals its value at the clamped row (column), which is exactly the
// replicate edge the reference pads the next stage's input with.  (That
// holds for one stage per axis only; two stages on one axis take the
// general route.)
//
// "general", any chain the wrapper accepts: each block owns one 32 x 64
// output tile and walks the chain backwards to find the region every
// stage must produce: stage s must cover the region stage s+1 reads,
// which is stage s+1's region widened by its tap reach on its axis and
// CLIPPED TO THE IMAGE.  The block loads the first region into shared
// memory once, then runs every stage from one shared buffer into the
// other; each stage clamps its tap coordinates to the image against its
// OWN input, so a border pixel of stage s+1 reads stage s's value at the
// border, exactly as the reference pads each stage's input.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

struct StageParams {
  int axis;  // 0: taps along W (axis -1), 1: taps along H (axis -2)
  int n_taps;
  int left;   // max(-min(offsets), 0)
  int right;  // max(max(offsets), 0)
  int shift;
  uint32_t half;  // the rounding constant 1 << (shift - 1), or 0
  int offsets[MAX_TAPS];
  uint32_t weights[MAX_TAPS];  // w & 0xFFFFFFFF
};

struct ChainParams {
  int n_stages;
  int height, width;
  int tile_h, tile_w;
  int buf_w;   // row stride of both shared buffers
  int buf_len; // elements in one shared buffer
  uint32_t sign;  // 1 << (N - 1)
  StageParams stages[MAX_STAGES];
};

struct Region {
  int y0, y1, x0, x1;  // [y0, y1) x [x0, x1), inside the image
};

constexpr int WARPS = 8;  // blocks of (32, 8) threads

// The last steps of every stage: sign extension (s ^ sign) - sign, then
// the rounding shift, in uint32 arithmetic (it wraps as the int32 lanes
// of the reference do) with an arithmetic right shift.
__device__ __forceinline__ int32_t finish(uint32_t acc, uint32_t sign,
                                          uint32_t half, int shift) {
  const int32_t v = (int32_t)((acc ^ sign) - sign);
  return (int32_t)((uint32_t)v + half) >> shift;
}

// ------------------------------------------------------- the sep2 route --

constexpr int S_TH = 32, S_TW = 128;  // output tile
constexpr int S_SW = S_TW + 8;        // shared row stride (ints)
constexpr int S_CG = S_TW / 32;       // 32-column groups of a tile row
constexpr int RS = WARPS / S_CG;      // row step of one warp
static_assert(WARPS % S_CG == 0 && S_TH % 16 == 0 && S_TH / 16 <= 2,
              "the frame columns take warps 0 and 1, 16 rows each");

// One stage of a sep2 chain: n_taps <= 3; step[j] is tap j's offset in
// shared-memory elements (1 or S_SW times its offset).
struct Sep2Stage {
  int n_taps;
  int shift;
  uint32_t half;
  int step[3];
  uint32_t weights[3];
};

struct Sep2Params {
  int height, width;
  int vec;  // 16-byte loads of the tile's interior rows
  uint32_t sign;
  Sep2Stage st[2];
};

template <class Add>
__device__ __forceinline__ int32_t sep2_taps(const Add& add,
                                             const Sep2Stage& st,
                                             uint32_t sign,
                                             const int32_t* s) {
  const uint32_t n_mask = add.c.n_mask;
  uint32_t acc = ((uint32_t)s[st.step[0]] * st.weights[0]) & n_mask;
  if (st.n_taps > 1)
    acc = add(acc, ((uint32_t)s[st.step[1]] * st.weights[1]) & n_mask);
  if (st.n_taps > 2)
    acc = add(acc, ((uint32_t)s[st.step[2]] * st.weights[2]) & n_mask);
  return finish(acc, sign, st.half, st.shift);
}

// H_FIRST: stage 0 taps along W, stage 1 along H; else the other way.
template <class Add, bool H_FIRST>
__global__ void __launch_bounds__(32 * WARPS)
chain_sep2_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  Sep2Params p, Add add) {
  // s_in[r][j] holds pixel (y0 - 1 + r, x0 - 4 + j), j in [3, S_TW + 5):
  // the tile's columns start 16-byte aligned at j = 4.
  __shared__ __align__(16) int32_t s_in[S_TH + 2][S_SW];
  __shared__ __align__(16) int32_t s_mid[S_TH + 2][S_SW];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int H = p.height, W = p.width;
  const int x0 = blockIdx.x * S_TW, y0 = blockIdx.y * S_TH;
  const long long plane = (long long)H * W;
  const int32_t* src = in + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;

  const bool interior = y0 >= 1 && x0 >= 1 && y0 + S_TH + 1 <= H &&
                        x0 + S_TW + 1 <= W;
  if (interior) {
    const int32_t* base = src + (long long)(y0 - 1) * W + x0;
    if (p.vec) {
      for (int i = tid; i < (S_TH + 2) * (S_TW / 4); i += 32 * WARPS) {
        const int r = i / (S_TW / 4), q = (i % (S_TW / 4)) * 4;
        *reinterpret_cast<int4*>(&s_in[r][4 + q]) =
            *reinterpret_cast<const int4*>(base + (long long)r * W + q);
      }
    } else {
      for (int r = warp; r < S_TH + 2; r += WARPS)
        for (int c = lane; c < S_TW; c += 32)
          s_in[r][4 + c] = base[(long long)r * W + c];
    }
    if (tid < 2 * (S_TH + 2)) {
      const int r = tid >> 1, c = (tid & 1) ? S_TW : -1;
      s_in[r][4 + c] = base[(long long)r * W + c];
    }
  } else {
    for (int r = warp; r < S_TH + 2; r += WARPS) {
      const int gy = min(max(y0 - 1 + r, 0), H - 1);
      const int32_t* row = src + (long long)gy * W;
      for (int c = lane - 1; c <= S_TW; c += 32)
        s_in[r][4 + c] = row[min(max(x0 + c, 0), W - 1)];
    }
  }
  __syncthreads();

  // Stage 0 into s_mid.  Warp w takes the 32 columns (w % S_CG) * 32 +
  // lane of every RS-th row from w / S_CG on: the same number of rows
  // for every warp, and no division.
  const int c = (warp % S_CG) * 32 + lane;
  if constexpr (H_FIRST) {
    // Rows y0 - 1 .. y0 + S_TH (s_mid row r), the tile's columns.
    for (int r = warp / S_CG; r < S_TH + 2; r += RS)
      s_mid[r][4 + c] = sep2_taps(add, p.st[0], p.sign, &s_in[r][4 + c]);
  } else {
    // The tile's rows (s_mid row r is y0 + r), columns x0 .. x0 + S_TW - 1,
    // then the frame columns x0 - 1 and x0 + S_TW: 16 rows of each in
    // warps 0 and 1.
    for (int r = warp / S_CG; r < S_TH; r += RS)
      s_mid[r][4 + c] = sep2_taps(add, p.st[0], p.sign, &s_in[r + 1][4 + c]);
    if (warp < 2) {
      const int r = warp * 16 + (lane >> 1), cf = (lane & 1) ? S_TW : -1;
      s_mid[r][4 + cf] =
          sep2_taps(add, p.st[0], p.sign, &s_in[r + 1][4 + cf]);
    }
  }
  __syncthreads();

  // Stage 1: the tile, straight to device memory (rows past H and
  // columns past W are computed from clamped pixels and not stored).
  const int rows = min(S_TH, H - y0);
  const bool in_w = x0 + c < W;
  int32_t* o = dst + (long long)(y0 + warp / S_CG) * W + x0 + c;
  for (int r = warp / S_CG; r < S_TH; r += RS, o += (long long)RS * W) {
    const int32_t* s = H_FIRST ? &s_mid[r + 1][4 + c] : &s_mid[r][4 + c];
    const int32_t v = sep2_taps(add, p.st[1], p.sign, s);
    if (in_w && r < rows) *o = v;
  }
}

// ---------------------------------------------------- the general route --

// The region stage s reads (s = n_stages: the block's output tile):
// the tile widened by the tap reach of every later stage on its axis,
// clipped to the image.
__device__ __forceinline__ Region region(const ChainParams& p, int s) {
  Region r;
  r.y0 = blockIdx.y * p.tile_h;
  r.x0 = blockIdx.x * p.tile_w;
  r.y1 = min(r.y0 + p.tile_h, p.height);
  r.x1 = min(r.x0 + p.tile_w, p.width);
  for (int t = p.n_stages - 1; t >= s; --t) {
    const StageParams& st = p.stages[t];
    if (st.axis == 0) {
      r.x0 = max(r.x0 - st.left, 0);
      r.x1 = min(r.x1 + st.right, p.width);
    } else {
      r.y0 = max(r.y0 - st.left, 0);
      r.y1 = min(r.y1 + st.right, p.height);
    }
  }
  return r;
}

template <class Add>
__global__ void __launch_bounds__(32 * WARPS)
chain_general_kernel(const int32_t* __restrict__ in,
                     int32_t* __restrict__ out, ChainParams p, Add add) {
  extern __shared__ int32_t smem[];
  int32_t* cur = smem;
  int32_t* nxt = smem + p.buf_len;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long plane = (long long)p.height * p.width;
  const int32_t* src = in + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;

  {
    const Region r0 = region(p, 0);
    for (int ly = ty; ly < r0.y1 - r0.y0; ly += WARPS)
      for (int lx = tx; lx < r0.x1 - r0.x0; lx += 32)
        cur[ly * p.buf_w + lx] =
            src[(long long)(r0.y0 + ly) * p.width + (r0.x0 + lx)];
  }
  __syncthreads();

  const uint32_t n_mask = add.c.n_mask;
  for (int s = 0; s < p.n_stages; ++s) {
    const StageParams& st = p.stages[s];
    const Region ri = region(p, s), ro = region(p, s + 1);
    for (int ly = ty; ly < ro.y1 - ro.y0; ly += WARPS) {
      for (int lx = tx; lx < ro.x1 - ro.x0; lx += 32) {
        const int gy = ro.y0 + ly, gx = ro.x0 + lx;
        uint32_t acc = 0u;
        for (int j = 0; j < st.n_taps; ++j) {
          int sy = gy, sx = gx;
          if (st.axis == 0) {
            sx = min(max(gx + st.offsets[j], 0), p.width - 1);
          } else {
            sy = min(max(gy + st.offsets[j], 0), p.height - 1);
          }
          const uint32_t u =
              ((uint32_t)cur[(sy - ri.y0) * p.buf_w + (sx - ri.x0)] *
               st.weights[j]) & n_mask;
          acc = j == 0 ? u : add(acc, u);
        }
        nxt[ly * p.buf_w + lx] = finish(acc, p.sign, st.half, st.shift);
      }
    }
    __syncthreads();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // The tile's values sit in the last region's buffer, whose origin is
  // the tile's own origin.
  const Region rt = region(p, p.n_stages);
  for (int ly = ty; ly < rt.y1 - rt.y0; ly += WARPS)
    for (int lx = tx; lx < rt.x1 - rt.x0; lx += 32)
      dst[(long long)(rt.y0 + ly) * p.width + (rt.x0 + lx)] =
          cur[ly * p.buf_w + lx];
}

struct LaunchSep2 {
  const int32_t* in;
  int32_t* out;
  Sep2Params p;
  bool h_first;
  dim3 grid;
  cudaStream_t stream;

  template <class Add>
  int operator()(const Add& add) const {
    const dim3 block(32, WARPS);
    if (h_first)
      chain_sep2_kernel<Add, true><<<grid, block, 0, stream>>>(in, out, p, add);
    else
      chain_sep2_kernel<Add, false><<<grid, block, 0, stream>>>(in, out, p,
                                                                add);
    return (int)cudaGetLastError();
  }
};

struct LaunchGeneral {
  const int32_t* in;
  int32_t* out;
  ChainParams p;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;

  template <class Add>
  int operator()(const Add& add) const {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          chain_general_kernel<Add>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    chain_general_kernel<Add><<<grid, dim3(32, WARPS), smem, stream>>>(
        in, out, p, add);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int filter_chain_launch(const void* in, void* out, int planes,
                                   int height, int width, int sep2,
                                   int tile_h, int tile_w, int n_stages,
                                   const int* stage_ints,
                                   const unsigned int* stage_weights,
                                   int kind, int n_bits, int lsm, int k,
                                   int fast, void* stream) {
  // stage_ints holds, per stage: axis, n_taps, shift, then MAX_TAPS
  // offsets; stage_weights holds MAX_TAPS weights per stage.  tile_h and
  // tile_w are the general route's tile.
  if (n_stages < 1 || n_stages > MAX_STAGES || n_bits < 1 || n_bits > 31)
    return (int)cudaErrorInvalidValue;
  if (planes <= 0 || height <= 0 || width <= 0) return 0;
  const AdderParams adder = make_adder(kind, n_bits, lsm, k, fast);
  const cudaStream_t st = (cudaStream_t)stream;
  ChainParams p;
  p.n_stages = n_stages;
  p.height = height;
  p.width = width;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.sign = 1u << (n_bits - 1);
  int halo_h = 0, halo_w = 0;
  for (int s = 0; s < MAX_STAGES; ++s) {
    StageParams& sp = p.stages[s];
    sp.axis = sp.n_taps = sp.left = sp.right = sp.shift = 0;
    sp.half = 0u;
    for (int j = 0; j < MAX_TAPS; ++j) {
      sp.offsets[j] = 0;
      sp.weights[j] = 0u;
    }
    if (s >= n_stages) continue;
    const int* si = stage_ints + s * (3 + MAX_TAPS);
    sp.axis = si[0];
    sp.n_taps = si[1];
    sp.shift = si[2];
    if (sp.n_taps < 1 || sp.n_taps > MAX_TAPS)
      return (int)cudaErrorInvalidValue;
    // 1 << (shift - 1), and 0 where the device's shift by shift - 1 gives
    // 0 (shift 0, or shift - 1 outside 0..31).
    sp.half = bit_or_0(sp.shift - 1);
    int lo = 0, hi = 0;
    for (int j = 0; j < sp.n_taps; ++j) {
      sp.offsets[j] = si[3 + j];
      sp.weights[j] = stage_weights[s * MAX_TAPS + j];
      lo = sp.offsets[j] < lo ? sp.offsets[j] : lo;
      hi = sp.offsets[j] > hi ? sp.offsets[j] : hi;
    }
    sp.left = -lo;
    sp.right = hi;
    if (sp.axis == 0) halo_w += sp.left + sp.right;
    else halo_h += sp.left + sp.right;
  }

  if (sep2) {
    // The wrapper has checked the route's conditions; check them again,
    // since the kernel's shared tile has room for a one-pixel frame only.
    if (n_stages != 2 || p.stages[0].axis == p.stages[1].axis)
      return (int)cudaErrorInvalidValue;
    Sep2Params q;
    q.height = height;
    q.width = width;
    q.vec = (((unsigned long long)in & 15ull) == 0 && width % 4 == 0) ? 1 : 0;
    q.sign = p.sign;
    for (int s = 0; s < 2; ++s) {
      const StageParams& sp = p.stages[s];
      if (sp.n_taps > 3 || sp.left > 1 || sp.right > 1)
        return (int)cudaErrorInvalidValue;
      Sep2Stage& ss = q.st[s];
      ss.n_taps = sp.n_taps;
      ss.shift = sp.shift;
      ss.half = sp.half;
      for (int j = 0; j < 3; ++j) {
        const int o = j < sp.n_taps ? sp.offsets[j] : 0;
        ss.step[j] = sp.axis == 0 ? o : o * S_SW;
        ss.weights[j] = j < sp.n_taps ? sp.weights[j] : 0u;
      }
    }
    dim3 grid((width + S_TW - 1) / S_TW, (height + S_TH - 1) / S_TH, planes);
    LaunchSep2 launch{(const int32_t*)in, (int32_t*)out, q,
                      p.stages[0].axis == 0, grid, st};
    return with_adder(adder, launch);
  }

  p.buf_w = tile_w + halo_w;
  p.buf_len = (tile_h + halo_h) * p.buf_w;
  dim3 grid((width + tile_w - 1) / tile_w, (height + tile_h - 1) / tile_h,
            planes);
  LaunchGeneral launch{(const int32_t*)in, (int32_t*)out, p, grid,
                       2 * (size_t)p.buf_len * sizeof(int32_t), st};
  return with_adder(adder, launch);
}
