// Multi-stage separable filter chain: the port of filter_chain_pallas
// (src/repro/kernels/conv_chain.py).
//
// Each stage taps its own input along W or H with replicate edges,
// scales the taps exactly, folds them left to right through the
// approximate adder mod 2^N, sign-extends, and applies an optional
// rounding shift.  Only the last stage's output leaves the chip.
//
// The Pallas kernel holds a whole plane in VMEM; at 1024 x 1024 that is
// 4 MiB of int32, beyond the 227 KB of shared memory a block may use.
// So each block owns one output tile and walks the chain backwards to
// find the region every stage must produce: stage s must cover the
// region stage s+1 reads, which is stage s+1's region widened by its tap
// reach on its axis and CLIPPED TO THE IMAGE.  The block loads the
// first region (tile plus the summed halo, clipped) into shared memory
// once, then runs every stage from one shared buffer into the other.
// Each stage clamps its tap coordinates to the image against its OWN
// input, so a border pixel of stage s+1 reads stage s's value at the
// border, exactly as the reference pads each stage's input: no stage
// value outside the image is ever computed or read.
//
// Bound: integer operations.  The chain moves one int32 read and one
// write per pixel, but its function needs at least 86 int32 operations
// per pixel for the gaussian chain (17 per haloc_axa add in the fused
// form, a mask per tap, a scale per weight other than 1, sign extension
// and rounding shift per stage); at 64 int32 lanes per SM that takes
// about twice as long as the traffic.  Keeping the intermediates in
// shared memory removes the per-stage round trips; the arithmetic stays.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

struct StageParams {
  int axis;  // 0: taps along W (axis -1), 1: taps along H (axis -2)
  int n_taps;
  int left;   // max(-min(offsets), 0)
  int right;  // max(max(offsets), 0)
  int shift;
  unsigned int unit_mask;  // bit j set: weight j is exactly 1
  int offsets[MAX_TAPS];
  uint32_t weights[MAX_TAPS];  // w & 0xFFFFFFFF
};

struct ChainParams {
  AdderParams adder;
  int n_stages;
  int height, width;
  int tile_h, tile_w;
  int buf_w;   // row stride of both shared buffers
  int buf_len; // elements in one shared buffer
  StageParams stages[MAX_STAGES];
};

struct Region {
  int y0, y1, x0, x1;  // [y0, y1) x [x0, x1), inside the image
};

__global__ void filter_chain_kernel(const int32_t* __restrict__ in,
                                    int32_t* __restrict__ out,
                                    ChainParams p) {
  extern __shared__ int32_t smem[];
  int32_t* cur = smem;
  int32_t* nxt = smem + p.buf_len;
  const long long plane = (long long)p.height * p.width;
  const int32_t* src = in + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;

  // reg[s] is the region stage s reads; reg[n_stages] is the output tile.
  Region reg[MAX_STAGES + 1];
  Region r;
  r.y0 = blockIdx.y * p.tile_h;
  r.x0 = blockIdx.x * p.tile_w;
  r.y1 = min(r.y0 + p.tile_h, p.height);
  r.x1 = min(r.x0 + p.tile_w, p.width);
  reg[p.n_stages] = r;
  for (int s = p.n_stages - 1; s >= 0; --s) {
    const StageParams& st = p.stages[s];
    if (st.axis == 0) {
      r.x0 = max(r.x0 - st.left, 0);
      r.x1 = min(r.x1 + st.right, p.width);
    } else {
      r.y0 = max(r.y0 - st.left, 0);
      r.y1 = min(r.y1 + st.right, p.height);
    }
    reg[s] = r;
  }

  const int nthreads = blockDim.x;
  {
    const Region& r0 = reg[0];
    const int w0 = r0.x1 - r0.x0;
    const int n0 = (r0.y1 - r0.y0) * w0;
    for (int idx = threadIdx.x; idx < n0; idx += nthreads) {
      int ly = idx / w0, lx = idx - ly * w0;
      cur[ly * p.buf_w + lx] =
          src[(long long)(r0.y0 + ly) * p.width + (r0.x0 + lx)];
    }
  }
  __syncthreads();

  const uint32_t mask = ones(p.adder.n_bits);
  const uint32_t sign = 1u << (p.adder.n_bits - 1);
  for (int s = 0; s < p.n_stages; ++s) {
    const StageParams& st = p.stages[s];
    const Region& ri = reg[s];
    const Region& ro = reg[s + 1];
    const int wo = ro.x1 - ro.x0;
    const int no = (ro.y1 - ro.y0) * wo;
    for (int idx = threadIdx.x; idx < no; idx += nthreads) {
      int ly = idx / wo, lx = idx - ly * wo;
      int gy = ro.y0 + ly, gx = ro.x0 + lx;
      uint32_t acc = 0u;
      for (int j = 0; j < st.n_taps; ++j) {
        int sy = gy, sx = gx;
        if (st.axis == 0) {
          sx = min(max(gx + st.offsets[j], 0), p.width - 1);
        } else {
          sy = min(max(gy + st.offsets[j], 0), p.height - 1);
        }
        uint32_t u =
            (uint32_t)cur[(sy - ri.y0) * p.buf_w + (sx - ri.x0)] & mask;
        u = scale_mod(u, st.weights[j], (st.unit_mask >> j) & 1u,
                      p.adder.n_bits);
        acc = j == 0 ? u : approx_add_mod(acc, u, p.adder);
      }
      // Sign extension (s ^ sign) - sign, then the rounding shift, in
      // uint32 arithmetic (it wraps as the int32 lanes of the reference
      // do) with an arithmetic right shift.
      int32_t v = (int32_t)((acc ^ sign) - sign);
      if (st.shift) {
        v = (int32_t)((uint32_t)v + (1u << (st.shift - 1))) >> st.shift;
      }
      nxt[ly * p.buf_w + lx] = v;
    }
    __syncthreads();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  const Region& rt = reg[p.n_stages];
  const int wt = rt.x1 - rt.x0;
  const int nt = (rt.y1 - rt.y0) * wt;
  for (int idx = threadIdx.x; idx < nt; idx += nthreads) {
    int ly = idx / wt, lx = idx - ly * wt;
    // The tile's values sit in the last region's buffer, whose origin is
    // the tile's own origin.
    dst[(long long)(rt.y0 + ly) * p.width + (rt.x0 + lx)] =
        cur[ly * p.buf_w + lx];
  }
}

extern "C" int filter_chain_launch(const void* in, void* out, int planes,
                                   int height, int width, int tile_h,
                                   int tile_w, int n_stages,
                                   const int* stage_ints,
                                   const unsigned int* stage_weights,
                                   int kind, int n_bits, int lsm, int k,
                                   int fast, void* stream) {
  // stage_ints holds, per stage: axis, n_taps, shift, unit_mask, then
  // MAX_TAPS offsets; stage_weights holds MAX_TAPS weights per stage.
  if (n_stages < 0 || n_stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  if (planes <= 0 || height <= 0 || width <= 0) return 0;
  ChainParams p;
  p.adder = make_adder(kind, n_bits, lsm, k, fast);
  p.n_stages = n_stages;
  p.height = height;
  p.width = width;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  int halo_h = 0, halo_w = 0;
  for (int s = 0; s < MAX_STAGES; ++s) {
    StageParams& st = p.stages[s];
    st.axis = st.n_taps = st.left = st.right = st.shift = 0;
    st.unit_mask = 0u;
    for (int j = 0; j < MAX_TAPS; ++j) {
      st.offsets[j] = 0;
      st.weights[j] = 0u;
    }
    if (s >= n_stages) continue;
    const int* si = stage_ints + s * (4 + MAX_TAPS);
    st.axis = si[0];
    st.n_taps = si[1];
    st.shift = si[2];
    st.unit_mask = (unsigned int)si[3];
    if (st.n_taps < 1 || st.n_taps > MAX_TAPS) return (int)cudaErrorInvalidValue;
    int lo = 0, hi = 0;
    for (int j = 0; j < st.n_taps; ++j) {
      st.offsets[j] = si[4 + j];
      st.weights[j] = stage_weights[s * MAX_TAPS + j];
      lo = st.offsets[j] < lo ? st.offsets[j] : lo;
      hi = st.offsets[j] > hi ? st.offsets[j] : hi;
    }
    st.left = -lo;
    st.right = hi;
    if (st.axis == 0) halo_w += st.left + st.right;
    else halo_h += st.left + st.right;
  }
  p.buf_w = tile_w + halo_w;
  p.buf_len = (tile_h + halo_h) * p.buf_w;
  size_t smem = 2 * (size_t)p.buf_len * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        filter_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((width + tile_w - 1) / tile_w, (height + tile_h - 1) / tile_h,
            planes);
  filter_chain_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, p);
  return (int)cudaGetLastError();
}
