// Weighted K-term approximate fold: the port of accumulate_pallas
// (src/repro/kernels/accumulate.py), and of the signed fold around it
// (AxEngine.accumulate_signed, scaled_add) in the same launch.
//
// out[i] = finish(fold_left(add, [scale(t[k][i] & pre, w[k]) for k < K]))
//
// The fold order is part of the result, so each thread folds its
// elements' K terms left to right in registers.  Two entries share one
// kernel:
// - accumulate(): K stacked N-bit containers, read in place; pre = ~0 and
//   finish is the identity (sign 0, shift 0);
// - accumulate_signed(): K signed int32 terms read where they lie, each
//   a base pointer with its own plane, row and column strides (sharpen's
//   q and blur from their own tensors, downsample2x's four phases from q
//   at offsets (0, 1, W, W+1) with row stride 2W and column stride 2);
//   pre masks each term to its container's N bits on load, and finish
//   sign-extends the sum from N bits and applies the rounding shift
//   (s + 2^(shift-1)) >> shift, whose add wraps in int32 as the
//   reference's int32 add does.  One launch, no stack, no mask,
//   sign-extension or rounding pass around it.
// A term is scaled as ((t & pre) * w) & post: post is ones(N), or all
// ones for a weight of 1, which passes the term through unmasked as the
// reference's scale_mod_u32 does; the multiply is one IMAD and the masks
// fold into the adder's first LOP3s.
//
// Bound: device memory (K int32 reads and one write per element, against
// about 10 instructions per term).  Its worth is in its loads, so:
// - the kernel is a template on the adder (with_adder: kind and form at
//   compile time, masks hoisted) and on K for the K the main paths launch,
//   2 (scaled_add) and 4 (downsample2x); any other K <= MAX_TERMS takes a
//   general instance that runs the same unrolled code with each term
//   guarded by j < K;
// - every term's load is issued before the first fold, so a thread keeps
//   K loads in flight;
// - the weights, masks and term pointers are read at compile-time indices
//   from the kernel's parameters: no local-memory copy, no stack frame;
// - four outputs a thread with 16-byte loads when the row length is a
//   multiple of 4 and every term is aligned with unit column stride (the
//   wrapper's accumulate_route decides; this entry refuses a route that
//   does not fit), one output a thread on any strides otherwise.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int THREADS = 256;

struct AccParams {
  int k_terms;  // K (the general instance's trip count)
  int planes, height;
  long long width;
  uint32_t pre;   // AND on load: ones(container bits), or ~0
  uint32_t sign;  // the container's sign bit, or 0 (no sign extension)
  uint32_t half;  // the rounding constant 2^(shift-1), or 0
  int shift;
  uint32_t weights[MAX_TERMS];  // w & 0xFFFFFFFF
  uint32_t post[MAX_TERMS];     // AND after the scale
  const int32_t* base[MAX_TERMS];
  long long plane[MAX_TERMS], row[MAX_TERMS], col[MAX_TERMS];  // elements
};

template <int VEC>
struct Lanes {
  uint32_t v[VEC];
};

template <int VEC>
__device__ __forceinline__ Lanes<VEC> load_lanes(const int32_t* p) {
  Lanes<VEC> r;
  if constexpr (VEC == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = (uint32_t)__ldg(p);
  }
  return r;
}

// KT: the K of the instance, or 0 for the general one (K <= MAX_TERMS at
// run time).  VEC: outputs a thread (4: 16-byte loads, unit column
// stride; 1: any strides).
template <class Add, int KT, int VEC>
__global__ void __launch_bounds__(THREADS)
accumulate_kernel(int32_t* __restrict__ out, AccParams p, Add add) {
  constexpr int KM = KT ? KT : MAX_TERMS;
  const long long x =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x >= p.width) return;
  for (int pl = blockIdx.z; pl < p.planes; pl += gridDim.z) {
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < p.height;
         y += gridDim.y * blockDim.y) {
      Lanes<VEC> t[KM];
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (KT != 0 || j < p.k_terms) {
          const long long at = pl * p.plane[j] + y * p.row[j] +
                               (VEC == 4 ? x : x * p.col[j]);
          t[j] = load_lanes<VEC>(p.base[j] + at);
        }
      }
      uint32_t r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        uint32_t acc = ((t[0].v[e] & p.pre) * p.weights[0]) & p.post[0];
#pragma unroll
        for (int j = 1; j < KM; ++j) {
          if (KT != 0 || j < p.k_terms)
            acc = add(acc, ((t[j].v[e] & p.pre) * p.weights[j]) & p.post[j]);
        }
        const int32_t s = (int32_t)((acc ^ p.sign) - p.sign);
        r[e] = (uint32_t)((int32_t)((uint32_t)s + p.half) >> p.shift);
      }
      int32_t* o = out + ((long long)pl * p.height + y) * p.width + x;
      if constexpr (VEC == 4) {
        *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
      } else {
        *o = (int32_t)r[0];
      }
    }
  }
}

struct LaunchAcc {
  int32_t* out;
  AccParams p;
  int kt, vec;
  dim3 grid, block;
  cudaStream_t stream;

  template <class Add, int VEC>
  void go(const Add& add) const {
    if (kt == 2)
      accumulate_kernel<Add, 2, VEC><<<grid, block, 0, stream>>>(out, p, add);
    else if (kt == 4)
      accumulate_kernel<Add, 4, VEC><<<grid, block, 0, stream>>>(out, p, add);
    else
      accumulate_kernel<Add, 0, VEC><<<grid, block, 0, stream>>>(out, p, add);
  }

  template <class Add>
  int operator()(const Add& add) const {
    if (vec == 4)
      go<Add, 4>(add);
    else
      go<Add, 1>(add);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// bases[j] and strides[3j .. 3j+2] (plane, row, column, in elements) give
// term j's element (p, y, x) at bases[j] + p*plane + y*row + x*col; the
// output is contiguous (planes, height, width).  container_bits = 0 is
// accumulate() (unsigned containers, no finish, shift 0); 1..31 is
// accumulate_signed() on containers of that many bits.  kt (0, 2 or 4)
// and vec (1 or 4) are the route accumulate_route chose.
extern "C" int accumulate_launch(const void* const* bases,
                                 const long long* strides, void* out,
                                 int planes, int height, long long width,
                                 int k_terms, const unsigned int* weights,
                                 int container_bits, int shift, int kt,
                                 int vec, int kind, int n_bits, int lsm,
                                 int k, int fast, void* stream) {
  if (k_terms < 1 || k_terms > MAX_TERMS || n_bits < 1 || n_bits > 32 ||
      container_bits < 0 || container_bits > 31 || shift < 0 || shift > 31 ||
      (container_bits == 0 && shift != 0))
    return (int)cudaErrorInvalidValue;
  if ((kt != 0 && kt != 2 && kt != 4) || (kt != 0 && kt != k_terms) ||
      (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    bool ok = width % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    for (int j = 0; j < k_terms; ++j) {
      ok = ok && (reinterpret_cast<uintptr_t>(bases[j]) & 15u) == 0 &&
           strides[3 * j + 2] == 1 && strides[3 * j] % 4 == 0 &&
           strides[3 * j + 1] % 4 == 0;
    }
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  if (planes <= 0 || height <= 0 || width <= 0) return 0;

  AccParams p;
  p.k_terms = k_terms;
  p.planes = planes;
  p.height = height;
  p.width = width;
  p.pre = container_bits ? ones_or_0(container_bits) : 0xFFFFFFFFu;
  p.sign = container_bits ? 1u << (container_bits - 1) : 0u;
  p.half = bit_or_0(shift - 1);
  p.shift = shift;
  const uint32_t n_mask = ones_or_0(n_bits);
  for (int j = 0; j < MAX_TERMS; ++j) {
    const bool on = j < k_terms;
    p.weights[j] = on ? weights[j] : 0u;
    p.post[j] = on && weights[j] == 1u ? 0xFFFFFFFFu : n_mask;
    p.base[j] = on ? (const int32_t*)bases[j] : nullptr;
    p.plane[j] = on ? strides[3 * j] : 0;
    p.row[j] = on ? strides[3 * j + 1] : 0;
    p.col[j] = on ? strides[3 * j + 2] : 0;
  }

  // 256 threads a block: as many along a row as it has (vectors of)
  // elements, up to all 256, and the rest on the next rows.
  int bx = 32;
  while (bx < THREADS && (long long)bx * vec < width) bx *= 2;
  const dim3 block(bx, THREADS / bx);
  const long long gx = (width + (long long)bx * vec - 1) / ((long long)bx * vec);
  const long long gy = (height + block.y - 1) / block.y;
  if (gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)(gy < 65535 ? gy : 65535),
                  (unsigned)(planes < 65535 ? planes : 65535));
  LaunchAcc launch{(int32_t*)out, p, kt, vec, grid, block,
                   (cudaStream_t)stream};
  return with_adder(make_adder(kind, n_bits, lsm, k, fast), launch);
}
