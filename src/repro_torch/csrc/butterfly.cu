// Radix-2 FFT butterflies on fixed point: the port of butterfly_pallas
// (src/repro/kernels/butterfly.py), in two entries.
//
//   t   = W * b              exact Q1.14 products, (x*w + 2^13) >> 14
//   top = a + t, bot = a - t  through the approximate adder (subtract =
//                             exact two's-complement negate + approximate
//                             add), each mod 2^N
//   inverse stages halve: (x + 1) >> 1 on the int32 value, with the +1
//   wrapping in 32 bits as the reference's int32 lanes wrap.
//
// The products are taken in int64 (the Pallas kernel splits them into
// 16-bit limbs only because the TPU has no 64-bit lanes); the low 32 bits
// of the rounded product are what both forms give.  The adder is a
// template argument (adders.cuh's with_adder dispatches once, on the host,
// over kind and form): no kind switch per add.
//
// butterfly_launch: ONE stage, what engine.butterfly computes.  One thread
// per (row, column) pair, a grid-stride loop over rows x half; the
// twiddle is indexed by column.  The four input planes may be strided
// (rows, half) views with their own row strides; the four outputs are
// contiguous (rows, half).  Bound: device memory (four int32 words read
// and four written a pair, against 59 instructions).
//
// butterfly_axis_launch: EVERY stage of a batch of length-n transforms in
// one launch, what a whole FFT axis computes.  Transform g = (outer o,
// inner i) starts at o * s_outer + i * s_inner and its elements lie
// s_elem apart, so the row axis, the column axis and the block tiles of
// an image are all read and written in place, without a copy.  A block
// takes T = 2^log_per_block consecutive transforms: it loads them into
// shared memory in bit-reversed order, runs the log2 n stages there in
// place (exactly the per-stage arithmetic, in the per-stage order), and
// writes them back in natural order.  With t_fast, neighbouring threads
// take neighbouring transforms on the load and the store (the column
// axis: neighbouring columns are neighbouring addresses), else
// neighbouring elements of one transform.  The twiddles of all stages
// come from one host-computed table (stage h at offset h - 1).  Bound:
// the operations at the paper's shapes (59 instructions a pair a stage,
// against 16 bytes a pair read and written once).  Input and output may
// be the same buffer: a block reads all its elements before it writes.
#include <cuda_runtime.h>

#include "adders.cuh"

using namespace repro_torch;

namespace {

constexpr int THREADS = 256;
// The axis kernel's block: one pair a thread a stage at 1024 elements.
constexpr int AXIS_THREADS = 512;
// Most elements (of each of re and im) one block holds, 2^12: 32 KB of
// shared memory in all (kernels/butterfly.py's AXIS_MAX_ELEMS).
constexpr int MAX_LOG_ELEMS = 12;

__device__ __forceinline__ uint32_t mul_q14(int32_t x, int32_t w) {
  long long p = (long long)x * (long long)w + (1LL << 13);
  return (uint32_t)(p >> 14);
}

__device__ __forceinline__ uint32_t halve(uint32_t x) {
  return (uint32_t)(((int32_t)(x + 1u)) >> 1);
}

// One butterfly in the per-stage order: the four products, the six adds,
// then the halving on inverse stages.
template <class Add>
__device__ __forceinline__ void butterfly_pair(uint32_t ar, uint32_t ai,
                                               int32_t br, int32_t bi,
                                               int32_t wr, int32_t wi,
                                               const Add& add, int inverse,
                                               uint32_t out[4]) {
  uint32_t rr = mul_q14(br, wr), ri = mul_q14(br, wi);
  uint32_t ir = mul_q14(bi, wr), ii = mul_q14(bi, wi);
  uint32_t t_re = add(rr, 0u - ii);
  uint32_t t_im = add(ri, ir);
  out[0] = add(ar, t_re);
  out[1] = add(ai, t_im);
  out[2] = add(ar, 0u - t_re);
  out[3] = add(ai, 0u - t_im);
  if (inverse) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = halve(out[q]);
  }
}

struct Planes {
  const int32_t* ar;
  const int32_t* ai;
  const int32_t* br;
  const int32_t* bi;
  long long ld_ar, ld_ai, ld_br, ld_bi;
};

template <class Add>
__global__ void __launch_bounds__(THREADS)
butterfly_kernel(Planes in, const int32_t* __restrict__ w_re,
                 const int32_t* __restrict__ w_im, int32_t* __restrict__ tr,
                 int32_t* __restrict__ ti, int32_t* __restrict__ cr,
                 int32_t* __restrict__ ci, long long rows, long long half,
                 Add add, int inverse) {
  long long n = rows * half;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i / half, c = i - r * half;
    uint32_t out[4];
    butterfly_pair((uint32_t)__ldg(in.ar + r * in.ld_ar + c),
                   (uint32_t)__ldg(in.ai + r * in.ld_ai + c),
                   __ldg(in.br + r * in.ld_br + c),
                   __ldg(in.bi + r * in.ld_bi + c), __ldg(w_re + c),
                   __ldg(w_im + c), add, inverse, out);
    tr[i] = (int32_t)out[0];
    ti[i] = (int32_t)out[1];
    cr[i] = (int32_t)out[2];
    ci[i] = (int32_t)out[3];
  }
}

struct LaunchStage {
  Planes in;
  const int32_t* w_re;
  const int32_t* w_im;
  int32_t* out[4];
  long long rows, half;
  int inverse;
  cudaStream_t stream;

  template <class Add>
  int operator()(const Add& add) const {
    butterfly_kernel<Add><<<blocks_for(rows * half, THREADS), THREADS, 0,
                            stream>>>(in, w_re, w_im, out[0], out[1], out[2],
                                      out[3], rows, half, add, inverse);
    return (int)cudaGetLastError();
  }
};

// Where the transforms of one axis lie (element strides).  The inner
// index is split from g with a multiply-high division (magic, shift), as
// kernels/butterfly.py's divider computes them; g < 2^31.
struct Axis {
  long long s_outer, s_inner, s_elem;
  int transforms;     // n_outer * n_inner
  uint32_t n_inner;   // transforms of one outer index
  uint32_t magic;     // g / n_inner = (umulhi(g, magic) + g) >> shift
  int shift;
  int log_n;          // n = 2^log_n
  int log_per_block;  // T = 2^log_per_block transforms a block
  int t_fast;         // load/store: neighbouring threads, transforms
};

// Element (t, e) of the block's transforms for thread slot idx, and its
// offset in the tensor; false when transform t is past the last one.
__device__ __forceinline__ bool axis_element(const Axis& ax, int idx,
                                             int* t, int* e,
                                             long long* at) {
  if (ax.t_fast) {
    *t = idx & ((1 << ax.log_per_block) - 1);
    *e = idx >> ax.log_per_block;
  } else {
    *e = idx & ((1 << ax.log_n) - 1);
    *t = idx >> ax.log_n;
  }
  const uint32_t g = ((uint32_t)blockIdx.x << ax.log_per_block) + *t;
  if (g >= (uint32_t)ax.transforms) return false;
  const uint32_t o = (__umulhi(g, ax.magic) + g) >> ax.shift;
  const uint32_t i = g - o * ax.n_inner;
  *at = o * ax.s_outer + i * ax.s_inner + *e * ax.s_elem;
  return true;
}

template <class Add>
__global__ void __launch_bounds__(AXIS_THREADS)
butterfly_axis_kernel(const int32_t* in_re, const int32_t* in_im,
                      int32_t* out_re, int32_t* out_im, Axis ax,
                      const int32_t* __restrict__ tw_re,
                      const int32_t* __restrict__ tw_im, Add add,
                      int inverse) {
  extern __shared__ uint32_t smem[];
  const int elems = 1 << (ax.log_n + ax.log_per_block);
  uint32_t* s_re = smem;
  uint32_t* s_im = smem + elems;

  // Load, bit-reversing the element index within each transform.
  for (int idx = threadIdx.x; idx < elems; idx += AXIS_THREADS) {
    int t, e;
    long long at;
    if (!axis_element(ax, idx, &t, &e, &at)) continue;
    const int slot = (t << ax.log_n) | (int)(__brev((unsigned)e) >>
                                             (32 - ax.log_n));
    s_re[slot] = (uint32_t)in_re[at];
    s_im[slot] = (uint32_t)in_im[at];
  }
  __syncthreads();

  // The stages in place: pair q of stage s (half h = 2^s) joins slots top
  // and top + h, with twiddle j = q mod h.  A transform's n/2 pairs are
  // consecutive q, and h divides n/2, so q's transform needs no index.
  for (int s = 0; s < ax.log_n; ++s) {
    const int h = 1 << s;
    const int32_t* wr = tw_re + (h - 1);
    const int32_t* wi = tw_im + (h - 1);
    for (int q = threadIdx.x; q < (elems >> 1); q += AXIS_THREADS) {
      const int j = q & (h - 1);
      const int top = ((q >> s) << (s + 1)) | j;
      const int bot = top + h;
      uint32_t out[4];
      butterfly_pair(s_re[top], s_im[top], (int32_t)s_re[bot],
                     (int32_t)s_im[bot], __ldg(wr + j), __ldg(wi + j), add,
                     inverse, out);
      s_re[top] = out[0];
      s_im[top] = out[1];
      s_re[bot] = out[2];
      s_im[bot] = out[3];
    }
    __syncthreads();
  }

  // Store in natural order.
  for (int idx = threadIdx.x; idx < elems; idx += AXIS_THREADS) {
    int t, e;
    long long at;
    if (!axis_element(ax, idx, &t, &e, &at)) continue;
    const int slot = (t << ax.log_n) | e;
    out_re[at] = (int32_t)s_re[slot];
    out_im[at] = (int32_t)s_im[slot];
  }
}

struct LaunchAxis {
  const int32_t* in_re;
  const int32_t* in_im;
  int32_t* out_re;
  int32_t* out_im;
  Axis ax;
  const int32_t* tw_re;
  const int32_t* tw_im;
  int inverse;
  unsigned int blocks;
  size_t smem;
  cudaStream_t stream;

  template <class Add>
  int operator()(const Add& add) const {
    butterfly_axis_kernel<Add><<<blocks, AXIS_THREADS, smem, stream>>>(
        in_re, in_im, out_re, out_im, ax, tw_re, tw_im, add, inverse);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int butterfly_launch(const void* ar, const void* ai,
                                const void* br, const void* bi,
                                long long ld_ar, long long ld_ai,
                                long long ld_br, long long ld_bi,
                                const void* w_re, const void* w_im, void* tr,
                                void* ti, void* cr, void* ci, long long rows,
                                long long half, int kind, int n_bits, int m,
                                int k, int fast, int inverse, void* stream) {
  if (rows <= 0 || half <= 0) return 0;
  LaunchStage launch;
  launch.in.ar = (const int32_t*)ar;
  launch.in.ai = (const int32_t*)ai;
  launch.in.br = (const int32_t*)br;
  launch.in.bi = (const int32_t*)bi;
  launch.in.ld_ar = ld_ar;
  launch.in.ld_ai = ld_ai;
  launch.in.ld_br = ld_br;
  launch.in.ld_bi = ld_bi;
  launch.w_re = (const int32_t*)w_re;
  launch.w_im = (const int32_t*)w_im;
  launch.out[0] = (int32_t*)tr;
  launch.out[1] = (int32_t*)ti;
  launch.out[2] = (int32_t*)cr;
  launch.out[3] = (int32_t*)ci;
  launch.rows = rows;
  launch.half = half;
  launch.inverse = inverse;
  launch.stream = (cudaStream_t)stream;
  return with_adder(make_adder(kind, n_bits, m, k, fast), launch);
}

// tw_re/tw_im: the n - 1 Q1.14 twiddles of every stage, stage half h at
// offset h - 1.  The layout (strides, inner count and its divider, log
// sizes, t_fast) is what kernels/butterfly.py's axis_plan chose; an entry
// that would not fit one block is refused.
extern "C" int butterfly_axis_launch(
    const void* in_re, const void* in_im, void* out_re, void* out_im,
    int transforms, long long s_outer, long long s_inner, long long s_elem,
    int n_inner, unsigned int magic, int shift, int log_n, int log_per_block,
    int t_fast, const void* tw_re, const void* tw_im, int kind, int n_bits,
    int m, int k, int fast, int inverse, void* stream) {
  if (log_n < 1 || log_per_block < 0 ||
      log_n + log_per_block > MAX_LOG_ELEMS || n_inner < 1 || shift < 0 ||
      shift > 31 || transforms < 0)
    return (int)cudaErrorInvalidValue;
  if (transforms == 0) return 0;
  LaunchAxis launch;
  launch.in_re = (const int32_t*)in_re;
  launch.in_im = (const int32_t*)in_im;
  launch.out_re = (int32_t*)out_re;
  launch.out_im = (int32_t*)out_im;
  launch.ax.s_outer = s_outer;
  launch.ax.s_inner = s_inner;
  launch.ax.s_elem = s_elem;
  launch.ax.transforms = transforms;
  launch.ax.n_inner = (uint32_t)n_inner;
  launch.ax.magic = magic;
  launch.ax.shift = shift;
  launch.ax.log_n = log_n;
  launch.ax.log_per_block = log_per_block;
  launch.ax.t_fast = t_fast;
  launch.tw_re = (const int32_t*)tw_re;
  launch.tw_im = (const int32_t*)tw_im;
  launch.inverse = inverse;
  launch.blocks = (unsigned int)(((long long)transforms +
                                  (1LL << log_per_block) - 1) >>
                                 log_per_block);
  launch.smem = 2 * sizeof(uint32_t) * ((size_t)1 << (log_n + log_per_block));
  launch.stream = (cudaStream_t)stream;
  return with_adder(make_adder(kind, n_bits, m, k, fast), launch);
}
