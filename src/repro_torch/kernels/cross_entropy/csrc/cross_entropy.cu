// Token cross-entropy on one shard of the vocabulary (B5) for Hopper,
// sm_90a: the loss of a training step over float32 logits, one pass that
// reads them for the forward and one that reads them and writes their
// gradient for the backward.
//
// Replaces no TPU kernel: it is XLA's fusion of src/repro/training/
// train_lib.py:22-31 (logsumexp, the label's logit) inside the jitted step
// (src/repro/launch/train.py:76), which reads the logits once forward and
// once backward.  On vocabulary-sharded logits XLA reduces the softmax
// across the shards; here each device runs the kernels on its own columns
// and the caller (ops.py) combines the per-row partials over the
// vocabulary's mesh axis, so no device gathers the logits.
//
// What bounds it: bytes.  The forward reads each logit once (4 B) and
// writes three floats a row; the backward reads each logit once and writes
// its gradient once (8 B).  A handful of float32 operations an element is
// far below the card's balance point.  phi4-mini's 2 x 512 x 200064 logits
// (819.5 MB) take 0.245 ms forward and 0.489 ms backward at 3.35 TB/s.
//
// The design (a simple kernel first):
// * One block of THREADS threads a row.  Thread t takes the row's groups
//   of 4 columns t, t + THREADS, ... in order, and thread 0 then the
//   width % 4 columns after the last whole group.  A row whose first
//   column sits on 16 bytes (the base aligned and width a multiple of 4)
//   reads a group as one 16-byte vector, else as four scalars: the order
//   of the arithmetic does not depend on the address, so the bits of a
//   result depend on the shape alone and replays repeat them.
// * ce_partials: each thread keeps an online max m and sum s of exp(x - m)
//   (a new max rescales the sum; -inf columns add 0), the block combines the threads' pairs in
//   a fixed tree (lanes by shuffles, then the warps in order by thread 0),
//   and thread 0 writes the row's m, s and the label's logit (0 when the
//   label's column is not in the shard, NaN when the label is at or past
//   the vocabulary, as JAX's take_along_axis fills).  No atomics.
// * ce_backward: dx = g * (exp(x - lse) - onehot), element by element, the
//   one-hot at the clamped label's column when the shard holds it.
//
// Rounding.  expf is the CUDA library's (2 ulp), no -use_fast_math.  The
// forward's sum differs from the plain version's only by its order and
// the rescaling; the backward rounds the subtraction and the product once
// each, as the plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;       // groups a thread loads before it adds them

// group j (4 floats) of a row
template <bool ALIGNED>
__device__ __forceinline__ float4 load_group(const float* __restrict__ row, long long j) {
  if constexpr (ALIGNED) {
    return __ldcs(reinterpret_cast<const float4*>(row) + j);
  } else {
    const float* p = row + 4 * j;
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

// (m, s) after the values of one group, in column order; while every
// value so far is -inf (m = -inf) nothing is added: exp(-inf - -inf) would
// be NaN where the plain version's exp(-inf - rowmax) is 0
__device__ __forceinline__ void online_add(float& m, float& s, const float4 v) {
  const float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  if (mx > m) {
    s = __fmul_rn(s, expf(m - mx));
    m = mx;
  }
  if (m == -INFINITY) return;
  s = __fadd_rn(s, expf(v.x - m));
  s = __fadd_rn(s, expf(v.y - m));
  s = __fadd_rn(s, expf(v.z - m));
  s = __fadd_rn(s, expf(v.w - m));
}

__device__ __forceinline__ void online_add1(float& m, float& s, const float x) {
  if (x > m) {
    s = __fmul_rn(s, expf(m - x));
    m = x;
  }
  if (m == -INFINITY) return;
  s = __fadd_rn(s, expf(x - m));
}

// two (max, sum) pairs as one; an empty pair (m = -inf) adds nothing
__device__ __forceinline__ void merge(float& m, float& s, const float m2, const float s2) {
  const float mx = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.0f : __fmul_rn(s, expf(m - mx));
  const float b = m2 == -INFINITY ? 0.0f : __fmul_rn(s2, expf(m2 - mx));
  m = mx;
  s = __fadd_rn(a, b);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
ce_partials_kernel(const float* __restrict__ x, const long long* __restrict__ labels,
                   long long width, long long start, long long vocab,
                   float* __restrict__ m_out, float* __restrict__ s_out,
                   float* __restrict__ gold_out) {
  const long long row = blockIdx.x;
  const float* xr = x + row * width;
  const long long groups = width / 4;
  float m = -INFINITY, s = 0.0f;
  long long j = threadIdx.x;
  for (; j + (UNROLL - 1) * THREADS < groups; j += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_group<ALIGNED>(xr, j + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) online_add(m, s, v[u]);
  }
  for (; j < groups; j += THREADS) online_add(m, s, load_group<ALIGNED>(xr, j));
  if (threadIdx.x == 0) {
    for (long long e = 4 * groups; e < width; ++e) online_add1(m, s, xr[e]);
  }

  // the block's pairs in a fixed tree: lanes, then warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, o);
    const float s2 = __shfl_down_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float wm[WARPS], ws[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = wm[0];
  s = ws[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) merge(m, s, wm[w], ws[w]);

  const long long label = labels[row];
  const long long col = (label < 0 ? 0 : label) - start;
  float gold = (col >= 0 && col < width) ? xr[col] : 0.0f;
  if (label >= vocab) gold = __int_as_float(0x7fc00000);        // NaN
  m_out[row] = m;
  s_out[row] = s;
  gold_out[row] = gold;
}

__device__ __forceinline__ float grad_one(float x, float lse, float g, bool hit) {
  return __fmul_rn(g, __fsub_rn(expf(x - lse), hit ? 1.0f : 0.0f));
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
ce_backward_kernel(const float* __restrict__ x, const long long* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   long long width, long long start, float* __restrict__ dx) {
  const long long row = blockIdx.x;
  const float* xr = x + row * width;
  float* dr = dx + row * width;
  const long long groups = width / 4;
  const float l = lse[row], gr = g[row];
  const long long label = labels[row];
  const long long col = (label < 0 ? 0 : label) - start;
  for (long long j = threadIdx.x; j < groups; j += THREADS) {
    const float4 v = load_group<ALIGNED>(xr, j);
    const long long e = 4 * j;
    const float4 d = make_float4(grad_one(v.x, l, gr, e == col), grad_one(v.y, l, gr, e + 1 == col),
                                 grad_one(v.z, l, gr, e + 2 == col),
                                 grad_one(v.w, l, gr, e + 3 == col));
    if constexpr (ALIGNED) {
      __stcs(reinterpret_cast<float4*>(dr) + j, d);
    } else {
      dr[e] = d.x; dr[e + 1] = d.y; dr[e + 2] = d.z; dr[e + 3] = d.w;
    }
  }
  if (threadIdx.x == 0) {
    for (long long e = 4 * groups; e < width; ++e) dr[e] = grad_one(xr[e], l, gr, e == col);
  }
}

}  // namespace

// The kernels' constants, for the wrapper to check against its own.
extern "C" int ce_threads(void) { return THREADS; }

// Loads every kernel on the current device (the module loads lazily
// otherwise, at a kernel's first launch, which may be under a CUDA graph
// capture).
extern "C" int ce_init(void) {
  cudaFuncAttributes attr;
  const void* fns[] = {reinterpret_cast<const void*>(ce_partials_kernel<true>),
                       reinterpret_cast<const void*>(ce_partials_kernel<false>),
                       reinterpret_cast<const void*>(ce_backward_kernel<true>),
                       reinterpret_cast<const void*>(ce_backward_kernel<false>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out = {m[rows], s[rows], gold[rows]} for the shard x (rows x width
// float32, contiguous) of the columns [start, start + width) of a
// vocabulary of vocab columns; labels int64 (rows,).  rows > 0 (the
// wrapper launches nothing for no rows, and for no logits backward).
extern "C" int ce_partials(const float* x, const long long* labels, long long rows,
                           long long width, long long start, long long vocab, int aligned,
                           float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    ce_partials_kernel<true><<<(unsigned)rows, THREADS, 0, s>>>(x, labels, width, start, vocab,
                                                                 out, out + rows, out + 2 * rows);
  } else {
    ce_partials_kernel<false><<<(unsigned)rows, THREADS, 0, s>>>(x, labels, width, start, vocab,
                                                                  out, out + rows, out + 2 * rows);
  }
  return (int)cudaGetLastError();
}

// dx = g[:, None] * (exp(x - lse[:, None]) - onehot), dx laid out as x.
extern "C" int ce_backward(const float* x, const long long* labels, const float* lse,
                           const float* g, long long rows, long long width, long long start,
                           int aligned, float* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    ce_backward_kernel<true><<<(unsigned)rows, THREADS, 0, s>>>(x, labels, lse, g, width, start,
                                                                 dx);
  } else {
    ce_backward_kernel<false><<<(unsigned)rows, THREADS, 0, s>>>(x, labels, lse, g, width, start,
                                                                  dx);
  }
  return (int)cudaGetLastError();
}
