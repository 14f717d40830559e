// AdamW with global-norm clipping (B4) for Hopper, sm_90a: the optimizer
// update of a training step, one pass over the gradients for the norm and
// one pass over every parameter's state for the update.
//
// Replaces no TPU kernel: it is XLA's fusion of src/repro/optim/adamw.py:29-71
// inside the jitted step (src/repro/launch/train.py:76, the parameters and
// the moments donated).  There global_norm's square-and-sum, the clip and
// each leaf's upd become one reduction that reads each gradient once and one
// element-wise pass that reads the gradient, the parameter and both moments
// once and writes the parameter and the moments once.  PyTorch has no call
// for JAX's casts (a bf16 gradient clipped in bf16, the update in float32,
// the parameter rounded back to bf16, float32 moments): its fused AdamW
// takes one dtype for the parameters and the moments.
//
// What bounds it: bytes.  A bf16 parameter moves 24 B a step: its gradient
// read for the norm (2), then the gradient, the parameter and the two
// float32 moments read (2 + 2 + 4 + 4) and the parameter and the moments
// written (2 + 4 + 4); a float32 one 32 B.  About 20 float32 operations an
// element against 24 B is far below the card's balance point.  phi4-mini's
// 4.45 B parameters move 106.8 GB: 31.9 ms at 3.35 TB/s.
//
// The design:
// * Three kernels, each launched once a leaf (kernel.py's choose_launch, a
//   function of the leaf's size and dtype alone, gives the grid): a leaf of
//   a model is large and contiguous, so a grid-stride loop of 256-thread
//   blocks over 16-byte vectors (8 bf16 or 4 float32 elements) streams it at
//   the card's rate, the last vector's tail taken by block 0's thread 0.  A
//   leaf whose base is off 16 bytes (a view) takes the same element order
//   with scalar loads: its bits do not depend on its address.
// * adamw_sumsq: each thread squares its vectors into one float32
//   accumulator a lane (FMA), the block sums them in a fixed tree into one
//   partial, and the last block to finish (a ticket counter, the only
//   atomic; it carries no value) sums the partials in index order into the
//   leaf's sum and resets the counter.  Every leaf's launch reuses the one
//   partials buffer: launches on a stream run in order.
// * adamw_finish (one block): the leaves' sums added in tree order, as
//   JAX's Python sum adds them, the norm, the clip scale min(1, max_norm /
//   (norm + 1e-9)), and, when given the step counter, the step advanced and
//   the bias corrections 1 - b^step, written to four device scalars.
// * adamw_step: JAX's upd, element by element, reading the clip scale, the
//   bias corrections and lr (a device scalar, or a constant) from device
//   memory, so a captured CUDA graph reads each replay's own step and
//   learning rate.  Parameters and moments are updated in place.
//
// Rounding.  Every operation of the update is written with an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn),
// so nvcc contracts none of them into an FMA: each rounds once, in JAX's
// order, as an unfused float32 evaluation of upd does.  The clip rounds the
// scale to the gradient's dtype and the product back to it (a bf16 gradient
// is clipped in bf16, as g * scale.astype(g.dtype) is).  The sum of squares
// uses FMA (one rounding an element); its order is fixed, not torch.sum's.
// No -use_fast_math: division and square root are IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;       // adamw_sumsq: vectors a thread loads before it squares them
constexpr int VEC_BYTES = 16;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, lr;
};

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and back (round to nearest, ties to even)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float<T>(from_float<T>(x)); }

// V = 16 / sizeof(T) elements of vector j, as float32
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_vec(const T* __restrict__ base, long long j,
                                         float (&x)[VEC_BYTES / sizeof(T)]) {
  constexpr int V = VEC_BYTES / sizeof(T);
  if constexpr (ALIGNED) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(base) + j);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (V == 8) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[2 * k] = __uint_as_float(w[k] << 16);
        x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = __uint_as_float(w[k]);
    }
  } else {
#pragma unroll
    for (int l = 0; l < V; ++l) x[l] = to_float<T>(base[j * V + l]);
  }
}

template <typename T, bool ALIGNED>
__device__ __forceinline__ void store_vec(T* __restrict__ base, long long j,
                                          const float (&x)[VEC_BYTES / sizeof(T)]) {
  constexpr int V = VEC_BYTES / sizeof(T);
  if constexpr (ALIGNED) {
    uint32_t w[4];
    if constexpr (V == 8) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k]));
        const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1]));
        w[k] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(x[k]);
    }
    __stcs(reinterpret_cast<uint4*>(base) + j, make_uint4(w[0], w[1], w[2], w[3]));
  } else {
#pragma unroll
    for (int l = 0; l < V; ++l) base[j * V + l] = from_float<T>(x[l]);
  }
}

// n float32 values starting at element e (n a multiple of 4; 16-byte
// aligned when ALIGNED)
template <bool ALIGNED, int N>
__device__ __forceinline__ void load_f32(const float* __restrict__ base, long long e,
                                         float (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    if constexpr (ALIGNED) {
      const float4 u = __ldcs(reinterpret_cast<const float4*>(base + e + k));
      x[k] = u.x; x[k + 1] = u.y; x[k + 2] = u.z; x[k + 3] = u.w;
    } else {
      x[k] = base[e + k]; x[k + 1] = base[e + k + 1];
      x[k + 2] = base[e + k + 2]; x[k + 3] = base[e + k + 3];
    }
  }
}

template <bool ALIGNED, int N>
__device__ __forceinline__ void store_f32(float* __restrict__ base, long long e,
                                          const float (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    if constexpr (ALIGNED) {
      __stcs(reinterpret_cast<float4*>(base + e + k), make_float4(x[k], x[k + 1], x[k + 2],
                                                                  x[k + 3]));
    } else {
      base[e + k] = x[k]; base[e + k + 1] = x[k + 1];
      base[e + k + 2] = x[k + 2]; base[e + k + 3] = x[k + 3];
    }
  }
}

// the block's sum of v in a fixed order (lane tree, then warps in order),
// valid in thread 0; every thread of the block must call it
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, warp_sums[w]);
  }
  __syncthreads();
  return total;
}

// the squares of the tail's elements (fewer than a vector), lane by lane
template <typename T>
__device__ __forceinline__ void add_tail(const T* __restrict__ tail_base, int tail,
                                         float (&acc)[VEC_BYTES / sizeof(T)]) {
  constexpr int V = VEC_BYTES / sizeof(T);
#pragma unroll
  for (int l = 0; l < V; ++l) {
    if (l < tail) {
      const float x = to_float<T>(tail_base[l]);
      acc[l] = __fmaf_rn(x, x, acc[l]);
    }
  }
}

// One leaf's float32 sum of squares into *out.  Thread t of block b takes
// vectors b*THREADS + t, then every gridDim.x*THREADS after it, in order.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
adamw_sumsq_kernel(const T* __restrict__ x, long long nvec, int tail,
                   float* __restrict__ partials, unsigned* __restrict__ ticket,
                   float* __restrict__ out) {
  constexpr int V = VEC_BYTES / sizeof(T);
  float acc[V];
#pragma unroll
  for (int l = 0; l < V; ++l) acc[l] = 0.0f;
  const long long stride = (long long)gridDim.x * THREADS;
  long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; j + (UNROLL - 1) * stride < nvec; j += UNROLL * stride) {
    float xs[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_vec<T, ALIGNED>(x, j + u * stride, xs[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int l = 0; l < V; ++l) acc[l] = __fmaf_rn(xs[u][l], xs[u][l], acc[l]);
    }
  }
  for (; j < nvec; j += stride) {
    float xs[V];
    load_vec<T, ALIGNED>(x, j, xs);
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = __fmaf_rn(xs[l], xs[l], acc[l]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) add_tail<T>(x + nvec * V, tail, acc);
  float s = acc[0];
#pragma unroll
  for (int l = 1; l < V; ++l) s = __fadd_rn(s, acc[l]);
  s = block_sum(s);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) t = __fadd_rn(t, __ldcg(partials + b));
  t = block_sum(t);
  if (threadIdx.x == 0) {
    *out = t;
    *ticket = 0u;
  }
}

// The norm, the clip scale and (with step) the bias corrections:
// out = {norm, scale, bc1, bc2}.  The sums are added one by one in index
// (tree) order by thread 0; the block only stages them in shared memory.
__global__ void __launch_bounds__(THREADS)
adamw_finish_kernel(const float* __restrict__ sums, int n, float* __restrict__ out,
                    int* __restrict__ step, float max_norm, float b1, float b2) {
  __shared__ float chunk[THREADS];
  float total = 0.0f;
  for (int base = 0; base < n; base += THREADS) {
    const int k = base + threadIdx.x;
    chunk[threadIdx.x] = k < n ? sums[k] : 0.0f;
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(THREADS, n - base);
      for (int i = 0; i < m; ++i) total = __fadd_rn(total, chunk[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float norm = __fsqrt_rn(total);
  out[0] = norm;
  out[1] = fminf(1.0f, __fdiv_rn(max_norm, __fadd_rn(norm, 1e-9f)));
  if (step != nullptr) {
    const int s = *step + 1;
    *step = s;
    out[2] = __fsub_rn(1.0f, powf(b1, (float)s));
    out[3] = __fsub_rn(1.0f, powf(b2, (float)s));
  } else {
    out[2] = 1.0f;
    out[3] = 1.0f;
  }
}

// JAX's upd for one element: the clipped gradient g (already in float32),
// the moments m and v and the parameter p in float32; p comes back
// unrounded (the caller rounds it to the parameter's dtype)
template <typename T>
__device__ __forceinline__ void adam_one(float g, float& m, float& v, float& p, float gscale,
                                         int clip, float bc1, float bc2, float lr,
                                         const Hyper& h) {
  if (clip) g = round_to<T>(__fmul_rn(g, gscale));
  const float m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mhat = __fdiv_rn(m2, bc1);
  const float vhat = __fdiv_rn(v2, bc2);
  const float delta = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
                                __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
  m = m2;
  v = v2;
}

// One leaf's update in place; vectors as adamw_sumsq takes them.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
adamw_step_kernel(const T* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
                  T* __restrict__ p, long long nvec, int tail,
                  const float* __restrict__ scalars, const float* __restrict__ lr_ptr,
                  Hyper h, int clip) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const float gscale = round_to<T>(scalars[1]);
  const float bc1 = scalars[2], bc2 = scalars[3];
  const float lr = lr_ptr != nullptr ? *lr_ptr : h.lr;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < nvec; j += stride) {
    float gs[V], ps[V], ms[V], vs[V];
    load_vec<T, ALIGNED>(g, j, gs);
    load_vec<T, ALIGNED>(p, j, ps);
    load_f32<ALIGNED>(m, j * V, ms);
    load_f32<ALIGNED>(v, j * V, vs);
#pragma unroll
    for (int l = 0; l < V; ++l) adam_one<T>(gs[l], ms[l], vs[l], ps[l], gscale, clip, bc1, bc2, lr, h);
    store_vec<T, ALIGNED>(p, j, ps);
    store_f32<ALIGNED>(m, j * V, ms);
    store_f32<ALIGNED>(v, j * V, vs);
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const long long e = nvec * V + threadIdx.x;
    float pe = to_float<T>(p[e]), me = m[e], ve = v[e];
    adam_one<T>(to_float<T>(g[e]), me, ve, pe, gscale, clip, bc1, bc2, lr, h);
    p[e] = from_float<T>(pe);
    m[e] = me;
    v[e] = ve;
  }
}

template <typename T>
cudaError_t launch_sumsq(const void* x, long long nvec, int tail, int grid, int aligned,
                         float* partials, unsigned* ticket, float* out, cudaStream_t stream) {
  if (aligned) {
    adamw_sumsq_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), nvec, tail, partials, ticket, out);
  } else {
    adamw_sumsq_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), nvec, tail, partials, ticket, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step(const void* g, void* m, void* v, void* p, long long nvec, int tail,
                        int grid, int aligned, const float* scalars, const float* lr_ptr,
                        const Hyper& h, int clip, cudaStream_t stream) {
  if (aligned) {
    adamw_step_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<float*>(m), static_cast<float*>(v),
        static_cast<T*>(p), nvec, tail, scalars, lr_ptr, h, clip);
  } else {
    adamw_step_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<float*>(m), static_cast<float*>(v),
        static_cast<T*>(p), nvec, tail, scalars, lr_ptr, h, clip);
  }
  return cudaGetLastError();
}

}  // namespace

// The kernels' constants, for the wrapper to check against its own.
extern "C" int adamw_threads(void) { return THREADS; }

// Loads every kernel on the current device (the module loads lazily
// otherwise, at a kernel's first launch, which may be under a CUDA graph
// capture).
extern "C" int adamw_init(void) {
  cudaFuncAttributes attr;
  const void* fns[] = {
      reinterpret_cast<const void*>(adamw_sumsq_kernel<float, true>),
      reinterpret_cast<const void*>(adamw_sumsq_kernel<float, false>),
      reinterpret_cast<const void*>(adamw_sumsq_kernel<__nv_bfloat16, true>),
      reinterpret_cast<const void*>(adamw_sumsq_kernel<__nv_bfloat16, false>),
      reinterpret_cast<const void*>(adamw_finish_kernel),
      reinterpret_cast<const void*>(adamw_step_kernel<float, true>),
      reinterpret_cast<const void*>(adamw_step_kernel<float, false>),
      reinterpret_cast<const void*>(adamw_step_kernel<__nv_bfloat16, true>),
      reinterpret_cast<const void*>(adamw_step_kernel<__nv_bfloat16, false>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Each kept leaf's sum of squares: leaf k (pointer x[k], dtype is_bf16[k],
// nvec[k] vectors and tail[k] elements, grid[k] blocks, base aligned[k] to
// 16 bytes) into sums[index[k]].  head points at the ticket counter (one
// uint32, padded to 16 bytes), sums follow it; both are zeroed first, so a
// leaf not passed sums to 0.  partials holds the largest grid's floats.
extern "C" int adamw_sumsq(int n, const unsigned long long* x, const int* is_bf16,
                           const long long* nvec, const int* tail, const int* grid,
                           const int* aligned, const int* index, void* head, int n_sums,
                           float* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = static_cast<unsigned*>(head);
  float* sums = reinterpret_cast<float*>(static_cast<char*>(head) + VEC_BYTES);
  cudaError_t err = cudaMemsetAsync(head, 0, VEC_BYTES + sizeof(float) * n_sums, s);
  for (int k = 0; k < n && err == cudaSuccess; ++k) {
    const void* ptr = reinterpret_cast<const void*>(x[k]);
    err = is_bf16[k]
              ? launch_sumsq<__nv_bfloat16>(ptr, nvec[k], tail[k], grid[k], aligned[k], partials,
                                            ticket, sums + index[k], s)
              : launch_sumsq<float>(ptr, nvec[k], tail[k], grid[k], aligned[k], partials, ticket,
                                    sums + index[k], s);
  }
  return (int)err;
}

// out[0..3] = norm, clip scale, bias corrections (step advanced in place;
// no step: the corrections are 1 and nothing is advanced).
extern "C" int adamw_finish(const float* sums, int n, float* out, int* step, float max_norm,
                            float b1, float b2, void* stream) {
  adamw_finish_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      sums, n, out, step, max_norm, b1, b2);
  return (int)cudaGetLastError();
}

// Leaf k's update in place: gradient g[k], moments m[k] and v[k] (float32),
// parameter p[k] of dtype is_bf16[k]; scalars = {norm, scale, bc1, bc2};
// lr read from lr_ptr when it is not null, else the constant lr.
extern "C" int adamw_step(int n, const unsigned long long* g, const unsigned long long* m,
                          const unsigned long long* v, const unsigned long long* p,
                          const int* is_bf16, const long long* nvec, const int* tail,
                          const int* grid, const int* aligned, const float* scalars,
                          const float* lr_ptr, float lr, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, int clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, wd, lr};
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < n && err == cudaSuccess; ++k) {
    const void* gk = reinterpret_cast<const void*>(g[k]);
    void* mk = reinterpret_cast<void*>(m[k]);
    void* vk = reinterpret_cast<void*>(v[k]);
    void* pk = reinterpret_cast<void*>(p[k]);
    err = is_bf16[k]
              ? launch_step<__nv_bfloat16>(gk, mk, vk, pk, nvec[k], tail[k], grid[k], aligned[k],
                                           scalars, lr_ptr, h, clip, s)
              : launch_step<float>(gk, mk, vk, pk, nvec[k], tail[k], grid[k], aligned[k],
                                   scalars, lr_ptr, h, clip, s);
  }
  return (int)err;
}
