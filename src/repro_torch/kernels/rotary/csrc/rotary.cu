// Rotary position embeddings (B9) for Hopper, sm_90a: every RoPE of the
// port's models, forward and backward, one pass over q or k.
//
// Replaces no TPU kernel: it is XLA's fusion of src/repro/models/layers.py:
// 79-88 (apply_rope: x's halves rotated by the positions' angles, in
// float32, rounded once to x's dtype) inside the jitted step
// (src/repro/launch/train.py:76), which reads x once and writes it once.
// The port ran it as about eight eager aten kernels (the float32 copy, the
// halves' four products, the difference, the sum, the concatenation, the
// cast), each a pass over memory, and its backward as many again.
//
// out = [x1 * cos - x2 * sin, x2 * cos + x1 * sin] for x = [x1 | x2], its
// last dimension split in halves; cos and sin are float32 (B, S, half)
// tables that the wrapper computes once a call with the plain version's own
// code (kernel.py), so the kernel reads angles it did not make.  The
// backward is the same rotation with -sin (negate): [d1 * cos + d2 * sin,
// d2 * cos - d1 * sin].
//
// What bounds it: bytes.  x read once and out written once (4 B an element
// at bf16) and the tables' 8 B a (token, pair) read from L2 for all heads;
// six float32 operations a pair.  phi4-mini's q and k at 2 x 512 tokens
// (4.2 M elements a layer): 5.0 us a layer at 3.35 TB/s.
//
// The design (a simple kernel first):
// * One block of 128 threads a token (b, s), over its heads' pairs in
//   order: item i is head i / (half / V) and the V pairs from (i % (half /
//   V)) * V, V = 4 when every row of x, the tables and the output sits on
//   V elements, else 1.  x is read through its strides (b, s, head; the
//   last dimension contiguous): DeepSeek's q_rope, a 64-wide view in q's
//   192-wide heads, and k_rope, a view in the latents' 576-wide rows, are
//   read where they lie.  out is written contiguous (B, S, heads, 2 half).
// * Each product, difference and sum is written with a round-to-nearest
//   intrinsic (__fmul_rn, __fsub_rn, __fadd_rn), so nvcc contracts none of
//   them into an FMA: each rounds once, in the plain version's order, and
//   the result is the plain version's bits, forward and backward.  The
//   store rounds to nearest even, as torch's cast does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V * sizeof(T) bytes: 8 or 16 when V = 4, one element when V = 1
template <typename T, int V>
using Raw = typename std::conditional<V * sizeof(T) == 16, uint4,
                                      typename std::conditional<V * sizeof(T) == 8, uint2,
                                                                T>::type>::type;

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  alignas(16) T e[V];
  *reinterpret_cast<Raw<T, V>*>(e) = *reinterpret_cast<const Raw<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_f<T>(e[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  alignas(16) T e[V];
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = from_f<T>(v[k]);
  *reinterpret_cast<Raw<T, V>*>(p) = *reinterpret_cast<const Raw<T, V>*>(e);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
rotary_kernel(const T* __restrict__ x, long long S, long long H, long long half, long long sb,
              long long ss, long long sh, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, long long tb, long long ts, int negate,
              T* __restrict__ out) {
  const long long tok = blockIdx.x;
  const long long b = tok / S, s = tok % S;
  const T* xt = x + b * sb + s * ss;
  const float* ct = cos_t + b * tb + s * ts;
  const float* st = sin_t + b * tb + s * ts;
  T* ot = out + tok * H * 2 * half;
  const long long per_head = half / V;
  const long long items = H * per_head;
  for (long long i = threadIdx.x; i < items; i += THREADS) {
    const long long h = i / per_head, q = (i - h * per_head) * V;
    float x1[V], x2[V], c[V], sn[V], o1[V], o2[V];
    load<T, V>(xt + h * sh + q, x1);
    load<T, V>(xt + h * sh + half + q, x2);
    load<float, V>(ct + q, c);
    load<float, V>(st + q, sn);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float sk = negate ? -sn[k] : sn[k];
      o1[k] = __fsub_rn(__fmul_rn(x1[k], c[k]), __fmul_rn(x2[k], sk));
      o2[k] = __fadd_rn(__fmul_rn(x2[k], c[k]), __fmul_rn(x1[k], sk));
    }
    store<T, V>(ot + h * 2 * half + q, o1);
    store<T, V>(ot + h * 2 * half + half + q, o2);
  }
}

template <typename T, int V>
int launch(const void* x, long long B, long long S, long long H, long long half, long long sb,
           long long ss, long long sh, const float* cos_t, const float* sin_t, long long tb,
           long long ts, int negate, void* out, cudaStream_t s) {
  rotary_kernel<T, V><<<(unsigned)(B * S), THREADS, 0, s>>>(
      static_cast<const T*>(x), S, H, half, sb, ss, sh, cos_t, sin_t, tb, ts, negate,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's constants, for the wrapper to check against its own.
extern "C" int rotary_threads(void) { return THREADS; }

// Loads every kernel on the current device (the module loads lazily
// otherwise, at a kernel's first launch, which may be under a CUDA graph
// capture).
extern "C" int rotary_init(void) {
  cudaFuncAttributes attr;
  const void* fns[] = {reinterpret_cast<const void*>(rotary_kernel<float, 1>),
                       reinterpret_cast<const void*>(rotary_kernel<float, 4>),
                       reinterpret_cast<const void*>(rotary_kernel<__nv_bfloat16, 1>),
                       reinterpret_cast<const void*>(rotary_kernel<__nv_bfloat16, 4>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out (B, S, H, 2 half), contiguous, of x (B, S, H, 2 half) at element
// strides (sb, ss, sh, 1), by the float32 tables cos and sin (B, S, half) at
// strides (tb, ts, 1); negate rotates by -sin (the backward).  bf16 selects
// __nv_bfloat16 for x and out, else float; vec reads and writes 4 elements
// at a time.  B * S > 0 (the wrapper launches nothing for no tokens).
extern "C" int rotary(const void* x, long long B, long long S, long long H, long long half,
                      long long sb, long long ss, long long sh, const float* cos_t,
                      const float* sin_t, long long tb, long long ts, int negate, int bf16,
                      int vec, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return vec ? launch<__nv_bfloat16, 4>(x, B, S, H, half, sb, ss, sh, cos_t, sin_t, tb, ts,
                                          negate, out, s)
               : launch<__nv_bfloat16, 1>(x, B, S, H, half, sb, ss, sh, cos_t, sin_t, tb, ts,
                                          negate, out, s);
  }
  return vec ? launch<float, 4>(x, B, S, H, half, sb, ss, sh, cos_t, sin_t, tb, ts, negate, out,
                                s)
             : launch<float, 1>(x, B, S, H, half, sb, ss, sh, cos_t, sin_t, tb, ts, negate, out,
                                s);
}
