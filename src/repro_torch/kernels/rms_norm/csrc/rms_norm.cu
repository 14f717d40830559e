// RMSNorm (B8) for Hopper, sm_90a: every RMSNorm of the port's models,
// forward and backward, one pass each over the rows.
//
// Replaces no TPU kernel: it is XLA's fusion of src/repro/models/layers.py:
// 57-67 (apply_norm's rmsnorm branch, y = x * rsqrt(mean(x^2) + eps) *
// (1 + scale)) and of _rms(x) * scale (the qk-norm at layers.py:241-243 and
// MLA's kv_norm at src/repro/models/mla.py:70) inside the jitted step
// (src/repro/launch/train.py:76), which reads each row once forward and
// once backward.  The port ran them as 7 eager aten kernels forward and
// about twice that backward, with float32 copies of each row in memory.
//
// y = (float(x) * rstd * (offset + scale)).to(x.dtype), rstd = rsqrt(
// mean(float(x)^2) + eps), a row at a time; scale is float32 (width,),
// offset 1.0 (apply_norm) or 0.0 (_rms * scale).
//
// What bounds it: bytes.  The forward reads x and writes y (4 B an element
// at bf16) and one float a row; the backward reads x and dy and writes dx
// (6 B).  A few float32 operations an element is far below the card's
// balance point.  phi4-mini's 1024 x 3072 bf16 rows: 1.9 us forward, 2.8
// backward at 3.35 TB/s.
//
// The design (a simple kernel first):
// * A row is width elements of x, rows `stride` elements apart (MLA's c_kv
//   is a 512-wide view in 576-wide rows: read where it lies).  y and dx are
//   written contiguous.  A row is cut into groups of 16 bytes (8 bf16 or 4
//   float32 elements); thread t of a row takes groups t, t + n, ... in
//   order, and thread 0 the width % group elements after the last whole
//   group.  When every row of every operand starts on 16 bytes the groups
//   load as one vector, else element by element: the order of the
//   arithmetic is the same, so the bits depend on the shape alone.
// * Narrow rows (width <= 1024, kernel.py's choose_launch) take a warp a
//   row, eight rows a block; wide rows a block a row of 64-512 threads.
//   The row's sum is a butterfly over the warp's lanes (every lane gets the
//   same value), then the warps' sums in order.
// * The forward reads the row twice (its sum of squares, then y), the
//   second time from L1; it writes each row's float32 rstd for the
//   backward.
// * The backward is persistent: a grid of at most kernel.BWD_BLOCKS blocks
//   walks the rows in a fixed order.  With g = dy * (offset + scale):
//   dx = rstd * (g - x * (rstd^2 * sum(g * x) / width)), and each thread
//   adds dy * (x * rstd) of its own columns into a float32 accumulator in
//   shared memory (one per warp in the warp layout), so no two threads
//   write one slot.  Each block then writes its partial d(scale) row, and
//   rms_dscale sums the blocks' rows in block order: no atomics, so two
//   runs on the same inputs give the same bits.
//
// Rounding.  Products and sums are written with round-to-nearest
// intrinsics in the plain version's order (ref.py), so nvcc contracts none
// of them into an FMA; the row sums differ from torch's only by their
// order, rsqrtf from torch's rsqrt on the card not at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP_ROWS = 8;                 // rows a block in the warp layout
constexpr int MAX_SMEM = 200 * 1024;         // the backward's accumulators, at most

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

// elements a 16-byte group
template <typename T>
struct G {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T, bool VEC>
__device__ __forceinline__ void load_group(const T* __restrict__ row, long long j,
                                           float (&v)[G<T>::N]) {
  constexpr int N = G<T>::N;
  if constexpr (VEC) {
    alignas(16) T e[N];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(row + j * N);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_f<T>(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_f<T>(row[j * N + k]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_group(T* __restrict__ row, long long j,
                                            const float (&v)[G<T>::N]) {
  constexpr int N = G<T>::N;
  if constexpr (VEC) {
    alignas(16) T e[N];
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint4*>(row + j * N) = *reinterpret_cast<const uint4*>(e);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) row[j * N + k] = from_f<T>(v[k]);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// the block's sum, the same value in every thread; red holds 32 floats
__device__ __forceinline__ float block_sum(float s, float* red) {
  s = warp_sum(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float t = 0.0f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) t = __fadd_rn(t, red[w]);
  __syncthreads();              // red is reused by the next row
  return t;
}

template <typename T, bool VEC>
__device__ __forceinline__ float row_sumsq(const T* __restrict__ xr, long long width, int t,
                                           int nt) {
  constexpr int N = G<T>::N;
  const long long groups = width / N;
  float s = 0.0f;
  for (long long j = t; j < groups; j += nt) {
    float v[N];
    load_group<T, VEC>(xr, j, v);
#pragma unroll
    for (int k = 0; k < N; ++k) s = __fadd_rn(s, __fmul_rn(v[k], v[k]));
  }
  if (t == 0) {
    for (long long e = groups * N; e < width; ++e) {
      const float v = to_f<T>(xr[e]);
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
  }
  return s;
}

template <typename T, bool VEC, bool WARP>
__global__ void rms_fwd_kernel(const T* __restrict__ x, long long stride, long long rows,
                               long long width, const float* __restrict__ scale, float offset,
                               float eps, T* __restrict__ y, float* __restrict__ rstd) {
  constexpr int N = G<T>::N;
  __shared__ float red[32];
  long long row;
  int t, nt;
  if constexpr (WARP) {
    row = (long long)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
    t = threadIdx.x & 31;
    nt = 32;
    if (row >= rows) return;    // the whole warp: the warp layout has no block barrier
  } else {
    row = blockIdx.x;
    t = threadIdx.x;
    nt = blockDim.x;
  }
  const T* xr = x + row * stride;
  float s = row_sumsq<T, VEC>(xr, width, t, nt);
  if constexpr (WARP) {
    s = warp_sum(s);
  } else {
    s = block_sum(s, red);
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(s, (float)width), eps));
  if (t == 0) rstd[row] = r;
  T* yr = y + row * width;
  const long long groups = width / N;
  for (long long j = t; j < groups; j += nt) {
    float v[N];
    load_group<T, VEC>(xr, j, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = __fmul_rn(__fmul_rn(v[k], r), __fadd_rn(offset, scale[j * N + k]));
    }
    store_group<T, VEC>(yr, j, v);
  }
  if (t == 0) {
    for (long long e = groups * N; e < width; ++e) {
      yr[e] = from_f<T>(__fmul_rn(__fmul_rn(to_f<T>(xr[e]), r), __fadd_rn(offset, scale[e])));
    }
  }
}

template <typename T, bool VEC, bool WARP>
__global__ void rms_bwd_kernel(const T* __restrict__ x, long long xs, const T* __restrict__ dy,
                               long long dys, const float* __restrict__ rstd, long long rows,
                               long long width, const float* __restrict__ scale, float offset,
                               T* __restrict__ dx, float* __restrict__ partial) {
  constexpr int N = G<T>::N;
  extern __shared__ float acc[];           // WARP: WARP_ROWS rows of width; else one
  __shared__ float red[32];
  const int warp = threadIdx.x >> 5;
  const int t = WARP ? (threadIdx.x & 31) : threadIdx.x;
  const int nt = WARP ? 32 : blockDim.x;
  float* mine = acc + (WARP ? warp * width : 0);
  const long long groups = width / N;
  // each thread owns the columns of its groups (thread 0 also the tail)
  for (long long j = t; j < groups; j += nt) {
#pragma unroll
    for (int k = 0; k < N; ++k) mine[j * N + k] = 0.0f;
  }
  if (t == 0) {
    for (long long e = groups * N; e < width; ++e) mine[e] = 0.0f;
  }
  const long long per = WARP ? WARP_ROWS : 1;
  const long long items = (rows + per - 1) / per;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long row = WARP ? it * WARP_ROWS + warp : it;
    if (WARP && row >= rows) continue;   // a whole warp; no block barrier in this layout
    const T* xr = x + row * xs;
    const T* dr = dy + row * dys;
    const float r = rstd[row];
    float c = 0.0f;
    for (long long j = t; j < groups; j += nt) {
      float xv[N], dv[N];
      load_group<T, VEC>(xr, j, xv);
      load_group<T, VEC>(dr, j, dv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float g = __fmul_rn(dv[k], __fadd_rn(offset, scale[j * N + k]));
        c = __fadd_rn(c, __fmul_rn(g, xv[k]));
      }
    }
    if (t == 0) {
      for (long long e = groups * N; e < width; ++e) {
        const float g = __fmul_rn(to_f<T>(dr[e]), __fadd_rn(offset, scale[e]));
        c = __fadd_rn(c, __fmul_rn(g, to_f<T>(xr[e])));
      }
    }
    if constexpr (WARP) {
      c = warp_sum(c);
    } else {
      c = block_sum(c, red);
    }
    const float kk = __fdiv_rn(__fmul_rn(__fmul_rn(r, r), c), (float)width);
    T* out = dx + row * width;
    for (long long j = t; j < groups; j += nt) {
      float xv[N], dv[N], o[N];
      load_group<T, VEC>(xr, j, xv);
      load_group<T, VEC>(dr, j, dv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float g = __fmul_rn(dv[k], __fadd_rn(offset, scale[j * N + k]));
        o[k] = __fmul_rn(r, __fsub_rn(g, __fmul_rn(xv[k], kk)));
        mine[j * N + k] = __fadd_rn(mine[j * N + k], __fmul_rn(dv[k], __fmul_rn(xv[k], r)));
      }
      store_group<T, VEC>(out, j, o);
    }
    if (t == 0) {
      for (long long e = groups * N; e < width; ++e) {
        const float xv = to_f<T>(xr[e]), dv = to_f<T>(dr[e]);
        const float g = __fmul_rn(dv, __fadd_rn(offset, scale[e]));
        out[e] = from_f<T>(__fmul_rn(r, __fsub_rn(g, __fmul_rn(xv, kk))));
        mine[e] = __fadd_rn(mine[e], __fmul_rn(dv, __fmul_rn(xv, r)));
      }
    }
  }
  __syncthreads();
  float* pb = partial + (long long)blockIdx.x * width;
  for (long long col = threadIdx.x; col < width; col += blockDim.x) {
    float s = acc[col];
    if constexpr (WARP) {
      for (int w = 1; w < WARP_ROWS; ++w) s = __fadd_rn(s, acc[w * width + col]);
    }
    pb[col] = s;
  }
}

// d(scale)[col] = the blocks' partial rows summed in block order
__global__ void rms_dscale_kernel(const float* __restrict__ partial, int blocks, long long width,
                                  float* __restrict__ dscale) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, partial[(long long)b * width + col]);
  dscale[col] = s;
}

template <typename T, bool VEC, bool WARP>
int launch_fwd(const void* x, long long stride, long long rows, long long width,
               const float* scale, float offset, float eps, int threads, long long grid,
               void* y, float* rstd, cudaStream_t s) {
  rms_fwd_kernel<T, VEC, WARP><<<(unsigned)grid, threads, 0, s>>>(
      static_cast<const T*>(x), stride, rows, width, scale, offset, eps, static_cast<T*>(y),
      rstd);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC, bool WARP>
int launch_bwd(const void* x, long long xs, const void* dy, long long dys, const float* rstd,
               long long rows, long long width, const float* scale, float offset, int threads,
               long long grid, void* dx, float* partial, float* dscale, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)width * (WARP ? WARP_ROWS : 1);
  rms_bwd_kernel<T, VEC, WARP><<<(unsigned)grid, threads, smem, s>>>(
      static_cast<const T*>(x), xs, static_cast<const T*>(dy), dys, rstd, rows, width, scale,
      offset, static_cast<T*>(dx), partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  rms_dscale_kernel<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(partial, (int)grid, width,
                                                                   dscale);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC, bool WARP>
int init_one() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rms_fwd_kernel<T, VEC, WARP>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&attr, rms_bwd_kernel<T, VEC, WARP>);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(rms_bwd_kernel<T, VEC, WARP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

}  // namespace

// The kernels' constants, for the wrapper to check against its own.
extern "C" int rms_warp_rows(void) { return WARP_ROWS; }
extern "C" int rms_max_smem(void) { return MAX_SMEM; }

// Loads every kernel on the current device and lets the backward take up to
// MAX_SMEM bytes of accumulators (the module loads lazily otherwise, at a
// kernel's first launch, which may be under a CUDA graph capture).
extern "C" int rms_init(void) {
  int err = 0;
  if ((err = init_one<float, false, false>())) return err;
  if ((err = init_one<float, false, true>())) return err;
  if ((err = init_one<float, true, false>())) return err;
  if ((err = init_one<float, true, true>())) return err;
  if ((err = init_one<__nv_bfloat16, false, false>())) return err;
  if ((err = init_one<__nv_bfloat16, false, true>())) return err;
  if ((err = init_one<__nv_bfloat16, true, false>())) return err;
  if ((err = init_one<__nv_bfloat16, true, true>())) return err;
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, rms_dscale_kernel);
}

#define RMS_DISPATCH(FN, ...)                                                        \
  if (bf16) {                                                                        \
    if (vec) return warp ? FN<__nv_bfloat16, true, true>(__VA_ARGS__)                \
                         : FN<__nv_bfloat16, true, false>(__VA_ARGS__);              \
    return warp ? FN<__nv_bfloat16, false, true>(__VA_ARGS__)                        \
                : FN<__nv_bfloat16, false, false>(__VA_ARGS__);                      \
  }                                                                                  \
  if (vec) return warp ? FN<float, true, true>(__VA_ARGS__) : FN<float, true, false>(__VA_ARGS__); \
  return warp ? FN<float, false, true>(__VA_ARGS__) : FN<float, false, false>(__VA_ARGS__);

// y (rows x width, contiguous) and rstd (rows) of x's rows, `stride`
// elements apart; bf16 selects __nv_bfloat16 for x and y, else float.
extern "C" int rms_forward(const void* x, long long stride, long long rows, long long width,
                           const float* scale, float offset, float eps, int bf16, int vec,
                           int warp, int threads, long long grid, void* y, float* rstd,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RMS_DISPATCH(launch_fwd, x, stride, rows, width, scale, offset, eps, threads, grid, y, rstd, s)
}

// dx (rows x width, contiguous) and d(scale) (width) from x's and dy's rows
// (xs and dys elements apart) and the forward's rstd; partial is grid x
// width float32 scratch.  Two kernels: the rows, then the partials' sum.
extern "C" int rms_backward(const void* x, long long xs, const void* dy, long long dys,
                            const float* rstd, long long rows, long long width,
                            const float* scale, float offset, int bf16, int vec, int warp,
                            int threads, long long grid, void* dx, float* partial,
                            float* dscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RMS_DISPATCH(launch_bwd, x, xs, dy, dys, rstd, rows, width, scale, offset, threads, grid, dx,
               partial, dscale, s)
}
