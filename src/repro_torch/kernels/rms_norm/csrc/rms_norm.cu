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
// balance point.  phi4-mini's 1024 x 3072 bf16 rows: 3.8 us forward, 5.6
// backward at 3.35 TB/s.
//
// The forward:
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
// * It reads the row twice (its sum of squares, then y), the second time
//   from L1, and writes each row's float32 rstd for the backward.
//
// The backward (kernel.py's choose_backward; two kernels a call).  With
// g = dy * (offset + scale): dx = rstd * (g - x * (rstd^2 * sum(g * x) /
// width)), and d(scale) = the rows' dy * (x * rstd) summed.
// * A team takes a row: a warp (rows of at most 32 x MAX_ITEMS groups,
//   eight teams a block) or, for wider rows that lie on 16 bytes, a block
//   of up to eight warps.  Thread t of a
//   team owns groups t, t + n, ..., at most MAX_ITEMS of them, on every row
//   it takes, so a row's x and dy are loaded once into its registers and
//   dx is computed from them: nothing is read twice.  Its columns' (offset
//   + scale) and d(scale) sums stay in registers over all its rows.
// * Where the bytes in flight come from.  Rows that lie on 16 bytes and
//   take a block (every path's but the narrow ones) go through
//   rms_bwd_kernel_tma: thread 0 keeps a ring of `stages` rows of x and dy
//   in flight as bulk copies into shared memory (one mbarrier a stage), so
//   the loads in flight cost no registers; the threads read their groups
//   from the ring.  Narrow rows (rms_bwd_kernel, a warp a row) load into
//   registers and issue the next row's loads before the current row's sum.
// * The grid is sized to the card (kernel.py's choose_backward, its
//   constants chosen by tools/rms_bwd_variants.py --sweep on the card): a
//   block walks rows block, block + grid, ... in order.
// * d(scale) crosses blocks in a fixed order, with no atomics: a block's
//   teams add their sums in shared memory in team order, the CTAs of a
//   thread-block cluster (up to MAX_CLUSTER) add their rows through
//   distributed shared memory in rank order, one partial row a cluster,
//   and rms_dscale_kernel sums the clusters' rows in a fixed tree
//   (FIN_SLICES strided chains, then a butterfly over them).  Both kernels
//   go by programmatic dependent launch, so each one's launch overlaps the
//   tail of the kernel before it; each waits for that grid
//   (griddepcontrol.wait) before it touches memory.
// * Rows wider than the register plan (MAX_ITEMS groups a thread of eight
//   warps), and block rows not on 16 bytes (an odd width, a base off), take
//   rms_bwd_kernel_wide: a block a row, x and dy read twice,
//   the d(scale) sums in shared memory (at most MAX_SMEM bytes), its
//   partial row written as a cluster of one.
//
// Rounding.  Products and sums are written with round-to-nearest
// intrinsics in the plain version's order (ref.py), so nvcc contracts none
// of them into an FMA; the row sums differ from torch's only by their
// order, rsqrtf from torch's rsqrt on the card not at all.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP_ROWS = 8;                 // rows a block in the warp layout
constexpr int MAX_SMEM = 200 * 1024;         // the backward's shared rows, at most
constexpr int MAX_ITEMS = 4;                 // 16-byte groups a thread holds in registers
constexpr int TEAM_THREADS = 256;            // the backward's rows kernel, a block at most
constexpr int WIDE_THREADS = 512;            // rms_bwd_kernel_wide's block
constexpr int MAX_CLUSTER = 8;               // CTAs a cluster, the portable most
constexpr int FIN_COLS = 32;                 // rms_dscale_kernel: columns a block (a lane each)
constexpr int FIN_SLICES = 32;               //   and its strided chains over the rows (a warp each)

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

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

struct Bwd {
  const void* x;
  long long xs;                 // x's row stride, elements
  const void* dy;
  long long dys;
  const float* rstd;
  long long rows, width;
  const float* scale;
  float offset;
  void* dx;                     // rows x width, contiguous
  float* partial;               // the clusters' d(scale) rows, clusters x width
};

// element k of a 16-byte group held as raw bits (k a constant once unrolled)
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int k);
template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int k) {
  return __uint_as_float(k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int k) {
  const int i = k >> 1;
  const unsigned w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// group j of a row as raw bits: one vector, or element by element
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ row, long long j) {
  constexpr int N = G<T>::N;
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(row + j * N);
  } else if constexpr (sizeof(T) == 4) {
    const float* r = reinterpret_cast<const float*>(row) + j * N;
    return make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]), __float_as_uint(r[2]),
                      __float_as_uint(r[3]));
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row) + j * N;
    return make_uint4(r[0] | ((unsigned)r[1] << 16), r[2] | ((unsigned)r[3] << 16),
                      r[4] | ((unsigned)r[5] << 16), r[6] | ((unsigned)r[7] << 16));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a lost arrival
// fails the launch (illegal instruction) after two seconds of waiting
// instead of spinning forever
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long since = 0;
  for (uint32_t tries = 1;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries % 1024 == 0) {
      long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (since == 0) since = now;
      else if (now - since > 2000000000LL) __trap();
    }
  }
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// This CTA's d(scale) row (`part`, width floats in shared memory) and its
// cluster's other CTAs' rows, added in rank order through distributed
// shared memory: rank q writes columns [q w / c, (q + 1) w / c) of the
// cluster's partial row (four columns a load when the width allows).
__device__ __forceinline__ void cluster_partial(float* part, long long width,
                                                float* __restrict__ partial) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();                    // every CTA's row is in its shared memory
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const float* peer[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) peer[q] = q < c ? cl.map_shared_rank(part, q) : part;
  float* out = partial + (long long)(blockIdx.x / c) * width;
  if ((width & 3) == 0) {       // four columns a load (the rows lie on 16 bytes)
    const long long quads = width >> 2, per = (quads + c - 1) / c, lo = rank * per;
    const long long hi = lo + per < quads ? lo + per : quads;
    for (long long q4 = lo + threadIdx.x; q4 < hi; q4 += blockDim.x) {
      float4 s = reinterpret_cast<const float4*>(peer[0])[q4];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q) {
        if (q < c) {
          const float4 v = reinterpret_cast<const float4*>(peer[q])[q4];
          s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                          __fadd_rn(s.w, v.w));
        }
      }
      reinterpret_cast<float4*>(out)[q4] = s;
    }
  } else {
    const long long per = (width + c - 1) / c, lo = rank * per;
    const long long hi = lo + per < width ? lo + per : width;
    for (long long col = lo + threadIdx.x; col < hi; col += blockDim.x) {
      float s = peer[0][col];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q) {
        if (q < c) s = __fadd_rn(s, peer[q][col]);
      }
      out[col] = s;
    }
  }
  cl.sync();                    // no CTA leaves while another reads its row
}

// x's and dy's groups of row R into XV, DV (raw), thread 0's tail into XT,
// DT, the row's rstd into RS
#define RMS_LOAD_ROW(R, XV, DV, XT, DT, RS)                                        \
  {                                                                                \
    const T* xr = x + (R) * p.xs;                                                  \
    const T* dr = dy + (R) * p.dys;                                                \
    _Pragma("unroll") for (int k = 0; k < K; ++k) {                                \
      const long long j = t + (long long)k * nt;                                   \
      if (j < groups) {                                                            \
        XV[k] = load_raw<T, VEC>(xr, j);                                           \
        DV[k] = load_raw<T, VEC>(dr, j);                                           \
      }                                                                            \
    }                                                                              \
    _Pragma("unroll") for (int i = 0; i < TAIL; ++i) {                             \
      if (t == 0 && i < ntail) {                                                   \
        XT[i] = to_f<T>(xr[tail0 + i]);                                            \
        DT[i] = to_f<T>(dr[tail0 + i]);                                            \
      }                                                                            \
    }                                                                              \
    RS = p.rstd[R];                                                                \
  }

// Narrow rows: a warp a row, a row each of the block's warps, each lane K
// groups of it in registers.  The plan guarantees 32 K >= width / N.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(TEAM_THREADS) rms_bwd_kernel(Bwd p) {
  constexpr int N = G<T>::N;
  constexpr int TAIL = VEC ? 1 : N - 1;     // a vector row has no tail (ntail 0)
  extern __shared__ float part[];           // a d(scale) row a warp
  const int t = threadIdx.x & 31, team = threadIdx.x >> 5, teams = blockDim.x >> 5;
  constexpr int nt = 32;
  const long long width = p.width, groups = width / N, tail0 = groups * N;
  const int ntail = VEC ? 0 : (int)(width - tail0);
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ dy = static_cast<const T*>(p.dy);
  T* __restrict__ dx = static_cast<T*>(p.dx);
  asm volatile("griddepcontrol.wait;" ::: "memory");       // the kernels before have written x, dy

  float sc[K][N], acc[K][N], sct[TAIL], acct[TAIL];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = t + (long long)k * nt;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sc[k][i] = j < groups ? __fadd_rn(p.offset, p.scale[j * N + i]) : 0.0f;
      acc[k][i] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    sct[i] = t == 0 && i < ntail ? __fadd_rn(p.offset, p.scale[tail0 + i]) : 0.0f;
    acct[i] = 0.0f;
  }

  // this row's groups (a) and the next row's (b), raw; thread 0's tail
  uint4 xa[K], da[K], xb[K], db[K];
  float xta[TAIL], dta[TAIL], xtb[TAIL], dtb[TAIL];
  float ra = 0.0f, rb = 0.0f;
  long long row = (long long)blockIdx.x * teams + team;
  const long long step = (long long)gridDim.x * teams;
  if (row < p.rows) RMS_LOAD_ROW(row, xa, da, xta, dta, ra)
  for (; row < p.rows; row += step) {
    // the next row's loads go out before this row's sum
    const long long next = row + step;
    if (next < p.rows) RMS_LOAD_ROW(next, xb, db, xtb, dtb, rb)
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (t + (long long)k * nt < groups) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float g = __fmul_rn(elem<T>(da[k], i), sc[k][i]);
          c = __fadd_rn(c, __fmul_rn(g, elem<T>(xa[k], i)));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TAIL; ++i) {
      if (t == 0 && i < ntail) c = __fadd_rn(c, __fmul_rn(__fmul_rn(dta[i], sct[i]), xta[i]));
    }
    c = warp_sum(c);
    const float r = ra;
    const float kk = __fdiv_rn(__fmul_rn(__fmul_rn(r, r), c), (float)width);
    T* out = dx + row * width;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long j = t + (long long)k * nt;
      if (j < groups) {
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xv = elem<T>(xa[k], i), dv = elem<T>(da[k], i);
          const float g = __fmul_rn(dv, sc[k][i]);
          o[i] = __fmul_rn(r, __fsub_rn(g, __fmul_rn(xv, kk)));
          acc[k][i] = __fadd_rn(acc[k][i], __fmul_rn(dv, __fmul_rn(xv, r)));
        }
        store_group<T, VEC>(out, j, o);
      }
    }
#pragma unroll
    for (int i = 0; i < TAIL; ++i) {
      if (t == 0 && i < ntail) {
        const float g = __fmul_rn(dta[i], sct[i]);
        out[tail0 + i] = from_f<T>(__fmul_rn(r, __fsub_rn(g, __fmul_rn(xta[i], kk))));
        acct[i] = __fadd_rn(acct[i], __fmul_rn(dta[i], __fmul_rn(xta[i], r)));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xa[k] = xb[k];
      da[k] = db[k];
    }
#pragma unroll
    for (int i = 0; i < TAIL; ++i) {
      xta[i] = xtb[i];
      dta[i] = dtb[i];
    }
    ra = rb;
  }
  // the rows are done: rms_dscale_kernel may launch (it waits for this grid)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  float* mine = part + team * width;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = t + (long long)k * nt;
    if (j < groups) {
#pragma unroll
      for (int i = 0; i < N; ++i) mine[j * N + i] = acc[k][i];
    }
  }
#pragma unroll
  for (int i = 0; i < TAIL; ++i) {
    if (t == 0 && i < ntail) mine[tail0 + i] = acct[i];
  }
  __syncthreads();              // the warps' rows, in warp order, into row 0
  for (long long col = threadIdx.x; col < width; col += blockDim.x) {
    float s = part[col];
    for (int w = 1; w < teams; ++w) s = __fadd_rn(s, part[w * width + col]);
    part[col] = s;
  }
  cluster_partial(part, width, p.partial);
}

#undef RMS_LOAD_ROW

// The rows in a ring of shared memory (aligned rows, a block a row): with
// the grid's dependencies met (programmatic dependent launch), thread 0
// keeps `stages` rows of x and dy in flight as bulk copies, each stage's
// mbarrier completing when both have landed.  Every thread reads its K
// groups of the row into registers; once the row-sum barrier has passed
// (every thread holds its groups) thread 0 refills the stage with the row
// `stages` rows on.  The arithmetic is rms_bwd_kernel's, the row's sum over
// the block's warps.
template <typename T, int K>
__global__ void __launch_bounds__(TEAM_THREADS) rms_bwd_kernel_tma(Bwd p, int stages) {
  constexpr int N = G<T>::N;
  extern __shared__ __align__(128) unsigned char ring[];    // stages x (x row, dy row)
  __shared__ float red[2][TEAM_THREADS / 32];               // the warps' row sums, two rows in turn
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int t = threadIdx.x, nt = blockDim.x;
  const long long width = p.width, groups = width / N;
  const uint32_t rb = (uint32_t)(width * sizeof(T));
  float* part = reinterpret_cast<float*>(ring + (size_t)stages * 2 * rb);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + width);
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ dy = static_cast<const T*>(p.dy);
  T* __restrict__ dx = static_cast<T*>(p.dx);
  const long long step = gridDim.x;

  auto issue = [&](int s, long long row) {
    const uint32_t bar = smem_u32(&full[s]), dst = smem_u32(ring + (size_t)s * 2 * rb);
    mbar_expect_tx(bar, 2 * rb);
    bulk_copy(dst, x + row * p.xs, rb, bar);
    bulk_copy(dst + rb, dy + row * p.dys, rb, bar);
  };
  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");       // the kernels before have written x, dy
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      if (blockIdx.x + s * step < p.rows) issue(s, blockIdx.x + s * step);
    }
  }

  float sc[K][N], acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = t + (long long)k * nt;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sc[k][i] = j < groups ? __fadd_rn(p.offset, p.scale[j * N + i]) : 0.0f;
      acc[k][i] = 0.0f;
    }
  }
  int buf = 0, s = 0;
  uint32_t phase = 0;
  for (long long row = blockIdx.x; row < p.rows; row += step) {
    const float r = p.rstd[row];
    mbar_wait(smem_u32(&full[s]), phase);
    const unsigned char* sx = ring + (size_t)s * 2 * rb;
    uint4 xa[K], da[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long j = t + (long long)k * nt;
      if (j < groups) {
        xa[k] = *reinterpret_cast<const uint4*>(sx + j * 16);
        da[k] = *reinterpret_cast<const uint4*>(sx + rb + j * 16);
      }
    }
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (t + (long long)k * nt < groups) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float g = __fmul_rn(elem<T>(da[k], i), sc[k][i]);
          c = __fadd_rn(c, __fmul_rn(g, elem<T>(xa[k], i)));
        }
      }
    }
    c = warp_sum(c);
    if (lane == 0) red[buf][warp] = c;
    __syncthreads();            // every thread holds its groups of stage s
    if (t == 0 && row + stages * step < p.rows) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s, row + stages * step);
    }
    c = 0.0f;
    for (int w = 0; w < warps; ++w) c = __fadd_rn(c, red[buf][w]);
    buf ^= 1;
    const float kk = __fdiv_rn(__fmul_rn(__fmul_rn(r, r), c), (float)width);
    T* out = dx + row * width;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long j = t + (long long)k * nt;
      if (j < groups) {
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xv = elem<T>(xa[k], i), dv = elem<T>(da[k], i);
          const float g = __fmul_rn(dv, sc[k][i]);
          o[i] = __fmul_rn(r, __fsub_rn(g, __fmul_rn(xv, kk)));
          acc[k][i] = __fadd_rn(acc[k][i], __fmul_rn(dv, __fmul_rn(xv, r)));
        }
        store_group<T, true>(out, j, o);
      }
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = t + (long long)k * nt;
    if (j < groups) {
#pragma unroll
      for (int i = 0; i < N; ++i) part[j * N + i] = acc[k][i];
    }
  }
  cluster_partial(part, width, p.partial);
}

// Rows wider than the register plan: a block a row, x and dy read twice
// (the row's sum, then dx), each thread's columns' d(scale) sums in shared
// memory; launched as clusters of one.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS) rms_bwd_kernel_wide(Bwd p) {
  constexpr int N = G<T>::N;
  extern __shared__ float acc[];            // width floats
  __shared__ float red[32];
  const int t = threadIdx.x, nt = blockDim.x;
  const long long width = p.width, groups = width / N;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ dy = static_cast<const T*>(p.dy);
  T* __restrict__ dx = static_cast<T*>(p.dx);
  asm volatile("griddepcontrol.wait;" ::: "memory");       // the kernels before have written x, dy
  for (long long col = t; col < width; col += nt) acc[col] = 0.0f;
  for (long long row = blockIdx.x; row < p.rows; row += gridDim.x) {
    const T* xr = x + row * p.xs;
    const T* dr = dy + row * p.dys;
    const float r = p.rstd[row];
    float c = 0.0f;
    for (long long j = t; j < groups; j += nt) {
      float xv[N], dv[N];
      load_group<T, VEC>(xr, j, xv);
      load_group<T, VEC>(dr, j, dv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float g = __fmul_rn(dv[k], __fadd_rn(p.offset, p.scale[j * N + k]));
        c = __fadd_rn(c, __fmul_rn(g, xv[k]));
      }
    }
    if (t == 0) {
      for (long long e = groups * N; e < width; ++e) {
        const float g = __fmul_rn(to_f<T>(dr[e]), __fadd_rn(p.offset, p.scale[e]));
        c = __fadd_rn(c, __fmul_rn(g, to_f<T>(xr[e])));
      }
    }
    c = block_sum(c, red);
    const float kk = __fdiv_rn(__fmul_rn(__fmul_rn(r, r), c), (float)width);
    T* out = dx + row * width;
    for (long long j = t; j < groups; j += nt) {
      float xv[N], dv[N], o[N];
      load_group<T, VEC>(xr, j, xv);
      load_group<T, VEC>(dr, j, dv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float g = __fmul_rn(dv[k], __fadd_rn(p.offset, p.scale[j * N + k]));
        o[k] = __fmul_rn(r, __fsub_rn(g, __fmul_rn(xv[k], kk)));
        acc[j * N + k] = __fadd_rn(acc[j * N + k], __fmul_rn(dv[k], __fmul_rn(xv[k], r)));
      }
      store_group<T, VEC>(out, j, o);
    }
    if (t == 0) {
      for (long long e = groups * N; e < width; ++e) {
        const float xv = to_f<T>(xr[e]), dv = to_f<T>(dr[e]);
        const float g = __fmul_rn(dv, __fadd_rn(p.offset, p.scale[e]));
        out[e] = from_f<T>(__fmul_rn(r, __fsub_rn(g, __fmul_rn(xv, kk))));
        acc[e] = __fadd_rn(acc[e], __fmul_rn(dv, __fmul_rn(xv, r)));
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  cluster_partial(acc, width, p.partial);
}

// d(scale)[col] = the clusters' partial rows summed: FIN_SLICES chains
// (chain s, warp s, adds rows s, s + FIN_SLICES, ... in order, a lane a
// column), then each column's chains by a butterfly over a warp's lanes, a
// fixed order.  It may start before the rows kernel ends (programmatic
// dependent launch) and waits for that grid before it reads.
__global__ void __launch_bounds__(FIN_COLS * FIN_SLICES)
    rms_dscale_kernel(const float* __restrict__ partial, int parts, long long width,
                      float* __restrict__ dscale) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float red[FIN_SLICES][FIN_COLS + 1];
  const int lane = threadIdx.x % FIN_COLS, slice = threadIdx.x / FIN_COLS;
  const long long col0 = (long long)blockIdx.x * FIN_COLS;
  float s = 0.0f;
  if (col0 + lane < width) {
#pragma unroll 4
    for (int b = slice; b < parts; b += FIN_SLICES) {
      s = __fadd_rn(s, partial[(long long)b * width + col0 + lane]);
    }
  }
  red[slice][lane] = s;
  __syncthreads();
  const float v = warp_sum(red[lane][slice]);     // warp `slice` takes column col0 + slice
  if (lane == 0 && col0 + slice < width) dscale[col0 + slice] = v;
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
int init_fwd() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, rms_fwd_kernel<T, VEC, WARP>);
}

// loads a backward kernel and lets it take up to MAX_SMEM bytes of shared rows
template <typename F>
int init_bwd(F* kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

template <typename T, bool VEC>
int init_bwd_all() {
  int err = 0;
  if ((err = init_bwd(rms_bwd_kernel<T, VEC, 1>))) return err;
  if ((err = init_bwd(rms_bwd_kernel<T, VEC, 2>))) return err;
  if ((err = init_bwd(rms_bwd_kernel<T, VEC, 3>))) return err;
  if ((err = init_bwd(rms_bwd_kernel<T, VEC, 4>))) return err;
  if constexpr (VEC) {
    if ((err = init_bwd(rms_bwd_kernel_tma<T, 1>))) return err;
    if ((err = init_bwd(rms_bwd_kernel_tma<T, 2>))) return err;
    if ((err = init_bwd(rms_bwd_kernel_tma<T, 3>))) return err;
    if ((err = init_bwd(rms_bwd_kernel_tma<T, 4>))) return err;
  }
  return init_bwd(rms_bwd_kernel_wide<T, VEC>);
}

// the launch of the backward's rows kernel: a 1-d grid of clusters of
// `cluster` CTAs, by programmatic dependent launch when `pdl`
struct RowsLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  RowsLaunch(int grid, int threads, int smem, int cluster, bool pdl, cudaStream_t s) : cfg{} {
    cfg.gridDim = dim3((unsigned)grid, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
  }
};

template <typename T, bool VEC>
int launch_rows(const Bwd& p, int items, int stages, int threads, int grid, int cluster, int smem,
                cudaStream_t s) {
  RowsLaunch l(grid, threads, smem, cluster, true, s);
  if constexpr (VEC) {
    if (stages) {
      switch (items) {
        case 1: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel_tma<T, 1>, p, stages);
        case 2: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel_tma<T, 2>, p, stages);
        case 3: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel_tma<T, 3>, p, stages);
        default: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel_tma<T, 4>, p, stages);
      }
    }
  }
  switch (items) {
    case 0: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel_wide<T, VEC>, p);
    case 1: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel<T, VEC, 1>, p);
    case 2: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel<T, VEC, 2>, p);
    case 3: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel<T, VEC, 3>, p);
    default: return (int)cudaLaunchKernelEx(&l.cfg, rms_bwd_kernel<T, VEC, 4>, p);
  }
}

// the rows kernel of a (dtype, vector, items, stages) plan, for the occupancy query
template <typename T, bool VEC>
const void* rows_kernel(int items, int stages) {
  if constexpr (VEC) {
    if (stages) {
      switch (items) {
        case 1: return (const void*)rms_bwd_kernel_tma<T, 1>;
        case 2: return (const void*)rms_bwd_kernel_tma<T, 2>;
        case 3: return (const void*)rms_bwd_kernel_tma<T, 3>;
        default: return (const void*)rms_bwd_kernel_tma<T, 4>;
      }
    }
  }
  switch (items) {
    case 0: return (const void*)rms_bwd_kernel_wide<T, VEC>;
    case 1: return (const void*)rms_bwd_kernel<T, VEC, 1>;
    case 2: return (const void*)rms_bwd_kernel<T, VEC, 2>;
    case 3: return (const void*)rms_bwd_kernel<T, VEC, 3>;
    default: return (const void*)rms_bwd_kernel<T, VEC, 4>;
  }
}

}  // namespace

// The kernels' constants, for the wrapper to check against its own.
extern "C" int rms_warp_rows(void) { return WARP_ROWS; }
extern "C" int rms_max_smem(void) { return MAX_SMEM; }
extern "C" int rms_max_items(void) { return MAX_ITEMS; }
extern "C" int rms_max_cluster(void) { return MAX_CLUSTER; }
extern "C" int rms_team_threads(void) { return TEAM_THREADS; }
extern "C" int rms_wide_threads(void) { return WIDE_THREADS; }

// Loads every kernel on the current device and lets the backward's take up
// to MAX_SMEM bytes of shared rows (the module loads lazily otherwise, at a
// kernel's first launch, which may be under a CUDA graph capture).
extern "C" int rms_init(void) {
  int err = 0;
  if ((err = init_fwd<float, false, false>())) return err;
  if ((err = init_fwd<float, false, true>())) return err;
  if ((err = init_fwd<float, true, false>())) return err;
  if ((err = init_fwd<float, true, true>())) return err;
  if ((err = init_fwd<__nv_bfloat16, false, false>())) return err;
  if ((err = init_fwd<__nv_bfloat16, false, true>())) return err;
  if ((err = init_fwd<__nv_bfloat16, true, false>())) return err;
  if ((err = init_fwd<__nv_bfloat16, true, true>())) return err;
  if ((err = init_bwd_all<float, false>())) return err;
  if ((err = init_bwd_all<float, true>())) return err;
  if ((err = init_bwd_all<__nv_bfloat16, false>())) return err;
  if ((err = init_bwd_all<__nv_bfloat16, true>())) return err;
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
// (xs and dys elements apart) and the forward's rstd.  The plan is
// kernel.py's choose_backward: `items` groups a thread in registers (0:
// rms_bwd_kernel_wide), `stages` rows in rms_bwd_kernel_tma's shared ring
// (0: rms_bwd_kernel, a warp a row), `threads` a block, `grid` blocks in
// clusters of `cluster`, `smem` bytes of shared memory; partial is
// (grid / cluster) x width float32 scratch.  Two kernels: the rows, then the
// partial rows' sum, both by programmatic dependent launch (each waits at
// its start for the grid before it).  Returns a CUDA error code (1,
// cudaErrorInvalidValue, for a plan the kernels do not take).
extern "C" int rms_backward(const void* x, long long xs, const void* dy, long long dys,
                            const float* rstd, long long rows, long long width,
                            const float* scale, float offset, int bf16, int vec, int items,
                            int stages, int threads, int grid, int cluster, int smem, void* dx,
                            float* partial, float* dscale, void* stream) {
  const int n = bf16 ? 8 : 4;
  const long long es = bf16 ? 2 : 4;
  const bool warp = items > 0 && stages == 0;
  const long long team = warp ? 32 : threads, teams = warp ? threads / 32 : 1;
  const long long shared = teams * (stages * (2 * width * es + 8) + 4 * width);
  const bool ok = items >= 0 && items <= MAX_ITEMS && threads > 0 && threads % 32 == 0 &&
                  threads <= (items ? TEAM_THREADS : WIDE_THREADS) && stages >= 0 &&
                  (stages == 0 || (vec && items)) && cluster >= 1 && cluster <= MAX_CLUSTER &&
                  grid >= cluster && grid % cluster == 0 && smem >= shared && smem <= MAX_SMEM &&
                  (items == 0 || items * team >= width / n) && (!vec || width % n == 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bwd p{x, xs, dy, dys, rstd, rows, width, scale, offset, dx, partial};
  int err;
  if (bf16) {
    err = vec ? launch_rows<__nv_bfloat16, true>(p, items, stages, threads, grid, cluster, smem, s)
              : launch_rows<__nv_bfloat16, false>(p, items, stages, threads, grid, cluster, smem, s);
  } else {
    err = vec ? launch_rows<float, true>(p, items, stages, threads, grid, cluster, smem, s)
              : launch_rows<float, false>(p, items, stages, threads, grid, cluster, smem, s);
  }
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((width + FIN_COLS - 1) / FIN_COLS), 1, 1);
  cfg.blockDim = dim3(FIN_COLS * FIN_SLICES, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rms_dscale_kernel, (const float*)partial, grid / cluster,
                                 width, dscale);
}

// The card's occupancy for a backward plan, into out[0] and out[1]: blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and clusters at
// once (cudaOccupancyMaxActiveClusters).
extern "C" int rms_bwd_occupancy(int bf16, int vec, int items, int stages, int threads,
                                 int smem, int cluster, int* out) {
  const void* k = bf16 ? (vec ? rows_kernel<__nv_bfloat16, true>(items, stages)
                              : rows_kernel<__nv_bfloat16, false>(items, stages))
                       : (vec ? rows_kernel<float, true>(items, stages)
                              : rows_kernel<float, false>(items, stages));
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, threads,
                                                                  (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  RowsLaunch l(cluster, threads, smem, cluster, false, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(&out[1], k, &l.cfg);
}
