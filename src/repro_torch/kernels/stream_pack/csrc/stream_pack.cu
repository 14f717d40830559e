// k independent same-shape matrix products in one launch (stream_pack), for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stream_pack/kernel.py
// (stream_pack_matmul, body _matmul_lane_kernel): out[g] = x[g] @ w[g] for
// every lane g of x (lanes, M, K) and w (lanes, K, N), float32 accumulation,
// output in the input type.  The TPU kernel walks K as its sequential grid
// axis with a float32 accumulator in VMEM.  Here the grid is (N tiles, M
// tiles, lanes), blocks run in any order, and each block walks K itself with
// the accumulator in registers: one load of the whole K panel (the panel
// variant), or a ring of shared-memory stages (the ring variants).  x's lane
// stride is an argument: 0 means one x shared by every lane (parallel
// branches reading the same activation), which is never copied; every block
// of every lane then reads the same x rows, from L2.  The ragged edge is
// masked, so any M, N and K are taken.
//
// What bounds it.  On Nimble's packed path the products are tiny: at the
// darts-like shape (7 lanes of 8x64 @ 64x64, float32, shared x) the work is
// 0.46 MFLOP over 131,072 bytes, a bound of 0.039 us on bytes (H100 SXM,
// 3.35 TB/s).  At such sizes the floor is one launch inside a CUDA graph plus
// one memory round trip per block, so the design spends exactly one round
// trip on a block's loads where the panel fits, fits the tile's rows to M,
// and cuts N into narrow slices so that tens of blocks share the work.
//
// The tile is chosen in Python (kernel.py, choose_launch); the entry point
// sizes the grid and the dynamic shared memory from it.  Variants:
// * f32 panel (stream_pack_f32, STAGES = 1): 128 threads, a BM x 16 tile
//   with BM = 8, 16 or 32 fitted to M, each thread one column of BM/8 rows.
//   The block copies x's BM rows of the whole K and its K x 16 slice of w
//   into shared memory at once, waits once, passes one barrier, then runs
//   the FMAs over the whole K with no barrier inside the loop.  Full float32
//   on the FMA units: no TF32, the reference is full float32.
// * f32 ring (STAGES = 4): the same tile and threads over a 4-stage ring of
//   64-deep K chunks, for panels that do not fit the panel's budget; the
//   copies of chunks c+1 .. c+3 are in flight while chunk c is multiplied.
// * bf16 ring (stream_pack_bf16): mma.sync.m16n8k16 (bf16 in, float32
//   accumulate), one warp per 16 rows of a BM x 32 tile (BM = 16, 32 or 64
//   fitted to M), over a 4-stage ring of 64-deep K chunks.  A fragments are read
//   with ldmatrix, B fragments with ldmatrix.trans from the row-major w
//   chunk.  At M <= 64 and these sizes the work is bound by bytes and
//   latency; wgmma's 64-row warpgroup tile would not change that, so bf16
//   stays on mma.sync until B2 has a compute-bound caller (MoE expert GEMMs
//   with hundreds of tokens per expert).
// Each variant comes in two loaders.  VEC: cp.async 16-byte copies, the
// ragged edge zero-filled by the copy's source size; it needs K and N to be
// whole 16-byte vectors and 16-byte aligned bases.  Otherwise (K or N not a
// multiple of the vector, or a base off 16 bytes): masked element-wise loads
// into the same stages.  Every output element is one thread's sum in
// ascending k: no split-K and no atomics, so two runs give the same bits.
// Dynamic shared memory above 48 KB (a panel of up to 64 KB, a ring of up to
// 56 KB) is allowed by stream_pack_init, which the wrapper calls once per
// device before its first launch, outside any CUDA-graph capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory, L2 only; src_bytes 0 fills zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The K walk shared by every variant: load(c, s) fills stage s with K chunk
// c, compute(s) multiplies stage s into the accumulators.  STAGES == 1: one
// load of the whole panel, one wait, one barrier.  Otherwise a ring: chunks
// c+1 .. c+STAGES-1 are in flight while chunk c is multiplied; the barrier
// at the top of step c also ends every reader of the stage that step c
// refills (chunk c-1's).
template <int STAGES, typename Load, typename Compute>
__device__ __forceinline__ void walk_k(int nchunks, Load load, Compute compute) {
  if constexpr (STAGES == 1) {
    load(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    compute(0);
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nchunks) load(s, s);
      cp_async_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<STAGES - 2>();  // chunk c has landed
      __syncthreads();
      const int next = c + STAGES - 1;
      if (next < nchunks) load(next, next % STAGES);
      cp_async_commit();              // an empty group keeps the count
      compute(c % STAGES);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

// the ring variants: RING_STAGES stages of RING_KC-deep K chunks
constexpr int RING_STAGES = 4;
constexpr int RING_KC = 64;

constexpr int F32_THREADS = 128;
constexpr int F32_BN = 16;  // tile columns: 16 threads across, 8 row groups down

// shared memory per stage: x chunk BM x (kc + 4) (rows padded by 16 bytes),
// w chunk kc x 16
__host__ __device__ constexpr int f32_stage_floats(int bm, int kc) {
  return bm * (kc + 4) + kc * F32_BN;
}

template <int BM, int STAGES, bool VEC>
__global__ void __launch_bounds__(F32_THREADS)
stream_pack_f32(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int M, int N, int K, int kc,
                long long x_lane_stride) {
  constexpr int TM = BM / 8;  // rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sx = reinterpret_cast<float*>(smem_raw);  // STAGES x BM x ldx
  const int ldx = kc + 4;
  float* const sw = sx + STAGES * BM * ldx;              // STAGES x kc x 16

  const int n0 = blockIdx.x * F32_BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int col = tid % F32_BN, rg = tid / F32_BN;  // rows rg + 8 i
  const float* xb = x + (long long)blockIdx.z * x_lane_stride;
  const float* wb = w + (size_t)blockIdx.z * K * N;
  float* ob = out + (size_t)blockIdx.z * M * N;

  auto load = [&](int c, int s) {
    const int k0 = c * kc;
    float* xs = sx + s * BM * ldx;
    float* ws = sw + s * kc * F32_BN;
    if constexpr (VEC) {
      const int xv = kc / 4;  // 16-byte vectors in a chunk row of x
      for (int i = tid; i < BM * xv; i += F32_THREADS) {
        const int r = i / xv, j = i % xv;
        const int gm = m0 + r, gk = k0 + 4 * j;
        const bool ok = gm < M && gk < K;
        cp_async16(xs + r * ldx + 4 * j, ok ? xb + (size_t)gm * K + gk : xb, ok);
      }
      for (int i = tid; i < kc * (F32_BN / 4); i += F32_THREADS) {
        const int r = i / (F32_BN / 4), j = i % (F32_BN / 4);
        const int gk = k0 + r, gn = n0 + 4 * j;
        const bool ok = gk < K && gn < N;
        cp_async16(ws + r * F32_BN + 4 * j, ok ? wb + (size_t)gk * N + gn : wb, ok);
      }
    } else {
      for (int i = tid; i < BM * kc; i += F32_THREADS) {
        const int r = i / kc, j = i % kc;
        const int gm = m0 + r, gk = k0 + j;
        xs[r * ldx + j] = (gm < M && gk < K) ? xb[(size_t)gm * K + gk] : 0.f;
      }
      for (int i = tid; i < kc * F32_BN; i += F32_THREADS) {
        const int r = i / F32_BN, j = i % F32_BN;
        const int gk = k0 + r, gn = n0 + j;
        ws[i] = (gk < K && gn < N) ? wb[(size_t)gk * N + gn] : 0.f;
      }
    }
  };

  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;

  auto compute = [&](int s) {
    const float* xs = sx + s * BM * ldx;
    const float* ws = sw + s * kc * F32_BN + col;
#pragma unroll 4
    for (int k = 0; k < kc; k += 4) {
      const float b0 = ws[(k + 0) * F32_BN], b1 = ws[(k + 1) * F32_BN];
      const float b2 = ws[(k + 2) * F32_BN], b3 = ws[(k + 3) * F32_BN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + (rg + 8 * i) * ldx + k);
        acc[i] = fmaf(a.x, b0, acc[i]);
        acc[i] = fmaf(a.y, b1, acc[i]);
        acc[i] = fmaf(a.z, b2, acc[i]);
        acc[i] = fmaf(a.w, b3, acc[i]);
      }
    }
  };

  walk_k<STAGES>((K + kc - 1) / kc, load, compute);

  const int gn = n0 + col;
  if (gn >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + rg + 8 * i;
    if (gm < M) ob[(size_t)gm * N + gn] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF16_BN = 32;  // tile columns: each warp 16 rows x 32

// shared memory per stage, elements: x chunk BM x 72, w chunk 64 x 40 (rows
// padded by 16 bytes: ldmatrix's 8 rows fall on distinct banks)
__host__ __device__ constexpr int bf16_stage_elems(int bm) {
  return bm * (RING_KC + 8) + RING_KC * (BF16_BN + 8);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(BM / 16 * 32)
stream_pack_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 long long x_lane_stride) {
  constexpr int BN = BF16_BN;
  constexpr int THREADS = BM / 16 * 32;
  constexpr int LDX = RING_KC + 8, LDW = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // stages x BM x LDX
  __nv_bfloat16* const sw = sx + RING_STAGES * BM * LDX;                 // stages x 64 x LDW

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int wm = tid >> 5, lane = tid & 31;  // warp wm: rows wm*16 .. wm*16 + 15
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* xb = x + (long long)blockIdx.z * x_lane_stride;
  const __nv_bfloat16* wb = w + (size_t)blockIdx.z * K * N;
  __nv_bfloat16* ob = out + (size_t)blockIdx.z * M * N;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto load = [&](int c, int s) {
    const int k0 = c * RING_KC;
    __nv_bfloat16* xs = sx + s * BM * LDX;
    __nv_bfloat16* ws = sw + s * RING_KC * LDW;
    if constexpr (VEC) {
      constexpr int XV = RING_KC / 8, WV = BN / 8;  // 16-byte vectors in a row
      for (int i = tid; i < BM * XV; i += THREADS) {
        const int r = i / XV, j = i % XV;
        const int gm = m0 + r, gk = k0 + 8 * j;
        const bool ok = gm < M && gk < K;
        cp_async16(xs + r * LDX + 8 * j, ok ? xb + (size_t)gm * K + gk : xb, ok);
      }
      for (int i = tid; i < RING_KC * WV; i += THREADS) {
        const int r = i / WV, j = i % WV;
        const int gk = k0 + r, gn = n0 + 8 * j;
        const bool ok = gk < K && gn < N;
        cp_async16(ws + r * LDW + 8 * j, ok ? wb + (size_t)gk * N + gn : wb, ok);
      }
    } else {
      for (int i = tid; i < BM * RING_KC; i += THREADS) {
        const int r = i / RING_KC, j = i % RING_KC;
        const int gm = m0 + r, gk = k0 + j;
        xs[r * LDX + j] = (gm < M && gk < K) ? xb[(size_t)gm * K + gk] : zero;
      }
      for (int i = tid; i < RING_KC * BN; i += THREADS) {
        const int r = i / BN, j = i % BN;
        const int gk = k0 + r, gn = n0 + j;
        ws[r * LDW + j] = (gk < K && gn < N) ? wb[(size_t)gk * N + gn] : zero;
      }
    }
  };

  // element e of acc[nb]: row wm*16 + g + 8 (e >> 1), column nb*8 + 2t + (e & 1)
  float acc[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  auto compute = [&](int s) {
    const __nv_bfloat16* xs = sx + s * BM * LDX;
    const __nv_bfloat16* ws = sw + s * RING_KC * LDW;
    const int m = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < RING_KC; kk += 16) {
      // A: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 the same rows at
      // k 8, giving a0 (rows 0-7, k 0-7), a1 (rows 8-15), a2 (k 8-15), a3
      uint32_t a[4];
      ldmatrix_x4(a, xs + (wm * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
      // B by ldmatrix.trans: lanes 8m..8m+7 address the rows of matrix m
      // (k +8 for odd m, columns +8 for m >= 2)
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, ws + (kk + (m & 1) * 8 + (lane & 7)) * LDW + dn * 16 + (m >> 1) * 8);
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
  };

  walk_k<RING_STAGES>((K + RING_KC - 1) / RING_KC, load, compute);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wm * 16 + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = n0 + nb * 8 + 2 * t;
      __nv_bfloat16* o = ob + (size_t)row * N + col;
      if (VEC && col + 1 < N) {  // N even: a 4-byte aligned pair
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[nb][2 * h], acc[nb][2 * h + 1]);
      } else {
        if (col < N) o[0] = __float2bfloat16(acc[nb][2 * h]);
        if (col + 1 < N) o[1] = __float2bfloat16(acc[nb][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the instantiations
// ---------------------------------------------------------------------------

struct Instance {
  int is_bf16, bm, stages, vec;
  const void* fn;
};

// kernel.py's INSTANCES, each tile with both loaders
#define F32(BM, S)                                                          \
  {0, BM, S, 1, (const void*)stream_pack_f32<BM, S, true>},                 \
  {0, BM, S, 0, (const void*)stream_pack_f32<BM, S, false>}
#define BF16(BM)                                                            \
  {1, BM, RING_STAGES, 1, (const void*)stream_pack_bf16<BM, true>},         \
  {1, BM, RING_STAGES, 0, (const void*)stream_pack_bf16<BM, false>}
const Instance kInstances[] = {
    F32(8, 1),  F32(16, 1), F32(32, 1), F32(8, RING_STAGES), F32(16, RING_STAGES),
    F32(32, RING_STAGES), BF16(16), BF16(32), BF16(64),
};
#undef F32
#undef BF16

const void* find_kernel(int is_bf16, int bm, int stages, int vec) {
  for (const Instance& k : kInstances)
    if (k.is_bf16 == is_bf16 && k.bm == bm && k.stages == stages && k.vec == vec) return k.fn;
  return nullptr;
}

}  // namespace

// Allows every kernel the device's largest dynamic shared memory.  Call once
// per device before the first launch there, outside any CUDA-graph capture.
// Returns the first CUDA error (0 on success).
extern "C" int stream_pack_init(void) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const Instance& k : kInstances)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return (int)err;
}

// x: lane g at x + g * x_lane_stride, each (M, K) row-major with rows of K
// elements (x_lane_stride 0: one x for every lane); w: (lanes, K, N) and
// out: (lanes, M, N), contiguous; float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  The tile, as kernel.py's choose_launch gives it: stages
// (1: the f32 panel; 4: a ring), vec (1: cp.async 16-byte copies; 0: masked
// element-wise loads), bm x bn (f32: bn 16; bf16: bn 32) and the K depth kc
// of one stage (f32: a multiple of 4, at least K for the panel, 64 for the
// ring; bf16: 64).  The grid and the dynamic shared memory follow from the
// tile.  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success; cudaErrorInvalidValue
// for a tile it has no kernel for).
extern "C" int stream_pack_matmul(const void* x, const void* w, void* out, int is_bf16,
                                  int lanes, int M, int N, int K,
                                  long long x_lane_stride, int stages, int vec, int bm,
                                  int bn, int kc, void* stream) {
  if (lanes <= 0 || M <= 0 || N <= 0 || K <= 0 || x_lane_stride < 0 || kc <= 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  if (is_bf16) {
    if (bn == BF16_BN && stages == RING_STAGES && kc == RING_KC)
      fn = find_kernel(1, bm, stages, vec);
    threads = bm / 16 * 32;
    smem = (size_t)RING_STAGES * bf16_stage_elems(bm) * sizeof(__nv_bfloat16);
  } else {
    const bool depth_ok =
        kc % 4 == 0 && (stages == 1 ? kc >= K : stages == RING_STAGES && kc == RING_KC);
    if (bn == F32_BN && depth_ok) fn = find_kernel(0, bm, stages, vec);
    threads = F32_THREADS;
    smem = (size_t)stages * f32_stage_floats(bm, kc) * sizeof(float);
  }
  const long long gx = (N + bn - 1) / bn, gy = (M + bm - 1) / bm;
  if (fn == nullptr || gx > 0x7fffffffLL || gy > 65535 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)lanes);
  int m = M, n = N, k = K, depth = kc;
  long long stride = x_lane_stride;
  void* args_f32[] = {(void*)&x, (void*)&w, &out, &m, &n, &k, &depth, &stride};
  void* args_bf16[] = {(void*)&x, (void*)&w, &out, &m, &n, &k, &stride};
  cudaLaunchKernel(fn, grid, dim3(threads), is_bf16 ? args_bf16 : args_f32, smem,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
