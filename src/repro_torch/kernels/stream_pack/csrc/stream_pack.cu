// k independent same-shape matrix products in one launch (stream_pack), for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stream_pack/kernel.py
// (stream_pack_matmul, body _matmul_lane_kernel): out[g] = x[g] @ w[g] for
// every lane g of x (lanes, M, K) and w (lanes, K, N), float32 accumulation,
// output in the input type.  The TPU kernel walks K as its sequential grid
// axis with a float32 accumulator in VMEM.  Here each block walks K itself
// with the accumulator in registers.  x's lane stride is an argument: 0
// means one x shared by every lane (parallel branches reading the same
// activation), which is never copied.  Each operand's matrices lie row-major
// or transposed (its gradient's x^T and w^T are views), read through the
// strides given.  The ragged edge is masked, so any M, N and K are taken.
//
// Two regimes, two designs; the tile is chosen in Python (kernel.py,
// choose_launch), and the entry point sizes the grid and the dynamic shared
// memory from it.
//
// 1. Nimble's packed path: tiny products.  At the darts-like shape (7 lanes
// of 8x64 @ 64x64, float32, shared x) the work is 0.46 MFLOP over 131,072
// bytes, a bound of 0.039 us on bytes (H100 SXM, 3.35 TB/s).  There the
// floor is one launch inside a CUDA graph plus one memory round trip per
// block, so these kernels spend one round trip on a block's loads where the
// panel fits, fit the tile's rows to M, and cut N into narrow slices so that
// tens of blocks share the work.  The grid is (N tiles, M tiles, lanes).
// * f32 panel (stream_pack_f32, STAGES = 1): 128 threads, a BM x 16 tile
//   with BM = 8, 16 or 32 fitted to M, each thread one column of BM/8 rows.
//   The block copies x's BM rows of the whole K and its K x 16 slice of w
//   into shared memory at once, waits once, passes one barrier, then runs
//   the FMAs over the whole K with no barrier inside the loop.  Full float32
//   on the FMA units: no TF32, the reference is full float32.
// * f32 ring (STAGES = 4): the same tile and threads over a 4-stage ring of
//   64-deep K chunks, for panels that do not fit the panel's budget.
// * bf16 ring (stream_pack_bf16): mma.sync.m16n8k16, one warp per 16 rows
//   of a BM x 32 tile (BM = 16, 32 or 64 fitted to M), over a 4-stage ring
//   of 64-deep K chunks; bf16 products too small for the stream (2.).
// Each comes in two loaders.  VEC: cp.async 16-byte copies, the ragged edge
// zero-filled by the copy's source size; it needs row-major operands, K and
// N in whole 16-byte vectors and 16-byte aligned bases.  Otherwise masked
// element-wise loads into the same stages, through any strides (a
// transposed operand is walked along its contiguous axis).
//
// 2. The MoE expert GEMMs: weight streaming (stream_pack_tma, bf16).  128 or
// 160 lanes of (M, 7168) @ (7168, 4864) and the like, M 2 to 64 (the
// experts' capacity), so at most 64 FLOP a byte of weight where the H100's
// tensor cores become the limit at about 295: a call costs its weights'
// bytes (8.9 GB for Arctic's gate, 2.67 ms at 3.35 TB/s) whatever M is.  The
// ring above, with its compute threads issuing 16-byte copies of 64-byte
// pieces of rows 9.7 KB apart, three 4 KB chunks in flight a block and a
// drained ring at every block's end, reached half of that at M 64.  So:
// * Persistent blocks, one an SM (min(items, 132)), walk the (lane, row
//   tile, column tile) items in a fixed order, column tiles fastest, so the
//   blocks in flight read neighbouring pieces of the same weight rows and
//   one item's stores overlap the next item's loads.
// * One producer warp issues TMA boxes from tensor maps built here on the
//   host: a stage is a 64-deep chunk of x's row tile (RT = 16, 32 or 64
//   rows fitted to M; rows past M filled with zeros by the TMA) and of w's
//   256-column tile (512 contiguous bytes of each of 64 weight rows),
//   completing on the stage's mbarrier, 128-byte swizzled.  A ring of 2
//   stages (68-80 KB in flight an SM) was measured as fast as 3 to 5, and
//   faster at DeepSeek's M 64 (kernel.py, TMA_STAGES).
// * Four consumer warps on mma.sync m16n8k16 (bf16 in, float32 sums), each
//   64 columns of every row of the tile, so each weight byte is read from
//   shared memory once; fragments by ldmatrix from the swizzled tiles
//   (no bank conflicts).  mma.sync over wgmma: at <= 64 FLOP a byte the
//   tensor cores are a third busy at most either way, mma.sync takes M in
//   16-row steps where wgmma's smallest M is 64 (four times the products at
//   M 4), and it reads either layout of either operand with or without
//   ldmatrix's .trans, so one kernel serves the forward and both products of
//   the backward.
// * Layouts: x row-major or transposed (the backward's dw = x^T dy reads x
//   (lanes, M, K) where it lies: a box of its rows, ldmatrix.trans for the A
//   fragments; its row tile is then 64), w row-major or transposed (dx =
//   dy w^T reads w where it lies: a box of 64-deep pieces of 256 rows,
//   ldmatrix without .trans).  dw writes lanes x K x N outputs from a depth
//   of M (2.5 GB at DeepSeek's expert shape): its items are as many as the
//   output's row tiles and its time is the stores'.
// * Stores: each warp stages its 16-row slices of its RT x 64 outputs in
//   shared memory (rows padded by 16 bytes) and writes them 16 bytes a
//   thread, 128 contiguous bytes a row; rows past M and columns past N are
//   not written.  Measured: without the stores, M 64 takes 3-8% less and
//   dw 15% less; handing them to TMA stores instead saved nothing in the
//   forward and cost dw 7%, and a 512-column tile (x read half as often)
//   saved nothing either, so what M 64 loses is the stores' own traffic.
// Every output element is one thread's sum in ascending k, in every kernel:
// no split-K and no atomics, so two runs give the same bits; bf16 output is
// rounded once.  Dynamic shared memory above 48 KB (a panel of up to 64 KB,
// a ring of up to 56 KB, the stream's about 90 KB) is allowed by
// stream_pack_init, which the wrapper calls once per device before its
// first launch, outside any CUDA-graph capture.

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// asynchronous copies and fragments
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory, L2 only; src_bytes 0 fills zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = smem_u32(smem);
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

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Strides in elements: x's (lane, row, depth), w's (lane, depth, column).
// A row-major x has depth stride 1, a transposed one row stride 1; a
// row-major w column stride 1, a transposed one depth stride 1.
struct PackStrides {
  long long xl, xr, xk, wl, wk, wn;
};

// The K walk of the rings: load(c, s) fills stage s with K chunk c,
// compute(s) multiplies stage s into the accumulators.  STAGES == 1: one
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

// Element-wise loads of an R x C stage (row pitch ld) from a matrix whose
// element (r, c) lies at src[r * sr + c * sc], zero past (rmax, cmax);
// consecutive threads walk the contiguous axis (c if sc == 1, else r).
template <typename T>
__device__ __forceinline__ void load_elems(T* dst, int ld, const T* src, long long sr,
                                           long long sc, int R, int C, int r0, int c0,
                                           int rmax, int cmax, int tid, int threads) {
  const T zero = T(0.f);
  for (int i = tid; i < R * C; i += threads) {
    const int r = sc == 1 ? i / C : i % R, c = sc == 1 ? i % C : i / R;
    const int gr = r0 + r, gc = c0 + c;
    dst[r * ld + c] = (gr < rmax && gc < cmax) ? src[gr * sr + gc * sc] : zero;
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
                float* __restrict__ out, int M, int N, int K, int kc, PackStrides st) {
  constexpr int TM = BM / 8;  // rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sx = reinterpret_cast<float*>(smem_raw);  // STAGES x BM x ldx
  const int ldx = kc + 4;
  float* const sw = sx + STAGES * BM * ldx;              // STAGES x kc x 16

  const int n0 = blockIdx.x * F32_BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int col = tid % F32_BN, rg = tid / F32_BN;  // rows rg + 8 i
  const float* xb = x + (long long)blockIdx.z * st.xl;
  const float* wb = w + (long long)blockIdx.z * st.wl;
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
        cp_async16(xs + r * ldx + 4 * j, ok ? xb + gm * st.xr + gk : xb, ok);
      }
      for (int i = tid; i < kc * (F32_BN / 4); i += F32_THREADS) {
        const int r = i / (F32_BN / 4), j = i % (F32_BN / 4);
        const int gk = k0 + r, gn = n0 + 4 * j;
        const bool ok = gk < K && gn < N;
        cp_async16(ws + r * F32_BN + 4 * j, ok ? wb + gk * st.wk + gn : wb, ok);
      }
    } else {
      load_elems(xs, ldx, xb, st.xr, st.xk, BM, kc, m0, k0, M, K, tid, F32_THREADS);
      load_elems(ws, F32_BN, wb, st.wk, st.wn, kc, F32_BN, k0, n0, K, N, tid, F32_THREADS);
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
// bf16 on the tensor cores: the ring
// ---------------------------------------------------------------------------

constexpr int BF16_BN = 32;  // tile columns: each warp 16 rows x 32

// shared memory per stage, elements: x chunk BM x 72, w chunk 64 x 40 (rows
// padded by 16 bytes: ldmatrix's 8 rows fall on distinct banks)
__host__ __device__ constexpr int bf16_stage_elems(int bm) {
  return bm * (RING_KC + 8) + RING_KC * (BF16_BN + 8);
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(BM / 16 * 32)
stream_pack_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K, PackStrides st) {
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
  const __nv_bfloat16* xb = x + (long long)blockIdx.z * st.xl;
  const __nv_bfloat16* wb = w + (long long)blockIdx.z * st.wl;
  __nv_bfloat16* ob = out + (size_t)blockIdx.z * M * N;

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
        cp_async16(xs + r * LDX + 8 * j, ok ? xb + gm * st.xr + gk : xb, ok);
      }
      for (int i = tid; i < RING_KC * WV; i += THREADS) {
        const int r = i / WV, j = i % WV;
        const int gk = k0 + r, gn = n0 + 8 * j;
        const bool ok = gk < K && gn < N;
        cp_async16(ws + r * LDW + 8 * j, ok ? wb + gk * st.wk + gn : wb, ok);
      }
    } else {
      load_elems(xs, LDX, xb, st.xr, st.xk, BM, RING_KC, m0, k0, M, K, tid, THREADS);
      load_elems(ws, LDW, wb, st.wk, st.wn, RING_KC, BN, k0, n0, K, N, tid, THREADS);
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
      ldmatrix_x4(a, smem_u32(xs + (wm * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8));
      // B by ldmatrix.trans: lanes 8m..8m+7 address the rows of matrix m
      // (k +8 for odd m, columns +8 for m >= 2)
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(ws + (kk + (m & 1) * 8 + (lane & 7)) * LDW + dn * 16 + (m >> 1) * 8));
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
// bf16 on the tensor cores: the weight stream (TMA ring, persistent blocks)
// ---------------------------------------------------------------------------

constexpr int TMA_KC = 64;                         // depth of a stage: one swizzle row
constexpr int TMA_BN = 256;                        // columns of a tile
constexpr int TMA_WARPS = 4;                       // consumer warps, 64 columns each
constexpr int TMA_THREADS = 32 * (TMA_WARPS + 1);  // and one producer warp
constexpr int SWZ_ROW = 128;                       // bytes; 8 rows make a 1024-byte atom
constexpr int BOX = 64;                            // rows and columns of a 64 x 64 box
constexpr int LDS = 64 + 8;                        // a staged output row, elements
constexpr int TMA_MAX_STAGES = 8;

// a stage: the x tile (RT rows, or 64 depth rows of x^T's 64 rows) and the w
// tile (4 boxes of 64 depth rows of 64 columns, or 256 rows of w^T), 128
// bytes a row
__host__ __device__ constexpr int tma_stage_bytes(int rt) { return (rt + TMA_BN) * SWZ_ROW; }
// kernel.py's tma_smem_bytes: 1024 to align the ring, the ring, each warp's
// 16 staged output rows, a full and an empty mbarrier a stage
__host__ __device__ constexpr size_t tma_smem_bytes(int rt, int stages) {
  return 1024 + (size_t)stages * tma_stage_bytes(rt) + TMA_WARPS * 16 * LDS * 2 + 16 * stages;
}

// the shared address of 16-byte chunk `chunk` of row `row` of a tile written
// by the TMA with the 128-byte swizzle (the chunk index XOR the row mod 8)
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int chunk) {
  return tile + row * SWZ_ROW + ((chunk ^ (row & 7)) << 4);
}

// 3-d TMA load of box {c0, c1, c2} into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

struct TmaShape {
  __nv_bfloat16* out;  // (lanes, R, C), contiguous
  int R, C, D;         // each lane: out (R x C) = A (R x D) . B (D x C)
  int row_tiles, col_tiles, items, stages;
};

// RT = 16 MT rows x 256 columns; warp w takes columns 64 w .. of every row.
// AT: x lies transposed (the tensor map's rows are depth, its columns x's
// rows: RT is 64, one swizzle row); BT: w lies transposed (the map's rows
// are w's columns).
template <int MT, bool AT, bool BT>
__global__ void __launch_bounds__(TMA_THREADS, 1)
stream_pack_tma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const TmaShape p) {
  constexpr int RT = 16 * MT, BN = TMA_BN;
  constexpr int NB = 8;  // a consumer warp's n8 blocks: 64 columns
  constexpr int STAGE = tma_stage_bytes(RT);
  static_assert(!AT || RT == BOX, "x^T's box spans 64 of x's rows: one swizzle row");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle's atoms are 1024 bytes
  const uint32_t staging = ring + p.stages * STAGE;
  __nv_bfloat16* const gstaging =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (staging - raw));
  const uint32_t bars = staging + TMA_WARPS * 16 * LDS * 2;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TMA_WARPS);  // lane 0 of each consumer warp releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_lane = p.row_tiles * p.col_tiles;
  const int nchunks = (p.D + TMA_KC - 1) / TMA_KC;

  if (warp == TMA_WARPS) {
    // ---- producer: one thread walks the block's items and their chunks ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tb)) : "memory");
      int cnt = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int g = item / per_lane, rest = item % per_lane;
        const int r0 = rest / p.col_tiles * RT, c0 = rest % p.col_tiles * BN;
        // w's boxes of 64 columns that start before N (a box past it would
        // only fill columns that are never stored)
        const int boxes = BT ? 0 : min(BN / BOX, (p.C - c0 + BOX - 1) / BOX);
        const uint32_t bytes = BT ? STAGE : (RT + BOX * boxes) * SWZ_ROW;
        for (int c = 0; c < nchunks; ++c, ++cnt) {
          const int s = cnt % p.stages, k0 = c * TMA_KC;
          mbar_wait(empty(s), ((cnt / p.stages) & 1) ^ 1);
          mbar_expect_tx(full(s), bytes);
          const uint32_t a = ring + s * STAGE, b = a + RT * SWZ_ROW;
          if (AT) tma_load3(a, &ta, r0, k0, g, full(s));  // 64 depth rows of 64 x rows
          else tma_load3(a, &ta, k0, r0, g, full(s));     // RT rows of 64 depth
          if (BT) {
            tma_load3(b, &tb, k0, c0, g, full(s));        // 256 w columns of 64 depth
          } else {
            for (int j = 0; j < boxes; ++j)               // 64 depth rows of 64 columns
              tma_load3(b + j * BOX * SWZ_ROW, &tb, c0 + BOX * j, k0, g, full(s));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warp `warp` takes columns 64 warp .. of every row ----
  const int g8 = lane >> 2, t4 = lane & 3;
  const int m = lane >> 3;  // the ldmatrix matrix this lane addresses
  __nv_bfloat16* const stg = gstaging + warp * 16 * LDS;
  // element e of acc[mt][nb]: row 16 mt + g8 + 8 (e >> 1), column nb*8 + 2 t4 + (e & 1)
  float acc[MT][NB][4];
  int cnt = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int g = item / per_lane, rest = item % per_lane;
    const int r0 = rest / p.col_tiles * RT, c0 = rest % p.col_tiles * BN + warp * 64;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;

    for (int c = 0; c < nchunks; ++c, ++cnt) {
      const int s = cnt % p.stages;
      mbar_wait(full(s), (cnt / p.stages) & 1);
      const uint32_t a = ring + s * STAGE, b = a + RT * SWZ_ROW;
#pragma unroll
      for (int kk = 0; kk < TMA_KC; kk += 16) {
        // A fragments a0 (rows 0-7, k 0-7), a1 (rows 8-15), a2 (k 8-15), a3
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (AT)  // stored [k][row]: matrix m at k + 8 (m >> 1), rows + 8 (m & 1)
            ldmatrix_x4_trans(af[mt], swz(a, kk + (m >> 1) * 8 + (lane & 7), 2 * mt + (m & 1)));
          else     // stored [row][k]: lanes 0-15 rows 0-15 at k, lanes 16-31 at k + 8
            ldmatrix_x4(af[mt], swz(a, 16 * mt + (lane & 15), kk / 8 + (lane >> 4)));
        }
#pragma unroll
        for (int dn = 0; dn < NB / 2; ++dn) {
          // B fragments of 16 of the warp's columns: matrix m at k + 8 (m & 1),
          // columns + 8 (m >> 1); b0, b1 the first n8 block, b2, b3 the second
          const int col = dn * 16 + (m >> 1) * 8;
          uint32_t bf[4];
          if (BT)  // stored [column][k]
            ldmatrix_x4(bf, swz(b, warp * 64 + col + (lane & 7), kk / 8 + (m & 1)));
          else     // box `warp` stored [k][column]
            ldmatrix_x4_trans(bf, swz(b + warp * BOX * SWZ_ROW, kk + (m & 1) * 8 + (lane & 7),
                                      col / 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dn], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * dn + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // ---- stores: 16 rows at a time through the warp's staging, 16 bytes a
    // thread; the producer meanwhile fills the ring with the next item ----
    if (c0 >= p.C) continue;
    __nv_bfloat16* const ob = p.out + (size_t)g * p.R * p.C;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (r0 + 16 * mt >= p.R) break;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(stg + (g8 + 8 * h) * LDS + nb * 8 + 2 * t4) =
              __floats2bfloat162_rn(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
      __syncwarp();
#pragma unroll
      for (int i = lane; i < 16 * 8; i += 32) {  // 16 rows of eight 16-byte pieces
        const int row = r0 + 16 * mt + i / 8, col = c0 + (i % 8) * 8;
        if (row < p.R && col < p.C)
          *reinterpret_cast<int4*>(ob + (size_t)row * p.C + col) =
              *reinterpret_cast<const int4*>(stg + (i / 8) * LDS + (i % 8) * 8);
      }
      __syncwarp();
    }
  }
}

// the 3-d map (d0, d1, d2) of a bf16 tensor, strides s1, s2 in elements,
// boxes of b0 x b1 x 1 with the 128-byte swizzle; out of bounds reads as 0
int make_map3(CUtensorMap* map, const void* ptr, long long d0, long long d1, long long d2,
              long long s1, long long s2, int b0, int b1) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// ---------------------------------------------------------------------------
// the instantiations
// ---------------------------------------------------------------------------

struct Instance {
  int is_bf16, bm, stages, vec;
  const void* fn;
};

// kernel.py's INSTANCES of the rings, each tile with both loaders
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

struct TmaInstance {
  int rt, at, bt;
  const void* fn;
};

// kernel.py's INSTANCES of the stream: x and w row-major (nn) or w
// transposed (nt) at every row tile, x transposed (tn) at 64 rows
#define TMA(MT, AT, BT) {16 * MT, AT, BT, (const void*)stream_pack_tma<MT, AT, BT>}
const TmaInstance kTma[] = {
    TMA(1, false, false), TMA(2, false, false), TMA(4, false, false),
    TMA(1, false, true),  TMA(2, false, true),  TMA(4, false, true),
    TMA(4, true, false),
};
#undef TMA

const void* find_tma(int rt, int at, int bt) {
  for (const TmaInstance& k : kTma)
    if (k.rt == rt && k.at == at && k.bt == bt) return k.fn;
  return nullptr;
}

// The stream over x (lanes, M, K) and w (lanes, K, N): R = M, D = K, C = N.
// x's map: row-major (K, M, lanes) in boxes of 64 x rt, transposed (M, K,
// lanes) in boxes of 64 x 64; w's map: row-major (N, K, lanes) in boxes of
// 64 x 64, transposed (K, N, lanes) in boxes of 64 x 256.
int launch_tma(const void* x, const void* w, void* out, int lanes, int M, int N, int K,
               long long x_lane, int rt, int bn, int at, int bt, int stages, int blocks,
               cudaStream_t stream) {
  const void* fn = find_tma(rt, at, bt);
  if (fn == nullptr || bn != TMA_BN || stages < 1 || stages > TMA_MAX_STAGES || blocks < 1 ||
      (lanes > 1 && x_lane == 0))
    return (int)cudaErrorInvalidValue;
  if (lanes == 1) x_lane = (long long)M * K;  // read for lane 0 only
  const long long row_tiles = (M + rt - 1) / rt, col_tiles = (N + TMA_BN - 1) / TMA_BN;
  const long long items = lanes * row_tiles * col_tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = at ? make_map3(&ta, x, M, K, lanes, M, x_lane, BOX, BOX)
               : make_map3(&ta, x, K, M, lanes, K, x_lane, BOX, rt);
  if (!err)
    err = bt ? make_map3(&tb, w, K, N, lanes, K, (long long)K * N, BOX, TMA_BN)
             : make_map3(&tb, w, N, K, lanes, N, (long long)K * N, BOX, BOX);
  if (err) return err;
  TmaShape p{static_cast<__nv_bfloat16*>(out), M, N, K, (int)row_tiles, (int)col_tiles,
             (int)items, stages};
  void* args[] = {&ta, &tb, &p};
  const int grid = blocks < items ? blocks : (int)items;
  cudaLaunchKernel(fn, dim3(grid), dim3(TMA_THREADS), args, tma_smem_bytes(rt, stages), stream);
  return (int)cudaGetLastError();
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
  for (const TmaInstance& k : kTma)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return (int)err;
}

// x: lane g's (M, K) matrix at x + g * strides[0], element (m, k) at
// m * strides[1] + k * strides[2] (strides[0] = 0: one x for every lane); w:
// lane g's (K, N) at w + g * strides[3], element (k, n) at k * strides[4] +
// n * strides[5]; out (lanes, M, N) contiguous; strides in elements; float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The tile, as kernel.py's
// choose_launch gives it: kind 0 (f32: stages 1 the panel, 4 the ring), 1
// (the bf16 ring) or 2 (the bf16 stream); vec (1: cp.async 16-byte copies of
// row-major operands; 0: masked element-wise loads through the strides); bm
// x bn (f32: bn 16; bf16 ring: bn 32; stream: bm its row tile, bn 256);
// the K depth kc of one stage (f32: a multiple of 4, at least K for the
// panel, 64 for the ring; bf16: 64); for the stream, x_t / w_t (x / w lies
// transposed; the strides are then not read beyond x's lane stride), its
// ring's stages and its persistent blocks.  The grid and the dynamic shared
// memory follow from the tile.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() after the launch (0 on success;
// cudaErrorInvalidValue for a tile it has no kernel for; ERR_* of hopper.cuh
// where a tensor map cannot be built).
extern "C" int stream_pack_matmul(const void* x, const void* w, void* out, int is_bf16,
                                  int lanes, int M, int N, int K, const long long* strides,
                                  int kind, int stages, int vec, int bm, int bn, int kc, int x_t,
                                  int w_t, int blocks, void* stream) {
  if (lanes <= 0 || M <= 0 || N <= 0 || K <= 0 || strides[0] < 0 || kc <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (!is_bf16 || kc != TMA_KC) return (int)cudaErrorInvalidValue;
    return launch_tma(x, w, out, lanes, M, N, K, strides[0], bm, bn, x_t, w_t, stages, blocks,
                      s);
  }
  const PackStrides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]};
  if (vec && (st.xk != 1 || st.wn != 1)) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  if (kind == 1 && is_bf16) {
    if (bn == BF16_BN && stages == RING_STAGES && kc == RING_KC)
      fn = find_kernel(1, bm, stages, vec);
    threads = bm / 16 * 32;
    smem = (size_t)RING_STAGES * bf16_stage_elems(bm) * sizeof(__nv_bfloat16);
  } else if (kind == 0 && !is_bf16) {
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
  PackStrides sv = st;
  void* args_f32[] = {(void*)&x, (void*)&w, &out, &m, &n, &k, &depth, &sv};
  void* args_bf16[] = {(void*)&x, (void*)&w, &out, &m, &n, &k, &sv};
  cudaLaunchKernel(fn, grid, dim3(threads), is_bf16 ? args_bf16 : args_f32, smem, s);
  return (int)cudaGetLastError();
}
