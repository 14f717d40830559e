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
// Three regimes, three designs; the tile is chosen in Python (kernel.py,
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
//
// 3. Training's expert products (stream_pack_wgmma, bf16).  A training step
// gives each expert a capacity of round(N k / E x 1.25) rows (384 at
// DeepSeek-V2's 2 x 4096 tokens), and B2 runs each of a layer's three
// expert GEMMs three times: the forward x w (nn), dx = dy w^T (nt) and
// dw = x^T dy (tn), 160 lanes of 384 x 5120 x 1536 or the like.  At M 384 a
// product does 384 FLOP a byte of weight, past the H100's ridge of about
// 295, so the tensor cores bound it (0.977 ms at 989 TFLOP/s) as much as
// its 3.3 GB do (0.996 ms at 3.35 TB/s).  The stream's mma.sync, fed by
// ldmatrix, and its 16- to 64-row tiles cannot approach that.  So:
// * wgmma m64n256k16, bf16 in, float32 sums in registers, both operands in
//   shared memory, read through descriptors: x K-major (nn, nt) or
//   MN-major (tn, the transpose bit), w MN-major (nn, tn) or K-major (nt:
//   w^T lies as wgmma's native B).  One template <AT, BT> serves the three
//   layouts with the same sequence of products.
// * A 128 x 256 output tile a CTA, 64 rows for each of two consumer
//   warpgroups (128 float32 accumulators a thread), and a producer warp:
//   288 threads, 154-156 registers, no spill.  A 64-deep chunk of the tile
//   does 85 FLOP a byte of shared memory it fills.  A consumer thread
//   issuing the loads (this kernel's first design) issued each one only
//   when both warpgroups had passed their products, and the loads stopped
//   overlapping them (PERF.md §6, the stream_pack_wgmma findings).
// * A ring of 4 stages of 48 KB, each a 64-deep chunk of x's 128 rows (one
//   128 x 64 box, or x^T's two 64 x 64 boxes) and of w's 256 columns (four
//   64 x 64 boxes), TMA boxes with the 128-byte swizzle the descriptors
//   name; the TMA zero-fills depth past K and rows and columns past M and
//   N, and boxes wholly past M or N are not loaded (they would fill only
//   outputs that are never stored).  Each stage has an mbarrier for its
//   loads and one that each consumer warpgroup of the cluster arrives on
//   once its products have read it; the producer walks the chunks on from
//   one item into the next.
// * Clusters of cl = 2 or 3 CTAs along M (the first that divides the row
//   tiles; 1 where none does) take one column tile of cl row tiles: each
//   CTA loads its x rows and w's boxes j = rank mod cl for all of them
//   (TMA multicast), so w's tile leaves L2 once a cluster.  At M 384 the 3
//   row tiles are one cluster, and each weight column panel is read once;
//   alone (cl 1) the forward took 1.9-2.4 ms, in clusters of 3 1.5-1.9.
//   A cluster of 3 uses 117 of the 132 SMs (39 clusters resident), of 2
//   all; clusters of 4 (30 resident) were no faster for dw.
// * Persistent clusters walk (lane, row-tile group, column tile) items,
//   column tiles fastest, as many as the card holds at once.
// * Each consumer warpgroup keeps one group of products in flight behind
//   the one it waits for (wgmma.wait_group 1), and starts each item with
//   scale-d 0, so no instruction but a wgmma writes the accumulators;
//   fence_regs around the waits keeps the compiler from moving the stores'
//   reads of them above the last wait.  The warpgroup index comes through
//   __shfl_sync, so ptxas sees it uniform across each warp (a branch on
//   threadIdx around the products serializes them).
// * Stores: a warpgroup writes its 64 x 256 outputs, rounded to bf16, into
//   a 32 KB staging tile in the 128-byte swizzle (no bank conflicts), and
//   one of its threads hands the four 64 x 64 boxes to TMA stores, which
//   clip rows past M and columns past N.  The two warpgroups take turns at
//   the one tile (named barriers 3 and 4), warpgroup 1 an epilogue behind
//   warpgroup 0, so each one's stores go under the other's products.  4
//   stages + staging + barriers take 230,464 of the 232,448 bytes a CTA may
//   have.
// Every output element is one thread's sum in ascending k, in every kernel:
// no split-K and no atomics, so two runs give the same bits; bf16 output is
// rounded once.  Dynamic shared memory above 48 KB (a panel of up to 64 KB,
// a ring of up to 56 KB, the stream's about 90 KB, the wgmma ring's 209 KB)
// is allowed by
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: training's products (wgmma, TMA ring, persistent blocks)
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;                           // tile rows: 64 for each warpgroup
constexpr int WG_BN = 256;                           // tile columns: one m64n256k16
constexpr int WG_KC = 64;                            // depth of a stage: one swizzle row
constexpr int WG_CONSUMERS = 2;                      // warpgroups, 64 tile rows each
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;  // and a producer warp
constexpr int WG_A_BYTES = WG_BM * SWZ_ROW;          // x's 128 rows of a chunk: 16 KB
constexpr int WG_B_BYTES = WG_BN * SWZ_ROW;          // w's 256 columns of a chunk: 32 KB
constexpr int WG_STAGE = WG_A_BYTES + WG_B_BYTES;    // 48 KB, a multiple of the 1 KB atom
constexpr int WG_OUT_BYTES = 64 * WG_BN * 2;         // one warpgroup's outputs: 32 KB
constexpr int WG_BOX_BYTES = BOX * SWZ_ROW;          // a 64 x 64 box: 8 KB
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_MAX_CLUSTER = 4;

// kernel.py's wgmma_smem_bytes: 1024 to align the ring, the ring, the
// staging of half the output tile, a full and an empty mbarrier a stage
__host__ __device__ constexpr size_t wgmma_smem_bytes(int stages) {
  return 1024 + (size_t)stages * WG_STAGE + WG_OUT_BYTES + 16 * stages;
}

// d (64 x 256) (+)= A (64 x 16) * B (16 x 256), both in shared memory: A
// K-major (TA 0) or MN-major (TA 1), B K-major (TB 0) or MN-major (TB 1);
// where scale_d is 0, d is overwritten
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// 3-d TMA store of the box at `src` to {c0, c1, c2}, in this thread's bulk group
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 3-d TMA load of box {c0, c1, c2} into shared memory at `dst` of every CTA
// of the cluster in `mask`, completing on the mbarrier at `bar` of each
__device__ __forceinline__ void tma_load3_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                    int c1, int c2, uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "h"(mask)
      : "memory");
}

// arrive on the mbarrier at shared address `bar` of CTA `cta` of the cluster
// (release at CTA scope: a cluster-scope release costs about half a
// microsecond an arrival)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

struct WgShape {
  int R, C, D;  // each lane: out (R x C) = A (R x D) . B (D x C)
  // the cluster's CTAs take `cl` consecutive row tiles of one column tile;
  // items: lanes x row_tiles / cl x col_tiles
  int row_tiles, col_tiles, items, stages, cl;
};

// AT: x lies transposed (its map's rows are depth, its columns x's rows: two
// 64 x 64 boxes a chunk); BT: w lies transposed (its map's rows are w's
// columns).  w's tile comes as four 64 x 64 boxes, box j issued by the
// cluster's CTA j mod cl to all of them.  `to` maps the output (N, M,
// lanes) in 64 x 64 boxes.
template <bool AT, bool BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
stream_pack_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap to, const WgShape p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle's atoms are 1024 bytes
  const uint32_t staging = ring + p.stages * WG_STAGE;
  const uint32_t bars = staging + WG_OUT_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };

  const int tid = threadIdx.x;
  // the warpgroup as a value ptxas knows is the same across a warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wl = (tid >> 5) & 3, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const bool leader = (tid & 127) == 0;  // its warpgroup's arrivals and stores
  const int rank = (int)cluster_rank(), clusters = gridDim.x / p.cl;
  const uint16_t all_ctas = (uint16_t)((1u << p.cl) - 1);
  const int per_lane = p.row_tiles / p.cl * p.col_tiles;
  const int nchunks = (p.D + WG_KC - 1) / WG_KC;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * p.cl);  // each warpgroup of each CTA of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before any copy reaches them

  if (wg == WG_CONSUMERS) {
    // ---- the producer warp: one thread walks the block's (item, chunk)
    // order, each chunk into the next stage once every warpgroup of the
    // cluster has freed it (w's boxes land in every CTA's stage) ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tb)) : "memory");
      int cnt = 0;
      for (int item = blockIdx.x / p.cl; item < p.items; item += clusters) {
        const int g = item / per_lane, rest = item % per_lane;
        const int r0 = (rest / p.col_tiles * p.cl + rank) * WG_BM;
        const int c0 = rest % p.col_tiles * WG_BN;
        // x^T's and w's 64 x 64 boxes that start before M and N
        const int a_boxes = AT ? min(WG_BM / BOX, (p.R - r0 + BOX - 1) / BOX) : 0;
        const int b_boxes = min(WG_BN / BOX, (p.C - c0 + BOX - 1) / BOX);
        const uint32_t bytes =
            (AT ? a_boxes * WG_BOX_BYTES : WG_A_BYTES) + b_boxes * WG_BOX_BYTES;
        for (int c = 0; c < nchunks; ++c, ++cnt) {
          const int s = cnt % p.stages, k0 = c * WG_KC;
          mbar_wait(empty(s), ((cnt / p.stages) & 1) ^ 1);
          mbar_expect_tx(full(s), bytes);
          const uint32_t a = ring + s * WG_STAGE, b = a + WG_A_BYTES;
          if (AT) {
            for (int j = 0; j < a_boxes; ++j)  // 64 depth rows of 64 x rows
              tma_load3(a + j * WG_BOX_BYTES, &ta, r0 + BOX * j, k0, g, full(s));
          } else {
            tma_load3(a, &ta, k0, r0, g, full(s));  // 128 x rows of 64 depth
          }
          for (int j = rank; j < b_boxes; j += p.cl) {
            if (BT)  // 64 w columns of 64 depth
              tma_load3_multicast(b + j * WG_BOX_BYTES, &tb, k0, c0 + BOX * j, g, full(s),
                                  all_ctas);
            else     // 64 depth rows of 64 columns
              tma_load3_multicast(b + j * WG_BOX_BYTES, &tb, c0 + BOX * j, k0, g, full(s),
                                  all_ctas);
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while a peer may still arrive on its barriers
    return;
  }

  // ---- the consumers ----
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&to)) : "memory");
  // a warpgroup is done reading stage s (its products that read it have
  // completed): its thread c tells CTA c of the cluster
  auto release = [&](int s) {
    if ((tid & 127) < p.cl) mbar_arrive_cluster(empty(s), tid & 127);
  };

  // The warpgroups take turns at the one staging tile: warpgroup 0 stages
  // an item's outputs once warpgroup 1 has handed it the tile after the
  // previous item (named barrier 4), warpgroup 1 once warpgroup 0 has
  // (barrier 3).  A warpgroup hands it over when its stores have read it,
  // checked after its next item's first products are issued.  So
  // warpgroup 1 runs an epilogue behind warpgroup 0, and each one's stores
  // go under the other's products.
  bool holding = false;  // this warpgroup's stores still read the staging
  auto hand_over = [&]() {
    if (leader) bulk_wait_all<true>();
    __syncwarp();
    if (wl == 0) bar_arrive(3 + wg, 128 + 32);  // its warp 0 arrives, the other waits
    holding = false;
  };

  // element i of acc: row 16 wl + g8 + 8 ((i >> 1) & 1) of the warpgroup's
  // 64, column 8 (i >> 2) + 2 t4 + (i & 1)
  float acc[128];
  unsigned char* const stg = smem_raw + (staging - raw);
  int cnt = 0, done = 0;
  for (int item = blockIdx.x / p.cl; item < p.items; item += clusters) {
    const int g = item / per_lane, rest = item % per_lane;
    const int r0 = (rest / p.col_tiles * p.cl + rank) * WG_BM, c0 = rest % p.col_tiles * WG_BN;
    for (int c = 0; c < nchunks; ++c, ++cnt) {
      const int s = cnt % p.stages;
      mbar_wait(full(s), (cnt / p.stages) & 1);
      // this warpgroup's 64 rows of x (its box of x^T), w's 256 columns
      const uint32_t a = ring + s * WG_STAGE + wg * WG_BOX_BYTES;
      const uint32_t b = ring + s * WG_STAGE + WG_A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_KC / 16; ++kk) {
        // K-major: 16 depth columns are 32 bytes along a swizzle row, 8-row
        // groups 1024 bytes apart; MN-major: 16 depth rows are 16 swizzle
        // rows down, 64-column boxes WG_BOX_BYTES apart
        const uint64_t da = AT ? make_desc(a + kk * 16 * SWZ_ROW, WG_BOX_BYTES, 1024, 1)
                               : make_desc(a + kk * 32, 16, 1024, 1);
        const uint64_t db = BT ? make_desc(b + kk * 32, 16, 1024, 1)
                               : make_desc(b + kk * 16 * SWZ_ROW, WG_BOX_BYTES, 1024, 1);
        wgmma_n256<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db, c > 0 || kk > 0);
      }
      wgmma_commit();
      if (holding) hand_over();
      wgmma_wait<1>();  // the previous chunk's products are done
      fence_regs(acc);
      if (c > 0) release((cnt - 1) % p.stages);
    }
    wgmma_wait<0>();
    fence_regs(acc);  // no read of acc moves above the wait
    release((cnt - 1) % p.stages);

    // ---- stores: this warpgroup's turn at the staging tile ----
    if (wg == 1 || done > 0) bar_sync(4 - wg, 128 + 32);
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wl + g8 + 8 * h;  // row & 7 == g8
        *reinterpret_cast<uint32_t*>(stg + (j >> 3) * WG_BOX_BYTES + row * SWZ_ROW +
                                     (((j & 7) ^ g8) << 4) + 4 * t4) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    fence_async_shared();
    bar_sync(1 + wg, 128);
    const int rw = r0 + BOX * wg;
    if (leader && rw < p.R) {
      for (int j = 0; j < WG_BN / BOX && c0 + BOX * j < p.C; ++j)
        tma_store3(&to, staging + j * WG_BOX_BYTES, c0 + BOX * j, rw, g);
      bulk_commit();
    }
    holding = true;
    ++done;
  }
  if (holding) hand_over();
  if (wg == 0 && done > 0) bar_sync(4, 128 + 32);  // warpgroup 1's last turn
  if (leader) bulk_wait_all<false>();
  cluster_sync();  // no CTA leaves while a peer may still arrive on its barriers
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

struct WgInstance {
  int at, bt;
  const void* fn;
};

// kernel.py's INSTANCES of training's products: nn, nt and tn
#define WG(AT, BT) {AT, BT, (const void*)stream_pack_wgmma<AT, BT>}
const WgInstance kWgmma[] = {WG(false, false), WG(false, true), WG(true, false)};
#undef WG

const void* find_wgmma(int at, int bt) {
  for (const WgInstance& k : kWgmma)
    if (k.at == at && k.bt == bt) return k.fn;
  return nullptr;
}

// The clusters of `cl` CTAs of the wgmma kernel (at, bt) with a ring of
// `stages` that the card holds at once (a cluster's CTAs share a GPC),
// asked once for each kernel, cluster size and ring; 0 where it cannot say.
int resident_clusters(int at, int bt, int stages, int cl) {
  const void* fn = find_wgmma(at, bt);
  if (fn == nullptr || cl < 1 || cl > WG_MAX_CLUSTER || stages < 2 || stages > WG_MAX_STAGES)
    return 0;
  static int known[3][WG_MAX_CLUSTER + 1][WG_MAX_STAGES + 1];
  int& most = known[at * 2 + bt][cl][stages];
  if (most == 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cl);
    cfg.blockDim = dim3(WG_THREADS);
    cfg.dynamicSmemBytes = wgmma_smem_bytes(stages);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&most, fn, &cfg) != cudaSuccess) most = 0;
  }
  return most;
}

// Training's products over x (lanes, M, K) and w (lanes, K, N): R = M, D =
// K, C = N.  x's map: row-major (K, M, lanes) in boxes of 64 x 128,
// transposed (M, K, lanes) in boxes of 64 x 64; w's map: row-major (N, K,
// lanes) or transposed (K, N, lanes), boxes of 64 x 64; out's map (N, M,
// lanes) in boxes of 64 x 64.  Clusters of `cl` CTAs along M (cl divides
// the row tiles), as many as the card holds at once and at most blocks / cl.
int launch_wgmma(const void* x, const void* w, void* out, int lanes, int M, int N, int K,
                 long long x_lane, int bm, int bn, int at, int bt, int stages, int cl,
                 int blocks, cudaStream_t stream) {
  const void* fn = find_wgmma(at, bt);
  const long long row_tiles = (M + WG_BM - 1) / WG_BM, col_tiles = (N + WG_BN - 1) / WG_BN;
  if (fn == nullptr || bm != WG_BM || bn != WG_BN || stages < 2 || stages > WG_MAX_STAGES ||
      cl < 1 || cl > WG_MAX_CLUSTER || row_tiles % cl != 0 || blocks < cl ||
      (lanes > 1 && x_lane == 0))
    return (int)cudaErrorInvalidValue;
  if (lanes == 1) x_lane = (long long)M * K;  // read for lane 0 only
  const long long items = lanes * (row_tiles / cl) * col_tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, to;
  int err = at ? make_map3(&ta, x, M, K, lanes, M, x_lane, BOX, BOX)
               : make_map3(&ta, x, K, M, lanes, K, x_lane, BOX, WG_BM);
  if (!err)
    err = bt ? make_map3(&tb, w, K, N, lanes, K, (long long)K * N, BOX, BOX)
             : make_map3(&tb, w, N, K, lanes, N, (long long)K * N, BOX, BOX);
  if (!err) err = make_map3(&to, out, N, M, lanes, N, (long long)M * N, BOX, BOX);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = wgmma_smem_bytes(stages);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int most = resident_clusters(at, bt, stages, cl);
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  long long n = blocks / cl;
  if (n > most) n = most;
  if (n > items) n = items;
  cfg.gridDim = dim3((unsigned)(n * cl));
  WgShape p{M, N, K, (int)row_tiles, (int)col_tiles, (int)items, stages, cl};
  void* args[] = {&ta, &tb, &to, &p};
  cudaLaunchKernelExC(&cfg, fn, args);
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
  for (const WgInstance& k : kWgmma)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return (int)err;
}

// How many clusters of `cl` CTAs of the wgmma kernel for x_t / w_t with a
// ring of `stages` the card holds at once (after stream_pack_init); 0 where
// there is no such kernel or the card cannot say.
extern "C" int stream_pack_wgmma_clusters(int x_t, int w_t, int stages, int cl) {
  return resident_clusters(x_t, w_t, stages, cl);
}

// x: lane g's (M, K) matrix at x + g * strides[0], element (m, k) at
// m * strides[1] + k * strides[2] (strides[0] = 0: one x for every lane); w:
// lane g's (K, N) at w + g * strides[3], element (k, n) at k * strides[4] +
// n * strides[5]; out (lanes, M, N) contiguous; strides in elements; float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The tile, as kernel.py's
// choose_launch gives it: kind 0 (f32: stages 1 the panel, 4 the ring), 1
// (the bf16 ring), 2 (the bf16 stream) or 3 (training's products on
// wgmma); vec (1: cp.async 16-byte copies of row-major operands; 0: masked
// element-wise loads through the strides); bm x bn (f32: bn 16; bf16 ring:
// bn 32; stream: bm its row tile, bn 256; wgmma: 128 x 256); the K depth kc
// of one stage (f32: a multiple of 4, at least K for the panel, 64 for the
// ring; bf16: 64); for the stream and wgmma, x_t / w_t (x / w lies
// transposed; the strides are then not read beyond x's lane stride), their
// ring's stages and their persistent blocks.  The grid and the dynamic shared
// memory follow from the tile.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() after the launch (0 on success;
// cudaErrorInvalidValue for a tile it has no kernel for; ERR_* of hopper.cuh
// where a tensor map cannot be built).
extern "C" int stream_pack_matmul(const void* x, const void* w, void* out, int is_bf16,
                                  int lanes, int M, int N, int K, const long long* strides,
                                  int kind, int stages, int vec, int bm, int bn, int kc, int x_t,
                                  int w_t, int cluster, int blocks, void* stream) {
  if (lanes <= 0 || M <= 0 || N <= 0 || K <= 0 || strides[0] < 0 || kc <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    if (!is_bf16 || kc != TMA_KC) return (int)cudaErrorInvalidValue;
    return launch_tma(x, w, out, lanes, M, N, K, strides[0], bm, bn, x_t, w_t, stages, blocks,
                      s);
  }
  if (kind == 3) {
    if (!is_bf16 || kc != WG_KC) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, w, out, lanes, M, N, K, strides[0], bm, bn, x_t, w_t, stages, cluster,
                        blocks, s);
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
