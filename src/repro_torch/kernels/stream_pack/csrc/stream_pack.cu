// k independent same-shape matrix products in one launch (stream_pack), for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stream_pack/kernel.py
// (stream_pack_matmul, body _matmul_lane_kernel): out[g] = x[g] @ w[g] for
// every lane g of x (lanes, M, K) and w (lanes, K, N), float32 accumulation,
// output in the input type.  The TPU kernel walks K as its sequential grid
// axis with a float32 accumulator in VMEM; here the grid is (N tiles, M
// tiles, lanes), blocks run in any order, and each block loops over K itself
// with the accumulator in registers.  x's lane stride is an argument: 0
// means one x shared by every lane (parallel branches reading the same
// activation), which is never copied.  The kernel masks the ragged edge, so
// any M, N and K are taken.
//
// What bounds it.  On Nimble's path the products are tiny: at darts-like
// shapes (7 lanes of 8x64 @ 64x64, float32, shared x) the work is 0.46
// MFLOP over 131 KB, a bound of about 0.04 us on bytes, far below the cost
// of one launch.  The kernel is bound by its launch and by one block's
// serial K loop; its job on that path is to replace k launches by one.
//
// Design (simple and right first).  64x64 output tiles.
// * bf16: 4 warps, each owning 16 rows of the tile, on mma.sync.m16n8k16
//   (bf16 in, float32 accumulate).  Each 32-deep K step stages the x tile
//   (rows padded by 16 bytes) and the w tile in shared memory; A fragments
//   are read as 32-bit pairs, B fragments with ldmatrix.trans from the
//   row-major w tile, as B1 reads V.
// * float32: no tensor cores (no TF32: the reference is full float32).  256
//   threads, each owning a 4x4 block of the tile, on the FMA units; each
//   16-deep K step stages the x tile transposed (padded against bank
//   conflicts) and the w tile in shared memory.
// Loads are element-wise and masked; cp.async/TMA staging, wgmma and
// vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows = BM
constexpr int BK16 = 32;
constexpr int LDA16 = BK16 + 8;   // padded shared row of the x tile, elements
constexpr int LDW16 = BN + 8;     // padded shared row of the w tile, elements

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__global__ void __launch_bounds__(MMA_THREADS)
stream_pack_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 long long x_lane_stride) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDA16];
  __shared__ __align__(16) __nv_bfloat16 Ws[BK16 * LDW16];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* xb = x + (long long)blockIdx.z * x_lane_stride;
  const __nv_bfloat16* wb = w + (size_t)blockIdx.z * K * N;
  __nv_bfloat16* ob = out + (size_t)blockIdx.z * M * N;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // element e of acc[nb]: row warp*16 + g + 8 * (e >> 1), column nb*8 + 2t + (e & 1)
  float acc[BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK16) {
    __syncthreads();  // previous step's readers are done
    for (int idx = tid; idx < BM * BK16; idx += MMA_THREADS) {
      const int r = idx / BK16, c = idx % BK16;
      const int gm = m0 + r, gk = k0 + c;
      As[r * LDA16 + c] = (gm < M && gk < K) ? xb[(size_t)gm * K + gk] : zero;
    }
    for (int idx = tid; idx < BK16 * BN; idx += MMA_THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r * LDW16 + c] = (gk < K && gn < N) ? wb[(size_t)gk * N + gn] : zero;
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < BK16 / 16; ++kc) {
      // A fragments: a0 (row g, cols 2t..), a1 (row g+8), a2 (row g, cols
      // 2t+8..), a3 (row g+8, cols 2t+8..)
      const __nv_bfloat16* ar = &As[(warp * 16 + g) * LDA16 + kc * 16 + 2 * t];
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(ar),
          *reinterpret_cast<const uint32_t*>(ar + 8 * LDA16),
          *reinterpret_cast<const uint32_t*>(ar + 8),
          *reinterpret_cast<const uint32_t*>(ar + 8 * LDA16 + 8)};
      // B fragments by ldmatrix.trans: lanes 8m..8m+7 address the rows of
      // matrix m (k +8 for odd m, columns +8 for m >= 2)
      const int m = lane >> 3;
#pragma unroll
      for (int dn = 0; dn < BN / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, &Ws[(kc * 16 + (m & 1) * 8 + (lane & 7)) * LDW16 + dn * 16 + (m >> 1) * 8]);
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + warp * 16 + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int col = n0 + nb * 8 + 2 * t;
      if (col < N) ob[(size_t)row * N + col] = __float2bfloat16(acc[nb][2 * h]);
      if (col + 1 < N) ob[(size_t)row * N + col + 1] = __float2bfloat16(acc[nb][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16 threads, each a 4x4 block
constexpr int BK32 = 16;

__global__ void __launch_bounds__(F32_THREADS)
stream_pack_f32(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int M, int N, int K, long long x_lane_stride) {
  __shared__ float As[BK32][BM + 1];  // x tile, transposed
  __shared__ float Ws[BK32][BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty + 16 i
  const int tx = tid & 15;  // columns tx + 16 j
  const float* xb = x + (long long)blockIdx.z * x_lane_stride;
  const float* wb = w + (size_t)blockIdx.z * K * N;
  float* ob = out + (size_t)blockIdx.z * M * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK32) {
    __syncthreads();  // previous step's readers are done
    for (int idx = tid; idx < BM * BK32; idx += F32_THREADS) {
      const int r = idx / BK32, c = idx % BK32;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? xb[(size_t)gm * K + gk] : 0.f;
    }
    for (int idx = tid; idx < BK32 * BN; idx += F32_THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? wb[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) ob[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// x: lane g at x + g * x_lane_stride, each (M, K) row-major with rows of K
// elements (x_lane_stride 0: one x for every lane); w: (lanes, K, N) and
// out: (lanes, M, N), contiguous; float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int stream_pack_matmul(const void* x, const void* w, void* out, int is_bf16,
                                  int lanes, int M, int N, int K,
                                  long long x_lane_stride, void* stream) {
  if (lanes <= 0 || M <= 0 || N <= 0 || K <= 0 || x_lane_stride < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, lanes);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    stream_pack_bf16<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K, x_lane_stride);
  } else {
    stream_pack_f32<<<grid, F32_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K, x_lane_stride);
  }
  return (int)cudaGetLastError();
}
