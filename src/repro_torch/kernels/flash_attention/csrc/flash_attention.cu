// Block-tiled online-softmax attention (flash) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel): the same function, scale, optional
// tanh soft-cap, causal and/or sliding-window mask, GQA (q head bh reads kv
// head bh / group), float32 running max / sum / accumulator, output in the
// input type.  Unlike the TPU kernel it masks the ragged edge itself, so
// any Sq and Skv are accepted; for every length the TPU accepts it computes
// what the TPU computes, including 0 for a row whose every key is masked
// (finite -1e30 fill and p zeroed under the mask, never -inf).
//
// What bounds it.  At phi4-mini prefill shapes (24 q heads over 8 kv
// heads, head_dim 128, bf16, causal, S = 64..2048) the work is
// 4*S*S*hd*BH/2 operations over (q+k+v+o) bytes: about 100 operations per
// byte at S = 512 and 400 at S = 2048, so on paper the short buckets are
// bound by bytes and the long ones by the tensor cores.  In practice both
// kernels here are bound by issue: the shared-memory reads that feed the
// arithmetic, and no overlap of the K/V tile loads with it.
//
// Design (simple and right first).  One CTA per (bh, 64-row query tile),
// heavy (late, causal) query tiles scheduled first.  Tiles wholly above the
// diagonal or left of every query's window are skipped, as on the TPU.
//
// * bf16: 4 warps, each owning 16 query rows.  Q stays in registers as the
//   A operand of mma.sync.m16n8k16 (bf16 in, float32 accumulate); each
//   64-key K/V tile is staged in shared memory (rows padded by 16 bytes, so
//   fragment reads are free of bank conflicts); S = Q K^T, the online
//   softmax and O += P V all stay in registers, P re-packed to bf16 as the
//   A operand of the second product and V read with ldmatrix.trans.
// * float32: no tensor cores (no TF32): 256 threads, each owning a 4x4
//   block of the 64x64 score tile and 4 output rows, Q/K/V/P staged in
//   shared memory as float32, row statistics combined over half-warps.
//
// wgmma, TMA, cp.async pipelining and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows = BQ

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int group, int Sq, int Skv, float scale, float softcap, int causal,
               int window) {
  constexpr int LDS = HD + 8;   // padded shared row, in bf16 elements
  constexpr int KC = HD / 16;   // 16-deep chunks of head_dim (Q K^T)
  constexpr int NB = HD / 8;    // 8-wide column blocks of the output
  constexpr int VEC = HD / 8;   // 16-byte vectors per K/V row
  constexpr int SB = BKV / 8;   // 8-wide column blocks of the score tile
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LDS];

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's query rows: r0 and r0 + 8
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * HD;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * Skv * HD;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * Skv * HD;

  // A fragments of Q: a0 (row g, cols 2t..), a1 (row g+8), a2 (row g, cols
  // 2t+8..), a3 (row g+8, cols 2t+8..), per 16-deep chunk
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(qb + (size_t)row * HD + kc * 16 + 2 * t);
      qa[kc][h] = row < Sq ? src[0] : 0u;
      qa[kc][h + 2] = row < Sq ? src[4] : 0u;
    }

  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    // whole tile left of every query's window? (block-uniform)
    if (window > 0 && k0 + BKV - 1 <= q0 - window) continue;
    __syncthreads();  // previous tile's readers are done
    for (int idx = tid; idx < BKV * VEC; idx += MMA_THREADS) {
      const int r = idx / VEC, c = (idx % VEC) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Skv) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * HD + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r * LDS + c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T: element e of s[nb] is row r0 + 8 * (e >> 1), key
    // k0 + nb * 8 + 2t + (e & 1)
    float s[SB][4];
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int nb = 0; nb < SB; ++nb) {
        const __nv_bfloat16* kr = &Ks[(nb * 8 + g) * LDS + kc * 16 + 2 * t];
        mma_bf16(s[nb], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    uint32_t ok_bits = 0u;  // bit 4 * nb + e: score (nb, e) is unmasked
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = r0 + 8 * (e >> 1);
        const int kp = k0 + nb * 8 + 2 * t + (e & 1);
        float x = s[nb][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (ok) ok_bits |= 1u << (4 * nb + e);
        x = ok ? x : NEG_INF;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 lanes of a quad hold one row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);
      alpha[h] = expf(m_i[h] - m_new);
      m_i[h] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok_bits >> (4 * nb + e) & 1u) ? expf(s[nb][e] - m_i[e >> 1]) : 0.f;
        s[nb][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l_i[h] = alpha[h] * l_i[h] + ps[h];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }

    // O += P V: the score accumulators are the A fragments of P; the V
    // fragments come from ldmatrix.trans (lanes 8m..8m+7 address the rows
    // of matrix m: keys +8 for odd m, head dims +8 for m >= 2)
    const int m = lane >> 3;
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, &Vs[(kc * 16 + (m & 1) * 8 + (lane & 7)) * LDS + dn * 16 + (m >> 1) * 8]);
        mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
  }

  __nv_bfloat16* ob = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_i[h], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * HD + nb * 8 + 2 * t) =
          pack_bf16(acc[nb][2 * h] / denom, acc[nb][2 * h + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int HD>
constexpr size_t f32_smem_bytes() {
  // Q tile + K tile + V tile (each 64 x (HD+1)) + P tile (64 x 65), float32
  return sizeof(float) * (size_t)(BQ * (HD + 1) + 2 * BKV * (HD + 1) + BQ * (BKV + 1));
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int group, int Sq,
              int Skv, float scale, float softcap, int causal, int window) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BKV + 1;
  constexpr int KPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ps = Vs + BKV * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i
  const int tc = tid & 15;  // score columns tc + 16 j, output columns tc + 16 c
  const float* qb = q + (size_t)bh * Sq * HD;
  const float* kb = k + (size_t)(bh / group) * Skv * HD;
  const float* vb = v + (size_t)(bh / group) * Skv * HD;

  for (int idx = tid; idx < BQ * HD; idx += F32_THREADS) {
    const int r = idx / HD, c = idx % HD;
    Qs[r * LD + c] = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * HD + c] : 0.f;
  }

  float m[4], l[4], acc[4][KPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    if (window > 0 && k0 + BKV - 1 <= q0 - window) continue;
    __syncthreads();  // Q staged; previous tile's K/V/P readers are done
    for (int idx = tid; idx < BKV * HD; idx += F32_THREADS) {
      const int r = idx / HD, c = idx % HD;
      const bool ok = k0 + r < Skv;
      const size_t gi = (size_t)(k0 + r) * HD + c;
      Ks[r * LD + c] = ok ? kb[gi] : 0.f;
      Vs[r * LD + c] = ok ? vb[gi] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    unsigned ok_bits = 0u;  // bit 4*i+j: score (i, j) is unmasked
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr + 16 * i;
      mx[i] = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        x = ok ? x : NEG_INF;
        if (ok) ok_bits |= 1u << (4 * i + j);
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (ok_bits >> (4 * i + j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int c = 0; c < KPT; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tr + 16 * i) * LDP + tc + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < BKV; ++jj) {
      float pv[4], vv[KPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * LDP + jj];
#pragma unroll
      for (int c = 0; c < KPT; ++c) vv[c] = Vs[jj * LD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < KPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* ob = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < KPT; ++c) ob[(size_t)qp * HD + tc + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int BH, group, Sq, Skv;
  float scale, softcap;
  int causal, window;
};

template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.BH, (a.Sq + BQ - 1) / BQ);
  flash_fwd_bf16<HD><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.group,
      a.Sq, a.Skv, a.scale, a.softcap, a.causal, a.window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  // above 48 KB only as opted-in dynamic shared memory.  The attribute is
  // set outside stream capture only: the first call of every instantiation
  // comes from an eager warm-up before any capture.
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing(stream, &status);
  if (err != cudaSuccess) return err;
  if (status == cudaStreamCaptureStatusNone) {
    err = cudaFuncSetAttribute(flash_fwd_f32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.BH, (a.Sq + BQ - 1) / BQ);
  flash_fwd_f32<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.group, a.Sq, a.Skv,
      a.scale, a.softcap, a.causal, a.window);
  return cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, hd), k/v: (BH / group, Skv, hd), o: (BH, Sq, hd), all
// contiguous and 16-byte aligned, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1).  Launches on `stream` and returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int is_bf16, int BH, int group, int Sq, int Skv,
                                   int hd, float scale, float softcap, int causal,
                                   int window, void* stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || group <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, BH, group, Sq, Skv, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return (int)(is_bf16 ? launch_bf16<32>(a, s) : launch_f32<32>(a, s));
    case 64: return (int)(is_bf16 ? launch_bf16<64>(a, s) : launch_f32<64>(a, s));
    case 128: return (int)(is_bf16 ? launch_bf16<128>(a, s) : launch_f32<128>(a, s));
    default: return (int)cudaErrorInvalidValue;
  }
}
