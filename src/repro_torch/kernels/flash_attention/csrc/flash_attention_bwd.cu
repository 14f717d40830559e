// The gradient of flash attention (B1) for Hopper, sm_90a: dq, dk, dv from
// q, k, v, the forward's output o and log-sum-exp (LSE), and dO.
//
// Not a port of a TPU kernel: the JAX package has no backward kernel (its
// training differentiates the plain attention through XLA).  It is the
// gradient of flash_attention.cu's function, with its masks (causal,
// aligned top-left when Sq != Skv; sliding window; ragged edges), scale,
// tanh soft-cap and GQA.  The equations, in float32, with P recomputed
// from the forward's LSE instead of stored:
//
//   P = exp(S - LSE)        (0 where masked; LSE = +inf on a fully masked row)
//   D = rowsum(dO * O)      (pre-pass)
//   dV = P^T dO             dP = dO V^T
//   dS = P * (dP - D) * (1 - tanh^2(x / cap)) * scale   (the cap's factor only with a cap)
//   dQ = dS K               dK = dS^T Q
//
// Deterministic, no atomics, three kernels on the caller's stream:
//   1. bwd_dot: D, one warp per row;
//   2. bwd_dkdv: one CTA per (batch, kv head, 64-key tile) keeps that tile's
//      K and V and its dK and dV accumulators and walks the query tiles of
//      every q head of its GQA group that can see the tile, recomputing S,
//      P, dP and dS for each: dK and dV are summed over the group in
//      registers and written once;
//   3. bwd_dq: one CTA per (batch, q head, 64-row query tile) walks the K/V
//      tiles its rows can see and accumulates dQ.
//
// Layout.  q, k, v, o, dO, dq, dk, dv are read and written through their
// batch, sequence and head strides (elements; last dimension contiguous),
// the model layout (B, S, heads, hd) or the flat (BH, S, hd) as B = 1.
// LSE and D are (B, NH, Sq) float32, contiguous.
//
// What bounds it, and the design.  At phi4-mini's training shape (B 2,
// S 512, 24 q heads over 8 kv heads, hd 128, bf16, causal) the work is
// about 2.5 times the forward's operations (S and dP recomputed, four
// products of the forward's size) over q, k, v, o, dO and the three
// gradients: above the card's ridge, so the tensor cores bound it.  This
// first kernel is simple and right: every product runs on the FMA units in
// float32 (bf16 inputs widened on load), 256 threads, each owning a 4 x 4
// block of a 64 x 64 score tile and 4 rows of the hd-wide accumulators,
// the tiles staged in shared memory with one padding column (no bank
// conflicts); one CTA per SM (shared memory).  It is far from the bound;
// wgmma and a TMA ring, as the forward has, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows of a tile
constexpr int BN = 64;        // keys of a tile
constexpr int THREADS = 256;
constexpr int DOT_ROWS = THREADS / 32;  // rows of the pre-pass per CTA

struct Strides {
  long long b, s, h;  // elements
};

struct Bwd {
  Strides q, k, v, o, dO, dq, dk, dv;
  int NH, group, Sq, Skv;
  float scale, softcap;
  int causal, window;
  const float* lse;  // (B, NH, Sq)
  float* D;          // (B, NH, Sq)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared memory of the two main kernels, in bytes (backward.py's formulas)
template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles (64 x (HD + 1)), P and dS tiles (64 x 65), LSE and D
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + 2 * BM * (BN + 1) + 2 * BM);
}
template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles, the dS tile, LSE and D
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + BM * (BN + 1) + 2 * BM);
}

// rows [r0, r0 + 64) x HD of a strided (batch, head) slice into a
// 64 x (HD + 1) float tile, rows at or past `rows` zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int r0,
                                          int rows) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    dst[r * LD + c] = r0 + r < rows ? to_f(src[(long long)(r0 + r) * row_stride + c]) : 0.f;
  }
}

// is the score of query qp and key kp unmasked?
__device__ __forceinline__ bool visible(const Bwd& d, int qp, int kp) {
  bool ok = qp < d.Sq && kp < d.Skv;
  if (d.causal) ok = ok && kp <= qp;
  if (d.window > 0) ok = ok && kp > qp - d.window;
  return ok;
}

// The scores and dP of this thread's 4 x 4 block (query rows tr + 16a of Qs
// and dOs, keys tc + 16b of Ks and Vs), turned into P and dS: p[a][b] and
// ds[a][b] on return.  ds carries the cap's factor and the scale, so that
// dQ = dS K and dK = dS^T Q.
template <int HD>
__device__ __forceinline__ void p_and_ds(const Bwd& d, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* lse_s,
                                         const float* D_s, int q0, int k0, int tr, int tc,
                                         float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int LD = HD + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < HD; ++dd) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = Qs[(tr + 16 * a) * LD + dd];
      ov[a] = dOs[(tr + 16 * a) * LD + dd];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kv[b] = Ks[(tc + 16 * b) * LD + dd];
      vv[b] = Vs[(tc + 16 * b) * LD + dd];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
        dp[a][b] = fmaf(ov[a], vv[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = tr + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float x = s[a][b] * d.scale, dcap = 1.f;
      if (d.softcap > 0.f) {
        const float t = tanhf(x / d.softcap);
        x = t * d.softcap;
        dcap = 1.f - t * t;
      }
      const float pv = visible(d, q0 + i, k0 + tc + 16 * b) ? expf(x - lse_s[i]) : 0.f;
      p[a][b] = pv;
      ds[a][b] = pv * (dp[a][b] - D_s[i]) * dcap * d.scale;
    }
  }
}

// the rows' LSE and D into shared memory (+inf and 0 past Sq)
__device__ __forceinline__ void load_rows(const Bwd& d, float* lse_s, float* D_s, long long base,
                                          int q0) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool in = q0 + r < d.Sq;
    lse_s[r] = in ? d.lse[base + q0 + r] : __int_as_float(0x7f800000);
    D_s[r] = in ? d.D[base + q0 + r] : 0.f;
  }
}

// 1. D = rowsum(dO * O), one warp per row (b, h, s) of the (B, NH, Sq) layout
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dO, const Bwd d, long long rows) {
  const long long row = (long long)blockIdx.x * DOT_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row % d.Sq);
  const long long bh = row / d.Sq;
  const int h = (int)(bh % d.NH), b = (int)(bh / d.NH);
  const T* orow = o + b * d.o.b + h * d.o.h + s * d.o.s;
  const T* drow = dO + b * d.dO.b + h * d.dO.h + s * d.dO.s;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32) acc = fmaf(to_f(drow[c]), to_f(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) d.D[row] = acc;
}

// 2. dK and dV of one (batch, kv head, key tile), summed over the group
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dO, T* __restrict__ dk, T* __restrict__ dv, const Bwd d) {
  constexpr int LD = HD + 1, LDP = BN + 1, KPT = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BM * LDP;
  float* lse_s = dSs + BM * LDP;
  float* D_s = lse_s + BM;

  const int nkv = d.NH / d.group;
  const int b = blockIdx.x / nkv, kvh = blockIdx.x % nkv;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  load_tile<T, HD>(Ks, k + b * d.k.b + kvh * d.k.h, d.k.s, k0, d.Skv);
  load_tile<T, HD>(Vs, v + b * d.v.b + kvh * d.v.h, d.v.s, k0, d.Skv);

  float dK[4][KPT], dV[4][KPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < KPT; ++c) dK[a][c] = dV[a][c] = 0.f;

  // the query rows that see a key of [k0, k_last]: from k0 (causal), below
  // k_last + window (window)
  const int k_last = min(k0 + BN, d.Skv) - 1;
  const int q_first = d.causal ? (k0 / BM) * BM : 0;
  const int q_end = d.window > 0 ? min(d.Sq, k_last + d.window) : d.Sq;

  for (int gi = 0; gi < d.group; ++gi) {
    const int h = kvh * d.group + gi;
    const long long base = ((long long)b * d.NH + h) * d.Sq;
    const T* qb = q + b * d.q.b + h * d.q.h;
    const T* db = dO + b * d.dO.b + h * d.dO.h;
    for (int q0 = q_first; q0 < q_end; q0 += BM) {
      __syncthreads();  // the last tile's readers of Qs, dOs, Ps, dSs are done
      load_tile<T, HD>(Qs, qb, d.q.s, q0, d.Sq);
      load_tile<T, HD>(dOs, db, d.dO.s, q0, d.Sq);
      load_rows(d, lse_s, D_s, base, q0);
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds<HD>(d, Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, tr, tc, p, ds);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          Ps[(tr + 16 * a) * LDP + tc + 16 * bb] = p[a][bb];
          dSs[(tr + 16 * a) * LDP + tc + 16 * bb] = ds[a][bb];
        }
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
      // (this thread: keys tr + 16a, columns tc + 16c)
#pragma unroll 4
      for (int i = 0; i < BM; ++i) {
        float pj[4], sj[4], ov[KPT], qv[KPT];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = Ps[i * LDP + tr + 16 * a];
          sj[a] = dSs[i * LDP + tr + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          ov[c] = dOs[i * LD + tc + 16 * c];
          qv[c] = Qs[i * LD + tc + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < KPT; ++c) {
            dV[a][c] = fmaf(pj[a], ov[c], dV[a][c]);
            dK[a][c] = fmaf(sj[a], qv[c], dK[a][c]);
          }
      }
    }
  }

  T* dkb = dk + b * d.dk.b + kvh * d.dk.h;
  T* dvb = dv + b * d.dv.b + kvh * d.dv.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + tr + 16 * a;
    if (kp >= d.Skv) continue;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      dkb[(long long)kp * d.dk.s + tc + 16 * c] = from_f<T>(dK[a][c]);
      dvb[(long long)kp * d.dv.s + tc + 16 * c] = from_f<T>(dV[a][c]);
    }
  }
}

// 3. dQ of one (batch, q head, query tile)
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dO, T* __restrict__ dq, const Bwd d) {
  constexpr int LD = HD + 1, LDP = BN + 1, KPT = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;
  float* lse_s = dSs + BM * LDP;
  float* D_s = lse_s + BM;

  const int b = blockIdx.x / d.NH, h = blockIdx.x % d.NH, kvh = h / d.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heavy (late, causal) tiles first
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  load_tile<T, HD>(Qs, q + b * d.q.b + h * d.q.h, d.q.s, q0, d.Sq);
  load_tile<T, HD>(dOs, dO + b * d.dO.b + h * d.dO.h, d.dO.s, q0, d.Sq);
  load_rows(d, lse_s, D_s, ((long long)b * d.NH + h) * d.Sq, q0);
  const T* kb = k + b * d.k.b + kvh * d.k.h;
  const T* vb = v + b * d.v.b + kvh * d.v.h;

  float dQ[4][KPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < KPT; ++c) dQ[a][c] = 0.f;

  const int kv_end = d.causal ? min(d.Skv, q0 + BM) : d.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    // a tile left of the first row's window is left of every row's
    if (d.window > 0 && k0 + BN - 1 <= q0 - d.window) continue;
    __syncthreads();  // Q staged; the last tile's readers of Ks, Vs, dSs are done
    load_tile<T, HD>(Ks, kb, d.k.s, k0, d.Skv);
    load_tile<T, HD>(Vs, vb, d.v.s, k0, d.Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD>(d, Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, tr, tc, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) dSs[(tr + 16 * a) * LDP + tc + 16 * bb] = ds[a][bb];
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]  (this thread: rows tr + 16a, columns tc + 16c)
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float sj[4], kv[KPT];
#pragma unroll
      for (int a = 0; a < 4; ++a) sj[a] = dSs[(tr + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < KPT; ++c) kv[c] = Ks[j * LD + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < KPT; ++c) dQ[a][c] = fmaf(sj[a], kv[c], dQ[a][c]);
    }
  }

  T* dqb = dq + b * d.dq.b + h * d.dq.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + tr + 16 * a;
    if (qp >= d.Sq) continue;
#pragma unroll
    for (int c = 0; c < KPT; ++c) dqb[(long long)qp * d.dq.s + tc + 16 * c] = from_f<T>(dQ[a][c]);
  }
}

// above 48 KB only as opted-in dynamic shared memory, once per kernel and
// device, outside stream capture (the first call of every instantiation is
// an eager warm-up before any capture), as flash_attention.cu does it
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, cudaStream_t stream, int& ready_on) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == ready_on) return err;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(stream, &status);
  if (err != cudaSuccess || status != cudaStreamCaptureStatusNone) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) ready_on = device;
  return err;
}

struct Ptrs {
  const void *q, *k, *v, *o, *dO;
  void *dq, *dk, *dv;
  int B;
};

template <typename T, int HD>
int launch(const Ptrs& p, const Bwd& d, cudaStream_t stream) {
  static int dkdv_ready = -1, dq_ready = -1;
  cudaError_t err = allow_smem(bwd_dkdv<T, HD>, dkdv_smem_bytes<HD>(), stream, dkdv_ready);
  if (err == cudaSuccess) err = allow_smem(bwd_dq<T, HD>, dq_smem_bytes<HD>(), stream, dq_ready);
  if (err != cudaSuccess) return (int)err;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dO = static_cast<const T*>(p.dO);
  const long long rows = (long long)p.B * d.NH * d.Sq;
  bwd_dot<T, HD><<<(unsigned)((rows + DOT_ROWS - 1) / DOT_ROWS), THREADS, 0, stream>>>(
      static_cast<const T*>(p.o), dO, d, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid(p.B * (d.NH / d.group), (d.Skv + BN - 1) / BN);
  bwd_dkdv<T, HD><<<kv_grid, THREADS, dkdv_smem_bytes<HD>(), stream>>>(
      q, k, v, dO, static_cast<T*>(p.dk), static_cast<T*>(p.dv), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid(p.B * d.NH, (d.Sq + BM - 1) / BM);
  bwd_dq<T, HD><<<q_grid, THREADS, dq_smem_bytes<HD>(), stream>>>(q, k, v, dO,
                                                                   static_cast<T*>(p.dq), d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Ptrs& p, const Bwd& d, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, d, stream);
    case 64: return launch<T, 64>(p, d, stream);
    case 80: return launch<T, 80>(p, d, stream);
    case 128: return launch<T, 128>(p, d, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dO, dq (B, Sq, NH, hd); k, v, dk, dv (B, Skv, NH / group, hd):
// `strides` holds the batch, sequence and head strides, in elements, of q,
// k, v, o, dO, dq, dk, dv in that order (24 numbers); the last dimension is
// contiguous.  `lse` is the forward's (B, NH, Sq) float32 log-sum-exp and
// `D` a (B, NH, Sq) float32 workspace.  float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1), accumulation in float32.  Launches the three kernels on
// `stream` and returns the first non-zero cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dO, const float* lse, float* D, void* dq, void* dk,
                                   void* dv, int is_bf16, int B, int NH, int group, int Sq,
                                   int Skv, int hd, const long long* strides, float scale,
                                   float softcap, int causal, int window, void* stream) {
  if (B <= 0 || NH <= 0 || Sq <= 0 || Skv <= 0 || group <= 0 || NH % group)
    return (int)cudaErrorInvalidValue;
  const Strides* st = reinterpret_cast<const Strides*>(strides);
  const Bwd d{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
              NH, group, Sq, Skv, scale, softcap, causal, window, lse, D};
  const Ptrs p{q, k, v, o, dO, dq, dk, dv, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(p, d, hd, s) : launch_hd<float>(p, d, hd, s);
}
