// Decode attention (B3) for Hopper, sm_90a: one decode step's grouped-query
// attention over a KV cache, the cache read in its own dtype (float32 or
// bf16), the scores, the softmax and the sums in float32.
//
// Replaces no TPU kernel.  The JAX package leaves decode attention to XLA:
// src/repro/models/layers.py, _sdpa_deferred (the einsums at :328 and :305
// in its cache form, _sdpa) multiplies the cache in its own dtype into
// float32 scores (preferred_element_type), a fused native-dtype dot that
// never writes a float32 copy of the cache.  PyTorch has no such product:
// torch.matmul on bf16 returns bf16, so the plain version (ref.py) upcasts
// both operands, and every decode step wrote and read a float32 copy of the
// whole cache in every layer.  This kernel computes the same function in one
// pass over the cache as it is stored.
//
// What bounds it: bytes.  Every cache byte is read once and takes part in
// G = NH / NKV (1 to 12) multiply-adds of the scores and as many of the
// product with v; at 2·G operations per bf16 element the card's float32
// units keep up with 3.35 TB/s, and no tensor core is needed.
//
// The design, for that bound:
// * Split over positions.  The grid is (parts, B·NKV, row tiles).  A CTA
//   takes one (batch row, kv head) and one chunk of cache positions, with
//   all G·S query rows of that kv head (up to 16 in one row tile), so each
//   K/V byte is read by one CTA only.  The chunk length is planned in Python
//   (kernel.py, choose_launch) from the shapes alone (B, T, NKV, G·S, hd,
//   dtype), so that the CTAs fill their last wave on the card's SMs best:
//   never from kv_valid or the positions, which the kernel reads on the
//   device.  A CUDA graph captured once stays valid as the offsets
//   advance, and a synchronized step (one offset for every row) runs the
//   same plan, with the same bits, as the per-slot step on the same state.
// * Chunks wholly at or past kv_valid[b] exit at once: the grid is fixed by
//   T, the work by what is valid.
// * The step's own keys and values (the deferred form) are one more part,
//   the last, read by the same loop from k_new / v_new at key positions
//   kv_valid[b] + j.
// * Loads: 64-position K and V tiles, 16 bytes a thread with cp.async (each
//   thread one 16-byte piece of every few rows, addresses stepped without
//   divisions), two stages, so tile i+1 is in flight while tile i is used.
//   K rows are padded to 32 bytes past a multiple of 128, so that the two
//   threads that share a key row (alternate 8-element chunks) and their
//   neighbours hit distinct banks; V rows are not (the product with v reads
//   a row's chunks side by side).  At phi4-mini's head dim a CTA takes
//   72752 bytes, three to an SM.
// * Scores: two threads a key position, float32 FMAs on the CUDA cores
//   against the query rows kept in shared memory as float32; masked scores
//   are -inf.  The online softmax's running max and sum live in float32
//   registers of one warp per row.  The product with v: each thread keeps
//   8 columns of every row for a slice of the tile's positions, rescaled by
//   the running max as it moves; at the end of the chunk the slices are
//   summed in a fixed order in shared memory.
// * Each live part writes its unnormalised float32 row sums with their max
//   and sum to the scratch; a second kernel weighs the parts of each row
//   once (in shared memory), sums them in a fixed order (part 0, 1, ...,
//   the new part last) and writes the output in q's dtype.  No atomics:
//   replays are bit-repeatable.
// A row whose every key is masked (no decode path makes one) comes out as 0;
// the plain version gives the mean of v there.
//
// Launches on the caller's stream and allocates nothing: kernel.py makes the
// output and the scratch with torch.empty.  decode_attention returns
// cudaGetLastError() after the two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TK = 64;          // key positions per K/V tile
constexpr int COLS = 8;         // columns per thread in the product with v
constexpr int MAX_HD = 128;
constexpr long long NO_ROW = -(1LL << 62);   // qpos of a padding row

struct Params {
  const void* q;
  const void* kc;
  const void* vc;
  const void* kn;
  const void* vn;
  void* out;
  float* part;
  const long long* positions;
  const long long* kv_valid;
  long long q_s[3];       // batch, step, head strides (elements)
  long long kc_s[3];      // batch, position, head
  long long vc_s[3];
  long long kn_s[3];
  long long vn_s[3];
  long long o_s[3];
  long long pos_s[2];     // batch, step
  long long kvv_s;        // batch (0: one offset for every row)
  long long window;       // 0: none
  int B, S, NKV, G, T, hd, chunk, n_chunks, n_parts, n_rt, causal;
  float scale, softcap;
};

// elements of one K tile row in shared memory: hd, padded so that rows lie
// 32 bytes past a multiple of 128 apart (V tile rows are hd apart: the
// product with v reads each row's chunks side by side)
__host__ __device__ inline int row_elems(int hd, int esize) {
  const int bytes = hd * esize;
  return (bytes + ((32 - bytes) % 128 + 128) % 128) / esize;
}

// the dynamic shared memory of a CTA: query positions (R), query rows
// (R x hd float32), scores / probabilities (R x TK), the rescale factors
// (R, padded to 16 bytes), then the K/V ring (2 stages of a K and a V
// tile), which the end of the chunk reuses to sum the threads' slices
// (THREADS x R x COLS float32)
__host__ __device__ inline int smem_bytes(int R, int hd, int esize) {
  const int head = 8 * R + 4 * R * hd + 4 * R * TK + 16 * ((4 * R + 15) / 16);
  const int ring = 2 * TK * (row_elems(hd, esize) + hd) * esize;
  const int red = THREADS * R * COLS * 4;
  return head + (ring > red ? ring : red);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 elements from shared memory (16-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// 16 bytes from global to shared memory, L2 only; valid false fills zeros
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One part of one (batch row, kv head, row tile): the rows' unnormalised
// sums over the part's key positions, with their running max and sum, into
// the scratch.  R query rows per tile (a power of two, 2 to 16).
template <typename T, int R>
__global__ void __launch_bounds__(THREADS) decode_partial(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int part = blockIdx.x, bh = blockIdx.y, rt = blockIdx.z;
  const int b = bh / p.NKV, kvh = bh % p.NKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = p.hd, C8 = hd / COLS, RE = row_elems(hd, sizeof(T));
  const long long kvv = p.kv_valid[b * p.kvv_s];
  const long long limit = kvv < p.T ? kvv : (long long)p.T;
  const bool is_new = part >= p.n_chunks;
  // a cache chunk at or past the valid entries does no work: the live ones
  // are a prefix, which the combine reads
  if (!is_new && (long long)part * p.chunk >= limit) return;
  // source rows [start, end) of k/v; key position = base + row
  const long long start = is_new ? 0 : (long long)part * p.chunk;
  const long long end = is_new ? p.S : (start + p.chunk < limit ? start + p.chunk : limit);
  const long long base = is_new ? kvv : 0;
  const T* ksrc = static_cast<const T*>(is_new ? p.kn : p.kc);
  const T* vsrc = static_cast<const T*>(is_new ? p.vn : p.vc);
  ksrc += b * (is_new ? p.kn_s[0] : p.kc_s[0]) + kvh * (is_new ? p.kn_s[2] : p.kc_s[2]);
  vsrc += b * (is_new ? p.vn_s[0] : p.vc_s[0]) + kvh * (is_new ? p.vn_s[2] : p.vc_s[2]);
  const long long kstep = is_new ? p.kn_s[1] : p.kc_s[1];   // position strides
  const long long vstep = is_new ? p.vn_s[1] : p.vc_s[1];

  long long* qpos = reinterpret_cast<long long*>(smem);
  float* qs = reinterpret_cast<float*>(qpos + R);
  float* ps = qs + R * hd;
  float* alpha = ps + R * TK;
  T* ring = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(alpha) +
                                 16 * ((4 * R + 15) / 16));
  float* red = reinterpret_cast<float*>(ring);

  // each thread copies 16-byte piece pc of rows row0, row0 + rstep, ... of
  // the K and V tiles (threads past rstep whole rows idle)
  const int per = 16 / (int)sizeof(T);
  const int pieces = hd / per, rstep = THREADS / pieces;
  const int pc = tid % pieces, row0 = tid / pieces;
  const int stage_elems = TK * (RE + hd);
  auto load_tile = [&](int i, int stage) {
    T* kt = ring + stage * stage_elems;
    T* vt = kt + TK * RE;
    const long long t0 = start + (long long)i * TK;
    if (row0 < rstep) {
      for (int row = row0; row < TK; row += rstep) {
        const long long t = t0 + row;
        const bool valid = t < end;
        cp_async16(kt + row * RE + pc * per, valid ? ksrc + t * kstep + pc * per : ksrc, valid);
        cp_async16(vt + row * hd + pc * per, valid ? vsrc + t * vstep + pc * per : vsrc, valid);
      }
    }
  };

  const int ntiles = (int)((end - start + TK - 1) / TK);
  constexpr int RW = (R + 3) / 4;          // rows per warp in the softmax
  float m_run[RW], l_run[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }
  float acc[R][COLS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < COLS; ++e) acc[r][e] = 0.f;
  const int PS = THREADS / C8;             // position slices of the product with v
  const int sl = tid / C8, col = tid - sl * C8;

  load_tile(0, 0);                         // in flight while the query rows load
  cp_async_commit();
  const int GS = p.G * p.S;
  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, rr = rt * R + r;
    float x = 0.f;
    if (rr < GS) {
      const int s = rr / p.G, g = rr - s * p.G;
      x = to_f(q[b * p.q_s[0] + s * p.q_s[1] + (long long)(kvh * p.G + g) * p.q_s[2] + d]);
    }
    qs[i] = x;
  }
  if (tid < R) {
    const int rr = rt * R + tid;
    qpos[tid] = rr < GS ? p.positions[b * p.pos_s[0] + (rr / p.G) * p.pos_s[1]] : NO_ROW;
  }
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_tile(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kt = ring + (i & 1) * stage_elems;
    const T* vt = kt + TK * RE;
    const long long t0 = start + (long long)i * TK;

    // scores: threads 2t and 2t+1 share key row t, alternate 8-column chunks
    {
      const int t = tid >> 1, h = tid & 1;
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      for (int c = h; c < C8; c += 2) {
        float k8[COLS];
        load8(kt + t * RE + c * COLS, k8);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float q8[COLS];
          load8(qs + r * hd + c * COLS, q8);
#pragma unroll
          for (int e = 0; e < COLS; ++e) sc[r] = fmaf(q8[e], k8[e], sc[r]);
        }
      }
      const long long kp = base + t0 + t;
      const bool in = t0 + t < end;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s2 = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 1);
        if ((r & 1) == h) {
          const long long qp = qpos[r];
          const bool ok = in && qp != NO_ROW && (!p.causal || kp <= qp) &&
                          (p.window == 0 || kp > qp - p.window);
          float s = s2 * p.scale;
          if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
          ps[r * TK + t] = ok ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int r = warp + 4 * j;
      if (r < R) {
        const float s0 = ps[r * TK + lane], s1 = ps[r * TK + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[j], mx);
        float p0 = 0.f, p1 = 0.f, a = 1.f;
        if (m_new != -INFINITY) {
          p0 = expf(s0 - m_new);
          p1 = expf(s1 - m_new);
          a = expf(m_run[j] - m_new);
        }
        ps[r * TK + lane] = p0;
        ps[r * TK + lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l_run[j] = l_run[j] * a + sum;
        m_run[j] = m_new;
        if (lane == 0) alpha[r] = a;
      }
    }
    __syncthreads();

    // the product with v: thread (slice, col) sums positions slice, slice + PS, ...
    if (sl < PS) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = alpha[r];
#pragma unroll
        for (int e = 0; e < COLS; ++e) acc[r][e] *= a;
      }
      for (int t = sl; t < TK; t += PS) {
        float v8[COLS];
        load8(vt + t * hd + col * COLS, v8);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pr = ps[r * TK + t];
#pragma unroll
          for (int e = 0; e < COLS; ++e) acc[r][e] = fmaf(pr, v8[e], acc[r][e]);
        }
      }
    }
    __syncthreads();      // the stage read here is the one refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the slices in a fixed order, then write the part
  if (sl < PS) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < COLS; ++e) red[(sl * R + r) * hd + col * COLS + e] = acc[r][e];
  }
  __syncthreads();
  const int stride = hd + 2;
  float* dst = p.part + ((long long)(bh * p.n_rt + rt) * p.n_parts + part) * R * stride;
  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    float s = 0.f;
    for (int k = 0; k < PS; ++k) s += red[(k * R + r) * hd + d];
    dst[r * stride + d] = s;
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + 4 * j;
    if (r < R && lane == 0) {
      dst[r * stride + hd] = m_run[j];
      dst[r * stride + hd + 1] = l_run[j];
    }
  }
}

// The parts of each row combined in a fixed order (the live cache chunks,
// a prefix, then the new part), normalised, written in q's dtype to out
// (B, S, NH, hd).  Shared memory: each row's weight of each part, then the
// rows' sums of exponentials.
template <typename T, int R>
__global__ void __launch_bounds__(THREADS) decode_combine(const Params p) {
  extern __shared__ float wsm[];
  const int bh = blockIdx.x, rt = blockIdx.y;
  const int b = bh / p.NKV, kvh = bh % p.NKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = p.hd, stride = hd + 2, GS = p.G * p.S;
  const long long kvv = p.kv_valid[b * p.kvv_s];
  long long limit = kvv < p.T ? kvv : (long long)p.T;
  if (limit < 0) limit = 0;
  const int live = (int)((limit + p.chunk - 1) / p.chunk);
  const int np = live + (p.n_parts > p.n_chunks ? 1 : 0);
  const float* src = p.part + (long long)(bh * p.n_rt + rt) * p.n_parts * R * stride;
  float* w = wsm;
  float* L = wsm + R * p.n_parts;
  // part j of the order above: row r's values at src + (part(j) * R + r) * stride
  auto part = [&](int j) { return j < live ? j : p.n_chunks; };
  for (int r = warp; r < R; r += 4) {
    float M = -INFINITY;
    for (int j = lane; j < np; j += 32) M = fmaxf(M, src[(part(j) * R + r) * stride + hd]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float sum = 0.f;
    for (int j = lane; j < np; j += 32) {
      const float* row = src + (part(j) * R + r) * stride;
      const float wt = M == -INFINITY ? 0.f : expf(row[hd] - M);
      w[r * p.n_parts + j] = wt;
      sum = fmaf(row[hd + 1], wt, sum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) L[r] = sum;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd, rr = rt * R + r;
    if (rr >= GS) continue;
    float O = 0.f;
    for (int j = 0; j < np; ++j) O = fmaf(src[(part(j) * R + r) * stride + d], w[r * p.n_parts + j], O);
    const int s = rr / p.G, g = rr - s * p.G;
    out[b * p.o_s[0] + s * p.o_s[1] + (long long)(kvh * p.G + g) * p.o_s[2] + d] =
        from_f<T>(L[r] > 0.f ? O / L[r] : 0.f);
  }
}

template <typename T, int R>
cudaError_t launch(const Params& p, int smem, cudaStream_t stream) {
  const dim3 grid(p.n_parts, p.B * p.NKV, p.n_rt);
  decode_partial<T, R><<<grid, THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int combine_smem = 4 * R * (p.n_parts + 1);
  decode_combine<T, R><<<dim3(p.B * p.NKV, p.n_rt), THREADS, combine_smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Params& p, int rows, int smem, cudaStream_t stream) {
  switch (rows) {
    case 2: return launch<T, 2>(p, smem, stream);
    case 4: return launch<T, 4>(p, smem, stream);
    case 8: return launch<T, 8>(p, smem, stream);
    case 16: return launch<T, 16>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t allow_smem(int most) {
  const void* fns[] = {(const void*)decode_partial<T, 2>, (const void*)decode_partial<T, 4>,
                       (const void*)decode_partial<T, 8>, (const void*)decode_partial<T, 16>};
  for (const void* fn : fns) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Allow every kernel the card's largest dynamic shared memory; kernel.py
// calls it once per device before the first launch.
extern "C" int decode_attention_init(void) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_smem<float>(most);
  if (err == cudaSuccess) err = allow_smem<__nv_bfloat16>(most);
  return (int)err;
}

// The shared memory a CTA of `rows` query rows takes (kernel.py's
// smem_bytes computes the same).
extern "C" int decode_attention_smem(int rows, int hd, int is_bf16) {
  return smem_bytes(rows, hd, is_bf16 ? 2 : 4);
}

// q (B, S, NH, hd); k_cache / v_cache (B, T, NKV, hd); k_new / v_new
// (B, S, NKV, hd) or null; out (B, S, NH, hd); every one read through its
// batch, row and head strides (strides: q, k_cache, v_cache, k_new, v_new,
// out, 3 each), with a contiguous last dimension, and k/v 16-byte aligned
// rows.  positions: int64 at b * pos_b + s * pos_s; kv_valid: int64 at
// b * kvv_b.  part: float32 scratch of n_parts x B·NKV x n_rt x rows x
// (hd + 2).  The plan (rows, chunk, n_chunks, smem) is kernel.py's
// choose_launch.  Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for a plan it cannot run.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* kn,
                                const void* vn, void* out, float* part,
                                const long long* positions, const long long* kv_valid,
                                const long long* strides, long long pos_b, long long pos_s,
                                long long kvv_b, int is_bf16, int B, int S, int NKV, int G,
                                int T, int hd, int rows, int chunk, int n_chunks, float scale,
                                float softcap, long long window, int causal, int smem,
                                void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  if (hd % COLS || hd > MAX_HD || hd * esize % 16 || chunk % TK || chunk <= 0 ||
      smem != smem_bytes(rows, hd, esize) || 4 * rows * (n_chunks + 2) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.kc = kc; p.vc = vc; p.kn = kn; p.vn = vn; p.out = out; p.part = part;
  p.positions = positions;
  p.kv_valid = kv_valid;
  long long* dsts[] = {p.q_s, p.kc_s, p.vc_s, p.kn_s, p.vn_s, p.o_s};
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) dsts[i][j] = strides[3 * i + j];
  p.pos_s[0] = pos_b;
  p.pos_s[1] = pos_s;
  p.kvv_s = kvv_b;
  p.window = window;
  p.B = B; p.S = S; p.NKV = NKV; p.G = G; p.T = T; p.hd = hd;
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.n_parts = n_chunks + (kn != nullptr ? 1 : 0);
  p.n_rt = (G * S + rows - 1) / rows;
  p.causal = causal;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_rows<__nv_bfloat16>(p, rows, smem, st)
                                  : launch_rows<float>(p, rows, smem, st);
  return (int)err;
}
