// Block-tiled online-softmax attention (flash) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel): the same function, scale, optional
// tanh soft-cap before the mask, causal (aligned top-left when Sq != Skv)
// and/or sliding-window mask (kv > q - window), GQA (q head h reads kv head
// h / group of the same batch index), float32 running max / sum /
// accumulator, output in the input type.  Unlike the TPU kernel it masks
// the ragged edge itself, so any Sq and Skv are accepted; for every length
// the TPU accepts it computes what the TPU computes, including 0 for a row
// whose every key is masked (finite -1e30 fill and p zeroed, never -inf).
//
// Layout.  Both kernels read the model layout through strides: q (B, Sq,
// NH, hd), k and v (B, Skv, NH / group, hd), o (B, Sq, NH, hd), each with
// its own batch, sequence and head strides in elements and a contiguous
// last dimension.  The JAX-style (BH, S, hd) layout is B = 1, NH = BH, head
// stride S * hd.
//
// What bounds it.  At phi4-mini prefill shapes (24 q heads over 8 kv
// heads, head_dim 128, bf16, causal, S = 64..2048) the work is
// 4 * hd * NH * S(S+1)/2 operations over (q + k + v + o) bytes: about 190
// operations per byte at S = 512, near the card's ridge (~295), and 770 at
// S = 2048, where the tensor cores bound it.
//
// bf16 design (warp specialisation, as Hopper's own GEMMs are built).  A CTA
// takes 64 query rows of one (batch, head) with one producer warp and one
// consumer warpgroup, or two that split its K/V tiles (even and odd) and
// merge their partial results through shared memory: kernel.py's chooser
// takes two when the grid fits the card in one wave, where the CTAs'
// chains of tiles, not the card's throughput, set the time.  The producer
// loads the Q tile once, then streams 64-key K and V tiles into a ring of
// STAGES stages by TMA (cp.async.bulk.tensor from tensor maps built on the
// host from the strides), each stage guarded by full barriers (K and V
// apart) and an empty barrier that the consuming warpgroup's threads
// arrive on.  Tiles wholly above the diagonal or left of every row's window
// are never loaded; the TMA zero-fills rows past Sq / Skv.  The consumers
// run S = Q K^T on wgmma.mma_async (m64n64k16, Q and K in shared memory,
// both K-major), the online softmax on the accumulator fragments in
// registers (float32 max and sum, masks on fragment coordinates only on
// tiles that cross an edge, the scale and log2(e) folded into one fma before
// ex2), then O += P V on wgmma (m64nHDk16) with P from registers: the S
// accumulator, rounded to bf16 after the rescale (the rounding point of
// P), already has the A-fragment layout; V is MN-major
// in shared memory (hd contiguous), read through the descriptor's
// transpose bit.  Within a warpgroup the products are pipelined: the Q K^T
// of one tile and the PV of the one before are in flight together while
// the softmax of the newer waits only for its scores.  Shared tiles use the
// 128-byte swizzle (64-byte for hd 32) in both the tensor maps and the
// wgmma descriptors.  The epilogue divides by the row sum and stores O
// through its strides, masking rows past Sq.  Heavy (late, causal) query
// tiles run first.  One consumer warpgroup needs at most 168 registers, so
// two CTAs share an SM (their shared memory fits twice) and setmaxnreg has
// nothing to move.
//
// Head dim 80 (zamba2-2.7b) runs the bf16 kernel on a 128-wide tile: the
// tensor maps declare the inner dimension as 80, so the TMA fills columns
// 80-127 of Q, K and V with zeros.  Q K^T takes only the 5 k-steps that
// hold data (exact); P V computes 128 output columns, of which the
// epilogue stores the first 80.  The 80-wide row is 160 bytes, so the
// strides stay 16-byte aligned.  The float32 kernel instantiates HD = 80.
//
// float32 on the FMA units (no TF32): 256 threads, each owning a 4x4 block
// of the 64x64 score tile and 4 output rows, Q/K/V/P staged in shared
// memory as float32, row statistics combined over half-warps.
//
// Training.  Given an `lse` pointer, both kernels also write each row's
// log-sum-exp of its unmasked scores (after the scale and the cap) as
// float32 in natural-log units, (B, NH, Sq) contiguous, +inf for a row
// whose every key is masked: what the backward kernel
// (flash_attention_bwd.cu) recomputes P = exp(S - LSE) from.  The bf16
// kernel keeps m in base-2 units, so it writes (m + log2 l) * ln 2.  A
// null `lse` (serving) skips the store.

#include "hopper.cuh"

#include <type_traits>

namespace {

struct Shape {
  Strides q, k, v, o;
  int NH, group, Sq, Skv;
  float scale, softcap;
  int causal, window;
  float* lse;  // (B, NH, Sq) float32, or null: no LSE written
};

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;

// Threads of a bf16 CTA: NWG consumer warpgroups and one producer warp.
constexpr int bf16_threads(int nwg) { return 128 * nwg + 32; }

// Bytes in which the second consumer warpgroup of a split CTA hands its
// partial result to the first: per thread its HD / 2 accumulators and two
// rows' max and sum.
constexpr size_t bf16_exchange_bytes(int hd, int nwg) {
  return nwg == 2 ? 4 * 128 * (size_t)(padded_hd(hd) / 2 + 4) : 0;
}

// Shared memory of one bf16 CTA: the 64-row Q tile, the K and V rings, 1 +
// 3 * STAGES mbarriers and the split CTA's exchange.  kernel.py's smem_bytes
// is the same formula.
constexpr size_t bf16_smem_bytes(int hd, int nwg, int bkv) {
  return 2 * (size_t)padded_hd(hd) * (64 + 2 * STAGES * bkv) + 8 * (1 + 3 * STAGES) +
         bf16_exchange_bytes(hd, nwg);
}

template <int HD, int NWG, int BKV>
__global__ void __launch_bounds__(bf16_threads(NWG), NWG == 1 ? 2 : 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
               const Shape d) {
  using W = Swz<HD>;
  constexpr int HDP = W::HDP;  // the tiles' width; columns past HD are zeros
  constexpr int BM = 64;
  constexpr int Q_BYTES = BM * HDP * 2;
  constexpr int KV_BYTES = BKV * HDP * 2;  // one K (or V) stage
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on 1024.
  // With no static shared memory the dynamic block starts the CTA's shared
  // window, so it is aligned; a launch where it is not traps.
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  if (sQ & 1023u) __trap();
  const uint32_t sK = sQ + Q_BYTES;
  const uint32_t sV = sK + STAGES * KV_BYTES;
  const uint32_t bar = sV + STAGES * KV_BYTES;  // q_full, k_full[S], v_full[S], empty[S]
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * STAGES + s); };
  // the split CTA's exchange, after the barriers
  float* xch = reinterpret_cast<float*>(smem_raw + Q_BYTES + 2 * STAGES * KV_BYTES +
                                        8 * (1 + 3 * STAGES));

  const int b = blockIdx.x / d.NH, h = blockIdx.x % d.NH;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  int t0, t1;
  kv_tile_range(d.Skv, d.causal, d.window, q0, BM, BKV, t0, t1);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128);  // every thread of the consuming warpgroup releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {
    // ---- producer: one thread loads Q once, then runs the K/V ring ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
      mbar_expect_tx(bar, Q_BYTES);
      tma_tile<HD, BM>(sQ, &tq, q0, h, b, bar);
      const int kvh = h / d.group;
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(s), KV_BYTES);
        tma_tile<HD, BKV>(sK + s * KV_BYTES, &tk, t * BKV, kvh, b, k_full(s));
        mbar_expect_tx(v_full(s), KV_BYTES);
        tma_tile<HD, BKV>(sV + s * KV_BYTES, &tv, t * BKV, kvh, b, v_full(s));
      }
    }
  } else {
    // ---- consumer warpgroups: the CTA's 64 query rows; with two, warpgroup
    // wg takes the tiles wg, wg + 2, ... of the ring and the two merge ----
    const int wg = warp / 4, wl = warp % 4;
    const int g = lane >> 2, t4 = lane & 3;
    const int tid = threadIdx.x % 128;
    const int r_first = q0;                       // the CTA's first row
    const int r0 = r_first + 16 * wl + g;         // this thread's rows: r0, r0 + 8
    // scores to log2 units: exp2(x * log2 e) = exp(x)
    const float qk_scale = d.softcap > 0.f ? d.scale / d.softcap : d.scale * LOG2E;
    const float cap_scale = d.softcap * LOG2E;

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f}, alpha[2];
    float sc[BKV / 2];         // scores of the newest tile, then its p
    uint32_t pa[BKV / 16][4];  // P of the tile whose PV product is next

    // S = Q K^T of tile stage s over HD / 16 k-steps (issued, not waited);
    // a padded tile's zero columns add nothing and are skipped
    auto issue_qk = [&](int s) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        wgmma_ss<BKV>(sc, desc_kmajor<HD, BM>(sQ, kc), desc_kmajor<HD, BKV>(sK + s * KV_BYTES, kc),
                      kc > 0);
      wgmma_commit();
    };
    // O += P V of stage s over BKV / 16 k-steps; V is MN-major
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        wgmma_rs<HDP>(acc, pa[kc], desc_mnmajor<HD, BKV>(sV + s * KV_BYTES, kc));
      wgmma_commit();
    };
    // the online softmax of the tile at key k0, in place on sc: masks,
    // the running max, alpha, p and the running sum (acc is rescaled by
    // alpha later, once the PV product in flight has finished with it)
    auto softmax_pass = [&](int k0, auto masked, auto capped) {
      constexpr bool CAP = decltype(capped)::value;
      // element 4j + e of sc: row r0 + 8 * (e >> 1), key k0 + 8j + 2 t4 + (e & 1).
      // Uncapped, sc keeps the raw scores and the scale goes into the
      // exponent's fma (it is positive, so the max commutes with it);
      // capped, sc holds the capped scores in log2 units.
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if constexpr (CAP) x = tanhf(x * qk_scale) * cap_scale;
          if constexpr (decltype(masked)::value) {
            const int qp = r0 + 8 * (e >> 1);
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            bool ok = kp < d.Skv;
            if (d.causal) ok = ok && kp <= qp;
            if (d.window > 0) ok = ok && kp > qp - d.window;
            x = ok ? x : NEG_INF;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      const float mul = CAP ? 1.f : qk_scale;
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes of a quad hold one row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r] == NEG_INF ? NEG_INF : mx[r] * mul);
        alpha[r] = ex2(m_i[r] - m_new);
        m_i[r] = m_new;
        // a masked score gives 2^(-1e30 * mul - m) = 0; a row whose keys are
        // all masked so far keeps max -1e30, and subtracts 0 instead
        m_use[r] = m_new == NEG_INF ? 0.f : m_new;
      }
      float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums per row
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[4 * j + e], mul, -m_use[e >> 1]));
          sc[4 * j + e] = p;
          ps[e >> 1][j & 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = ps[r][0] + ps[r][1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_i[r] = alpha[r] * l_i[r] + sum;
      }
    };
    // one straight-line pass per case: the mask only on tiles that cross
    // the diagonal, the window's edge or Skv, the cap only when asked for
    auto softmax = [&](int k0) {
      const bool masked = k0 + BKV > d.Skv || (d.causal && k0 + BKV - 1 > r_first) ||
                          (d.window > 0 && k0 <= r_first + 63 - d.window);
      using T = std::true_type;
      using F = std::false_type;
      if (d.softcap > 0.f) {
        if (masked) softmax_pass(k0, T{}, T{});
        else softmax_pass(k0, F{}, T{});
      } else {
        if (masked) softmax_pass(k0, T{}, F{});
        else softmax_pass(k0, F{}, F{});
      }
    };
    // acc *= alpha, then P to bf16 A fragments: P is rounded to bf16 here,
    // after the rescale and before the PV product; the row sum keeps the
    // float32 values
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pack_a<BKV / 8>(pa, sc);
    };

    // Software pipeline over this warpgroup's tiles i = wg, wg + NWG, ...
    // (ring slot i % STAGES): the Q K^T product of one tile and the PV
    // product of the one before are in flight together, and the softmax of
    // the newer runs while the tensor cores finish the PV product.
    const int n = t1 - t0;
    const int mine = n > wg ? (n - wg + NWG - 1) / NWG : 0;
    auto slot = [](int i) { return i % STAGES; };
    auto parity = [](int i) { return (uint32_t)((i / STAGES) & 1); };
    mbar_wait(bar, 0);
    if (mine > 0) {
      mbar_wait(k_full(slot(wg)), parity(wg));
      wgmma_fence();
      issue_qk(slot(wg));
      wgmma_wait<0>();
      fence_regs(sc);
      softmax((t0 + wg) * BKV);
      rescale_and_pack();
    }
    for (int j = 1; j < mine; ++j) {
      const int i = wg + j * NWG, ip = i - NWG;
      mbar_wait(k_full(slot(i)), parity(i));
      mbar_wait(v_full(slot(ip)), parity(ip));
      wgmma_fence();
      issue_qk(slot(i));
      issue_pv(slot(ip));
      wgmma_wait<1>();  // Q K^T of tile i done; PV of tile ip may run on
      fence_regs(sc);
      softmax((t0 + i) * BKV);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);   // the PV product read these registers until now
      mbar_arrive(empty(slot(ip)));
      rescale_and_pack();
    }
    if (mine > 0) {
      const int ip = wg + (mine - 1) * NWG;
      mbar_wait(v_full(slot(ip)), parity(ip));
      wgmma_fence();
      issue_pv(slot(ip));
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty(slot(ip)));
    }

    if constexpr (NWG == 2) {
      // warpgroup 1 hands (acc, m, l) over in its own fragment order
      // (element k of thread t at k * 128 + t: no bank conflicts) through
      // named barrier 1; warpgroup 0 merges and writes the output
      if (wg == 1) {
#pragma unroll
        for (int k = 0; k < HDP / 2; ++k) xch[k * 128 + tid] = acc[k];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xch[(HDP / 2 + r) * 128 + tid] = m_i[r];
          xch[(HDP / 2 + 2 + r) * 128 + tid] = l_i[r];
        }
        asm volatile("bar.arrive 1, 256;\n" ::: "memory");
        return;
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xch[(HDP / 2 + r) * 128 + tid];
        const float m = fmaxf(m_i[r], m1);
        a0[r] = ex2(m_i[r] - m);  // both -1e30: 1 and 1, over zero sums
        a1[r] = ex2(m1 - m);
        l_i[r] = l_i[r] * a0[r] + xch[(HDP / 2 + 2 + r) * 128 + tid] * a1[r];
        m_i[r] = m;
      }
#pragma unroll
      for (int k = 0; k < HDP / 2; ++k)
        acc[k] = acc[k] * a0[(k >> 1) & 1] + xch[k * 128 + tid] * a1[(k >> 1) & 1];
    }

    // epilogue: O / l through o's strides, rows past Sq masked, the HD
    // columns of the row (a padded tile's last columns are not stored)
    __nv_bfloat16* ob = o + (long long)b * d.o.b + (long long)h * d.o.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= d.Sq) continue;
      const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
      if (d.lse != nullptr && t4 == 0)  // m_i and l_i in base-2 units
        d.lse[((long long)b * d.NH + h) * d.Sq + row] =
            l_i[r] > 0.f ? (m_i[r] + log2f(l_i[r])) * LN2 : __int_as_float(0x7f800000);
      __nv_bfloat16* orow = ob + (long long)row * d.o.s;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BKV32 = 64;
constexpr int F32_THREADS = 256;

template <int HD>
constexpr size_t f32_smem_bytes() {
  // Q tile + K tile + V tile (each 64 x (HD+1)) + P tile (64 x 65), float32
  return sizeof(float) * (size_t)(BQ * (HD + 1) + 2 * BKV32 * (HD + 1) + BQ * (BKV32 + 1));
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, const Shape d) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BKV32 + 1;
  constexpr int KPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV32 * LD;
  float* Ps = Vs + BKV32 * LD;

  const int b = blockIdx.x / d.NH, h = blockIdx.x % d.NH;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i
  const int tc = tid & 15;  // score columns tc + 16 j, output columns tc + 16 c
  const float* qb = q + (long long)b * d.q.b + (long long)h * d.q.h;
  const float* kb = k + (long long)b * d.k.b + (long long)(h / d.group) * d.k.h;
  const float* vb = v + (long long)b * d.v.b + (long long)(h / d.group) * d.v.h;

  for (int idx = tid; idx < BQ * HD; idx += F32_THREADS) {
    const int r = idx / HD, c = idx % HD;
    Qs[r * LD + c] = (q0 + r < d.Sq) ? qb[(long long)(q0 + r) * d.q.s + c] : 0.f;
  }

  float m[4], l[4], acc[4][KPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = d.causal ? min(d.Skv, q0 + BQ) : d.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV32) {
    if (d.window > 0 && k0 + BKV32 - 1 <= q0 - d.window) continue;
    __syncthreads();  // Q staged; previous tile's K/V/P readers are done
    for (int idx = tid; idx < BKV32 * HD; idx += F32_THREADS) {
      const int r = idx / HD, c = idx % HD;
      const bool ok = k0 + r < d.Skv;
      Ks[r * LD + c] = ok ? kb[(long long)(k0 + r) * d.k.s + c] : 0.f;
      Vs[r * LD + c] = ok ? vb[(long long)(k0 + r) * d.v.s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < HD; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LD + dd];
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
        float x = s[i][j] * d.scale;
        if (d.softcap > 0.f) x = tanhf(x / d.softcap) * d.softcap;
        bool ok = kp < d.Skv;
        if (d.causal) ok = ok && kp <= qp;
        if (d.window > 0) ok = ok && kp > qp - d.window;
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
    for (int jj = 0; jj < BKV32; ++jj) {
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

  float* ob = o + (long long)b * d.o.b + (long long)h * d.o.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp >= d.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (d.lse != nullptr && tc == 0)
      d.lse[((long long)b * d.NH + h) * d.Sq + qp] =
          l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
#pragma unroll
    for (int c = 0; c < KPT; ++c) ob[(long long)qp * d.o.s + tc + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v;
  void* o;
  int B;
};

template <int HD, int NWG, int BKV>
int launch_bf16(const Ptrs& p, const Shape& d, cudaStream_t stream) {
  constexpr int BM = 64;
  const size_t smem = bf16_smem_bytes(HD, NWG, BKV);
  CUtensorMap tq, tk, tv;
  const int nkv = d.NH / d.group;
  int err = make_map<HD>(&tq, p.q, p.B, d.Sq, d.NH, d.q, BM);
  if (!err) err = make_map<HD>(&tk, p.k, p.B, d.Skv, nkv, d.k, BKV);
  if (!err) err = make_map<HD>(&tv, p.v, p.B, d.Skv, nkv, d.v, BKV);
  if (err) return err;
  static int ready_on = -1;
  cudaError_t cerr = allow_smem(flash_fwd_bf16<HD, NWG, BKV>, smem, stream, ready_on);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(p.B * d.NH, (d.Sq + BM - 1) / BM);
  flash_fwd_bf16<HD, NWG, BKV><<<grid, bf16_threads(NWG), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(p.o), d);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Ptrs& p, const Shape& d, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  static int ready_on = -1;
  cudaError_t err = allow_smem(flash_fwd_f32<HD>, smem, stream, ready_on);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * d.NH, (d.Sq + BQ - 1) / BQ);
  flash_fwd_f32<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<float*>(p.o), d);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16_tile(const Ptrs& p, const Shape& d, int nwg, int bkv, cudaStream_t stream) {
  if (nwg == 1 && bkv == 64) return launch_bf16<HD, 1, 64>(p, d, stream);
  if (nwg == 2 && bkv == 64) return launch_bf16<HD, 2, 64>(p, d, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, NH, hd), k and v (B, Skv, NH / group, hd), o (B, Sq, NH, hd):
// `strides` holds the batch, sequence and head strides, in elements, of
// q, k, v and o in that order (12 numbers); the last dimension is
// contiguous.  float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); the bf16
// kernel runs the tile of `nwg` consumer warpgroups and `bkv` keys per K/V
// tile (kernel.py's TILES), and needs 16-byte aligned base pointers and
// strides (its tensor maps).  `lse`, if not null, receives each row's
// log-sum-exp, (B, NH, Sq) float32.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success), or ERR_* above.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int is_bf16, int B, int NH, int group, int Sq,
                                   int Skv,
                                   int hd, const long long* strides, float scale, float softcap,
                                   int causal, int window, int nwg, int bkv, void* stream) {
  if (B <= 0 || NH <= 0 || Sq <= 0 || Skv <= 0 || group <= 0 || NH % group)
    return (int)cudaErrorInvalidValue;
  const Strides* st = reinterpret_cast<const Strides*>(strides);
  const Shape d{st[0], st[1], st[2], st[3], NH, group, Sq, Skv,
                scale, softcap, causal, window, lse};
  const Ptrs p{q, k, v, o, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return is_bf16 ? launch_bf16_tile<32>(p, d, nwg, bkv, s) : launch_f32<32>(p, d, s);
    case 64: return is_bf16 ? launch_bf16_tile<64>(p, d, nwg, bkv, s) : launch_f32<64>(p, d, s);
    case 80: return is_bf16 ? launch_bf16_tile<80>(p, d, nwg, bkv, s) : launch_f32<80>(p, d, s);
    case 128: return is_bf16 ? launch_bf16_tile<128>(p, d, nwg, bkv, s) : launch_f32<128>(p, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
