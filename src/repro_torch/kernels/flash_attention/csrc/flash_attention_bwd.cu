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
//      registers, in a fixed order, and written once;
//   3. bwd_dq: one CTA per (batch, q head, 64-row query tile) walks the K/V
//      tiles its rows can see and accumulates dQ.
// Splitting dQ from dK/dV recomputes S and dP once more than an atomic dQ
// would, and keeps every sum in one order: two calls on the same inputs
// give the same bits, and so do a training step run eagerly and replayed.
//
// Layout.  q, k, v, o, dO, dq, dk, dv are read and written through their
// batch, sequence and head strides (elements; last dimension contiguous),
// the model layout (B, S, heads, hd) or the flat (BH, S, hd) as B = 1.
// LSE and D are (B, NH, Sq) float32, contiguous.
//
// What bounds it.  At phi4-mini's training shape (B 2, S 512, 24 q heads
// over 8 kv heads, hd 128, bf16, causal) the work is five products of the
// forward's size over the visible pairs, 8.07 GFLOP, over about 34 MB of
// q, k, v, o, dO, LSE and the three gradients: 240 operations a byte, near
// the card's ridge, with the bytes' bound (10.1 us) a little above the
// operations' (8.2 us).  Both are far below what one CTA's chain of tiles
// takes, so what bounds a call is the longest CTA: the dK/dV CTA of causal
// key tile 0 walks 24 query tiles (3 heads x 8), six 64 x 64 x 128 products
// each (below), about 150 MFLOP on one SM of the 132.
//
// bf16 design (the forward's pieces, hopper.cuh).  Each main kernel has one
// producer warp and one consumer warpgroup (160 threads).  The producer
// loads the CTA's resident tiles once by TMA and streams the others into a
// ring of stages, each guarded by a full barrier (the TMA's bytes plus the
// producer lanes' arrivals) and an empty barrier (the 128 consumer
// threads).  bwd_dkdv takes the keys as the product's M dimension: K and V
// stay resident and the ring (3 stages) carries each query tile's Q and dO
// with its 64 LSE (times log2 e) and 64 D values.  Per stage the consumers
// run S^T = K Q^T and dP^T = V dO^T on wgmma (SS, both K-major), turn S^T
// into P^T in registers while dP^T runs (the scale, the cap, exp2 against
// the LSE; the masks on fragment coordinates only on tiles that cross the
// diagonal or the window's edge: rows past Sq have LSE = +inf and so
// P = 0), then dV += P^T dO with P^T as A fragments from registers and dO
// read MN-major through the descriptor's transpose bit, then dS^T = P^T
// (dP^T - D) times the cap's factor and the scale, and dK += dS^T Q the
// same way.  Key tile 0, which sees the most query tiles under a causal
// mask, runs first.  bwd_dq takes the query rows as M: Q, dO and the rows'
// LSE and D stay resident (LSE and D in registers), the ring (2 stages)
// carries K and V tiles, and the products are S = Q K^T, dP = dO V^T (SS,
// P computed while dP runs) and dQ += dS K (RS, K MN-major).  Head dim 80
// runs on a 128-wide tile the TMA zero-fills, as the forward does.  Every
// product of a stage is retired within its loop iteration, as in the
// forward: with the next stage's products in flight across the loop's back
// edge, ptxas serialised every wgmma (its warning C7515).
//
// Precision.  P and dS enter their products as a pair of bf16 fragments,
// hi = bf16(x) and lo = bf16(x - hi) (split_a), so the products see them to
// about 16 bits: dV, dK and dQ take two products each.  A single bf16 P or
// dS, as FlashAttention's kernels round them, put dk 2.2 times and dv 1.2
// times past this repo's tolerance in the capped sweep cases, where the
// scores are large and the sums cancel; with the pair the gradients'
// errors are their output's rounding.
//
// Registers and occupancy.  A dK/dV consumer thread holds dK and dV (HD/2
// float32 each: 64 + 64 at hd 128), S^T and dP^T (32 + 32) and the pairs of
// P^T's or dS^T's fragments (32): ptxas gives it 255 registers at hd 80 and
// 128 with no spill, one CTA of 160 threads to an SM.  The grid at phi4's
// shape is 128 CTAs, under one wave of 132 SMs.  Two consumer warpgroups
// sharing a key tile need setmaxnreg to get those registers (at 288 threads
// ptxas caps a thread at 168 and spills: 0.130 ms a call against 0.072);
// with it, a first try did not finish.  More CTAs, one per (q head, key
// tile), made the dK/dV kernel 12-16% faster (chip_smoke.py phase 19a)
// before the partial sums over the group it would need (about 25 MB of
// float32 traffic): not worth them.  A dQ thread holds 64 + 32 + 32 + 32
// (168 registers): two CTAs share an SM, registers and shared memory both.
//
// float32 keeps the FMA-unit kernels (no TF32, so that float32 stays within
// summation order of its plain version): 256 threads, each owning a 4 x 4
// block of a 64 x 64 score tile and 4 rows of the hd-wide accumulators, the
// tiles staged in shared memory with one padding column; one CTA per SM.

#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int BM = 64;        // query rows of a tile
constexpr int BN = 64;        // keys of a tile
constexpr int THREADS = 256;  // the pre-pass and the float32 kernels
constexpr int DOT_ROWS = THREADS / 32;      // float32 pre-pass rows per CTA: a warp each
constexpr int BF16_DOT_ROWS = THREADS / 8;  // bf16 pre-pass rows per CTA: 8 lanes each

struct Bwd {
  Strides q, k, v, o, dO, dq, dk, dv;
  int NH, group, Sq, Skv;
  float scale, softcap;
  int causal, window;
  const float* lse;  // (B, NH, Sq)
  float* D;          // (B, NH, Sq)
};

// is the score of query qp and key kp unmasked (causal and window only:
// the ragged edges are handled where they occur)?
__device__ __forceinline__ bool in_mask(const Bwd& d, int qp, int kp) {
  bool ok = true;
  if (d.causal) ok = kp <= qp;
  if (d.window > 0) ok = ok && kp > qp - d.window;
  return ok;
}

// 1. D = rowsum(dO * O) over the rows (b, h, s) of the (B, NH, Sq) layout:
// float32 one warp per row, element by element; bf16 8 lanes per row, 16
// bytes (8 values) a load (its rows are 16-byte aligned: the wrapper
// prepares o and dO for the TMA as it does q, k and v)
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dO, const Bwd d, long long rows) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LANES = BF16 ? 8 : 32;
  const long long row = (long long)blockIdx.x * (THREADS / LANES) + threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  float acc = 0.f;
  if (row < rows) {
    const int s = (int)(row % d.Sq);
    const long long bh = row / d.Sq;
    const int h = (int)(bh % d.NH), b = (int)(bh / d.NH);
    const T* orow = o + b * d.o.b + h * d.o.h + s * d.o.s;
    const T* drow = dO + b * d.dO.b + h * d.dO.h + s * d.dO.s;
    if constexpr (BF16) {
      for (int c = sub; c < HD / 8; c += LANES) {
        const uint4 a = reinterpret_cast<const uint4*>(orow)[c];
        const uint4 g = reinterpret_cast<const uint4*>(drow)[c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 af = __bfloat1622float2(a2[i]), gf = __bfloat1622float2(g2[i]);
          acc = fmaf(gf.x, af.x, acc);
          acc = fmaf(gf.y, af.y, acc);
        }
      }
    } else {
      for (int c = sub; c < HD; c += LANES) acc = fmaf(drow[c], orow[c], acc);
    }
  }
  // every lane shuffles (a row past the end adds 0 and is not stored)
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) d.D[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int BF16_THREADS = 160;  // one consumer warpgroup and one producer warp
constexpr int DKDV_STAGES = 3;     // (Q, dO) stages of bwd_dkdv's ring
constexpr int DQ_STAGES = 2;       // (K, V) stages of bwd_dq's ring

// one 64-row bf16 tile at the padded width
constexpr size_t tile_bytes(int hd) { return 2 * (size_t)BM * padded_hd(hd); }

// Shared memory of a bf16 dK/dV CTA: the K and V tiles, the ring's Q and dO
// tiles, its stages' 64 LSE and 64 D values, and 1 + 2 * STAGES mbarriers.
// backward.py's dkdv_smem_bytes is the same formula.
constexpr size_t dkdv_bf16_smem(int hd) {
  return tile_bytes(hd) * (2 + 2 * DKDV_STAGES) + 4 * 2 * BM * DKDV_STAGES +
         8 * (1 + 2 * DKDV_STAGES);
}
// Shared memory of a bf16 dQ CTA: the Q and dO tiles, the ring's K and V
// tiles and 1 + 2 * STAGES mbarriers (backward.py's dq_smem_bytes).
constexpr size_t dq_bf16_smem(int hd) {
  return tile_bytes(hd) * (2 + 2 * DQ_STAGES) + 8 * (1 + 2 * DQ_STAGES);
}

using T_ = std::true_type;
using F_ = std::false_type;

// 2. dK and dV of one (batch, kv head, key tile), summed over the group
template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 1)
bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, const Bwd d) {
  using W = Swz<HD>;
  constexpr int HDP = W::HDP;  // the tiles' width; columns past HD are zeros
  constexpr int S = DKDV_STAGES;
  constexpr uint32_t TILE = BM * HDP * 2;
  // tiles start on 1024 bytes (the swizzle's period): the dynamic block
  // starts the CTA's shared window; a launch where it does not traps
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sK = smem_u32(smem_raw);
  if (sK & 1023u) __trap();
  const uint32_t sV = sK + TILE;
  auto q_at = [&](int s) { return sK + (2 + 2 * s) * TILE; };
  auto do_at = [&](int s) { return sK + (3 + 2 * s) * TILE; };
  // stage s's LSE (times log2 e) at rows[s * BM], its D at rows[(S + s) * BM]
  float* rows = reinterpret_cast<float*>(smem_raw + (2 + 2 * S) * TILE);
  const uint32_t bar = smem_u32(rows + 2 * BM * S);  // kv_full, full[S], empty[S]
  auto full = [&](int s) { return bar + 8u * (1 + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + S + s); };

  const int nkv = d.NH / d.group;
  const int b = blockIdx.x / nkv, kvh = blockIdx.x % nkv;
  const int k0 = blockIdx.y * BN;  // causal: tile 0 sees the most query tiles, and runs first
  // the query tiles that see a key of [k0, k_last]: from the diagonal's
  // (causal), below k_last + window (window); stage i is q head
  // kvh * group + i / per_head, query tile qt0 + i % per_head
  const int k_last = min(k0 + BN, d.Skv) - 1;
  const int qt0 = d.causal ? k0 / BM : 0;
  const int q_end = d.window > 0 ? min(d.Sq, k_last + d.window) : d.Sq;
  const int per_head = max(0, (q_end + BM - 1) / BM - qt0);
  const int n = per_head * d.group;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);    // the producer's lanes, one with the TMA's bytes
      mbar_init(empty(s), 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer: K and V once, then each stage's Q, dO, LSE and D ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tdo)) : "memory");
      mbar_expect_tx(bar, 2 * TILE);
      tma_tile<HD, BN>(sK, &tk, k0, kvh, b, bar);
      tma_tile<HD, BN>(sV, &tv, k0, kvh, b, bar);
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      const int h = kvh * d.group + i / per_head, q0 = (qt0 + i % per_head) * BM;
      mbar_wait(empty(s), ((i / S) & 1) ^ 1);
      const long long base = ((long long)b * d.NH + h) * d.Sq;
      for (int r = lane; r < BM; r += 32) {  // rows past Sq: P = 0 and D = 0
        const bool in = q0 + r < d.Sq;
        rows[s * BM + r] = in ? d.lse[base + q0 + r] * LOG2E : __int_as_float(0x7f800000);
        rows[(S + s) * BM + r] = in ? d.D[base + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * TILE);
        tma_tile<HD, BM>(q_at(s), &tq, q0, h, b, full(s));
        tma_tile<HD, BM>(do_at(s), &tdo, q0, h, b, full(s));
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 keys, 16 a warp ----
  const int g = lane >> 2, t4 = lane & 3;
  const int kr = k0 + 16 * warp + g;  // this thread's keys: kr, kr + 8
  // the raw score times `mul` is tanh's argument (capped) or log2 units
  const float mul = d.softcap > 0.f ? d.scale / d.softcap : d.scale * LOG2E;
  const float cap2 = d.softcap * LOG2E;

  float dK[HDP / 2], dV[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dK[i] = dV[i] = 0.f;
  // element 4j + e of a 64 x 64 tile: key kr + 8 (e >> 1), query
  // q0 + 8j + 2 t4 + (e & 1)
  float st[32];         // S^T, then P^T times the cap's factor and the scale
  float dpt[32];        // dP^T, then dS^T
  uint32_t pa[2][4][4]; // P^T as a bf16 pair (hi, lo): dV's A operands (depth: 64 queries)
  uint32_t sa[2][4][4]; // dS^T as a bf16 pair (hi, lo): dK's A operands

  auto issue_sdp = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss<64>(st, desc_kmajor<HD, BN>(sK, kc), desc_kmajor<HD, BM>(q_at(s), kc), kc > 0);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss<64>(dpt, desc_kmajor<HD, BN>(sV, kc), desc_kmajor<HD, BM>(do_at(s), kc), kc > 0);
    wgmma_commit();
  };
  // P^T of stage s into pa (a bf16 pair) and st (float32, times the
  // cap's factor and the scale: dS^T = st * (dP^T - D))
  auto p_pass = [&](int s, int q0, auto masked, auto capped) {
    const float* lse2 = rows + s * BM;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t4);
      float p[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = st[4 * j + e], f = d.scale;
        if constexpr (decltype(capped)::value) {
          const float t = tanhf(x * mul);
          x = t * cap2;
          f *= 1.f - t * t;
        } else {
          x *= mul;
        }
        p[e] = ex2(x - ((e & 1) ? l.y : l.x));
        if constexpr (decltype(masked)::value) {
          if (!in_mask(d, q0 + 8 * j + 2 * t4 + (e & 1), kr + 8 * (e >> 1))) p[e] = 0.f;
        }
        st[4 * j + e] = p[e] * f;
        lo[e] = p[e] - __bfloat162float(__float2bfloat16(p[e]));
      }
      pa[0][j / 2][2 * (j & 1)] = pack_bf16(p[0], p[1]);
      pa[0][j / 2][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      pa[1][j / 2][2 * (j & 1)] = pack_bf16(lo[0], lo[1]);
      pa[1][j / 2][2 * (j & 1) + 1] = pack_bf16(lo[2], lo[3]);
    }
  };
  auto ds_pass = [&](int s) {
    const float* D = rows + (S + s) * BM;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(D + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
    }
    split_a<8>(sa, dpt);
  };
  // dV += P^T dO and dK += dS^T Q over the stage's 64 queries (4 k-steps),
  // dO and Q read MN-major
  auto issue_dv = [&](int s) {
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc)
        wgmma_rs<HDP>(dV, pa[part][kc], desc_mnmajor<HD, BM>(do_at(s), kc));
    wgmma_commit();
  };
  auto issue_dk = [&](int s) {
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc)
        wgmma_rs<HDP>(dK, sa[part][kc], desc_mnmajor<HD, BM>(q_at(s), kc));
    wgmma_commit();
  };

  // every product of a stage retired within its iteration (see the note
  // at the top); P^T is computed while dP^T runs
  mbar_wait(bar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S, q0 = (qt0 + i % per_head) * BM;
    mbar_wait(full(s), (i / S) & 1);
    wgmma_fence();
    issue_sdp(s);
    wgmma_wait<1>();  // S^T done; dP^T runs on
    fence_regs(st);
    // the masks only on tiles that cross the diagonal or the window's edge
    const bool masked = (d.causal && q0 < k0 + BN - 1) ||
                        (d.window > 0 && q0 + BM - 1 - d.window >= k0);
    if (d.softcap > 0.f) {
      if (masked) p_pass(s, q0, T_{}, T_{});
      else p_pass(s, q0, F_{}, T_{});
    } else {
      if (masked) p_pass(s, q0, T_{}, F_{});
      else p_pass(s, q0, F_{}, F_{});
    }
    wgmma_fence();
    issue_dv(s);
    wgmma_wait<0>();  // dP^T and dV done: P^T's fragments are free for dS^T's
    fence_regs(dpt);
    fence_regs(dV);
    fence_regs(pa[0]);
    fence_regs(pa[1]);
    ds_pass(s);
    wgmma_fence();
    issue_dk(s);
    wgmma_wait<0>();
    fence_regs(dK);
    fence_regs(sa[0]);
    fence_regs(sa[1]);
    mbar_arrive(empty(s));  // the stage's products are done with its tiles
  }

  // epilogue: the HD columns of keys below Skv, through dk's and dv's strides
  __nv_bfloat16* dkb = dk + (long long)b * d.dk.b + (long long)kvh * d.dk.h;
  __nv_bfloat16* dvb = dv + (long long)b * d.dv.b + (long long)kvh * d.dv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kr + 8 * r;
    if (kp >= d.Skv) continue;
    __nv_bfloat16* krow = dkb + (long long)kp * d.dk.s;
    __nv_bfloat16* vrow = dvb + (long long)kp * d.dv.s;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j + 2 * t4) =
          pack_bf16(dK[4 * j + 2 * r], dK[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j + 2 * t4) =
          pack_bf16(dV[4 * j + 2 * r], dV[4 * j + 2 * r + 1]);
    }
  }
}

// 3. dQ of one (batch, q head, query tile)
template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 2)
bwd_dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            __nv_bfloat16* __restrict__ dq, const Bwd d) {
  using W = Swz<HD>;
  constexpr int HDP = W::HDP;
  constexpr int S = DQ_STAGES;
  constexpr uint32_t TILE = BM * HDP * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  if (sQ & 1023u) __trap();
  const uint32_t sdO = sQ + TILE;
  auto k_at = [&](int s) { return sQ + (2 + 2 * s) * TILE; };
  auto v_at = [&](int s) { return sQ + (3 + 2 * s) * TILE; };
  const uint32_t bar = sQ + (2 + 2 * S) * TILE;  // qdo_full, full[S], empty[S]
  auto full = [&](int s) { return bar + 8u * (1 + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + S + s); };

  const int b = blockIdx.x / d.NH, h = blockIdx.x % d.NH, kvh = h / d.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heavy (late, causal) tiles first
  int t0, t1;
  kv_tile_range(d.Skv, d.causal, d.window, q0, BM, BN, t0, t1);
  const int n = t1 - t0;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer: Q and dO once, then the K/V ring ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
      mbar_expect_tx(bar, 2 * TILE);
      tma_tile<HD, BM>(sQ, &tq, q0, h, b, bar);
      tma_tile<HD, BM>(sdO, &tdo, q0, h, b, bar);
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        mbar_wait(empty(s), ((i / S) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * TILE);
        tma_tile<HD, BN>(k_at(s), &tk, (t0 + i) * BN, kvh, b, full(s));
        tma_tile<HD, BN>(v_at(s), &tv, (t0 + i) * BN, kvh, b, full(s));
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 query rows, 16 a warp ----
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
  const float mul = d.softcap > 0.f ? d.scale / d.softcap : d.scale * LOG2E;
  const float cap2 = d.softcap * LOG2E;
  float lse2[2], Dr[2];  // rows past Sq: P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long long at = ((long long)b * d.NH + h) * d.Sq + row;
    lse2[r] = row < d.Sq ? d.lse[at] * LOG2E : __int_as_float(0x7f800000);
    Dr[r] = row < d.Sq ? d.D[at] : 0.f;
  }

  float dQ[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dQ[i] = 0.f;
  // element 4j + e of a 64 x 64 tile: row r0 + 8 (e >> 1), key
  // k0 + 8j + 2 t4 + (e & 1)
  float sc[32];         // S, then P times the cap's factor and the scale
  float dp[32];         // dP, then dS
  uint32_t sa[2][4][4]; // dS as a bf16 pair (hi, lo): dQ's A operands (depth: 64 keys)

  auto issue_sdp = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss<64>(sc, desc_kmajor<HD, BM>(sQ, kc), desc_kmajor<HD, BN>(k_at(s), kc), kc > 0);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss<64>(dp, desc_kmajor<HD, BM>(sdO, kc), desc_kmajor<HD, BN>(v_at(s), kc), kc > 0);
    wgmma_commit();
  };
  auto p_pass = [&](int k0, auto masked, auto capped) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e], f = d.scale;
        if constexpr (decltype(capped)::value) {
          const float t = tanhf(x * mul);
          x = t * cap2;
          f *= 1.f - t * t;
        } else {
          x *= mul;
        }
        float p = ex2(x - lse2[e >> 1]);
        if constexpr (decltype(masked)::value) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kp >= d.Skv || !in_mask(d, r0 + 8 * (e >> 1), kp)) p = 0.f;
        }
        sc[4 * j + e] = p * f;
      }
  };
  auto issue_dq = [&](int s) {
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs<HDP>(dQ, sa[part][kc], desc_mnmajor<HD, BN>(k_at(s), kc));
    wgmma_commit();
  };

  // every product retired within its iteration, as in bwd_dkdv_bf16; P is
  // computed while dP runs
  mbar_wait(bar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S, k0 = (t0 + i) * BN;
    mbar_wait(full(s), (i / S) & 1);
    wgmma_fence();
    issue_sdp(s);
    wgmma_wait<1>();  // S done; dP runs on
    fence_regs(sc);
    const bool masked = k0 + BN > d.Skv || (d.causal && k0 + BN - 1 > q0) ||
                        (d.window > 0 && k0 <= q0 + BM - 1 - d.window);
    if (d.softcap > 0.f) {
      if (masked) p_pass(k0, T_{}, T_{});
      else p_pass(k0, F_{}, T_{});
    } else {
      if (masked) p_pass(k0, T_{}, F_{});
      else p_pass(k0, F_{}, F_{});
    }
    wgmma_wait<0>();  // dP done
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = sc[j] * (dp[j] - Dr[(j >> 1) & 1]);
    split_a<8>(sa, dp);
    wgmma_fence();
    issue_dq(s);
    wgmma_wait<0>();
    fence_regs(dQ);
    fence_regs(sa[0]);
    fence_regs(sa[1]);
    mbar_arrive(empty(s));
  }

  __nv_bfloat16* dqb = dq + (long long)b * d.dq.b + (long long)h * d.dq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= d.Sq) continue;
    __nv_bfloat16* qrow = dqb + (long long)row * d.dq.s;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(qrow + 8 * j + 2 * t4) =
          pack_bf16(dQ[4 * j + 2 * r], dQ[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

// shared memory of the two float32 kernels, in bytes (backward.py's formulas)
template <int HD>
constexpr size_t dkdv_f32_smem() {
  // K, V, Q, dO tiles (64 x (HD + 1)), P and dS tiles (64 x 65), LSE and D
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + 2 * BM * (BN + 1) + 2 * BM);
}
template <int HD>
constexpr size_t dq_f32_smem() {
  // Q, dO, K, V tiles, the dS tile, LSE and D
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + BM * (BN + 1) + 2 * BM);
}

// rows [r0, r0 + 64) x HD of a strided (batch, head) slice into a
// 64 x (HD + 1) float tile, rows at or past `rows` zero
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int r0, int rows) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    dst[r * LD + c] = r0 + r < rows ? src[(long long)(r0 + r) * row_stride + c] : 0.f;
  }
}

// is the score of query qp and key kp unmasked?
__device__ __forceinline__ bool visible(const Bwd& d, int qp, int kp) {
  return qp < d.Sq && kp < d.Skv && in_mask(d, qp, kp);
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

// 2. dK and dV of one (batch, kv head, key tile), summed over the group
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO, float* __restrict__ dk,
             float* __restrict__ dv, const Bwd d) {
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
  load_tile<HD>(Ks, k + b * d.k.b + kvh * d.k.h, d.k.s, k0, d.Skv);
  load_tile<HD>(Vs, v + b * d.v.b + kvh * d.v.h, d.v.s, k0, d.Skv);

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
    const float* qb = q + b * d.q.b + h * d.q.h;
    const float* db = dO + b * d.dO.b + h * d.dO.h;
    for (int q0 = q_first; q0 < q_end; q0 += BM) {
      __syncthreads();  // the last tile's readers of Qs, dOs, Ps, dSs are done
      load_tile<HD>(Qs, qb, d.q.s, q0, d.Sq);
      load_tile<HD>(dOs, db, d.dO.s, q0, d.Sq);
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

  float* dkb = dk + b * d.dk.b + kvh * d.dk.h;
  float* dvb = dv + b * d.dv.b + kvh * d.dv.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + tr + 16 * a;
    if (kp >= d.Skv) continue;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      dkb[(long long)kp * d.dk.s + tc + 16 * c] = dK[a][c];
      dvb[(long long)kp * d.dv.s + tc + 16 * c] = dV[a][c];
    }
  }
}

// 3. dQ of one (batch, q head, query tile)
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dO, float* __restrict__ dq, const Bwd d) {
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
  load_tile<HD>(Qs, q + b * d.q.b + h * d.q.h, d.q.s, q0, d.Sq);
  load_tile<HD>(dOs, dO + b * d.dO.b + h * d.dO.h, d.dO.s, q0, d.Sq);
  load_rows(d, lse_s, D_s, ((long long)b * d.NH + h) * d.Sq, q0);
  const float* kb = k + b * d.k.b + kvh * d.k.h;
  const float* vb = v + b * d.v.b + kvh * d.v.h;

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
    load_tile<HD>(Ks, kb, d.k.s, k0, d.Skv);
    load_tile<HD>(Vs, vb, d.v.s, k0, d.Skv);
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

  float* dqb = dq + b * d.dq.b + h * d.dq.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + tr + 16 * a;
    if (qp >= d.Sq) continue;
#pragma unroll
    for (int c = 0; c < KPT; ++c) dqb[(long long)qp * d.dq.s + tc + 16 * c] = dQ[a][c];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *o, *dO;
  void *dq, *dk, *dv;
  int B;
};

template <typename T, int HD>
cudaError_t launch_dot(const Ptrs& p, const Bwd& d, cudaStream_t stream) {
  const long long rows = (long long)p.B * d.NH * d.Sq;
  constexpr int per_cta = std::is_same<T, float>::value ? DOT_ROWS : BF16_DOT_ROWS;
  bwd_dot<T, HD><<<(unsigned)((rows + per_cta - 1) / per_cta), THREADS, 0, stream>>>(
      static_cast<const T*>(p.o), static_cast<const T*>(p.dO), d, rows);
  return cudaGetLastError();
}

template <int HD>
int launch_bf16(const Ptrs& p, const Bwd& d, cudaStream_t stream) {
  static int dkdv_ready = -1, dq_ready = -1;
  cudaError_t err = allow_smem(bwd_dkdv_bf16<HD>, dkdv_bf16_smem(HD), stream, dkdv_ready);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_bf16<HD>, dq_bf16_smem(HD), stream, dq_ready);
  if (err != cudaSuccess) return (int)err;
  // every tile is 64 rows: one map each for q, k, v and dO serves both kernels
  CUtensorMap tq, tk, tv, tdo;
  const int nkv = d.NH / d.group;
  int merr = make_map<HD>(&tq, p.q, p.B, d.Sq, d.NH, d.q, BM);
  if (!merr) merr = make_map<HD>(&tk, p.k, p.B, d.Skv, nkv, d.k, BN);
  if (!merr) merr = make_map<HD>(&tv, p.v, p.B, d.Skv, nkv, d.v, BN);
  if (!merr) merr = make_map<HD>(&tdo, p.dO, p.B, d.Sq, d.NH, d.dO, BM);
  if (merr) return merr;
  err = launch_dot<__nv_bfloat16, HD>(p, d, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid(p.B * nkv, (d.Skv + BN - 1) / BN);
  bwd_dkdv_bf16<HD><<<kv_grid, BF16_THREADS, dkdv_bf16_smem(HD), stream>>>(
      tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(p.dk), static_cast<__nv_bfloat16*>(p.dv), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid(p.B * d.NH, (d.Sq + BM - 1) / BM);
  bwd_dq_bf16<HD><<<q_grid, BF16_THREADS, dq_bf16_smem(HD), stream>>>(
      tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(p.dq), d);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Ptrs& p, const Bwd& d, cudaStream_t stream) {
  static int dkdv_ready = -1, dq_ready = -1;
  cudaError_t err = allow_smem(bwd_dkdv_f32<HD>, dkdv_f32_smem<HD>(), stream, dkdv_ready);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_f32<HD>, dq_f32_smem<HD>(), stream, dq_ready);
  if (err == cudaSuccess) err = launch_dot<float, HD>(p, d, stream);
  if (err != cudaSuccess) return (int)err;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dO = static_cast<const float*>(p.dO);
  const dim3 kv_grid(p.B * (d.NH / d.group), (d.Skv + BN - 1) / BN);
  bwd_dkdv_f32<HD><<<kv_grid, THREADS, dkdv_f32_smem<HD>(), stream>>>(
      q, k, v, dO, static_cast<float*>(p.dk), static_cast<float*>(p.dv), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid(p.B * d.NH, (d.Sq + BM - 1) / BM);
  bwd_dq_f32<HD><<<q_grid, THREADS, dq_f32_smem<HD>(), stream>>>(q, k, v, dO,
                                                                 static_cast<float*>(p.dq), d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dO, dq (B, Sq, NH, hd); k, v, dk, dv (B, Skv, NH / group, hd):
// `strides` holds the batch, sequence and head strides, in elements, of q,
// k, v, o, dO, dq, dk, dv in that order (24 numbers); the last dimension is
// contiguous.  `lse` is the forward's (B, NH, Sq) float32 log-sum-exp and
// `D` a (B, NH, Sq) float32 workspace.  float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1), accumulation in float32; bf16 needs 16-byte aligned base
// pointers and strides of q, k, v and dO (its tensor maps).  Launches the
// three kernels on `stream` and returns the first non-zero
// cudaGetLastError() (0 on success), or hopper.cuh's ERR_* when a tensor
// map cannot be built (before any launch).
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
  switch (hd) {
    case 32: return is_bf16 ? launch_bf16<32>(p, d, s) : launch_f32<32>(p, d, s);
    case 64: return is_bf16 ? launch_bf16<64>(p, d, s) : launch_f32<64>(p, d, s);
    case 80: return is_bf16 ? launch_bf16<80>(p, d, s) : launch_f32<80>(p, d, s);
    case 128: return is_bf16 ? launch_bf16<128>(p, d, s) : launch_f32<128>(p, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
