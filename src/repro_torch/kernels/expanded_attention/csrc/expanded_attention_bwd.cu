// The gradient of expanded attention (B7) for Hopper, sm_90a: the five
// gradients of multi-head latent attention's expanded form, d q_nope,
// d q_rope, d k_nope, d k_rope and d v, from the inputs, the forward's
// output o and log-sum-exp (LSE), and dO.
//
// Not a port of a TPU kernel: the JAX package differentiates its jnp
// expanded form (src/repro/models/mla.py:90-103) through XLA.  It is the
// gradient of expanded_attention.cu's function, with its mask (key t
// visible to the query at q_pos[s] when t <= q_pos[s]; q_pos read on the
// device) and its -1e30 fill.  The equations, in float32, with P recomputed
// from the forward's LSE instead of stored:
//
//   P = exp(S - LSE) where visible; where not, 0, or 1 / T on a row whose
//       every key is masked (its softmax is uniform over the T keys)
//   D = rowsum(dO * O)                         (pre-pass)
//   dV = P^T dO                                dP = dO V^T
//   dS = P * (dP - D) * scale where visible, 0 where not (the fill is a
//        constant: no gradient reaches a masked logit)
//   dQ_nope = dS K_nope    dQ_rope = dS K_rope
//   dK_nope = dS^T Q_nope  dK_rope = sum over the N heads of dS^T Q_rope
//
// Deterministic (every sum in a fixed order, no atomic sums), four kernels
// on the caller's stream:
//   1. exp_bwd_prep: D, and for each 64-row query tile the keys its rows see
//      ([0, tile_lim), T when a row is fully masked) and its rows' smallest
//      position (tile_min), from q_pos on the device;
//   2. exp_dkdv: one CTA per (batch, head, 64-key tile) keeps that tile's K
//      and V and walks the query tiles that see it (tile_lim > its first
//      key), recomputing S, P, dP and dS for each: dV and dK_nope summed in
//      registers in a fixed order and written once; dK_rope's share of this
//      head written as float32 to a (B, N, T, rope) scratch;
//   3. exp_dq: one CTA per (batch, head, two 64-row query tiles; float32:
//      one) walks the key tiles its rows see and accumulates dQ_nope and
//      dQ_rope;
//   4. exp_rope_reduce: dK_rope = the heads' shares summed in head order.
// Two calls on the same inputs give the same bits, and so do a training
// step run eagerly and replayed.
//
// What bounds it.  At 2 x 4096 tokens and 128 heads the causal half needs
// 3.57 TFLOP, 2.6x the forward (the scores recomputed once, dP, dV, dQ and
// dK): the tensor cores.  These kernels run 5.02 TFLOP of products (the
// scores and dP twice, once for dK/dV and once for dQ).
//
// bf16 design (the forward's pieces, hopper.cuh).  Q and K tiles are 64 x
// 192, three TMA boxes side by side (two from the nope tensor, one from the
// rope tensor: k_rope through its own map, no head-broadcast copy); V and
// dO tiles 64 x 128, two boxes.  P and dS enter their products as bf16
// fragments, as FlashAttention rounds them: phase 3d's tolerances hold on
// every case, the large-score one too, so a (hi, lo) pair of fragments,
// which B1's backward needs for its capped scores, would double the
// accumulating products for nothing.  The grids are one dimension,
// the (batch, head) outermost, so that the CTAs in flight share a few
// heads' tiles in the L2.
//   exp_dkdv: a dK/dV CTA holds dK_nope (64 x 128), dK_rope (64 x 64) and
//   dV (64 x 128) in float32, 160 registers a thread in one warpgroup
//   before the S and dP fragments.  So the CTA has two consumer warpgroups
//   and no producer warp (256 threads, up to 255 registers each; a producer
//   warp would make 288 and cap a thread at 168), and each query tile's
//   products are split between them, each computed once.  Warpgroup 0
//   scores S^T = K Q^T (m64n64k16, 12 k-steps), forms P^T (the masks, 1 / T
//   on a fully masked row), writes P^T * scale as float32 into the stage's
//   16 KB buffer and arrives on the stage's named barrier, then adds dV +=
//   P^T dO (m64n128k16).  Warpgroup 1 takes dP^T = V dO^T (8 k-steps),
//   waits on that barrier, forms dS^T = P^T * scale * (dP^T - D) from the
//   buffer (each of its threads reads what the thread of warpgroup 0 in
//   the same place wrote, the fragments' layouts being alike) and adds
//   dK_nope += dS^T Q_nope (m64n128k16) and dK_rope += dS^T Q_rope
//   (m64n64k16).  Per 64 x 64 tile pair 5.24 MFLOP of products (S 1.57, dP
//   1.05, dV 1.05, dK_nope 1.05, dK_rope 0.52).  Each warpgroup's pass runs
//   under the other's products.  (Issuing the product that closes tile i -
//   1 beside the first of tile i, to run a warpgroup's own pass under it,
//   holds each stage a tile longer, and the loads then wait: slower.)  Each
//   warpgroup's products are issued and retired inside its own branch on
//   the warpgroup index, which comes through __shfl_sync (a branch on
//   threadIdx, or a product in flight across such a branch, makes ptxas
//   serialize every wgmma).  The first warp of warpgroup 1, which is
//   behind warpgroup 0 by the hand-off, refills the ring (three stages of
//   Q, dO and the 64 rows' LSE, D and positions) once both warpgroups have
//   released a stage; a stage's P^T buffer is rewritten only after that
//   refill, so the three barriers never see two rounds at once.
//   exp_dq: two consumer warpgroups and no producer warp (256 threads: a
//   producer warp would cap a thread at 168 registers), each with its own
//   64-row query tile's Q and dO, sharing one ring of K and V tiles, so
//   each tile is loaded once for 128 rows; dQ_nope and dQ_rope (64 + 32
//   float32) in registers.  Each warpgroup scores S = Q K^T and dP = dO
//   V^T, forms P and dS and adds dQ_nope += dS K_nope and dQ_rope += dS
//   K_rope (4.19 MFLOP a tile pair); each one's pass runs under the other's
//   products.  Both walk the keys either tile sees (the first masks its
//   last tile).  The one of the two that finishes a stage second (a count
//   in shared memory, after a named barrier over its own warpgroup)
//   refills it.
//
// float32 keeps the FMA units (no TF32): 256 threads, each owning a 4 x 4
// block of a 64 x 64 score tile and 4 rows of the accumulators, the tiles
// staged in shared memory with one padding column.

#include <math.h>

#include <type_traits>

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int BM = 64;                 // query rows of a tile
constexpr int BN = 64;                 // keys of a tile
constexpr int BOX = 64;                // bf16 columns of one 128-byte swizzle row
constexpr uint32_t BOX_BYTES = 64 * 128;
constexpr int ROPE_BOX = 2;            // a Q or K tile: nope boxes 0 and 1, the rope box
constexpr uint32_t QK_TILE = 3 * BOX_BYTES;
constexpr uint32_t V_TILE = 2 * BOX_BYTES;
constexpr int PREP_THREADS = 256;
constexpr int TILE_WARPS = PREP_THREADS / 32;   // the pre-pass's query tiles a block: a warp each
constexpr int DKDV_THREADS = 256;      // two consumer warpgroups, no producer warp
constexpr int DKDV_STAGES = 3;         // (Q, dO, rows) stages of exp_dkdv's ring
constexpr int DQ_THREADS = 256;        // two consumer warpgroups, no producer warp
constexpr int DQ_STAGES = 3;           // (K, V) stages of exp_dq's ring
constexpr int DQ_ROWS = 2 * BM;        // query rows of a dQ CTA: two tiles
constexpr int F_THREADS = 256;
constexpr int REDUCE_THREADS = 256;
constexpr int FQK = 192, FV = 128;     // float32: the widest q . k and v
constexpr int LDQK = FQK + 1, LDV = FV + 1, LDP = BN + 1;
constexpr int ALL = 0x7fffffff;

struct Bwd {
  const void *qn_p, *qr_p, *kn_p, *kr_p, *v_p, *o_p, *do_p;
  void *dqn_p, *dqr_p, *dkn_p, *dkr_p, *dv_p;
  // batch, sequence, head strides in elements (k_rope and its gradient: batch, position)
  long long qn[3], qr[3], kn[3], kr[2], v[3], o[3], dO[3], dqn[3], dqr[3], dkn[3], dkr[2], dv[3];
  const long long* q_pos;
  long long pos_s;
  const float* lse;   // (B, N, S) float32, natural-log units
  float* D;           // (B, N, S) float32
  int* tile_lim;      // (nqt,): the keys [0, tile_lim) that a query tile's rows see
  int* tile_min;      // (nqt,): its rows' smallest position
  float* part;        // (B, N, T, rope) float32: each head's share of dK_rope
  int B, S, N, T, nope, rope, dvw, nqt;  // dvw: v's width
  float scale;
};

struct Maps {
  CUtensorMap qn, qr, kn, kr, v, dO;
};

__device__ __forceinline__ int clamp_pos(long long p, int T) {
  return p < 0 ? -1 : (p >= T ? T - 1 : (int)p);
}

// the fixed part of a bf16 dK/dV CTA's shared memory: K and V, the ring's
// Q and dO tiles, its stages' P^T (64 x 64 float32, the hand-off from
// warpgroup 0 to warpgroup 1), its stages' 64 LSE (times log2 e), D and
// positions, 1 + 2 * STAGES mbarriers, the list's count and a pad; the list
// of query tiles (an int each) follows.  backward.py's dkdv_smem_bytes is
// the same.
constexpr uint32_t PT_BYTES = BN * BM * 4;
constexpr size_t DKDV_PT = (size_t)(1 + DKDV_STAGES) * (QK_TILE + V_TILE);
constexpr size_t DKDV_ROWS = DKDV_PT + (size_t)DKDV_STAGES * PT_BYTES;
constexpr size_t DKDV_BARS = DKDV_ROWS + 3 * DKDV_STAGES * BM * 4;
constexpr size_t DKDV_LIST = DKDV_BARS + 8 * (1 + 2 * DKDV_STAGES) + 8;
size_t dkdv_bf16_smem(int nqt) { return DKDV_LIST + 4 * (size_t)nqt; }
// a bf16 dQ CTA: each warpgroup's Q and dO, the ring's K and V tiles, 1 +
// STAGES mbarriers and a count a stage of the warpgroups done with it
constexpr size_t dq_bf16_smem() {
  return (size_t)(2 + DQ_STAGES) * (QK_TILE + V_TILE) + 8 * (1 + DQ_STAGES) + 4 * DQ_STAGES;
}
// float32: K, V, Q, dO, P and dS tiles, the rows' LSE, D and positions
constexpr size_t dkdv_f32_smem() {
  return 4 * (size_t)(2 * BN * LDQK + 2 * BN * LDV + 2 * BM * LDP + 3 * BM);
}
// float32: Q, dO, K and V tiles, dS, the rows' LSE, D and positions
constexpr size_t dq_f32_smem() {
  return 4 * (size_t)(2 * BM * LDQK + 2 * BM * LDV + BM * LDP + 3 * BM);
}

// 1. D = rowsum(dO * O) over the rows (b, h, s) of the (B, N, S) layout
// (float32 one warp a row; bf16 8 lanes a row, 16 bytes a load: the
// wrapper prepares o and dO as it prepares the TMA's inputs), then, in the
// blocks past the rows', one warp a query tile: its key limit and its rows'
// smallest position
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
    exp_bwd_prep(const Bwd d, long long rows, int dot_blocks) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if ((int)blockIdx.x >= dot_blocks) {
    const int qt = ((int)blockIdx.x - dot_blocks) * TILE_WARPS + warp;
    if (qt >= d.nqt) return;  // the whole warp
    int mx = 0, mn = ALL;
    for (int r = lane; r < BM; r += 32) {
      const int s = qt * BM + r;
      if (s < d.S) {
        const int qp = clamp_pos(d.q_pos[(long long)s * d.pos_s], d.T);
        mx = max(mx, qp < 0 ? d.T : qp + 1);
        mn = min(mn, qp);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    if (lane == 0) {
      d.tile_lim[qt] = mx;
      d.tile_min[qt] = mn;
    }
    return;
  }
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LANES = BF16 ? 8 : 32;
  const long long row = (long long)blockIdx.x * (PREP_THREADS / LANES) + threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  float acc = 0.f;
  if (row < rows) {
    const int s = (int)(row % d.S);
    const long long bh = row / d.S;
    const int h = (int)(bh % d.N), b = (int)(bh / d.N);
    const T* orow = static_cast<const T*>(d.o_p) + b * d.o[0] + s * d.o[1] + h * d.o[2];
    const T* drow = static_cast<const T*>(d.do_p) + b * d.dO[0] + s * d.dO[1] + h * d.dO[2];
    if constexpr (BF16) {
      for (int c = sub; c < d.dvw / 8; c += LANES) {
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
      for (int c = sub; c < d.dvw; c += LANES) acc = fmaf(drow[c], orow[c], acc);
    }
  }
  // every lane shuffles (a row past the end adds 0 and is not stored)
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) d.D[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA rings
// ---------------------------------------------------------------------------

// zero box 1 of a tile at byte `off` of shared memory (a box wholly past a
// width, never loaded), threads [0, n) 16 bytes each
__device__ __forceinline__ void zero_box(uint8_t* smem, uint32_t off, int n) {
  for (int i = threadIdx.x; i < (int)(BOX_BYTES / 16); i += n)
    reinterpret_cast<uint4*>(smem + off + BOX_BYTES)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// the nope boxes and the rope box of a 64-row Q or K tile at `dst`, and
// the boxes of a 64-row V or dO tile at `dst_v`, completing on `bar`.  One
// thread calls it; the rope map's head is always 0 for k_rope.
__device__ __forceinline__ void load_qk(uint32_t dst, const CUtensorMap* xn, const CUtensorMap* xr,
                                        int nb, int pos, int h, int rope_h, int b, uint32_t bar) {
  for (int c = 0; c < nb; ++c) tma_load(dst + c * BOX_BYTES, xn, c * BOX, pos, h, b, bar);
  tma_load(dst + ROPE_BOX * BOX_BYTES, xr, 0, pos, rope_h, b, bar);
}
__device__ __forceinline__ void load_v(uint32_t dst, const CUtensorMap* x, int vb, int pos, int h,
                                       int b, uint32_t bar) {
  for (int c = 0; c < vb; ++c) tma_load(dst + c * BOX_BYTES, x, c * BOX, pos, h, b, bar);
}

// named barriers (0 is __syncthreads): stage s's P^T buffer, BAR_PT + s,
// which warpgroup 0 arrives on once it has written it and warpgroup 1
// waits on before it reads it
constexpr int BAR_PT = 1;

// 2. dK_nope, dV and this head's share of dK_rope for one (batch, head, key tile)
__global__ void __launch_bounds__(DKDV_THREADS, 1)
    exp_dkdv_bf16(const __grid_constant__ Maps maps, const Bwd d) {
  constexpr int S = DKDV_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sK = smem_u32(smem_raw);
  if (sK & 1023u) __trap();
  const uint32_t sV = sK + QK_TILE;
  auto q_off = [](int s) { return (uint32_t)((1 + s) * (QK_TILE + V_TILE)); };
  auto q_at = [&](int s) { return sK + q_off(s); };
  auto do_at = [&](int s) { return sK + q_off(s) + QK_TILE; };
  // [S][8][128]: stage s's P^T * scale, float4 k of warpgroup thread w at [s][k][w]
  float4* pt_s = reinterpret_cast<float4*>(smem_raw + DKDV_PT);
  float* lse_s = reinterpret_cast<float*>(smem_raw + DKDV_ROWS);  // [S][BM], times log2 e
  float* D_s = lse_s + S * BM;                                      // [S][BM]
  int* pos_s = reinterpret_cast<int*>(D_s + S * BM);                // [S][BM], clamped
  const uint32_t bar = sK + (uint32_t)DKDV_BARS;                    // kv_full, full[S], empty[S]
  auto full = [&](int s) { return bar + 8u * (1 + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + S + s); };
  int* count = reinterpret_cast<int*>(smem_raw + DKDV_LIST - 8);
  int* list = reinterpret_cast<int*>(smem_raw + DKDV_LIST);

  // one dimension, the (batch, head) outermost (as the forward's), heavy
  // (early) key tiles first
  const int per = (d.T + BN - 1) / BN;
  const int bh = blockIdx.x / per;
  const int b = bh / d.N, h = bh % d.N;
  const int k0 = (int)(blockIdx.x % per) * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warpgroup as a value ptxas knows is the same across a warp
  const int j = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3, wt = tid & 127;
  const int nb = (d.nope + BOX - 1) / BOX, vb = (d.dvw + BOX - 1) / BOX;

  if (tid == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);            // the loading warp's lanes, one with the TMA's bytes
      mbar_init(empty(s), DKDV_THREADS);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (nb < 2) {
    zero_box(smem_raw, 0, DKDV_THREADS);
    for (int s = 0; s < S; ++s) zero_box(smem_raw, q_off(s), DKDV_THREADS);
  }
  if (vb < 2) {
    zero_box(smem_raw, QK_TILE, DKDV_THREADS);
    for (int s = 0; s < S; ++s) zero_box(smem_raw, q_off(s) + QK_TILE, DKDV_THREADS);
  }
  // the query tiles whose rows see a key of this tile (or hold a fully
  // masked row, whose P is 1 / T on every key), in order
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < d.nqt; base += 32) {
      const int qt = base + lane;
      const bool take = qt < d.nqt && d.tile_lim[qt] > k0;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) list[n + __popc(m & ((1u << lane) - 1u))] = qt;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, for wgmma
  __syncthreads();
  const int n = __shfl_sync(0xffffffffu, *count, 0);

  // stage i's rows and tiles, by the whole first warp of warpgroup 1 (its
  // lanes write the rows and arrive; lane 0 arrives with the TMA's bytes)
  const long long row0 = ((long long)b * d.N + h) * d.S;
  auto load = [&](int i) {
    const int s = i % S, q0 = list[i] * BM;
    for (int r = lane; r < BM; r += 32) {
      const int q = q0 + r;
      const bool in = q < d.S;  // rows past S: P = 0 (LSE +inf) and D = 0
      lse_s[s * BM + r] = in ? d.lse[row0 + q] * LOG2E : INFINITY;
      D_s[s * BM + r] = in ? d.D[row0 + q] : 0.f;
      pos_s[s * BM + r] = in ? clamp_pos(d.q_pos[(long long)q * d.pos_s], d.T) : d.T - 1;
    }
    if (lane == 0) {
      mbar_expect_tx(full(s), (nb + 1 + vb) * BOX_BYTES);
      load_qk(q_at(s), &maps.qn, &maps.qr, nb, q0, h, h, b, full(s));
      load_v(do_at(s), &maps.dO, vb, q0, h, b, full(s));
    } else {
      mbar_arrive(full(s));
    }
  };
  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(bar, (nb + 1 + vb) * BOX_BYTES);
      load_qk(sK, &maps.kn, &maps.kr, nb, k0, h, 0, b, bar);
      load_v(sV, &maps.v, vb, k0, h, b, bar);
    }
    for (int i = 0; i < S && i < n; ++i) load(i);
  }

  // ---- both warpgroups: 64 keys, 16 a warp ----
  const int kr = k0 + 16 * wl + g;  // this thread's keys: kr, kr + 8
  const float mul = d.scale * LOG2E;
  const float inv_T = 1.f / (float)d.T;
  // warpgroup 0: accA is dV; warpgroup 1: accA is dK_nope, accB dK_rope
  float accA[64], accB[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) accA[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) accB[i] = 0.f;
  // element 4q + e of a 64 x 64 tile: key kr + 8 (e >> 1), query
  // q0 + 8q + 2 t4 + (e & 1)
  float st[32];        // warpgroup 0: S^T, then P^T; warpgroup 1: dP^T, then dS^T
  uint32_t xa[4][4];   // st in bf16: the A operand of the product that closes its tile

  // warpgroup 0: P^T of stage s in place on st, and P^T * scale (0 where
  // masked) into the stage's buffer for warpgroup 1
  auto p_pass = [&](int s, auto masked) {
    const float* lse2 = lse_s + s * BM;
    const int* qpos = pos_s + s * BM;
    float4* buf = pt_s + s * (8 * 128);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * q + 2 * t4);
      const int2 qp = *reinterpret_cast<const int2*>(qpos + 8 * q + 2 * t4);
      float sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(st[4 * q + e] * mul - ((e & 1) ? l.y : l.x));
        float f = d.scale;
        if constexpr (decltype(masked)::value) {
          const int at = (e & 1) ? qp.y : qp.x;
          if (kr + 8 * (e >> 1) > at) {
            pe = at < 0 ? inv_T : 0.f;
            f = 0.f;
          }
        }
        sv[e] = pe * f;
        st[4 * q + e] = pe;
      }
      buf[q * 128 + wt] = make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
  };
  // warpgroup 0's pass over tile i (stage s), the mask only on tiles past T
  // or past some row's position; then P^T's buffer is handed over
  auto p_tile = [&](int i, int s) {
    if (k0 + BN > d.T || d.tile_min[list[i]] < k0 + BN - 1) p_pass(s, std::true_type{});
    else p_pass(s, std::false_type{});
    bar_arrive(BAR_PT + s, 2 * 128);
  };
  // warpgroup 1: dS^T = P^T * scale * (dP^T - D) of stage s in place on
  // st, P^T from the stage's buffer (written by the thread of warpgroup 0
  // that holds the same elements) once warpgroup 0 has handed it over
  auto ds_tile = [&](int s) {
    bar_sync(BAR_PT + s, 2 * 128);
    const float* D = D_s + s * BM;
    const float4* buf = pt_s + s * (8 * 128);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 dd = *reinterpret_cast<const float2*>(D + 8 * q + 2 * t4);
      const float4 pv = buf[q * 128 + wt];
      st[4 * q] = pv.x * (st[4 * q] - dd.x);
      st[4 * q + 1] = pv.y * (st[4 * q + 1] - dd.y);
      st[4 * q + 2] = pv.z * (st[4 * q + 2] - dd.x);
      st[4 * q + 3] = pv.w * (st[4 * q + 3] - dd.y);
    }
  };
  // the products, each committed as one group: S^T = K Q^T (12 k-steps),
  // dP^T = V dO^T (8), and from xa dV += P^T dO and dK_nope += dS^T Q_nope,
  // dK_rope += dS^T Q_rope (dO and Q MN-major, their boxes LBO apart)
  auto issue_s = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < 12; ++kc)
      wgmma_ss<64>(st, desc_kmajor<192, BN>(sK, kc), desc_kmajor<192, BM>(q_at(s), kc), kc > 0);
    wgmma_commit();
  };
  auto issue_dp = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
      wgmma_ss<64>(st, desc_kmajor<128, BN>(sV, kc), desc_kmajor<128, BM>(do_at(s), kc), kc > 0);
    wgmma_commit();
  };
  auto issue_dv = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc)
      wgmma_rs<128>(accA, xa[kc], desc_mnmajor<128, BM>(do_at(s), kc));
    wgmma_commit();
  };
  auto issue_dk = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      wgmma_rs<128>(accA, xa[kc], desc_mnmajor<128, BM>(q_at(s), kc));
      wgmma_rs<64>(accB, xa[kc], desc_mnmajor<64, BM>(q_at(s) + ROPE_BOX * BOX_BYTES, kc));
    }
    wgmma_commit();
  };
  // this thread is done with tile i's stage (warpgroup 1 also with its
  // P^T); the first warp of warpgroup 1 refills it once both are
  auto release = [&](int i) {
    const int s = i % S;
    mbar_arrive(empty(s));
    if (warp == 4 && i + S < n) {
      mbar_wait(empty(s), (i / S) & 1);
      load(i + S);
    }
  };

  // Each warpgroup's products are issued and retired inside its own branch
  // (a product in flight across such a branch made ptxas serialize them
  // all); each one's pass runs under the other's products.
  mbar_wait(bar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    mbar_wait(full(s), (i / S) & 1);
    if (j == 0) {
      // ---- warpgroup 0: S^T and P^T, then dV ----
      wgmma_fence();
      issue_s(s);
      wgmma_wait<0>();
      fence_regs(st);
      p_tile(i, s);
      pack_a<8>(xa, st);
      wgmma_fence();
      issue_dv(s);
      wgmma_wait<0>();
      fence_regs(accA);
    } else {
      // ---- warpgroup 1: dP^T and dS^T, then dK ----
      wgmma_fence();
      issue_dp(s);
      wgmma_wait<0>();
      fence_regs(st);
      ds_tile(s);
      pack_a<8>(xa, st);
      wgmma_fence();
      issue_dk(s);
      wgmma_wait<0>();
      fence_regs(accA);
      fence_regs(accB);
    }
    fence_regs(xa);
    release(i);
  }

  // epilogue: the keys below T, through the gradients' strides
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    if (key >= d.T) continue;
    if (j == 0) {
      __nv_bfloat16* row = static_cast<__nv_bfloat16*>(d.dv_p) + b * d.dv[0] + key * d.dv[1] +
                           h * d.dv[2];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = 8 * c + 2 * t4;
        if (col < d.dvw)
          *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(accA[4 * c + 2 * r], accA[4 * c + 2 * r + 1]);
      }
    } else {
      __nv_bfloat16* row = static_cast<__nv_bfloat16*>(d.dkn_p) + b * d.dkn[0] +
                           key * d.dkn[1] + h * d.dkn[2];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = 8 * c + 2 * t4;
        if (col < d.nope)
          *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(accA[4 * c + 2 * r], accA[4 * c + 2 * r + 1]);
      }
      float* prow = d.part + (((long long)b * d.N + h) * d.T + key) * d.rope;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * t4;
        if (col < d.rope)
          *reinterpret_cast<float2*>(prow + col) = make_float2(accB[4 * c + 2 * r], accB[4 * c + 2 * r + 1]);
      }
    }
  }
}

// named barriers of exp_dq (0 is __syncthreads): warpgroup 0's and 1's own
constexpr int BAR_DQ = 1;

// 3. dQ_nope and dQ_rope of two query tiles (128 rows) of one (batch, head)
__global__ void __launch_bounds__(DQ_THREADS, 1)
    exp_dq_bf16(const __grid_constant__ Maps maps, const Bwd d) {
  constexpr int S = DQ_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();
  // warpgroup w's Q and dO, then the ring's K and V stages
  auto q_at = [&](int w) { return base + w * (QK_TILE + V_TILE); };
  auto do_at = [&](int w) { return q_at(w) + QK_TILE; };
  auto k_off = [](int s) { return (uint32_t)((2 + s) * (QK_TILE + V_TILE)); };
  auto k_at = [&](int s) { return base + k_off(s); };
  auto v_at = [&](int s) { return base + k_off(s) + QK_TILE; };
  const uint32_t bar = base + (2 + S) * (QK_TILE + V_TILE);  // qdo_full, full[S]
  auto full = [&](int s) { return bar + 8u * (1 + s); };
  // [S]: the warpgroups done with each stage, counted up for good (odd: one of the two)
  int* done = reinterpret_cast<int*>(smem_raw + (2 + S) * (QK_TILE + V_TILE) + 8 * (1 + S));

  // one dimension, the (batch, head) outermost (as the forward's)
  const int per = (d.nqt + 1) / 2;
  const int bh = blockIdx.x / per;
  const int b = bh / d.N, h = bh % d.N;
  const int qt0 = 2 * (per - 1 - (int)(blockIdx.x % per));  // heavy (late) tiles first
  const bool two = qt0 + 1 < d.nqt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warpgroup as a value ptxas knows is the same across a warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // both warpgroups walk the keys either tile's rows see
  const int limit = two ? max(d.tile_lim[qt0], d.tile_lim[qt0 + 1]) : d.tile_lim[qt0];
  const int tiles = (limit + BN - 1) / BN;
  const int nb = (d.nope + BOX - 1) / BOX, vb = (d.dvw + BOX - 1) / BOX;

  // stage i's K and V tiles, by one thread
  auto load = [&](int i) {
    const int s = i % S;
    mbar_expect_tx(full(s), (nb + 1 + vb) * BOX_BYTES);
    load_qk(k_at(s), &maps.kn, &maps.kr, nb, i * BN, h, 0, b, full(s));
    load_v(v_at(s), &maps.v, vb, i * BN, h, b, full(s));
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = 0; w < 2; ++w) {
    if (nb < 2) zero_box(smem_raw, w * (QK_TILE + V_TILE), DQ_THREADS);
    if (vb < 2) zero_box(smem_raw, w * (QK_TILE + V_TILE) + QK_TILE, DQ_THREADS);
  }
  for (int s = 0; s < S; ++s) {
    if (nb < 2) zero_box(smem_raw, k_off(s), DQ_THREADS);
    if (vb < 2) zero_box(smem_raw, k_off(s) + QK_TILE, DQ_THREADS);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.kn)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.v)) : "memory");
    // warpgroup 1's rows, or, when the last tile is warpgroup 0's, its rows
    // again (warpgroup 1's rows are then past S: P = 0, nothing stored)
    const int q1 = (two ? qt0 + 1 : qt0) * BM;
    mbar_expect_tx(bar, 2 * (nb + 1 + vb) * BOX_BYTES);
    for (int w = 0; w < 2; ++w) {
      load_qk(q_at(w), &maps.qn, &maps.qr, nb, w ? q1 : qt0 * BM, h, h, b, bar);
      load_v(do_at(w), &maps.dO, vb, w ? q1 : qt0 * BM, h, b, bar);
    }
    for (int i = 0; i < S && i < tiles; ++i) load(i);
  }

  // ---- both warpgroups: 64 query rows each, 16 a warp ----
  const int qt = qt0 + wg;            // warpgroup 1's is past the last tile when !two
  const int min_pos = __shfl_sync(0xffffffffu, qt < d.nqt ? d.tile_min[qt] : ALL, 0);
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = qt * BM + 16 * (warp & 3) + g;  // this thread's rows: r0, r0 + 8
  const bool leader = (tid & 127) == 0;
  const uint32_t sQ = q_at(wg), sdO = do_at(wg);
  const float mul = d.scale * LOG2E;
  float lse2[2], Dr[2];
  int rpos[2];  // rows past S: P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long long at = ((long long)b * d.N + h) * d.S + row;
    lse2[r] = row < d.S ? d.lse[at] * LOG2E : INFINITY;
    Dr[r] = row < d.S ? d.D[at] : 0.f;
    rpos[r] = row < d.S ? clamp_pos(d.q_pos[(long long)row * d.pos_s], d.T) : d.T - 1;
  }

  float dqn[64], dqr[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqn[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dqr[i] = 0.f;
  // element 4q + e of a 64 x 64 tile: row r0 + 8 (e >> 1), key
  // k0 + 8q + 2 t4 + (e & 1)
  float sc[32];        // S, then P times the scale (0 where masked)
  float dp[32];        // dP, then dS
  uint32_t sa[4][4];   // dS in bf16: dQ's A operands (depth: 64 keys)

  auto p_pass = [&](int k0, auto masked) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(sc[4 * q + e] * mul - lse2[e >> 1]);
        if constexpr (decltype(masked)::value) {
          const int key = k0 + 8 * q + 2 * t4 + (e & 1);
          if (key >= d.T || key > rpos[e >> 1]) pe = 0.f;
        }
        sc[4 * q + e] = pe * d.scale;
      }
  };
  // S = Q K^T (12 k-steps) and dP = dO V^T (8) of stage s, each a group
  auto issue_s_dp = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < 12; ++kc)
      wgmma_ss<64>(sc, desc_kmajor<192, BM>(sQ, kc), desc_kmajor<192, BN>(k_at(s), kc), kc > 0);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
      wgmma_ss<64>(dp, desc_kmajor<128, BM>(sdO, kc), desc_kmajor<128, BN>(v_at(s), kc), kc > 0);
    wgmma_commit();
  };
  // dQ_nope += dS K_nope and dQ_rope += dS K_rope of stage s, K MN-major
  auto issue_dq = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      wgmma_rs<128>(dqn, sa[kc], desc_mnmajor<128, BN>(k_at(s), kc));
      wgmma_rs<64>(dqr, sa[kc], desc_mnmajor<64, BN>(k_at(s) + ROPE_BOX * BOX_BYTES, kc));
    }
    wgmma_commit();
  };
  // P once S is done (the mask only on tiles past T or past some row's
  // position of this warpgroup), then dS in place on dp once dP is done
  auto p_ds = [&](int k0, auto wait_dp) {
    fence_regs(sc);
    if (k0 + BN > d.T || k0 + BN - 1 > min_pos) p_pass(k0, std::true_type{});
    else p_pass(k0, std::false_type{});
    wait_dp();
    fence_regs(dp);
#pragma unroll
    for (int q = 0; q < 32; ++q) dp[q] = sc[q] * (dp[q] - Dr[(q >> 1) & 1]);
  };
  // this warpgroup is done with tile i's stage (its named barrier: every
  // warp's products have read it); the second of the two to finish refills it
  auto release = [&](int i) {
    if (i + S < tiles) {
      bar_sync(BAR_DQ + wg, 128);
      if (leader && (atomicAdd(&done[i % S], 1) & 1)) load(i + S);
    }
  };

  mbar_wait(bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int s = i % S;
    mbar_wait(full(s), (i / S) & 1);
    wgmma_fence();
    issue_s_dp(s);
    wgmma_wait<1>();  // S done; dP runs on
    p_ds(i * BN, [] { wgmma_wait<0>(); });
    pack_a<8>(sa, dp);
    wgmma_fence();
    issue_dq(s);
    wgmma_wait<0>();
    fence_regs(dqn);
    fence_regs(dqr);
    fence_regs(sa);
    release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= d.S) continue;
    __nv_bfloat16* nrow = static_cast<__nv_bfloat16*>(d.dqn_p) + b * d.dqn[0] + row * d.dqn[1] +
                          h * d.dqn[2];
    __nv_bfloat16* rrow = static_cast<__nv_bfloat16*>(d.dqr_p) + b * d.dqr[0] + row * d.dqr[1] +
                          h * d.dqr[2];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 8 * c + 2 * t4;
      if (col < d.nope)
        *reinterpret_cast<uint32_t*>(nrow + col) = pack_bf16(dqn[4 * c + 2 * r], dqn[4 * c + 2 * r + 1]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (col < d.rope)
        *reinterpret_cast<uint32_t*>(rrow + col) = pack_bf16(dqr[4 * c + 2 * r], dqr[4 * c + 2 * r + 1]);
    }
  }
}

// 4. dK_rope[b, t] = the heads' shares summed in head order, a thread an element
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS) exp_rope_reduce(const Bwd d) {
  const long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= (long long)d.B * d.T * d.rope) return;
  const int c = (int)(i % d.rope);
  const long long bt = i / d.rope;
  const int t = (int)(bt % d.T), b = (int)(bt / d.T);
  const float* src = d.part + ((long long)b * d.N * d.T + t) * d.rope + c;
  const long long step = (long long)d.T * d.rope;
  float sum = 0.f;
#pragma unroll 8
  for (int n = 0; n < d.N; ++n) sum += src[n * step];
  T* out = static_cast<T*>(d.dkr_p) + b * d.dkr[0] + t * d.dkr[1] + c;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) *out = __float2bfloat16(sum);
  else *out = sum;
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

// rows [r0, r0 + BM) of [x_nope | x_rope] of (b, h) into dst[r * LDQK + c],
// zeros past `rows` and past nope + rope; the rope part of a key tile has no
// head (xr_s[2] = 0)
__device__ __forceinline__ void f32_qk(float* dst, const float* xn, const float* xr,
                                       const long long* xn_s, const long long* xr_s, int b, int h,
                                       int r0, int rows, int nope, int rope) {
  for (int idx = threadIdx.x; idx < BM * FQK; idx += F_THREADS) {
    const int r = idx / FQK, c = idx % FQK;
    float x = 0.f;
    if (r0 + r < rows && c < nope + rope) {
      const long long pos = r0 + r;
      x = c < nope ? xn[b * xn_s[0] + pos * xn_s[1] + h * xn_s[2] + c]
                   : xr[b * xr_s[0] + pos * xr_s[1] + h * xr_s[2] + c - nope];
    }
    dst[r * LDQK + c] = x;
  }
}

// rows [r0, r0 + BM) x dv of a (B, ·, N, dv) tensor into dst[r * LDV + c]
__device__ __forceinline__ void f32_v(float* dst, const float* x, const long long* s, int b, int h,
                                      int r0, int rows, int dv) {
  for (int idx = threadIdx.x; idx < BM * FV; idx += F_THREADS) {
    const int r = idx / FV, c = idx % FV;
    dst[r * LDV + c] = (r0 + r < rows && c < dv)
                           ? x[b * s[0] + (long long)(r0 + r) * s[1] + h * s[2] + c]
                           : 0.f;
  }
}

// the rows' LSE, D and clamped positions of query tile q0 into shared
// memory (+inf, 0 and T - 1 past S)
__device__ __forceinline__ void f32_rows(const Bwd& d, float* lse_s, float* D_s, int* pos_s,
                                         long long row0, int q0) {
  for (int r = threadIdx.x; r < BM; r += F_THREADS) {
    const int q = q0 + r;
    const bool in = q < d.S;
    lse_s[r] = in ? d.lse[row0 + q] : INFINITY;
    D_s[r] = in ? d.D[row0 + q] : 0.f;
    pos_s[r] = in ? clamp_pos(d.q_pos[(long long)q * d.pos_s], d.T) : d.T - 1;
  }
}

// The scores and dP of this thread's 4 x 4 block (query rows tr + 16a of Qs
// and dOs, keys tc + 16c of Ks and Vs, key 0 of the tile at k0) turned
// into p[a][c] and ds[a][c] (ds carries the scale; 0 where masked; p is 1 / T
// on a masked key of a fully masked row)
__device__ __forceinline__ void f32_p_ds(const Bwd& d, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* lse_s,
                                         const float* D_s, const int* pos_s, int k0, int tr,
                                         int tc, float (&p)[4][4], float (&ds)[4][4]) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < d.nope + d.rope; ++dd) {
    float qv[4], kv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qv[a] = Qs[(tr + 16 * a) * LDQK + dd];
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = Ks[(tc + 16 * c) * LDQK + dd];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
  }
#pragma unroll 4
  for (int dd = 0; dd < d.dvw; ++dd) {
    float ov[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ov[a] = dOs[(tr + 16 * a) * LDV + dd];
#pragma unroll
    for (int c = 0; c < 4; ++c) vv[c] = Vs[(tc + 16 * c) * LDV + dd];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[a][c] = fmaf(ov[a], vv[c], dp[a][c]);
  }
  const float inv_T = 1.f / (float)d.T;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = tr + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + tc + 16 * c;
      const bool vis = key < d.T && key <= pos_s[i];
      const float pe = vis ? expf(s[a][c] * d.scale - lse_s[i])
                           : (key < d.T && pos_s[i] < 0 ? inv_T : 0.f);
      p[a][c] = pe;
      ds[a][c] = vis ? pe * (dp[a][c] - D_s[i]) * d.scale : 0.f;
    }
  }
}

// 2. dK_nope, dV and this head's share of dK_rope for one (batch, head, key tile)
__global__ void __launch_bounds__(F_THREADS, 1) exp_dkdv_f32(const Bwd d) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Qs = Ks + BN * LDQK;
  float* Vs = Qs + BM * LDQK;
  float* dOs = Vs + BN * LDV;
  float* Ps = dOs + BM * LDV;
  float* dSs = Ps + BM * LDP;
  float* lse_s = dSs + BM * LDP;
  float* D_s = lse_s + BM;
  int* pos_s = reinterpret_cast<int*>(D_s + BM);

  const int b = blockIdx.x / d.N, h = blockIdx.x % d.N;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int dqk = d.nope + d.rope;
  const long long kr_s[3] = {d.kr[0], d.kr[1], 0};
  f32_qk(Ks, static_cast<const float*>(d.kn_p), static_cast<const float*>(d.kr_p), d.kn, kr_s, b,
         h, k0, d.T, d.nope, d.rope);
  f32_v(Vs, static_cast<const float*>(d.v_p), d.v, b, h, k0, d.T, d.dvw);

  float dK[4][12], dV[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 12; ++c) dK[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) dV[a][c] = 0.f;
  }
  const long long row0 = ((long long)b * d.N + h) * d.S;
  for (int qt = 0; qt < d.nqt; ++qt) {
    if (d.tile_lim[qt] <= k0) continue;  // no row of the tile sees a key of this one
    const int q0 = qt * BM;
    __syncthreads();  // the last tile's readers of Qs, dOs, Ps, dSs are done
    f32_qk(Qs, static_cast<const float*>(d.qn_p), static_cast<const float*>(d.qr_p), d.qn, d.qr,
           b, h, q0, d.S, d.nope, d.rope);
    f32_v(dOs, static_cast<const float*>(d.do_p), d.dO, b, h, q0, d.S, d.dvw);
    f32_rows(d, lse_s, D_s, pos_s, row0, q0);
    __syncthreads();
    float p[4][4], ds[4][4];
    f32_p_ds(d, Qs, dOs, Ks, Vs, lse_s, D_s, pos_s, k0, tr, tc, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(tr + 16 * a) * LDP + tc + 16 * c] = p[a][c];
        dSs[(tr + 16 * a) * LDP + tc + 16 * c] = ds[a][c];
      }
    __syncthreads();
    // dV[k] += sum_i P[i][k] dO[i];  dK[k] += sum_i dS[i][k] Q[i]
    // (this thread: keys tr + 16a, columns tc + 16c)
#pragma unroll 2
    for (int i = 0; i < BM; ++i) {
      float pk[4], sk[4], ov[8], qv[12];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pk[a] = Ps[i * LDP + tr + 16 * a];
        sk[a] = dSs[i * LDP + tr + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) ov[c] = dOs[i * LDV + tc + 16 * c];
#pragma unroll
      for (int c = 0; c < 12; ++c) qv[c] = Qs[i * LDQK + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) dV[a][c] = fmaf(pk[a], ov[c], dV[a][c]);
#pragma unroll
        for (int c = 0; c < 12; ++c) dK[a][c] = fmaf(sk[a], qv[c], dK[a][c]);
      }
    }
  }

  float* dvb = static_cast<float*>(d.dv_p) + b * d.dv[0] + h * d.dv[2];
  float* dkb = static_cast<float*>(d.dkn_p) + b * d.dkn[0] + h * d.dkn[2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + tr + 16 * a;
    if (key >= d.T) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (tc + 16 * c < d.dvw) dvb[(long long)key * d.dv[1] + tc + 16 * c] = dV[a][c];
    float* prow = d.part + (((long long)b * d.N + h) * d.T + key) * d.rope;
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const int col = tc + 16 * c;
      if (col < d.nope) dkb[(long long)key * d.dkn[1] + col] = dK[a][c];
      else if (col < dqk) prow[col - d.nope] = dK[a][c];
    }
  }
}

// 3. dQ_nope and dQ_rope of one (batch, head, query tile)
__global__ void __launch_bounds__(F_THREADS, 1) exp_dq_f32(const Bwd d) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LDQK;
  float* dOs = Ks + BN * LDQK;
  float* Vs = dOs + BM * LDV;
  float* dSs = Vs + BN * LDV;
  float* lse_s = dSs + BM * LDP;
  float* D_s = lse_s + BM;
  int* pos_s = reinterpret_cast<int*>(D_s + BM);

  const int b = blockIdx.x / d.N, h = blockIdx.x % d.N;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy (late) tiles first
  const int q0 = qt * BM;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int dqk = d.nope + d.rope;
  const long long kr_s[3] = {d.kr[0], d.kr[1], 0};
  f32_qk(Qs, static_cast<const float*>(d.qn_p), static_cast<const float*>(d.qr_p), d.qn, d.qr, b,
         h, q0, d.S, d.nope, d.rope);
  f32_v(dOs, static_cast<const float*>(d.do_p), d.dO, b, h, q0, d.S, d.dvw);
  f32_rows(d, lse_s, D_s, pos_s, ((long long)b * d.N + h) * d.S, q0);

  float dQ[4][12];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 12; ++c) dQ[a][c] = 0.f;

  const int limit = d.tile_lim[qt];
  for (int k0 = 0; k0 < limit; k0 += BN) {
    __syncthreads();  // Q staged; the last tile's readers of Ks, Vs, dSs are done
    f32_qk(Ks, static_cast<const float*>(d.kn_p), static_cast<const float*>(d.kr_p), d.kn, kr_s, b,
           h, k0, d.T, d.nope, d.rope);
    f32_v(Vs, static_cast<const float*>(d.v_p), d.v, b, h, k0, d.T, d.dvw);
    __syncthreads();
    float p[4][4], ds[4][4];
    f32_p_ds(d, Qs, dOs, Ks, Vs, lse_s, D_s, pos_s, k0, tr, tc, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dSs[(tr + 16 * a) * LDP + tc + 16 * c] = ds[a][c];
    __syncthreads();
    // dQ[i] += sum_k dS[i][k] K[k]  (this thread: rows tr + 16a, columns tc + 16c)
#pragma unroll 2
    for (int kk = 0; kk < BN; ++kk) {
      float sk[4], kv[12];
#pragma unroll
      for (int a = 0; a < 4; ++a) sk[a] = dSs[(tr + 16 * a) * LDP + kk];
#pragma unroll
      for (int c = 0; c < 12; ++c) kv[c] = Ks[kk * LDQK + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 12; ++c) dQ[a][c] = fmaf(sk[a], kv[c], dQ[a][c]);
    }
  }

  float* nb = static_cast<float*>(d.dqn_p) + b * d.dqn[0] + h * d.dqn[2];
  float* rb = static_cast<float*>(d.dqr_p) + b * d.dqr[0] + h * d.dqr[2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + tr + 16 * a;
    if (row >= d.S) continue;
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const int col = tc + 16 * c;
      if (col < d.nope) nb[(long long)row * d.dqn[1] + col] = dQ[a][c];
      else if (col < dqk) rb[(long long)row * d.dqr[1] + col - d.nope] = dQ[a][c];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the 4-d map (width, seq, heads, batch) of a bf16 tensor read through its
// strides, boxes of 64 columns by 64 rows, 128-byte swizzle (columns past
// the width inside a box and rows past seq zero-filled)
int make_map_w(CUtensorMap* map, const void* ptr, int width, int seq, int heads, int batch,
               long long st_b, long long st_s, long long st_h) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st_s * 2, (cuuint64_t)st_h * 2, (cuuint64_t)st_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <typename T>
cudaError_t launch_tail(const Bwd& d, cudaStream_t st) {
  const long long total = (long long)d.B * d.T * d.rope;
  exp_rope_reduce<T><<<(unsigned)((total + REDUCE_THREADS - 1) / REDUCE_THREADS), REDUCE_THREADS,
                       0, st>>>(d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prep(const Bwd& d, cudaStream_t st) {
  constexpr int per = std::is_same<T, float>::value ? PREP_THREADS / 32 : PREP_THREADS / 8;
  const long long rows = (long long)d.B * d.N * d.S;
  const int dot_blocks = (int)((rows + per - 1) / per);
  const int tile_blocks = (d.nqt + TILE_WARPS - 1) / TILE_WARPS;
  exp_bwd_prep<T><<<dot_blocks + tile_blocks, PREP_THREADS, 0, st>>>(d, rows, dot_blocks);
  return cudaGetLastError();
}

}  // namespace

// Allow the main kernels the card's largest dynamic shared memory;
// backward.py calls it once per device before the first launch.
extern "C" int expanded_attention_bwd_init(void) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exp_dkdv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exp_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exp_dkdv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exp_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return (int)err;
}

// The five gradients.  q_nope, q_rope, o, dO, dq_nope, dq_rope (B, S, N, ·);
// k_nope, v, dk_nope, dv (B, T, N, ·); k_rope, dk_rope (B, T, rope); each
// read or written through its strides (`strides`, elements: q_nope 3,
// q_rope 3, k_nope 3, k_rope 2, v 3, o 3, dO 3, dq_nope 3, dq_rope 3,
// dk_nope 3, dk_rope 2, dv 3; batch, sequence, head), last dimension
// contiguous; bf16 base pointers and strides 16-byte aligned (the tensor
// maps, and o's and dO's rows for the pre-pass).  lse is the forward's (B,
// N, S) float32; D (B, N, S) float32, tiles (2 * ceil(S / 64)) int32 and
// part (B, N, T, rope) float32 are workspace.  `dkdv_smem` and `dq_smem`
// are backward.py's formulas.  Launches the four kernels on `stream` and
// returns the first non-zero cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for shapes it cannot run, or 9000 / 9001 when a
// tensor map cannot be built (before any launch).
extern "C" int expanded_attention_bwd(
    const void* q_nope, const void* q_rope, const void* k_nope, const void* k_rope, const void* v,
    const void* o, const void* dO, const float* lse, const long long* q_pos, float* D, int* tiles,
    float* part, void* dq_nope, void* dq_rope, void* dk_nope, void* dk_rope, void* dv,
    const long long* strides, long long pos_s, int is_bf16, int B, int S, int N, int T, int nope,
    int rope, int dv_w, int dkdv_smem, int dq_smem, float scale, void* stream) {
  const int nqt = (S + BM - 1) / BM;
  if (B < 1 || S < 1 || N < 1 || T < 1 || nope < 16 || nope > 128 || nope % 16 || rope < 16 ||
      rope > 64 || rope % 16 || dv_w < 16 || dv_w > 128 || dv_w % 16 ||
      (long long)B * N > 0x7fffffffLL || nqt > 65535 || (T + BN - 1) / BN > 65535 ||
      dkdv_smem != (int)(is_bf16 ? dkdv_bf16_smem(nqt) : dkdv_f32_smem()) ||
      dq_smem != (int)(is_bf16 ? dq_bf16_smem() : dq_f32_smem()))
    return (int)cudaErrorInvalidValue;
  Bwd d;
  d.qn_p = q_nope; d.qr_p = q_rope; d.kn_p = k_nope; d.kr_p = k_rope; d.v_p = v; d.o_p = o;
  d.do_p = dO; d.dqn_p = dq_nope; d.dqr_p = dq_rope; d.dkn_p = dk_nope; d.dkr_p = dk_rope;
  d.dv_p = dv;
  long long* three[] = {d.qn, d.qr, d.kn, nullptr, d.v, d.o, d.dO, d.dqn, d.dqr, d.dkn, nullptr, d.dv};
  int at = 0;
  for (int t = 0; t < 12; ++t) {
    long long* dst = three[t] ? three[t] : (t == 3 ? d.kr : d.dkr);
    const int n = three[t] ? 3 : 2;
    for (int i = 0; i < n; ++i) dst[i] = strides[at + i];
    at += n;
  }
  d.q_pos = q_pos;
  d.pos_s = pos_s;
  d.lse = lse;
  d.D = D;
  d.tile_lim = tiles;
  d.tile_min = tiles + nqt;
  d.part = part;
  d.B = B; d.S = S; d.N = N; d.T = T; d.nope = nope; d.rope = rope; d.dvw = dv_w; d.nqt = nqt;
  d.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // float32: two dimensions, a dQ CTA a query tile; bf16: one dimension,
  // (batch, head) outermost, a dQ CTA two query tiles
  const dim3 kv_grid(B * N, (T + BN - 1) / BN), q_grid(B * N, nqt);
  const long long kv_ctas = (long long)B * N * ((T + BN - 1) / BN),
                  dq_ctas = (long long)B * N * ((nqt + 1) / 2);
  cudaError_t err;
  if (!is_bf16) {
    err = launch_prep<float>(d, st);
    if (err != cudaSuccess) return (int)err;
    exp_dkdv_f32<<<kv_grid, F_THREADS, dkdv_smem, st>>>(d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    exp_dq_f32<<<q_grid, F_THREADS, dq_smem, st>>>(d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return (int)launch_tail<float>(d, st);
  }
  if (kv_ctas > 0x7fffffffLL || dq_ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Maps maps = {};
  int merr = make_map_w(&maps.qn, q_nope, nope, S, N, B, d.qn[0], d.qn[1], d.qn[2]);
  if (!merr) merr = make_map_w(&maps.qr, q_rope, rope, S, N, B, d.qr[0], d.qr[1], d.qr[2]);
  if (!merr) merr = make_map_w(&maps.kn, k_nope, nope, T, N, B, d.kn[0], d.kn[1], d.kn[2]);
  if (!merr) merr = make_map_w(&maps.kr, k_rope, rope, T, 1, B, d.kr[0], d.kr[1], rope);
  if (!merr) merr = make_map_w(&maps.v, v, dv_w, T, N, B, d.v[0], d.v[1], d.v[2]);
  if (!merr) merr = make_map_w(&maps.dO, dO, dv_w, S, N, B, d.dO[0], d.dO[1], d.dO[2]);
  if (merr) return merr;
  err = launch_prep<__nv_bfloat16>(d, st);
  if (err != cudaSuccess) return (int)err;
  exp_dkdv_bf16<<<(unsigned)kv_ctas, DKDV_THREADS, dkdv_smem, st>>>(maps, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  exp_dq_bf16<<<(unsigned)dq_ctas, DQ_THREADS, dq_smem, st>>>(maps, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_tail<__nv_bfloat16>(d, st);
}
