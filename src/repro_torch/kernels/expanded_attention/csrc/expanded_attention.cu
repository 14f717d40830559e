// Expanded attention (B7), forward, for Hopper, sm_90a: multi-head latent
// attention's expanded form (DeepSeek-V2, arXiv:2405.04434), the form that
// training and `forward` run, with float32 logits, softmax and sums.
//
// Replaces no TPU kernel.  The JAX package computes the expanded form in
// jnp outside any Pallas kernel (src/repro/models/mla.py:90-103): K and V
// expanded per token from the latent, the logits
// (q_nope . k_nope + q_rope . k_rope) * scale as float32 einsums, a -1e30
// fill where key t is past the query's position (q_pos[s] >= t visible),
// a float32 softmax, the probabilities in the activation dtype and their
// product with V.  The port's plain version (ref.py) does the same with the
// (B, N, S, T) float32 scores in device memory.  B1 cannot take it: its q,
// k and v share one head dim, where MLA's q . k is 192 wide (128 nope + 64
// rope, the rope key shared by every head) and its v 128.
//
// What it computes.  q_nope (B, S, N, nope), q_rope (B, S, N, rope),
// k_nope (B, T, N, nope), k_rope (B, T, rope), one for all N heads, v (B, T,
// N, dv), each read through its strides; q_pos (S,) int64 read on the
// device.  o (B, S, N, dv) in the inputs' dtype and, given `lse`, each
// row's float32 log-sum-exp (B, N, S) in natural-log units, which the
// backward (expanded_attention_bwd.cu) recomputes P from.  Widths: nope up
// to 128, rope up to 64, dv up to 128, each a multiple of 16.
//
// Masks as JAX's: key t is visible to the query at q_pos[s] when t <=
// q_pos[s]; a masked logit is the finite -1e30, so a row whose every key is
// masked (q_pos[s] < 0) comes out as the mean of v over the T keys.  Keys
// past T (a ragged tile's TMA fill) are excluded (-inf).  A CTA reads only
// the keys below the largest visible end of its rows, all T when one of its
// rows is fully masked; the positions are read on the device, so a captured
// CUDA graph replays any q_pos, and the mask is applied only on tiles that
// cross some row's end.
//
// What bounds it.  At DeepSeek-V2's widths (128 heads, 192 + 128 wide) the
// causal half of 2 x 4096 tokens is 1.374 TFLOP against 0.8 GB of q, k, v
// and o: about 1700 operations a byte, far past the card's ridge (295), so
// the products must run on the tensor cores.
//
// bf16 design: two consumer warpgroups in ping-pong (FlashAttention-3,
// Shah et al. 2024) over one K/V ring.  A CTA takes 128 query rows of one
// (batch, head), 64 for each consumer warpgroup, and one producer warp (288
// threads).  The producer loads each warpgroup's 64 x 192 Q tile once, as
// three TMA boxes of 64 columns (a 128-byte swizzle row each): two from
// q_nope and one from q_rope, side by
// side, so that one K-major descriptor walks the 192-wide depth; then it
// streams BN-key K tiles the same way (two boxes of k_nope and one of
// k_rope, read through its own map, so no concatenated or head-broadcast
// copy is made) and the BN x 128 V tiles into a ring of STAGES stages that
// both warpgroups read; K and V are released apart (a K tile once both
// warpgroups' scores are done, a V tile once their P V is).  In each
// warpgroup S = Q K^T runs on wgmma m64nBNk16 over 12 k-steps, the online
// softmax on the accumulator fragments in float32 (log2 units, ex2), P
// rounded to bf16 after the rescale (as the plain version rounds the
// probabilities), then O += P V on m64n128k16 with P from registers and V
// MN-major; the Q K^T of one tile and the P V of the one before are
// issued together.  The two warpgroups take turns at issuing (named
// barriers 1 and 2): warpgroup 0 issues its pair of products, then
// warpgroup 1, and each one's softmax runs while the tensor cores run the
// other's products.  Both walk the CTA's tiles (the second warpgroup's
// rows see up to one tile more; the first masks it), so the turns pair up.
// Widths below the tile's boxes: the TMA zero-fills the columns past a
// width inside a box; a box wholly past the width is zeroed once and never
// loaded.  At 64 keys a tile and four stages Q (48 KB) and the ring (160
// KB) take 213,144 bytes: one CTA an SM.  288 threads put three warps on
// one of the SM's four schedulers, which caps a thread at 168 registers:
// at 128 keys a tile (the scores 64 registers, P 32) ptxas spilled 208
// bytes and serialized the wgmma, and the kernel ran 25% slower than at
// 64 (142 registers); without the producer warp (256 threads, a thread of
// warpgroup 1 refilling the ring) 128 keys fit in 228 registers and ran
// no faster than this design.  The grid is one dimension, the (batch,
// head) outermost and heavy (late) query tiles first within it: the CTAs
// in flight share a few heads' K and V, which the L2 serves after the
// first read (with the head innermost, each CTA read its own head's from
// device memory, about 11 GB for 2 x 4096 tokens at 128 heads, and the
// kernel took as long without its products as with them).
//
// float32 (the smoke configs, the parity runs against the CPU) keeps the
// FMA units (no TF32): 256 threads, each owning a 4 x 4 block of a 64 x 64
// score tile and 4 rows of up to 8 output columns, the tiles staged in
// shared memory with one padding column.
//
// Launches on the caller's stream (capturable in a CUDA graph) and
// allocates nothing: kernel.py makes o and the LSE with torch.empty.

#include <math.h>

#include <type_traits>

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int BM = 64;                 // query rows of a warpgroup (bf16) or a CTA (float32)
constexpr int CTA_ROWS = 2 * BM;       // bf16: query rows a CTA, two consumer warpgroups
constexpr int BN = 64;                 // bf16: keys a tile
constexpr int STAGES = 4;              // bf16: the K/V ring
constexpr int F_BN = 64;               // float32: keys a tile
constexpr int BOX = 64;                // bf16 columns of one 128-byte swizzle row
constexpr uint32_t BOX_BYTES = 64 * 128;   // a box of 64 rows (Q)
constexpr uint32_t KV_BOX = BN * 128;      // a box of BN rows (K, V)
constexpr int ROPE_BOX = 2;            // a Q or K tile: nope boxes 0 and 1, the rope box
constexpr uint32_t Q_TILE = 3 * BOX_BYTES;  // one warpgroup's 64 x 192 Q tile
constexpr uint32_t K_TILE = 3 * KV_BOX, V_TILE = 2 * KV_BOX;
constexpr int THREADS = 288;           // two consumer warpgroups and one producer warp
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_WARP = 8;
constexpr int BAR_TURN = 1;            // named barriers 1 and 2: warpgroup 0's and 1's turn
constexpr int F_THREADS = 256;
constexpr int FQK = 192, FV = 128;     // float32: the widest q . k and v
constexpr int LDQK = FQK + 1, LDV = FV + 1, LDP = F_BN + 1;
constexpr float MASKED = -1e30f * LOG2E;   // -1e30 in natural-log units, in log2 units
constexpr int ALL = 0x7fffffff;

struct Params {
  const void *qn_p, *qr_p, *kn_p, *kr_p, *v_p;
  void* o_p;
  long long qn[3], qr[3], kn[3], kr[2], v[3], o[3];  // batch, seq, head strides (k_rope: batch, position)
  const long long* q_pos;
  long long pos_s;
  float* lse;            // (B, N, S) float32, or null: not written
  int B, S, N, T, nope, rope, dv;
  float scale;
};

struct Maps {
  CUtensorMap qn, qr, kn, kr, v;
};

// bf16 shared memory: the two warpgroups' Q tiles, the K and V rings, 1 +
// 4 * STAGES mbarriers and the CTA's key limit and its warpgroups' smallest
// positions.  kernel.py's smem_bytes is the same.
constexpr size_t bf16_smem_bytes() {
  return 2 * Q_TILE + STAGES * (K_TILE + V_TILE) + 8 * (1 + 4 * STAGES) + 16;
}
// float32: Q and K tiles of 192 + 1 columns, V of 128 + 1, P of 64 + 1, the limit
constexpr size_t f32_smem_bytes() {
  return 4 * (size_t)(BM * LDQK + F_BN * LDQK + F_BN * LDV + BM * LDP) + 16;
}

// the position of a query clamped to [-1, T - 1]: the keys t < T with t <= p
// are the same, and -1 marks a row whose every key is masked
__device__ __forceinline__ int clamp_pos(long long p, int T) {
  return p < 0 ? -1 : (p >= T ? T - 1 : (int)p);
}

// the CTA's key limit (the largest visible end of its real rows, T when a
// row sees no key) into lim[0] and the smallest position of each 64 of its
// rows into lim[1], lim[2]; threads [0, rows) take a row each.  The caller
// zeroes lim[0], sets the others to ALL and synchronises before, and
// synchronises after.
__device__ __forceinline__ void reduce_rows(const Params& p, int q0, int rows, int* lim) {
  const int t = threadIdx.x;
  if (t < rows && q0 + t < p.S) {
    const int qp = clamp_pos(p.q_pos[(long long)(q0 + t) * p.pos_s], p.T);
    atomicMax(&lim[0], qp < 0 ? p.T : qp + 1);
    atomicMin(&lim[1 + t / BM], qp);
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
    exp_fwd_bf16(const __grid_constant__ Maps maps, const Params p) {
  // tiles start on 1024 bytes (the swizzle's period): the dynamic block starts
  // the CTA's shared window; a launch where it does not traps
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  if (sQ & 1023u) __trap();
  const uint32_t sK = sQ + 2 * Q_TILE;
  const uint32_t sV = sK + STAGES * K_TILE;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  const uint32_t bar = sV + STAGES * V_TILE;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bar + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar + 8u * (1 + 3 * STAGES + s); };
  int* lim = reinterpret_cast<int*>(smem_raw + 2 * Q_TILE + STAGES * (K_TILE + V_TILE) +
                                    8 * (1 + 4 * STAGES));

  // one dimension, the (batch, head) outermost (see the note above)
  const int per = (p.S + CTA_ROWS - 1) / CTA_ROWS;
  const int bh = blockIdx.x / per;
  const int b = bh / p.N, h = bh % p.N;
  const int q0 = (per - 1 - (int)(blockIdx.x % per)) * CTA_ROWS;   // heavy (late) tiles first
  const int tid = threadIdx.x;
  const int nb = (p.nope + BOX - 1) / BOX, vb = (p.dv + BOX - 1) / BOX;

  if (tid == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);  // every consumer thread releases it
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    lim[0] = 0;
    lim[1] = lim[2] = ALL;
  }
  // boxes wholly past a width are zeroed once and never loaded: nope box 1
  // of both Q tiles and of every K stage, V box 1 of every stage
  for (int i = tid; i < (int)(KV_BOX / 16); i += THREADS) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if (nb < 2) {
      if (i < (int)(BOX_BYTES / 16))
        for (int w = 0; w < 2; ++w)
          reinterpret_cast<uint4*>(smem_raw + w * Q_TILE + BOX_BYTES)[i] = z;
      for (int s = 0; s < STAGES; ++s)
        reinterpret_cast<uint4*>(smem_raw + 2 * Q_TILE + s * K_TILE + KV_BOX)[i] = z;
    }
    if (vb < 2)
      for (int s = 0; s < STAGES; ++s)
        reinterpret_cast<uint4*>(smem_raw + 2 * Q_TILE + STAGES * K_TILE + s * V_TILE + KV_BOX)[i] = z;
  }
  __syncthreads();
  reduce_rows(p, q0, CTA_ROWS, lim);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, for wgmma
  __syncthreads();
  // uniform values, as ptxas must know them to be (a branch it takes for
  // divergent serializes every wgmma)
  const int limit = __shfl_sync(0xffffffffu, lim[0], 0);
  const int tiles = (limit + BN - 1) / BN;   // both warpgroups walk them all

  const int warp = tid / 32, lane = tid % 32;
  if (warp == PRODUCER_WARP) {
    // ---- producer: one thread loads both Q tiles once, then runs the K/V ring ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.kn)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.kr)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.v)) : "memory");
      // warpgroup 1's rows, or, when all of them are past S, warpgroup 0's
      // again (a row past S is computed and not stored)
      const int q1 = q0 + BM < p.S ? q0 + BM : q0;
      mbar_expect_tx(bar, 2 * (nb + 1) * BOX_BYTES);
      for (int w = 0; w < 2; ++w) {
        const uint32_t at = sQ + w * Q_TILE;
        for (int c = 0; c < nb; ++c)
          tma_load(at + c * BOX_BYTES, &maps.qn, c * BOX, w ? q1 : q0, h, b, bar);
        tma_load(at + ROPE_BOX * BOX_BYTES, &maps.qr, 0, w ? q1 : q0, h, b, bar);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = ((t / STAGES) & 1) ^ 1;
        const uint32_t k_at = sK + s * K_TILE, v_at = sV + s * V_TILE;
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), (nb + 1) * KV_BOX);
        for (int c = 0; c < nb; ++c)
          tma_load(k_at + c * KV_BOX, &maps.kn, c * BOX, t * BN, h, b, k_full(s));
        tma_load(k_at + ROPE_BOX * KV_BOX, &maps.kr, 0, t * BN, 0, b, k_full(s));
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), vb * KV_BOX);
        for (int c = 0; c < vb; ++c)
          tma_load(v_at + c * KV_BOX, &maps.v, c * BOX, t * BN, h, b, v_full(s));
      }
    }
    return;
  }

  // ---- the consumer warpgroups: 64 query rows each, 16 a warp ----
  // the warpgroup as a value ptxas knows is the same across a warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int min_pos = __shfl_sync(0xffffffffu, lim[1 + wg], 0);
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + BM * wg + 16 * (warp & 3) + g;   // this thread's rows: r0, r0 + 8
  const uint32_t sQw = sQ + wg * Q_TILE;
  const float qk_scale = p.scale * LOG2E;
  int rpos[2];  // the rows' positions; a row past S sees every key (its output is not stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    rpos[r] = row < p.S ? clamp_pos(p.q_pos[(long long)row * p.pos_s], p.T) : p.T - 1;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f}, alpha[2];
  float sc[BN / 2];        // scores of the newest tile, then its p
  uint32_t pa[BN / 16][4];  // P of the tile whose PV product is next

  // S = Q K^T of stage s over the 192-wide depth (12 k-steps: two nope boxes
  // and the rope box side by side), issued, not waited
  auto issue_qk = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < 12; ++kc)
      wgmma_ss<BN>(sc, desc_kmajor<192, BM>(sQw, kc), desc_kmajor<192, BN>(sK + s * K_TILE, kc),
                   kc > 0);
    wgmma_commit();
  };
  // O += P V of stage s over BN / 16 k-steps; V is MN-major, its two boxes LBO apart
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
      wgmma_rs<128>(acc, pa[kc], desc_mnmajor<128, BN>(sV + s * V_TILE, kc));
    wgmma_commit();
  };
  // the online softmax of the tile at key k0, in place on sc (log2 units):
  // the masks, the running max, alpha, p and the running sum (acc is
  // rescaled by alpha later, once the PV product in flight is done with it)
  auto softmax_pass = [&](int k0, auto masked) {
    // element 4j + e of sc: row r0 + 8 (e >> 1), key k0 + 8j + 2 t4 + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * qk_scale;
        if constexpr (decltype(masked)::value) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          x = kp < p.T ? (kp <= rpos[e >> 1] ? x : MASKED) : -INFINITY;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a quad hold one row; every tile holds a key below T,
      // so the max is finite (-1e30 on a fully masked row: p = 1 a key)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = ex2(m_i[r] - m_new);   // 2^-inf = 0 on the first tile
      m_i[r] = m_new;
    }
    float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(sc[4 * j + e] - m_i[e >> 1]);
        sc[4 * j + e] = pe;
        ps[e >> 1][j & 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = ps[r][0] + ps[r][1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i[r] = alpha[r] * l_i[r] + sum;
    }
  };
  // the mask only on tiles past T or past some row's position (of this warpgroup)
  auto softmax = [&](int k0) {
    if (k0 + BN > p.T || k0 + BN - 1 > min_pos) softmax_pass(k0, std::true_type{});
    else softmax_pass(k0, std::false_type{});
  };
  // acc *= alpha, then P to bf16 A fragments (rounded here, after the rescale)
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    pack_a<BN / 8>(pa, sc);
  };
  // ping-pong: a warpgroup issues its products in its turn (named barrier
  // BAR_TURN + wg, which the other warpgroup arrives on once it has issued
  // its own), so that each one's softmax runs under the other's products
  auto my_turn = [&]() { bar_sync(BAR_TURN + wg, CONSUMERS); };
  auto your_turn = [&]() { bar_arrive(BAR_TURN + 1 - wg, CONSUMERS); };

  auto slot = [](int i) { return i % STAGES; };
  auto parity = [](int i) { return (uint32_t)((i / STAGES) & 1); };
  mbar_wait(bar, 0);
  mbar_wait(k_full(0), 0);
  if (wg == 1) your_turn();  // warpgroup 0 goes first
  my_turn();
  wgmma_fence();
  issue_qk(0);
  your_turn();
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(k_empty(0));
  softmax(0);
  rescale_and_pack();
  for (int i = 1; i < tiles; ++i) {
    const int ip = i - 1;
    mbar_wait(k_full(slot(i)), parity(i));
    mbar_wait(v_full(slot(ip)), parity(ip));
    my_turn();
    wgmma_fence();
    issue_qk(slot(i));
    issue_pv(slot(ip));
    your_turn();
    wgmma_wait<1>();  // Q K^T of tile i done; PV of tile ip may run on
    fence_regs(sc);
    mbar_arrive(k_empty(slot(i)));
    softmax(i * BN);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);   // the PV product read these registers until now
    mbar_arrive(v_empty(slot(ip)));
    rescale_and_pack();
  }
  {
    const int ip = tiles - 1;
    mbar_wait(v_full(slot(ip)), parity(ip));
    my_turn();
    wgmma_fence();
    issue_pv(slot(ip));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(v_empty(slot(ip)));
    // warpgroup 1's last turn; warpgroup 1 issues last, so no arrival of
    // its is left over at the end
    if (wg == 0) your_turn();
  }

  // epilogue: O / l through o's strides, rows past S masked, the dv columns
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o_p) + (long long)b * p.o[0] +
                      (long long)h * p.o[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= p.S) continue;
    const float inv = 1.f / l_i[r];
    if (p.lse != nullptr && t4 == 0)  // m_i and l_i in base-2 units
      p.lse[((long long)b * p.N + h) * p.S + row] = (m_i[r] + log2f(l_i[r])) * LN2;
    __nv_bfloat16* orow = ob + (long long)row * p.o[1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < p.dv)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

// Row r of a BM-row tile of [x_nope | x_rope] (a query or key tile) at
// position r0 + r of (b, h) into dst[r * LDQK + c], zeros past `rows` and
// past nope + rope.  The rope part of a key tile has no head (xr_s[2] 0).
__device__ __forceinline__ void load_qk(float* dst, const float* xn, const float* xr,
                                        const long long* xn_s, const long long* xr_s, int b, int h,
                                        int r0, int rows, int nope, int rope, int nthreads) {
  const int dqk = nope + rope;
  for (int idx = threadIdx.x; idx < BM * FQK; idx += nthreads) {
    const int r = idx / FQK, c = idx % FQK;
    float x = 0.f;
    if (r0 + r < rows && c < dqk) {
      const long long pos = r0 + r;
      x = c < nope ? xn[b * xn_s[0] + pos * xn_s[1] + h * xn_s[2] + c]
                   : xr[b * xr_s[0] + pos * xr_s[1] + h * xr_s[2] + c - nope];
    }
    dst[r * LDQK + c] = x;
  }
}

// rows [r0, r0 + BM) x dv of a (B, ·, N, dv) tensor into dst[r * LDV + c]
__device__ __forceinline__ void load_v(float* dst, const float* x, const long long* s, int b,
                                       int h, int r0, int rows, int dv, int nthreads) {
  for (int idx = threadIdx.x; idx < BM * FV; idx += nthreads) {
    const int r = idx / FV, c = idx % FV;
    dst[r * LDV + c] = (r0 + r < rows && c < dv)
                           ? x[b * s[0] + (long long)(r0 + r) * s[1] + h * s[2] + c]
                           : 0.f;
  }
}

__global__ void __launch_bounds__(F_THREADS)
    exp_fwd_f32(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LDQK;
  float* Vs = Ks + F_BN * LDQK;
  float* Ps = Vs + F_BN * LDV;
  int* lim = reinterpret_cast<int*>(Ps + BM * LDP);

  const int b = blockIdx.x / p.N, h = blockIdx.x % p.N;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i
  const int tc = tid & 15;  // score columns tc + 16 j, output columns tc + 16 c
  const int dqk = p.nope + p.rope;
  const float* qn = static_cast<const float*>(p.qn_p);
  const float* qr = static_cast<const float*>(p.qr_p);
  const float* kn = static_cast<const float*>(p.kn_p);
  const float* kr = static_cast<const float*>(p.kr_p);
  const float* v = static_cast<const float*>(p.v_p);
  const long long kr_s[3] = {p.kr[0], p.kr[1], 0};

  if (tid == 0) {
    lim[0] = 0;
    lim[1] = ALL;
  }
  load_qk(Qs, qn, qr, p.qn, p.qr, b, h, q0, p.S, p.nope, p.rope, F_THREADS);
  __syncthreads();
  reduce_rows(p, q0, BM, lim);
  __syncthreads();
  const int limit = lim[0];
  int qpos[4];  // a row past S sees every key (its output is not stored)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    qpos[i] = row < p.S ? clamp_pos(p.q_pos[(long long)row * p.pos_s], p.T) : p.T - 1;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < limit; k0 += F_BN) {
    __syncthreads();  // the last tile's readers of K, V and P are done
    load_qk(Ks, kn, kr, p.kn, kr_s, b, h, k0, p.T, p.nope, p.rope, F_THREADS);
    load_v(Vs, v, p.v, b, h, k0, p.T, p.dv, F_THREADS);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < dqk; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * LDQK + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LDQK + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // natural-log units: a masked logit is -1e30, a key past T -inf; the
    // max is finite (every tile holds a key below T)
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        const float x = kp < p.T ? (kp <= qpos[i] ? s[i][j] * p.scale : NEG_INF) : -INFINITY;
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - m_new);
        s[i][j] = pe;
        ps += pe;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tr + 16 * i) * LDP + tc + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < F_BN; ++jj) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * LDP + jj];
#pragma unroll
      for (int c = 0; c < 8; ++c) vv[c] = Vs[jj * LDV + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* ob = static_cast<float*>(p.o_p) + (long long)b * p.o[0] + (long long)h * p.o[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp >= p.S) continue;
    if (p.lse != nullptr && tc == 0)
      p.lse[((long long)b * p.N + h) * p.S + qp] = m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (tc + 16 * c < p.dv) ob[(long long)qp * p.o[1] + tc + 16 * c] = acc[i][c] / l[i];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the 4-d map (width, seq, heads, batch) of a bf16 tensor read through its
// strides (elements: batch, seq, head), boxes of 64 columns by `rows` rows,
// 128-byte swizzle; columns past `width` (inside a box) and rows past `seq`
// are zero-filled.  The caller gives a dimension of length one a stride the
// encoder takes (a multiple of 16 bytes).
int make_map_w(CUtensorMap* map, const void* ptr, int width, int seq, int heads, int batch,
               long long st_b, long long st_s, long long st_h, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st_s * 2, (cuuint64_t)st_h * 2, (cuuint64_t)st_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

}  // namespace

// Allow both kernels the card's largest dynamic shared memory; kernel.py
// calls it once per device before the first launch (outside any capture).
extern "C" int expanded_attention_init(void) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exp_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exp_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return (int)err;
}

// q_nope (B, S, N, nope), q_rope (B, S, N, rope), k_nope (B, T, N, nope),
// k_rope (B, T, rope), v (B, T, N, dv), o (B, S, N, dv), each read or
// written through its strides (`strides`: q_nope 3, q_rope 3, k_nope 3,
// k_rope 2, v 3, o 3, in elements; batch, sequence, head), last dimension
// contiguous; bf16 base pointers and strides 16-byte aligned (its tensor
// maps; a dimension of length one takes any such stride).  q_pos int64 at
// s * pos_s.  `lse`, if not null, receives the rows' log-sum-exp (B, N,
// S).  `smem` is kernel.py's smem_bytes.  Returns the launch's error (0 on
// success), cudaErrorInvalidValue for shapes it cannot run, 9000 / 9001
// when a tensor map cannot be built.
extern "C" int expanded_attention_fwd(const void* q_nope, const void* q_rope, const void* k_nope,
                                      const void* k_rope, const void* v, void* o, float* lse,
                                      const long long* q_pos, const long long* strides,
                                      long long pos_s, int is_bf16, int B, int S, int N, int T,
                                      int nope, int rope, int dv, int smem, float scale,
                                      void* stream) {
  if (B < 1 || S < 1 || N < 1 || T < 1 || nope < 16 || nope > 128 || nope % 16 || rope < 16 ||
      rope > 64 || rope % 16 || dv < 16 || dv > 128 || dv % 16 ||
      smem != (int)(is_bf16 ? bf16_smem_bytes() : f32_smem_bytes()) ||
      (long long)B * N > 0x7fffffffLL || (S + BM - 1) / BM > 65535)  // 64-row tiles, as the backward's
    return (int)cudaErrorInvalidValue;
  const int rows = is_bf16 ? CTA_ROWS : BM;   // query rows a CTA
  if (is_bf16 && (long long)B * N * ((S + rows - 1) / rows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.qn_p = q_nope; p.qr_p = q_rope; p.kn_p = k_nope; p.kr_p = k_rope; p.v_p = v; p.o_p = o;
  for (int i = 0; i < 3; ++i) {
    p.qn[i] = strides[i];
    p.qr[i] = strides[3 + i];
    p.kn[i] = strides[6 + i];
    p.v[i] = strides[11 + i];
    p.o[i] = strides[14 + i];
  }
  p.kr[0] = strides[9];
  p.kr[1] = strides[10];
  p.q_pos = q_pos;
  p.pos_s = pos_s;
  p.lse = lse;
  p.B = B; p.S = S; p.N = N; p.T = T; p.nope = nope; p.rope = rope; p.dv = dv;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * N, (S + rows - 1) / rows);
  if (!is_bf16) {
    exp_fwd_f32<<<grid, F_THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  Maps maps = {};
  int err = make_map_w(&maps.qn, q_nope, nope, S, N, B, p.qn[0], p.qn[1], p.qn[2], BM);
  if (!err) err = make_map_w(&maps.qr, q_rope, rope, S, N, B, p.qr[0], p.qr[1], p.qr[2], BM);
  if (!err) err = make_map_w(&maps.kn, k_nope, nope, T, N, B, p.kn[0], p.kn[1], p.kn[2], BN);
  // k_rope: one head for all N, its head dimension of length one
  if (!err) err = make_map_w(&maps.kr, k_rope, rope, T, 1, B, p.kr[0], p.kr[1], rope, BN);
  if (!err) err = make_map_w(&maps.v, v, dv, T, N, B, p.v[0], p.v[1], p.v[2], BN);
  if (err) return err;
  exp_fwd_bf16<<<grid.x * grid.y, THREADS, smem, st>>>(maps, p);
  return (int)cudaGetLastError();
}
