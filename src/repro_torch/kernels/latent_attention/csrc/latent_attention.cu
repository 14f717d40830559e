// Latent attention (B6) for Hopper, sm_90a: multi-head latent attention's
// absorbed form (DeepSeek-V2, arXiv:2405.04434) against the latent cache,
// read in its own dtype, with float32 logits, softmax and sums.
//
// Replaces no TPU kernel.  The JAX package computes the absorbed form in
// jnp outside any Pallas kernel (src/repro/models/mla.py:113-128): the
// logits (q_lat . ckv + q_rope . krope) * scale as float32 einsums over
// upcast operands, a -1e30 fill where key t is past a query's position or
// past the slot's valid length, a float32 softmax, the probabilities in the
// activation dtype and their product with ckv.  The port's plain version
// (ref.py) does the same step by step: a float32 copy of the layer's cache,
// the (B, N, S, T) float32 scores in device memory and three more passes
// over them.  This kernel computes the same function in one pass over the
// cache as it is stored, the scores kept on chip.
//
// What bounds it.  Every query head (and in a prompt pass every query
// token) shares each latent row: one 576-wide key row (512 latent + 64 rope
// columns at DeepSeek's widths) and one 512-wide value row, the same
// latents.  At 128 heads that is about 240 operations a byte of cache,
// against the card's ridge of about 295 in bf16: the products must run on
// the tensor cores.  decode_32k's share (8 sequences of 32768 positions)
// moves 302 MB of cache, 90 us at 3.35 TB/s, and does 73 GFLOP, 74 us at
// the bf16 peak.  A served step over 4 slots of 1024 is a few microseconds
// of either, so its latency chain is its time.
//
// bf16 design:
// * A CTA takes 64 query rows of one batch row (the flattened (token,
//   head) index, so at 128 heads one token's 64 heads) against the key
//   positions of one split: the heads are the products' M, so each cache
//   tile loaded once serves 64 rows.  Two consumer warpgroups and one
//   producer warp.
// * The producer streams 64-position tiles of [ckv | krope] into a ring of
//   2 or 3 stages by TMA (a box of 64 columns a 128-byte swizzle row, the
//   rope columns one more box), each stage completing on its mbarrier.  A
//   tile at DeepSeek's widths is 72 KB; the Q tile (64 x 576, copied once by
//   the consumers from q_lat and q_rope through their strides, every
//   16-byte cp.async in flight at once) is 72 KB more, so a 512-wide latent
//   fits two stages.  Latent widths are padded to a multiple of 128 and the
//   rope width to 64: boxes wholly past the width are zeroed once and never
//   loaded, and the TMA zero-fills the columns past the width inside a box
//   and the rows past T.
// * S = Q K^T on wgmma (m64n32k16, Q and K in shared memory, both K-major):
//   warpgroup j scores keys 32j .. 32j + 31 of the tile over the whole
//   depth.  The two halves' row maxima meet in shared memory, both take the
//   same running max, and each writes its half of P (bf16, unnormalised,
//   the sum of exponentials taken before the rounding) into a swizzled
//   64 x 64 tile.  Then O += P V on wgmma (m64n64k16, P K-major and V
//   MN-major from the same ckv tile): warpgroup j owns output columns
//   [R/2 j, R/2 (j + 1)), 128 float32 accumulators a thread at R = 512
//   (the 64 x 512 float32 output of a tile is 128 KB: split over two
//   warpgroups it fits their registers).  The card allocates a 288-thread
//   CTA's registers as a 384-thread one's, so ptxas holds the kernel to
//   168 a thread and issues the products one at a time, short of what the
//   R = 512 kernel needs to keep them in flight (a build given more fails
//   to launch for resources): the first thing a faster design has to
//   change.
// * Masks as JAX's: key t of a row at position p in slot b is visible when
//   t <= p and t < kv_len[b]; a masked logit is the finite -1e30, so a row
//   whose every key is masked comes out as the mean of the latents with no
//   special case.  Keys past T (a ragged tile's TMA fill) are excluded.  A
//   CTA whose rows each see some key reads only positions below the
//   largest visible end of its rows (a prompt pass skips the tiles above
//   its diagonal; a decode step the slots' unwritten tail); one with a
//   fully masked row reads all T.  The limits are read on the device: the
//   plan depends on shapes alone, and a captured CUDA graph stays valid as
//   the offsets advance.
// * The split over positions.  A served decode step has only B x N / 64
//   row tiles (8 for 4 slots at 128 heads) for 132 SMs, so kernel.py's plan
//   splits the positions into chunks of whole tiles, one CTA a (row tile,
//   chunk).  A CTA takes 230 KB of shared memory, one an SM, so a cluster
//   combine in distributed shared memory would cap the split by the
//   clusters a GPC holds at once (14 of 8 CTAs); instead each CTA writes
//   its float32 row sums, max and sum of exponentials, and a second kernel,
//   latent_combine, weighs the splits in order into the output: two
//   kernels a call, bit-repeatable.  A plan of one split (a prompt pass)
//   normalises and writes the output itself: one kernel a call.
//
// float32 (the smoke configs, the parity runs against the CPU) keeps the
// CUDA cores: a CTA of 128 threads takes 16 query rows over every tile of
// 32 positions, scores one key a lane, the online softmax a warp a row,
// the product with ckv a thread a few columns; no split.
//
// Launches on the caller's stream (capturable in a CUDA graph) and
// allocates nothing: kernel.py makes the output and the split's partials
// with torch.empty.  latent_attention returns the launches' error.

#include <math.h>

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int MT = 64;                    // bf16: query rows a CTA, the products' M
constexpr int TK = 64;                    // bf16: key positions a tile
constexpr int BOX = 64;                   // bf16 columns in one 128-byte swizzle row
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int CWARPS = CONSUMERS / 32;
constexpr int MIN_STAGES = 2, MAX_STAGES = 3;
constexpr int MAX_SPLIT = 256;            // the combine's weights in shared memory
constexpr int FR = 16;                    // float32: query rows a CTA
constexpr int FK = 32;                    // float32: key positions a tile
constexpr int F_THREADS = 128;
constexpr int COMBINE_THREADS = 128;
constexpr long long NO_ROW = -(1LL << 62);  // the position of a padding row

struct Params {
  const void* q_lat;     // (B, S, N, R)
  const void* q_rope;    // (B, S, N, Rr)
  const void* ckv;       // (B, T, R)
  const void* krope;     // (B, T, Rr)
  void* out;             // (B, S, N, R), the inputs' dtype
  float* o_part;         // (split, B * row tiles * rows, R) float32, or null: one split
  float* ml_part;        // (split, B * row tiles * rows, 2): max (log2 units), sum
  const long long* positions;
  const long long* kv_len;
  long long ql_s[3];     // batch, token, head strides (elements)
  long long qr_s[3];
  long long ckv_s[2];    // batch, position
  long long kr_s[2];
  long long o_s[3];
  long long pos_s[2];    // batch (0: one row of positions for every slot), token
  long long kvl_s;       // batch (0: one length for every slot)
  int B, S, N, T, R, Rr, split, chunk, stages, row_tiles;
  float scale;
};

// bf16 shared memory, in bytes from its start: the Q tile (KB boxes of 64
// rows), the ring of `stages` K tiles (KB boxes of TK rows each), the P tile
// (64 x 64), the two warpgroups' row maxima (then sums), the mbarriers (full
// and empty a stage) and the CTA's visible limit.  KB = 2 NCH + 1: the
// latent padded to 128 NCH columns, then one rope box.
struct Layout {
  int stage, ring, p, xch, bars, limit, total;
};

__host__ __device__ inline Layout layout_bf16(int nch, int stages) {
  const int kb = 2 * nch + 1;
  Layout l;
  l.stage = kb * TK * 2 * BOX;
  l.ring = kb * MT * 2 * BOX;
  l.p = l.ring + stages * l.stage;
  l.xch = l.p + MT * 2 * BOX;
  l.bars = l.xch + 2 * MT * 4;
  l.limit = l.bars + 16 * MAX_STAGES;
  l.total = l.limit + 16;
  return l;
}

// float32 shared memory, in floats: the Q rows (FR x D), the K tile (FK x
// (D + 1), odd rows against bank conflicts), P (FR x FK), the rescale
// factors (FR) and the visible limit.
__host__ __device__ inline int f32_smem_bytes(int D) {
  return 4 * (FR * D + FK * (D + 1) + FR * FK + FR) + 16;
}

// The position of row rr (the flattened (token, head) index) of batch row
// b, or NO_ROW for a padding row past S N.
__device__ __forceinline__ long long row_position(const Params& p, int b, long long rr) {
  if (rr >= (long long)p.S * p.N) return NO_ROW;
  const int s = (int)(rr / p.N);
  return p.positions[b * p.pos_s[0] + s * p.pos_s[1]];
}

// The positions a row at position qp of batch row b sees: min(qp + 1,
// kv_len[b]), at most T; 0 or less when every key is masked.
__device__ __forceinline__ long long visible_end(const Params& p, int b, long long qp) {
  const long long kvl = p.kv_len[b * p.kvl_s];
  long long v = qp + 1 < kvl ? qp + 1 : kvl;
  return v < p.T ? v : (long long)p.T;
}

// The CTA's limit: the largest visible end of its rows, or T when a row
// sees no key (its output is the mean over every position).  Threads
// [0, rows) each take a row; `slot` is an int in shared memory, zeroed by
// the caller before a __syncthreads.
__device__ void reduce_limit(const Params& p, int b, long long r0, int rows, int* slot) {
  const int t = threadIdx.x;
  if (t < rows) {
    const long long qp = row_position(p, b, r0 + t);
    if (qp != NO_ROW) {
      const long long v = visible_end(p, b, qp);
      atomicMax(slot, v <= 0 ? p.T : (int)v);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: two consumer warpgroups on wgmma, fed by a TMA ring
// ---------------------------------------------------------------------------

// d (64 x 32) (+)= A (64 x 16, shared, K-major) * B (16 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, shared, K-major) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_n64_mn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// 3-d TMA load of box {c, t, b} into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c, int t,
                                          int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the byte of 8 bf16 columns (chunk j = col / 8 of a 64-column box) of row
// `row` in a 128-byte-swizzled box of 128-byte rows
__device__ __forceinline__ uint32_t swz(int row, int j) {
  return row * 128 + ((j ^ (row & 7)) << 4);
}

struct Maps {
  CUtensorMap ckv, krope;
};

// One CTA: grid (row tiles, split, B).  Rows rt*64 .. rt*64 + 63 of batch
// row b (the flattened (token, head) index) over the positions [k chunk,
// (k + 1) chunk) of split k, cut at the CTA's visible limit.
template <int NCH>
__global__ void __launch_bounds__(THREADS, 1)
    latent_attention_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int RP = 128 * NCH;           // the latent's padded width
  constexpr int KB = 2 * NCH + 1;         // boxes of a Q or K row
  constexpr int KS = RP / 16 + 4;         // depth steps of the scores
  constexpr int BOX_Q = MT * 2 * BOX;     // bytes of one Q box
  constexpr int BOX_K = TK * 2 * BOX;     // bytes of one K box
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout lay = layout_bf16(NCH, p.stages);
  const uint32_t base = smem_u32(smem);
  if (base & 1023u) __trap();
  const uint32_t sQ = base, ring = base + lay.ring, sP = base + lay.p;
  const uint32_t bars = base + lay.bars;
  float* xch = reinterpret_cast<float*>(smem + lay.xch);
  int* lim = reinterpret_cast<int*>(smem + lay.limit);

  const int rt = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r_first = (long long)rt * MT;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full: the producer's arrival
      mbar_init(bars + 8 * (MAX_STAGES + s), CWARPS);    // empty: one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *lim = 0;
  }
  __syncthreads();
  reduce_limit(p, b, r_first, MT, lim);
  __syncthreads();
  const int limit = *lim;
  const int start = k * p.chunk;
  const int end = start + p.chunk < limit ? start + p.chunk : limit;
  const int tiles = end > start ? (end - start + TK - 1) / TK : 0;
  const int boxes = (p.R + BOX - 1) / BOX;             // latent boxes the TMA loads

  if (warp == CWARPS) {
    // ---- producer: lane 0 keeps the ring full ----
    if (lane == 0 && tiles > 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.ckv)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.krope)) : "memory");
      for (int i = 0; i < tiles; ++i) {
        const int st = i % p.stages, round = i / p.stages;
        const uint32_t full = bars + 8 * st;
        if (round > 0) mbar_wait(bars + 8 * (MAX_STAGES + st), (round - 1) & 1);
        mbar_expect_tx(full, (boxes + 1) * BOX_K);
        const uint32_t dst = ring + st * lay.stage;
        const int t0 = start + i * TK;
        for (int c = 0; c < boxes; ++c) tma_load3(dst + c * BOX_K, &maps.ckv, c * BOX, t0, b, full);
        tma_load3(dst + (KB - 1) * BOX_K, &maps.krope, 0, t0, b, full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup j scores keys 32j .. 32j + 31 of each tile and
  // owns output columns [RP/2 j, RP/2 (j + 1)) ----
  const int j = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const unsigned short* ql = static_cast<const unsigned short*>(p.q_lat);
  const unsigned short* qr = static_cast<const unsigned short*>(p.q_rope);

  // Q (64 x (RP + 64), swizzled boxes) from q_lat and q_rope, 16 bytes a
  // thread a copy, all in flight at once (cp.async; a copy of 0 source
  // bytes writes zeros): columns past R or Rr and rows past S N are zeros.
  // The ring's boxes past the latent's loaded width are zeroed once.
  for (int i = tid; i < MT * KB * 8; i += CONSUMERS) {
    const int r = i / (KB * 8), rest = i - r * (KB * 8), c = rest >> 3, ch = rest & 7;
    const long long rr = r_first + r;
    const unsigned short* src = ql;
    int bytes = 0;
    if (rr < (long long)p.S * p.N) {
      const int s = (int)(rr / p.N), n = (int)(rr - (long long)s * p.N);
      if (c < KB - 1) {
        const int col = c * BOX + 8 * ch;
        src = ql + b * p.ql_s[0] + s * p.ql_s[1] + n * p.ql_s[2] + col;
        bytes = col < p.R ? 16 : 0;
      } else {
        src = qr + b * p.qr_s[0] + s * p.qr_s[1] + n * p.qr_s[2] + 8 * ch;
        bytes = 8 * ch < p.Rr ? 16 : 0;
      }
      if (bytes == 0) src = ql;
    }
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sQ + c * BOX_Q + swz(r, ch)),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  {
    const int zero_boxes = KB - 1 - boxes;             // per stage
    const int per = zero_boxes * BOX_K / 16;
    for (int i = tid; i < p.stages * per; i += CONSUMERS) {
      const int st = i / per, off = (i - st * per) * 16;
      *reinterpret_cast<uint4*>(smem + lay.ring + st * lay.stage + boxes * BOX_K + off) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  fence_async_shared();
  consumer_sync();

  // this thread's rows: 16 wl + g and + 8 of the tile
  long long qp[2];
  long long kvl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qp[h] = row_position(p, b, r_first + 16 * wl + g + 8 * h);
    kvl[h] = p.kv_len[b * p.kvl_s];
  }
  const float qk_scale = p.scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float sc[16];
  float* xmax = xch;                                   // [2][64]

  for (int i = 0; i < tiles; ++i) {
    const int st = i % p.stages;
    const uint32_t stage = ring + st * lay.stage;
    mbar_wait(bars + 8 * st, (i / p.stages) & 1);
    // S = Q K^T over this warpgroup's 32 keys
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      const int c = kc >> 2, off = (kc & 3) * 32;
      wgmma_n32(sc, make_desc(sQ + c * BOX_Q + off, 16, 1024, 1),
                make_desc(stage + c * BOX_K + 32 * j * 128 + off, 16, 1024, 1), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale to log2 units and mask: element 4q + e is row 16 wl + g + 8 (e >> 1),
    // key t0 + 32 j + 8 q + 2 t4 + (e & 1)
    const long long t0 = (long long)start + (long long)i * TK + 32 * j;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const long long t = t0 + 8 * q + 2 * t4 + (e & 1);
        float x = sc[4 * q + e] * qk_scale;
        if (t >= p.T) x = -INFINITY;                   // past the cache: no key at all
        else if (!(t <= qp[h] && t < kvl[h])) x = NEG_INF;
        sc[4 * q + e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t4 == 0) xmax[j * MT + 16 * wl + g + 8 * h] = mx[h];
    }
    consumer_sync();
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * wl + g + 8 * h;
      const float m_new = fmaxf(m_run[h], fmaxf(xmax[row], xmax[MT + row]));
      alpha[h] = m_run[h] == -INFINITY ? 0.f : ex2(m_run[h] - m_new);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      m_run[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = ex2(sc[4 * q + e] - m_use[e >> 1]);
        sc[4 * q + e] = pr;
        ps[e >> 1] += pr;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l_run[h] = l_run[h] * alpha[h] + ps[h];
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc[c][4 * q] *= alpha[0];
        acc[c][4 * q + 1] *= alpha[0];
        acc[c][4 * q + 2] *= alpha[1];
        acc[c][4 * q + 3] *= alpha[1];
      }
    // this half of P, rounded to bf16, into the swizzled 64 x 64 tile
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wl + g + 8 * h, col = 32 * j + 8 * q + 2 * t4;
        *reinterpret_cast<uint32_t*>(smem + lay.p + swz(row, col >> 3) + (col & 7) * 2) =
            pack_bf16(sc[4 * q + 2 * h], sc[4 * q + 2 * h + 1]);
      }
    fence_async_shared();
    consumer_sync();
    // O += P V over this warpgroup's columns
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_n64_mn(acc[c], make_desc(sP + kk * 32, 16, 1024, 1),
                     make_desc(stage + (NCH * j + c) * BOX_K + kk * 16 * 128, BOX_K, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + st));
  }

  // the row sums of both halves, in order
  float* xl = xch;                                     // [2][64], free after the loop
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) xl[j * MT + 16 * wl + g + 8 * h] = l_run[h];
  }
  consumer_sync();
  float l_tot[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * wl + g + 8 * h;
    l_tot[h] = xl[row] + xl[MT + row];
  }

  const long long M = (long long)p.S * p.N;
  const long long prow0 = ((long long)b * p.row_tiles + rt) * MT;   // the partials' row
  const long long P = (long long)p.B * p.row_tiles * MT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * wl + g + 8 * h;
    const long long rr = r_first + row;
    if (rr >= M) continue;
    if (p.o_part == nullptr) {
      // one split: the output, normalised, in bf16 through its strides
      const int s = (int)(rr / p.N), n = (int)(rr - (long long)s * p.N);
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + b * p.o_s[0] + s * p.o_s[1] +
                         n * p.o_s[2];
      const float inv = 1.f / l_tot[h];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = (NCH * j + c) * BOX + 8 * q + 2 * t4;
          if (col < p.R)
            *reinterpret_cast<uint32_t*>(o + col) =
                pack_bf16(acc[c][4 * q + 2 * h] * inv, acc[c][4 * q + 2 * h + 1] * inv);
        }
    } else {
      const long long prow = (long long)k * P + prow0 + row;
      float* o = p.o_part + prow * p.R;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = (NCH * j + c) * BOX + 8 * q + 2 * t4;
          if (col < p.R)
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc[c][4 * q + 2 * h], acc[c][4 * q + 2 * h + 1]);
        }
      if (j == 0 && t4 == 0) {
        p.ml_part[2 * prow] = m_run[h];
        p.ml_part[2 * prow + 1] = l_tot[h];
      }
    }
  }
}

// The splits of a row weighed in order: M = max_k m_k, w_k = 2^(m_k - M),
// out = sum_k w_k o_k / sum_k w_k l_k, in bf16 through out's strides.  One
// block a partial row; a padding row returns.
__global__ void __launch_bounds__(COMBINE_THREADS)
    latent_combine(const Params p) {
  __shared__ float w[MAX_SPLIT];
  __shared__ float total;
  const long long prow = blockIdx.x;
  const long long per_b = (long long)p.row_tiles * MT;
  const int b = (int)(prow / per_b);
  const long long rr = prow - b * per_b;
  if (rr >= (long long)p.S * p.N) return;
  const long long P = (long long)p.B * per_b;
  if (threadIdx.x == 0) {
    float M = -INFINITY;
    for (int k = 0; k < p.split; ++k) M = fmaxf(M, p.ml_part[2 * (k * P + prow)]);
    float L = 0.f;
    for (int k = 0; k < p.split; ++k) {
      const float m = p.ml_part[2 * (k * P + prow)];
      const float wk = m == -INFINITY ? 0.f : ex2(m - M);
      w[k] = wk;
      L = fmaf(wk, p.ml_part[2 * (k * P + prow) + 1], L);
    }
    total = L;
  }
  __syncthreads();
  const int s = (int)(rr / p.N), n = (int)(rr - (long long)s * p.N);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + b * p.o_s[0] + s * p.o_s[1] +
                     n * p.o_s[2];
  const float inv = 1.f / total;
  for (int col = 2 * threadIdx.x; col < p.R; col += 2 * COMBINE_THREADS) {
    float a0 = 0.f, a1 = 0.f;
    for (int k = 0; k < p.split; ++k) {
      if (w[k] == 0.f) continue;
      const float2 v = *reinterpret_cast<const float2*>(p.o_part + (k * P + prow) * p.R + col);
      a0 = fmaf(w[k], v.x, a0);
      a1 = fmaf(w[k], v.y, a1);
    }
    *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(a0 * inv, a1 * inv);
  }
}

// ---------------------------------------------------------------------------
// float32 on the FMA units
// ---------------------------------------------------------------------------

// One CTA: grid (row tiles of FR, 1, B), every tile of FK positions below
// the CTA's limit.  Thread (warp w, lane l) scores key l for rows w, w + 4,
// w + 8, w + 12 and keeps their online softmax; in the product with ckv it
// sums columns tid, tid + 128, ... of all FR rows.
__global__ void __launch_bounds__(F_THREADS)
    latent_attention_f32(const Params p) {
  constexpr int RW = FR / 4;                 // rows a warp
  constexpr int CT = 512 / F_THREADS;        // columns a thread, at most
  extern __shared__ float fsm[];
  const int D = p.R + p.Rr, DK = D + 1;
  float* qs = fsm;                           // FR x D
  float* ks = qs + FR * D;                   // FK x DK
  float* ps = ks + FK * DK;                  // FR x FK
  float* al = ps + FR * FK;                  // FR
  int* lim = reinterpret_cast<int*>(al + FR);

  const int rt = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r_first = (long long)rt * FR;
  const long long M = (long long)p.S * p.N;
  const float* ql = static_cast<const float*>(p.q_lat);
  const float* qr = static_cast<const float*>(p.q_rope);
  const float* ckv = static_cast<const float*>(p.ckv);
  const float* kr = static_cast<const float*>(p.krope);

  if (tid == 0) *lim = 0;
  for (int i = tid; i < FR * D; i += F_THREADS) {
    const int r = i / D, d = i - r * D;
    const long long rr = r_first + r;
    float x = 0.f;
    if (rr < M) {
      const int s = (int)(rr / p.N), n = (int)(rr - (long long)s * p.N);
      x = d < p.R ? ql[b * p.ql_s[0] + s * p.ql_s[1] + n * p.ql_s[2] + d]
                  : qr[b * p.qr_s[0] + s * p.qr_s[1] + n * p.qr_s[2] + d - p.R];
    }
    qs[i] = x;
  }
  __syncthreads();
  reduce_limit(p, b, r_first, FR, lim);
  __syncthreads();
  const int limit = *lim;

  long long qp[RW];
  const long long kvl = p.kv_len[b * p.kvl_s];
  float m_run[RW], l_run[RW];
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    qp[q] = row_position(p, b, r_first + warp + 4 * q);
    m_run[q] = -INFINITY;
    l_run[q] = 0.f;
  }
  float acc[FR][CT];
#pragma unroll
  for (int r = 0; r < FR; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;

  for (int t0 = 0; t0 < limit; t0 += FK) {
    for (int i = tid; i < FK * D; i += F_THREADS) {
      const int t = i / D, d = i - t * D;
      float x = 0.f;
      if (t0 + t < p.T)
        x = d < p.R ? ckv[b * p.ckv_s[0] + (long long)(t0 + t) * p.ckv_s[1] + d]
                    : kr[b * p.kr_s[0] + (long long)(t0 + t) * p.kr_s[1] + d - p.R];
      ks[t * DK + d] = x;
    }
    __syncthreads();
    const long long t = t0 + lane;
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const int r = warp + 4 * q;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[r * D + d], ks[lane * DK + d], s);
      float x = s * p.scale;
      if (t >= p.T) x = -INFINITY;
      else if (!(t <= qp[q] && t < kvl)) x = NEG_INF;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[q], mx);
      const float a = m_run[q] == -INFINITY ? 0.f : expf(m_run[q] - m_new);
      const float pr = x == -INFINITY ? 0.f : expf(x - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[q] = l_run[q] * a + sum;
      m_run[q] = m_new;
      ps[r * FK + lane] = pr;
      if (lane == 0) al[r] = a;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = tid + c * F_THREADS;
      if (col >= p.R) continue;
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        float o = acc[r][c] * al[r];
        for (int tt = 0; tt < FK; ++tt) o = fmaf(ps[r * FK + tt], ks[tt * DK + col], o);
        acc[r][c] = o;
      }
    }
    __syncthreads();
  }
  // the rows' sums through shared memory, then the output through its strides
#pragma unroll
  for (int q = 0; q < RW; ++q)
    if (lane == 0) al[warp + 4 * q] = l_run[q];
  __syncthreads();
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < FR; ++r) {
    const long long rr = r_first + r;
    if (rr >= M) continue;
    const int s = (int)(rr / p.N), n = (int)(rr - (long long)s * p.N);
    const float inv = 1.f / al[r];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = tid + c * F_THREADS;
      if (col < p.R) out[b * p.o_s[0] + s * p.o_s[1] + n * p.o_s[2] + col] = acc[r][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the 3-d map (width, positions, batch) of a bf16 (B, T, width) view, boxes
// of 64 columns by TK rows, 128-byte swizzle; a dimension of size one takes
// the span of the next inner one as its stride (the encoder wants every
// stride a multiple of 16 bytes)
int make_map3(CUtensorMap* map, const void* ptr, int width, int T, int B, long long t_s,
              long long b_s) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  if (T == 1) t_s = width;
  if (B == 1) b_s = t_s * T;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)t_s * 2, (cuuint64_t)b_s * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)TK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

using Kernel = void (*)(Maps, Params);
const Kernel kBf16[4] = {latent_attention_kernel<1>, latent_attention_kernel<2>,
                         latent_attention_kernel<3>, latent_attention_kernel<4>};

}  // namespace

// Allow every kernel the card's largest dynamic shared memory; kernel.py
// calls it once per device before the first launch.
extern "C" int latent_attention_init(void) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const Kernel fn : kBf16)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(latent_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
  return (int)err;
}

// q_lat (B, S, N, R), q_rope (B, S, N, Rr), ckv (B, T, R), krope (B, T, Rr),
// out (B, S, N, R), each read through its strides (strides: q_lat 3,
// q_rope 3, ckv 2, krope 2, out 3) with a contiguous last dimension;
// bf16 rows 16-byte aligned.  positions int64 at b pos_b + s pos_s, kv_len
// int64 at b kvl_b.  The plan (rows, split, chunk, stages, smem) is
// kernel.py's choose_launch; with split > 1, o_part and ml_part are its
// float32 scratch and latent_combine runs after.  Returns the first
// launch error (0 on success), cudaErrorInvalidValue for a plan it cannot
// run, 9000 / 9001 when a tensor map cannot be built.
extern "C" int latent_attention(const void* q_lat, const void* q_rope, const void* ckv,
                                const void* krope, void* out, float* o_part, float* ml_part,
                                const long long* positions, const long long* kv_len,
                                const long long* strides, long long pos_b, long long pos_s,
                                long long kvl_b, int is_bf16, int B, int S, int N, int T, int R,
                                int Rr, int rows, int split, int chunk, int stages, int smem,
                                float scale, void* stream) {
  const int nch = (R + 127) / 128;
  const long long M = (long long)S * N;
  const int row_tiles = (int)((M + rows - 1) / rows);
  if (R < 16 || R > 512 || R % 16 || Rr < 16 || Rr > 64 || Rr % 16 || rows != (is_bf16 ? MT : FR) ||
      split < 1 || split > MAX_SPLIT || chunk < 1 || (is_bf16 && chunk % TK) ||
      (long long)(split - 1) * chunk >= T || (long long)split * chunk < T ||
      (split > 1 && (!is_bf16 || o_part == nullptr || ml_part == nullptr)) ||
      (is_bf16 && (stages < MIN_STAGES || stages > MAX_STAGES)) ||
      smem != (is_bf16 ? layout_bf16(nch, stages).total : f32_smem_bytes(R + Rr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q_lat = q_lat; p.q_rope = q_rope; p.ckv = ckv; p.krope = krope; p.out = out;
  p.o_part = split > 1 ? o_part : nullptr;
  p.ml_part = split > 1 ? ml_part : nullptr;
  p.positions = positions;
  p.kv_len = kv_len;
  for (int i = 0; i < 3; ++i) {
    p.ql_s[i] = strides[i];
    p.qr_s[i] = strides[3 + i];
    p.o_s[i] = strides[10 + i];
  }
  for (int i = 0; i < 2; ++i) {
    p.ckv_s[i] = strides[6 + i];
    p.kr_s[i] = strides[8 + i];
  }
  p.pos_s[0] = pos_b;
  p.pos_s[1] = pos_s;
  p.kvl_s = kvl_b;
  p.B = B; p.S = S; p.N = N; p.T = T; p.R = R; p.Rr = Rr;
  p.split = split; p.chunk = chunk; p.stages = stages; p.row_tiles = row_tiles;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_tiles, split, B);
  if (!is_bf16) {
    latent_attention_f32<<<grid, F_THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  Maps maps = {};
  int err = make_map3(&maps.ckv, ckv, R, T, B, p.ckv_s[1], p.ckv_s[0]);
  if (!err) err = make_map3(&maps.krope, krope, Rr, T, B, p.kr_s[1], p.kr_s[0]);
  if (err) return err;
  switch (nch) {
    case 1: latent_attention_kernel<1><<<grid, THREADS, smem, st>>>(maps, p); break;
    case 2: latent_attention_kernel<2><<<grid, THREADS, smem, st>>>(maps, p); break;
    case 3: latent_attention_kernel<3><<<grid, THREADS, smem, st>>>(maps, p); break;
    default: latent_attention_kernel<4><<<grid, THREADS, smem, st>>>(maps, p); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  latent_combine<<<(unsigned)((long long)B * row_tiles * MT), COMBINE_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
