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
// both operands.  This kernel computes the same function in one pass over
// the cache as it is stored.
//
// What bounds it: bytes at long caches, latency at short ones.  Every cache
// byte is read once and takes part in G = NH / NKV (1 to 12) multiply-adds
// of the scores and as many of the product with v.  A served step's cache
// (16.8 MB at phi4-mini's 4 slots of 1024) takes 5 us at 3.35 TB/s, about
// two launches' worth, so there a call's latency chain is its time; at
// 32768 positions (1.07 GB) the bytes are.  Done as float32 FMAs, the
// products and the conversion of every bf16 element take a quarter (G = 3)
// to all (G = 12) of the bytes' time in lane instructions.
//
// The design, for both:
// * One launch a call, its combine inside a thread-block cluster.  A
//   cluster of c CTAs (c <= 8, the portable most) takes one (batch row,
//   kv head, row tile); its ranks split the positions the tile's rows see
//   (the cache, or under a sliding window the window's reach from the
//   earliest row's start) into chunks.  Each rank leaves its running max,
//   sum and
//   unnormalised float32 row sums in its shared memory; after a cluster
//   barrier every rank reads all the ranks' parts through distributed
//   shared memory, weighs them in rank order and writes its share of the
//   output columns in q's dtype; a second barrier keeps each part alive
//   until it has been read.  No scratch in device memory, no second kernel,
//   no atomics: replays are bit-repeatable.
// * The plan (c, the chunk, the stages) is kernel.py's choose_launch, a
//   function of the shapes alone (B, T, NKV, G·S, hd, dtype, the new part,
//   the window): every cluster resident at once on the card's GPCs, and at
//   most one CTA an SM where a rank streams many tiles (the bytes bound it;
//   a second CTA only takes issue slots), as many ranks as fit where it
//   streams few (latency bounds it).  The kernel reads kv_valid and the
//   positions on the device: a rank whose positions are all at or past
//   kv_valid[b] does no work but still takes part in both barriers with an
//   empty part (max -inf, sum 0).  A CUDA graph captured once stays valid as the
//   offsets advance, and a synchronized step (one offset for every row)
//   runs the same plan, with the same bits, as the per-slot step.
// * The step's own keys and values (the deferred form) are the last tiles
//   of the plan's new rank (the cluster's last), at key positions
//   kv_valid[b] + j: the combine weighs them last, as their own part was
//   before.
// * The partials form, for a cache split over positions across devices
//   (the JAX package's long-context rules shard kv_seq): the call gets one
//   shard, whose row t holds key position t_start + t; the masks, the
//   window and kv_valid stay in global positions, kv_valid on the device.
//   The cluster combines as above, then writes the float32 output
//   normalized over this shard's keys and each row's log-sum-exp, which
//   ops.py's combine weighs across the shards.  Only the shard the caller
//   gives the step's own keys counts them.  A shard with no visible key
//   writes 0 and -inf, which the combine weighs by 0.
// * Loads: one producer warp feeds a ring of 3 or 4 stages (by shared
//   memory, in the plan) of 64-position K and V tiles, each stage completing
//   on its mbarrier; consumer warps spend no registers or issue slots on
//   addresses, and the cache is read through its strides, with no layout
//   copy.  The producer warp walks the ring whole and meets the others at
//   the cluster barriers: a lone producer lane, its warp's other lanes
//   parked at the first barrier, held the ring to a third of the bytes.  bf16: one lane issues TMA boxes (cp.async.bulk.tensor) over
//   tensor maps of the layer's (B, T, NKV, hd) view and of the step's own
//   keys, 128-byte swizzled (64-byte at hd 32; hd 80 padded to 128 with
//   zeros), two to four boxes a stage.  Rows of a tile past kv_valid are
//   read as stored (finite in every cache the port makes; the plain
//   version reads them too) and masked; rows past the tensor's end come
//   as zeros.  float32: one bulk copy (cp.async.bulk) a row, rows past a
//   tile's end repeating its last row.  A bulk copy a row was the first
//   design for both, but 128 copies a tile held the copy engine to about a
//   third of the card's bytes.
// * bf16: both products on the tensor cores (mma.sync m16n8k16, bf16 in,
//   float32 out), fed by ldmatrix from the swizzled tiles (no bank
//   conflicts).  The G·S query rows of a kv head (padded to 16) are the
//   M of the products; each of the four consumer warps takes 16 positions
//   of every tile, keeps its own online softmax in registers and its own
//   row sums; the four are summed into the CTA's part at the end.  P is
//   the tile's unnormalised exp(s - m) rounded to bf16, as B1 rounds it;
//   the sum of exponentials is taken before the rounding; exponentials are
//   2^x on the special-function unit, a soft-cap's tanh one more 2^x and a
//   reciprocal.  A warp whose 16 positions every row sees skips the masks,
//   and the rescale of its sums when no row's max moved.  mma.sync over
//   wgmma: M = 16 query rows is all a decode step has, where wgmma's
//   smallest M is 64; the products are a tenth of the bytes' time either
//   way, and the register fragments pass P from the scores to the product
//   with v without shared memory.
// * float32 (the smoke lanes and the parity cases) keeps the CUDA cores
//   (TF32 would not hold 1e-4): two threads a key position for the scores,
//   a warp per row for the online softmax, each thread 8 columns of every
//   row for a slice of the tile's positions in the product with v.
// A row whose every key is masked (no decode path makes one) comes out as 0;
// the plain version gives the mean of v there.
//
// Launches on the caller's stream with cudaLaunchKernelEx (capturable in a
// CUDA graph) and allocates nothing: kernel.py makes the output with
// torch.empty.  decode_attention returns the launch's error.

#include <cooperative_groups.h>
#include <math.h>

#include "../../flash_attention/csrc/hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CONSUMERS = 128;           // four consumer warps
constexpr int WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int TK = 64;                   // key positions per K/V tile
constexpr int COLS = 8;                  // float32: columns per thread in the product with v
constexpr int MMA_ROWS = 16;             // bf16: query rows per CTA, the M of the products
constexpr int MAX_HD = 128;
constexpr int MIN_STAGES = 3, MAX_STAGES = 4;
constexpr int MAX_CLUSTER = 8;
constexpr int BARS = 128;                // bytes of the ring's mbarriers, padded
constexpr long long NO_ROW = -(1LL << 62);   // qpos of a padding row

struct Params {
  const void* q;
  const void* kc;
  const void* vc;
  const void* kn;
  const void* vn;
  void* out;
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
  long long t_start;      // the global position of the cache's first row
  float* lse;             // the partials form's log-sum-exp (B, S, NH), or null
  int B, S, NKV, G, T, hd, chunk, cluster, stages, new_rank, causal;
  float scale, softcap;
};

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// float32 tiles, one bulk copy a row: K rows padded so that rows lie 32
// bytes past a multiple of 128 apart (two threads share a key row and read
// alternate 8-column chunks); V rows hd apart (the product with v reads each
// row's chunks side by side).
__host__ __device__ inline int k_pitch(int hd) {
  const int bytes = hd * 4;
  return (bytes + ((32 - bytes) % 128 + 128) % 128) / 4;
}

// bf16 tiles, TMA boxes of TK rows by one swizzle row of columns (Swz in
// hopper.cuh: 64 columns in 128 bytes, or 32 in 64 for hd 32; hd 128 and
// hd 80, padded to 128, take two boxes side by side)
__host__ __device__ inline int bf16_tile_bytes(int hd) {
  const int cols = hd < 64 ? hd : 64, hdp = hd == 80 ? 128 : hd;
  return (hdp / cols) * TK * 2 * cols;
}

// The dynamic shared memory of a CTA of R query rows, in bytes from its
// start: the ring of `stages` K/V tiles (first: a 128-byte swizzle repeats
// every 1024 bytes).  When the chunk is done the ring's bytes hold the end's
// scratch (bf16: each warp's row sums, max and sum; float32: the threads'
// slices), then the part the other ranks read (R rows of hd float32 sums,
// R maxima, R sums), then the combine's weights (R x MAX_CLUSTER) and totals
// (R).  After the ring: the mbarriers; float32 only, the query positions
// (R), query rows (R x hd float32), scores (R x TK) and rescale factors (R,
// padded).
struct Layout {
  int stage, part, weights, bars, head, total;
};

__host__ __device__ inline Layout layout(int R, int hd, int esize, int stages) {
  Layout l;
  l.stage = esize == 2 ? 2 * bf16_tile_bytes(hd) : TK * (k_pitch(hd) + hd) * 4;
  const int scratch = esize == 2 ? WARPS * MMA_ROWS * (hd + 2) * 4 + MMA_ROWS * WARPS * 4
                                 : CONSUMERS * R * COLS * 4;
  l.part = align_up(scratch, 16);
  l.weights = align_up(l.part + R * (hd + 2) * 4, 16);
  const int end = l.weights + R * (MAX_CLUSTER + 1) * 4;
  l.bars = align_up(stages * l.stage > end ? stages * l.stage : end, 128);
  l.head = l.bars + BARS;
  l.total = l.head;
  if (esize == 4) l.total += 8 * R + 4 * R * hd + 4 * R * TK + 16 * ((4 * R + 15) / 16);
  return l;
}

// The address of 8 bf16 columns (col a multiple of 8) of tile row `row`:
// box col / COLS, its swizzled 16-byte chunk (128-byte swizzle: the chunk
// index XOR row % 8; 64-byte: XOR (row / 2) % 4).
template <int HD>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int row, int col) {
  using W = Swz<HD>;
  const int c = col / W::COLS, j = (col % W::COLS) / 8;
  const int sw = W::BYTES == 128 ? (row & 7) : ((row >> 1) & 3);
  return tile + c * TK * W::BYTES + row * W::BYTES + ((j ^ sw) << 4);
}

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

// `bytes` (a multiple of 16) from global to shared memory, 16-byte aligned
// both, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warps' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One rank's work: the cache rows [start, end), then, on the new rank, the
// step's own rows [0, S) at key positions kvv + j; tiles of TK rows each.
// Cache row t holds key position t_start + t (t_start 0 but for a shard of
// a cache split over positions).  The ranks split the rows some row of the
// tile sees: [lo, kv_valid - t_start) with lo 0, or, under a window, the
// earliest row's window start; the last rank takes what is left past the
// plan's chunks (nothing, unless the positions of one tile's rows lie
// further apart than its steps).
struct Span {
  long long start, end, kvv;
  int cache_tiles, tiles;
};

// Rows [t0, t_end) of one tile in k / v (row t at k + t * kstep) and the
// key position of its row t, base + t.
struct Tile {
  const void* k;
  const void* v;
  long long kstep, vstep, t0, t_end, base;
};

template <int R>
__device__ Span span_of(const Params& p, int b, int rt, int rank) {
  Span sp;
  sp.kvv = p.kv_valid[b * p.kvv_s];
  long long limit = sp.kvv - p.t_start < p.T ? sp.kvv - p.t_start : (long long)p.T;
  if (limit < 0) limit = 0;
  long long lo = 0;
  if (p.window > 0) {
    lo = -1;
    const int GS = p.G * p.S, last = (rt + 1) * R < GS ? (rt + 1) * R : GS;
    for (int s = rt * R / p.G; s * p.G < last; ++s) {
      const long long qp = p.positions[b * p.pos_s[0] + s * p.pos_s[1]];
      if (lo < 0 || qp - p.window + 1 < lo) lo = qp - p.window + 1 < 0 ? 0 : qp - p.window + 1;
    }
    lo = lo > p.t_start ? lo - p.t_start : 0;
  }
  sp.start = lo + (long long)rank * p.chunk;
  sp.end = rank == p.cluster - 1 || sp.start + p.chunk > limit ? limit : sp.start + p.chunk;
  sp.cache_tiles = sp.end > sp.start ? (int)((sp.end - sp.start + TK - 1) / TK) : 0;
  const int new_tiles = (p.kn != nullptr && rank == p.new_rank) ? (p.S + TK - 1) / TK : 0;
  sp.tiles = sp.cache_tiles + new_tiles;
  return sp;
}

template <typename T>
__device__ __forceinline__ Tile tile_of(const Params& p, const Span& sp, int b, int kvh, int i) {
  Tile t;
  if (i < sp.cache_tiles) {
    t.k = static_cast<const T*>(p.kc) + b * p.kc_s[0] + kvh * p.kc_s[2];
    t.v = static_cast<const T*>(p.vc) + b * p.vc_s[0] + kvh * p.vc_s[2];
    t.kstep = p.kc_s[1];
    t.vstep = p.vc_s[1];
    t.t0 = sp.start + (long long)i * TK;
    t.t_end = sp.end;
    t.base = p.t_start;
  } else {
    t.k = static_cast<const T*>(p.kn) + b * p.kn_s[0] + kvh * p.kn_s[2];
    t.v = static_cast<const T*>(p.vn) + b * p.vn_s[0] + kvh * p.vn_s[2];
    t.kstep = p.kn_s[1];
    t.vstep = p.vn_s[1];
    t.t0 = (long long)(i - sp.cache_tiles) * TK;
    t.t_end = p.S;
    t.base = sp.kvv;
  }
  return t;
}

// The tensor maps of a bf16 call: the layer's cache and the step's own keys
// and values, each (hd, rows, kv heads, batch), boxes of TK rows.
struct Maps {
  CUtensorMap k, v, kn, vn;
};

// bf16 producer: each stage's K and V tiles as TMA boxes (rows past the
// tensor's end zero-filled), issued by lane 0 and completing on the stage's
// mbarrier.  The whole warp walks the ring, so that it reaches the cluster
// barriers together.
template <int HD>
__device__ void produce_tma(const Params& p, const Maps& maps, const Span& sp, int b, int kvh,
                            uint32_t ring, int stage_bytes, uint32_t bars, int lane) {
  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.v)) : "memory");
  }
  for (int i = 0; i < sp.tiles; ++i) {
    const int st = i % p.stages, round = i / p.stages;
    const uint32_t full = bars + 8 * st, empty = bars + 8 * (MAX_STAGES + st);
    if (round > 0) mbar_wait(empty, (round - 1) & 1);
    if (lane == 0) {
      mbar_expect_tx(full, stage_bytes);
      const bool cache = i < sp.cache_tiles;
      const int t0 = cache ? (int)(sp.start + (long long)i * TK) : (i - sp.cache_tiles) * TK;
      const uint32_t kt = ring + st * stage_bytes;
      tma_tile<HD, TK>(kt, cache ? &maps.k : &maps.kn, t0, kvh, b, full);
      tma_tile<HD, TK>(kt + stage_bytes / 2, cache ? &maps.v : &maps.vn, t0, kvh, b, full);
    }
    __syncwarp();
  }
}

// float32 producer, the whole warp: each stage's K and V rows, one bulk
// copy a row, lane l taking rows l and l + 32; lane 0 arms the stage's
// mbarrier first.  Rows past the tile's end repeat its last row.
__device__ void produce_rows(const Params& p, const Span& sp, int b, int kvh, uint32_t ring,
                             int stage_bytes, uint32_t bars, int lane) {
  const int KP = k_pitch(p.hd), row_bytes = p.hd * 4;
  const uint32_t tx = 2u * TK * (uint32_t)row_bytes;
  for (int i = 0; i < sp.tiles; ++i) {
    const int st = i % p.stages, round = i / p.stages;
    const uint32_t full = bars + 8 * st, empty = bars + 8 * (MAX_STAGES + st);
    if (round > 0) mbar_wait(empty, (round - 1) & 1);
    if (lane == 0) mbar_expect_tx(full, tx);
    __syncwarp();
    const Tile t = tile_of<float>(p, sp, b, kvh, i);
    const uint32_t kt = ring + st * stage_bytes, vt = kt + TK * KP * 4;
    const float* k = static_cast<const float*>(t.k);
    const float* v = static_cast<const float*>(t.v);
    for (int r = lane; r < TK; r += 32) {
      long long row = t.t0 + r;
      if (row >= t.t_end) row = t.t_end - 1;
      bulk_copy(kt + r * KP * 4, k + row * t.kstep, row_bytes, full);
      bulk_copy(vt + r * p.hd * 4, v + row * t.vstep, row_bytes, full);
    }
  }
}

// The part a CTA leaves for the combine: rows' sums (R x hd), maxima (R),
// sums of exponentials (R), in shared memory.
struct Part {
  float* o;
  float* m;
  float* l;
};

// bf16 consumers: warp w takes positions 16w .. 16w + 15 of every tile.
// Thread (lane) holds rows g = lane / 4 and g + 8 of the fragments, their
// columns 2 (lane % 4) and one more.
template <int HD>
__device__ void consume_bf16(const Params& p, const Span& sp, int b, int kvh, int rt,
                             uint32_t ring, int stage_bytes, uint32_t bars, float* scratch,
                             const Part& part, int tid) {
  constexpr int KS = HD / 16;   // depth steps of the scores
  constexpr int NT = HD / 8;    // column tiles of the product with v
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int GS = p.G * p.S;

  // q's rows g and g + 8 as A fragments, and their positions
  uint32_t qa[KS][4];
  long long qp[2];
  const unsigned short* q = static_cast<const unsigned short*>(p.q);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = rt * MMA_ROWS + g + 8 * h;
    const bool valid = rr < GS;
    const int s = valid ? rr / p.G : 0, gg = valid ? rr - s * p.G : 0;
    const unsigned short* row =
        q + b * p.q_s[0] + s * p.q_s[1] + (long long)(kvh * p.G + gg) * p.q_s[2];
    qp[h] = valid ? p.positions[b * p.pos_s[0] + s * p.pos_s[1]] : NO_ROW;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 8 * half + 2 * t4;
        const uint32_t lo = valid ? row[c] : 0u, hi = valid ? row[c + 1] : 0u;
        qa[kk][h + 2 * half] = lo | (hi << 16);
      }
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float cap2 = p.softcap > 0.f ? 2.f * LOG2E / p.softcap : 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this lane's ldmatrix row addresses (elements within a tile)
  const int krow = 16 * warp + (lane >> 4) * 8 + (lane & 7), kcol = ((lane >> 3) & 1) * 8;
  const int vrow = 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7), vcol = (lane >> 4) * 8;

  for (int i = 0; i < sp.tiles; ++i) {
    const int st = i % p.stages;
    mbar_wait(bars + 8 * st, (i / p.stages) & 1);
    const Tile t = tile_of<__nv_bfloat16>(p, sp, b, kvh, i);
    if (t.t0 + 16 * warp < t.t_end) {   // this warp's positions hold a row
      const uint32_t kt = ring + st * stage_bytes, vt = kt + stage_bytes / 2;
      // two chains of products (even and odd depth steps) halve the
      // scores' dependent mma latency
      float sa[2][4], sb[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = sb[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, tile_addr<HD>(kt, krow, 16 * kk + kcol));
        if (kk & 1) {
          mma_bf16(sb[0], qa[kk], kb[0], kb[1]);
          mma_bf16(sb[1], qa[kk], kb[2], kb[3]);
        } else {
          mma_bf16(sa[0], qa[kk], kb[0], kb[1]);
          mma_bf16(sa[1], qa[kk], kb[2], kb[3]);
        }
      }
      // scale, cap and mask: sc[j][e] is row g + 8 (e >> 1), position
      // 16 warp + 8 j + 2 t4 + (e & 1) of the tile.  A slice whose 16
      // positions every row of this thread sees skips the mask.
      const long long r0 = t.t0 + 16 * warp, k0 = t.base + r0;
      bool whole = r0 + 15 < t.t_end;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        whole = whole && (qp[h] == NO_ROW || ((!p.causal || k0 + 15 <= qp[h]) &&
                                              (p.window == 0 || k0 > qp[h] - p.window)));
      float sc[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float s = (sa[j][e] + sb[j][e]) * p.scale;
          // cap tanh(s / cap) as cap (1 - 2 / (2^(2 s log2(e) / cap) + 1)):
          // one 2^x and one reciprocal, where tanhf and a division cost the
          // windowed layer's tiles more than their loads
          if (p.softcap > 0.f) s = p.softcap * fmaf(-2.f, __frcp_rn(ex2(s * cap2) + 1.f), 1.f);
          if (!whole) {
            const long long row = r0 + 8 * j + 2 * t4 + (e & 1), kp = t.base + row;
            const bool ok = row < t.t_end && qp[h] != NO_ROW && (!p.causal || kp <= qp[h]) &&
                            (p.window == 0 || kp > qp[h] - p.window);
            s = ok ? s : -INFINITY;
          }
          sc[j][e] = s;
          mx[h] = fmaxf(mx[h], s);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        float sum = 0.f;
        alpha[h] = 1.f;
        if (m_new == -INFINITY) {
#pragma unroll
          for (int j = 0; j < 2; ++j) sc[j][2 * h] = sc[j][2 * h + 1] = 0.f;
        } else {
          // e^x as 2^(x log2 e) on the special-function unit
          const float ml = m_new * LOG2E;
          alpha[h] = ex2(fmaf(m_run[h], LOG2E, -ml));
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              sc[j][e] = ex2(fmaf(sc[j][e], LOG2E, -ml));
              sum += sc[j][e];
            }
        }
        l_run[h] = l_run[h] * alpha[h] + sum;
        m_run[h] = m_new;
      }
      // the running max settles early in a long cache: most tiles rescale
      // by exactly 1, and the warp skips the multiplies
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }
      // P (16 rows x this warp's 16 positions) as the A fragment of P V
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tile_addr<HD>(vt, vrow, 8 * n + vcol));
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + st));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }

  // the four warps' states summed into the CTA's part, in warp order; the
  // scratch is the ring's bytes, free once every warp is past its last tile
  consumer_sync();
  constexpr int WS = HD + 2;   // a warp's row: sums, max, sum of exponentials
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      scratch[(warp * MMA_ROWS + g + 8 * (e >> 1)) * WS + 8 * n + 2 * t4 + (e & 1)] = acc[n][e];
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      scratch[(warp * MMA_ROWS + g + 8 * h) * WS + HD] = m_run[h];
      scratch[(warp * MMA_ROWS + g + 8 * h) * WS + HD + 1] = l_run[h];
    }
  }
  consumer_sync();
  float* wt = scratch + WARPS * MMA_ROWS * WS;   // each warp's weight of each row
  if (tid < MMA_ROWS) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, scratch[(w * MMA_ROWS + tid) * WS + HD]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* row = scratch + (w * MMA_ROWS + tid) * WS;
      const float e = M == -INFINITY ? 0.f : expf(row[HD] - M);
      wt[tid * WARPS + w] = e;
      L = fmaf(row[HD + 1], e, L);
    }
    part.m[tid] = M;
    part.l[tid] = L;
  }
  consumer_sync();
  for (int i = tid; i < MMA_ROWS * HD; i += CONSUMERS) {
    const int r = i / HD, d = i - r * HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o = fmaf(scratch[(w * MMA_ROWS + r) * WS + d], wt[r * WARPS + w], o);
    part.o[i] = o;
  }
}

// float32 consumers (CUDA cores): R query rows per tile (a power of two, 2
// to 16); the query rows, scores and rescale factors live in shared memory
// at `head`.
template <int R>
__device__ void consume_f32(const Params& p, const Span& sp, int b, int kvh, int rt,
                            unsigned char* head, float* ring, int stage_elems, uint32_t bars,
                            float* red, const Part& part, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int hd = p.hd, C8 = hd / COLS, KP = k_pitch(hd);
  long long* qpos = reinterpret_cast<long long*>(head);
  float* qs = reinterpret_cast<float*>(qpos + R);
  float* ps = qs + R * hd;
  float* alpha = ps + R * TK;

  const int GS = p.G * p.S;
  const float* q = static_cast<const float*>(p.q);
  for (int i = tid; i < R * hd; i += CONSUMERS) {
    const int r = i / hd, d = i - r * hd, rr = rt * R + r;
    float x = 0.f;
    if (rr < GS) {
      const int s = rr / p.G, g = rr - s * p.G;
      x = q[b * p.q_s[0] + s * p.q_s[1] + (long long)(kvh * p.G + g) * p.q_s[2] + d];
    }
    qs[i] = x;
  }
  if (tid < R) {
    const int rr = rt * R + tid;
    qpos[tid] = rr < GS ? p.positions[b * p.pos_s[0] + (rr / p.G) * p.pos_s[1]] : NO_ROW;
  }
  consumer_sync();

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
  const int PS = CONSUMERS / C8;           // position slices of the product with v
  const int sl = tid / C8, col = tid - sl * C8;

  for (int i = 0; i < sp.tiles; ++i) {
    const int st = i % p.stages;
    mbar_wait(bars + 8 * st, (i / p.stages) & 1);
    const float* kt = ring + st * stage_elems;
    const float* vt = kt + TK * KP;
    const Tile tl = tile_of<float>(p, sp, b, kvh, i);

    // scores: threads 2t and 2t+1 share key row t, alternate 8-column chunks
    {
      const int t = tid >> 1, h = tid & 1;
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      for (int c = h; c < C8; c += 2) {
        float k8[COLS];
        load8(kt + t * KP + c * COLS, k8);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float q8[COLS];
          load8(qs + r * hd + c * COLS, q8);
#pragma unroll
          for (int e = 0; e < COLS; ++e) sc[r] = fmaf(q8[e], k8[e], sc[r]);
        }
      }
      const long long kp = tl.base + tl.t0 + t;
      const bool in = tl.t0 + t < tl.t_end;
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
    consumer_sync();

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
    consumer_sync();

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
    consumer_sync();      // the stage, ps and alpha are free again
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + st));
  }

  // the slices summed in a fixed order into the CTA's part; the slices live
  // in the ring's bytes, free once the last tile is done
  if (sl < PS) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < COLS; ++e) red[(sl * R + r) * hd + col * COLS + e] = acc[r][e];
  }
  consumer_sync();
  for (int i = tid; i < R * hd; i += CONSUMERS) {
    const int r = i / hd, d = i - r * hd;
    float s = 0.f;
    for (int k = 0; k < PS; ++k) s += red[(k * R + r) * hd + d];
    part.o[i] = s;
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + 4 * j;
    if (r < R && lane == 0) {
      part.m[r] = m_run[j];
      part.l[r] = l_run[j];
    }
  }
}

// One cluster: grid (c, B·NKV, row tiles), cluster (c, 1, 1); rank r takes
// cache positions [r·chunk, (r+1)·chunk).  After its chunk, each rank's
// part is weighed with every rank's, in rank order, and the rank writes the
// output elements r·THREADS + tid, stepping by c·THREADS, in q's dtype to
// out (B, S, NH, hd).  The partials form (lse set) writes them in float32,
// normalized over this cache's keys alone, and rank 0 writes each row's
// log-sum-exp, M + log(L); a row that sees no key here gets 0 and -inf.
template <typename T, int R, int HD>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const __grid_constant__ Maps maps, const Params p) {
  // the ring first: a 128-byte swizzle repeats every 1024 bytes, and the
  // dynamic shared memory starts at the CTA's window, so it is aligned; a
  // launch where it is not traps
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nrank = (int)cluster.num_blocks();
  const int bh = blockIdx.y, rt = blockIdx.z;
  const int b = bh / p.NKV, kvh = bh % p.NKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int ES = sizeof(T);
  const int hd = HD > 0 ? HD : p.hd;
  const Layout lay = layout(R, hd, ES, p.stages);
  const uint32_t bars = smem_u32(smem + lay.bars);
  unsigned char* ring = smem;
  if (ES == 2 && (smem_u32(ring) & 1023u)) __trap();
  const Part part = {reinterpret_cast<float*>(ring + lay.part),
                     reinterpret_cast<float*>(ring + lay.part) + R * hd,
                     reinterpret_cast<float*>(ring + lay.part) + R * hd + R};

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full: the producer's arrival
      mbar_init(bars + 8 * (MAX_STAGES + s), WARPS);    // empty: one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const Span sp = span_of<R>(p, b, rt, rank);
  if (warp == WARPS) {
    if constexpr (ES == 2) {
      produce_tma<HD>(p, maps, sp, b, kvh, smem_u32(ring), lay.stage, bars, lane);
    } else {
      produce_rows(p, sp, b, kvh, smem_u32(ring), lay.stage, bars, lane);
    }
  } else if constexpr (ES == 2) {
    consume_bf16<HD>(p, sp, b, kvh, rt, smem_u32(ring), lay.stage, bars,
                     reinterpret_cast<float*>(ring), part, tid);
  } else {
    consume_f32<R>(p, sp, b, kvh, rt, smem + lay.head, reinterpret_cast<float*>(ring),
                   lay.stage / ES, bars, reinterpret_cast<float*>(ring), part, tid);
  }

  // every rank's part is written; weigh them in rank order (a rank past
  // kv_valid has max -inf and weight 0)
  cluster.sync();
  float* wt = reinterpret_cast<float*>(ring + lay.weights);   // R x MAX_CLUSTER, then R totals
  float* total = wt + R * MAX_CLUSTER;
  if (tid < R) {
    float M = -INFINITY;
    for (int k = 0; k < nrank; ++k) M = fmaxf(M, cluster.map_shared_rank(part.m, k)[tid]);
    float L = 0.f;
    for (int k = 0; k < nrank; ++k) {
      const float w = M == -INFINITY ? 0.f : expf(cluster.map_shared_rank(part.m, k)[tid] - M);
      wt[tid * MAX_CLUSTER + k] = w;
      L = fmaf(cluster.map_shared_rank(part.l, k)[tid], w, L);
    }
    total[tid] = L;
    const int rr = rt * R + tid;
    if (p.lse != nullptr && rank == 0 && rr < p.G * p.S) {
      const int s = rr / p.G, g = rr - s * p.G;
      p.lse[((long long)b * p.S + s) * (p.NKV * p.G) + kvh * p.G + g] =
          L > 0.f ? M + logf(L) : -INFINITY;
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  float* out_f = static_cast<float*>(p.out);
  const int GS = p.G * p.S;
  for (int i = rank * THREADS + tid; i < R * hd; i += nrank * THREADS) {
    const int r = i / hd, d = i - r * hd, rr = rt * R + r;
    if (rr >= GS) continue;
    float O = 0.f;
    for (int k = 0; k < nrank; ++k)
      O = fmaf(cluster.map_shared_rank(part.o, k)[i], wt[r * MAX_CLUSTER + k], O);
    const int s = rr / p.G, g = rr - s * p.G;
    const long long at = b * p.o_s[0] + s * p.o_s[1] + (long long)(kvh * p.G + g) * p.o_s[2] + d;
    const float o = total[r] > 0.f ? O / total[r] : 0.f;
    if (p.lse != nullptr)
      out_f[at] = o;
    else
      out[at] = from_f<T>(o);
  }
  // no rank leaves while another may still read its part
  cluster.sync();
}

// A tensor map's strides for a (B, rows, H, hd) view: a dimension of size
// one is never stepped, so it takes the span of the next inner one (the
// encoder wants every stride a multiple of 16 bytes).
Strides map_strides(const long long (&s)[3], int B, int rows, int H, int hd) {
  Strides st = {s[0], s[1], s[2]};
  if (rows == 1) st.s = hd;
  if (H == 1) st.h = st.s * rows;
  if (B == 1) st.b = st.h * H;
  return st;
}

// bf16: the cache's and the new part's tensor maps, then the launch.
// Returns a CUDA error, or hopper.cuh's ERR_NO_ENCODER / ERR_ENCODE.
template <typename T, int R, int HD>
int launch(const Params& p, int cluster, int smem, cudaStream_t stream) {
  Maps maps = {};
  if constexpr (HD > 0) {
    int err = make_map<HD>(&maps.k, p.kc, p.B, p.T, p.NKV,
                           map_strides(p.kc_s, p.B, p.T, p.NKV, HD), TK);
    if (!err)
      err = make_map<HD>(&maps.v, p.vc, p.B, p.T, p.NKV,
                         map_strides(p.vc_s, p.B, p.T, p.NKV, HD), TK);
    if (!err && p.kn != nullptr)
      err = make_map<HD>(&maps.kn, p.kn, p.B, p.S, p.NKV,
                         map_strides(p.kn_s, p.B, p.S, p.NKV, HD), TK);
    if (!err && p.vn != nullptr)
      err = make_map<HD>(&maps.vn, p.vn, p.B, p.S, p.NKV,
                         map_strides(p.vn_s, p.B, p.S, p.NKV, HD), TK);
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, p.B * p.NKV, (p.G * p.S + R - 1) / R);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, R, HD>, maps, p);
}

// the library's kernels: float32 at 2/4/8/16 rows (head dim at run time),
// bf16 at 16 rows and each head dim
using Kernel = void (*)(Maps, Params);
struct Instance {
  int is_bf16, rows, hd;  // hd 0: any
  Kernel fn;
  int (*run)(const Params&, int, int, cudaStream_t);
};

const Instance kInstances[] = {
    {0, 2, 0, decode_attention_kernel<float, 2, 0>, launch<float, 2, 0>},
    {0, 4, 0, decode_attention_kernel<float, 4, 0>, launch<float, 4, 0>},
    {0, 8, 0, decode_attention_kernel<float, 8, 0>, launch<float, 8, 0>},
    {0, 16, 0, decode_attention_kernel<float, 16, 0>, launch<float, 16, 0>},
    {1, MMA_ROWS, 32, decode_attention_kernel<__nv_bfloat16, MMA_ROWS, 32>,
     launch<__nv_bfloat16, MMA_ROWS, 32>},
    {1, MMA_ROWS, 64, decode_attention_kernel<__nv_bfloat16, MMA_ROWS, 64>,
     launch<__nv_bfloat16, MMA_ROWS, 64>},
    {1, MMA_ROWS, 80, decode_attention_kernel<__nv_bfloat16, MMA_ROWS, 80>,
     launch<__nv_bfloat16, MMA_ROWS, 80>},
    {1, MMA_ROWS, 128, decode_attention_kernel<__nv_bfloat16, MMA_ROWS, 128>,
     launch<__nv_bfloat16, MMA_ROWS, 128>},
};

const Instance* find(int is_bf16, int rows, int hd) {
  for (const Instance& in : kInstances)
    if (in.is_bf16 == is_bf16 && in.rows == rows && (in.hd == 0 || in.hd == hd)) return &in;
  return nullptr;
}

}  // namespace

// Allow every kernel the card's largest dynamic shared memory; kernel.py
// calls it once per device before the first launch.
extern "C" int decode_attention_init(void) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const Instance& in : kInstances) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  return (int)err;
}

// cudaOccupancyMaxActiveClusters for a plan: how many of its clusters the
// card holds at once (-1 on an error).
extern "C" int decode_attention_max_clusters(int is_bf16, int rows, int hd, int cluster,
                                             int smem) {
  const Instance* in = find(is_bf16, rows, hd);
  if (in == nullptr) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, in->fn, &cfg) == cudaSuccess ? n : -1;
}

// q (B, S, NH, hd); k_cache / v_cache (B, T, NKV, hd); k_new / v_new
// (B, S, NKV, hd) or null; out (B, S, NH, hd); every one read through its
// batch, row and head strides (strides: q, k_cache, v_cache, k_new, v_new,
// out, 3 each), with a contiguous last dimension, and k/v 16-byte aligned
// rows.  positions: int64 at b * pos_b + s * pos_s; kv_valid: int64 at
// b * kvv_b.  The plan (rows, cluster, chunk, stages, new_rank, smem) is
// kernel.py's choose_launch.  Returns the launch's error (0 on success),
// cudaErrorInvalidValue for a plan it cannot run, 9000 / 9001 when a bf16
// call's tensor maps cannot be built (no cuTensorMapEncodeTiled, or the
// driver refused a map).
// The partials form (lse not null) takes a shard of the cache whose row t
// holds key position t_start + t and writes out in float32 and lse
// (B, S, NH) float32, contiguous.
static int run(const void* q, const void* kc, const void* vc, const void* kn, const void* vn,
               void* out, float* lse, long long t_start, const long long* positions,
               const long long* kv_valid, const long long* strides, long long pos_b,
               long long pos_s, long long kvv_b, int is_bf16, int B, int S, int NKV, int G,
               int T, int hd, int rows, int cluster, int chunk, int stages, int new_rank,
               float scale, float softcap, long long window, int causal, int smem,
               void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  const Instance* in = find(is_bf16, rows, hd);
  if (in == nullptr || hd % COLS || hd > MAX_HD || hd * esize % 16 || chunk <= 0 ||
      cluster < 1 || cluster > MAX_CLUSTER || stages < MIN_STAGES || stages > MAX_STAGES ||
      new_rank != (kn != nullptr ? cluster - 1 : -1) || t_start < 0 ||
      smem != layout(rows, hd, esize, stages).total)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.kc = kc; p.vc = vc; p.kn = kn; p.vn = vn; p.out = out;
  p.positions = positions;
  p.kv_valid = kv_valid;
  long long* dsts[] = {p.q_s, p.kc_s, p.vc_s, p.kn_s, p.vn_s, p.o_s};
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) dsts[i][j] = strides[3 * i + j];
  p.pos_s[0] = pos_b;
  p.pos_s[1] = pos_s;
  p.kvv_s = kvv_b;
  p.window = window;
  p.t_start = t_start;
  p.lse = lse;
  p.B = B; p.S = S; p.NKV = NKV; p.G = G; p.T = T; p.hd = hd;
  p.chunk = chunk;
  p.cluster = cluster;
  p.stages = stages;
  p.new_rank = new_rank;
  p.causal = causal;
  p.scale = scale;
  p.softcap = softcap;
  return in->run(p, cluster, smem, static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* kn,
                                const void* vn, void* out, const long long* positions,
                                const long long* kv_valid, const long long* strides,
                                long long pos_b, long long pos_s, long long kvv_b, int is_bf16,
                                int B, int S, int NKV, int G, int T, int hd, int rows,
                                int cluster, int chunk, int stages, int new_rank, float scale,
                                float softcap, long long window, int causal, int smem,
                                void* stream) {
  return run(q, kc, vc, kn, vn, out, nullptr, 0, positions, kv_valid, strides, pos_b, pos_s,
             kvv_b, is_bf16, B, S, NKV, G, T, hd, rows, cluster, chunk, stages, new_rank, scale,
             softcap, window, causal, smem, stream);
}

// The partials form: decode_attention's arguments, then lse and t_start.
extern "C" int decode_attention_partials(
    const void* q, const void* kc, const void* vc, const void* kn, const void* vn, void* out,
    const long long* positions, const long long* kv_valid, const long long* strides,
    long long pos_b, long long pos_s, long long kvv_b, int is_bf16, int B, int S, int NKV,
    int G, int T, int hd, int rows, int cluster, int chunk, int stages, int new_rank,
    float scale, float softcap, long long window, int causal, int smem, void* stream,
    float* lse, long long t_start) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, kc, vc, kn, vn, out, lse, t_start, positions, kv_valid, strides, pos_b, pos_s,
             kvv_b, is_bf16, B, S, NKV, G, T, hd, rows, cluster, chunk, stages, new_rank, scale,
             softcap, window, causal, smem, stream);
}
