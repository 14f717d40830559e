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
// * A CTA of 256 threads, two warpgroups and no producer warp, takes 64
//   query rows of one batch row (the flattened (token, head) index, so at
//   128 heads one token's 64 heads) against the key positions of one
//   split: the heads are the products' M, so each cache tile loaded once
//   serves 64 rows.  __launch_bounds__(256, 1) lets ptxas give a thread up
//   to 255 registers: a warpgroup's half of the output (64 x R/2 float32,
//   128 a thread at R = 512), a whole tile's scores (32) and its P as
//   wgmma A fragments (16) stay in registers.  A producer warp would make
//   it 288 threads, which the card allocates as 384: ptxas then holds a
//   thread to 168 registers, spills and issues each product alone.
// * The cache comes in pairs of 64-position tiles of [ckv | krope], tile
//   2p into buffer 0 and 2p + 1 into buffer 1, by TMA (a box of 64 columns
//   a 128-byte swizzle row, the rope columns one more box).  Q (64 x 576,
//   72 KB at DeepSeek's widths, copied once from q_lat and q_rope through
//   their strides, every 16-byte cp.async in flight at once) and the two
//   buffers (72 KB each) fill 222,784 of the 232,448 bytes a CTA may have,
//   so there is no third buffer: each buffer is refilled in two groups of
//   boxes, each on its own mbarrier, as soon as the products that read the
//   group are done (one thread of the warpgroup that finishes them issues
//   the loads), and a warpgroup scores the group that comes back first
//   first.  Latent widths are padded to a multiple of 128 and the rope
//   width to 64: boxes wholly past the width are zeroed once and never
//   loaded, and the TMA zero-fills the columns past the width inside a box
//   and the rows past T.
// * Warpgroup s scores tile 2p + s against all 64 rows, S = Q K^T on wgmma
//   (m64n64k16, Q and K in shared memory, both K-major, 36 steps over the
//   576-wide depth), and owns output columns [R/2 s, R/2 (s + 1)).  The
//   order follows FlashMLA's "seesaw" (DeepSeek, 2025): warpgroup 0 takes
//   tile 2p's softmax from the running max (m0 = max(m, rowmax S0), P0 =
//   2^(S0 - m0), a0 = 2^(m - m0)), publishes m0, a0 and P0 (P overwriting
//   the tile's rope box, whose scores are done: the same 64 x 64 bf16 in
//   the same swizzle) and starts O0 = O0 a0 + P0 V0 with P0 from registers;
//   warpgroup 1 starts O1 = O1 a0 + P0 V0 with P0 from shared memory and,
//   under that product, takes tile 2p + 1's softmax from m0 (m1, P1, a1),
//   publishes them and adds O1 = O1 a1 + P1 V1 from registers; warpgroup 0
//   then adds O0 = O0 a1 + P1 V1 from shared memory.  Each P is shared at
//   its own max and both halves apply a0 then a1, so the halves agree, and
//   buffer 0 is read to its end early in the pair: tile 2p + 2 loads under
//   the pair's second half.  At R 512 each P·V step is one m64n256k16 (A
//   sent once for the four boxes).  Only warpgroup 0 issues the next
//   pair's scores before it waits for its last product: warpgroup 1's next
//   tile lands in buffer 1, which is reloaded only after its P1 V1, so its
//   scores wait for that load.  A chunk with an odd number of tiles gives
//   its last tile to warpgroup 0 alone.
// * What bounds it (H100, PERF.md): at decode_32k's share the loads alone
//   (the products removed) take 0.145 ms of its 0.164 and the products and
//   softmax alone 0.127.  Each cache tile goes to the CTAs of both row
//   tiles of a token; with two buffers the pair's second tile is reloaded
//   only after its last product, so the next pair's odd tile waits for its
//   load; the scores' m64n64k16 steps read both operands from shared memory
//   (4 KB a step, the SM's 128 bytes a cycle at the tensor cores' rate),
//   and a softmax waits for the other warpgroup's max.
// * Masks as JAX's: key t of a row at position p in slot b is visible when
//   t <= p and t < kv_len[b]; a masked logit is the finite -1e30, so a row
//   whose every key is masked comes out as the mean of the latents with no
//   special case.  Keys past T (a ragged tile's TMA fill) are excluded.  A
//   CTA whose rows each see some key reads only positions below the
//   largest visible end of its rows (a prompt pass skips the tiles above
//   its diagonal; a decode step the slots' unwritten tail); one with a
//   fully masked row reads all T.  The limits are read on the device: the
//   plan depends on shapes alone, and a captured CUDA graph stays valid as
//   the offsets advance.  A prompt pass's last tokens see the most tiles,
//   so blockIdx.x runs over the row tiles from the last: the longest CTAs
//   start first and the short ones fill the wave's tail.
// * The split over positions.  A served decode step has only B x N / 64
//   row tiles (8 for 4 slots at 128 heads) for 132 SMs, so kernel.py's plan
//   splits the positions into chunks of whole pairs of tiles (one tile for
//   each warpgroup to score), one CTA a (row tile, chunk).  A CTA takes 218 KB of shared memory, one an SM, so a cluster
//   combine in distributed shared memory would cap the split by the
//   clusters a GPC holds at once; instead each CTA writes its float32 row
//   sums, max and sum of exponentials, and a second kernel, latent_combine,
//   weighs the splits in order into the output: two kernels a call.  A plan
//   of one split (a prompt pass) normalises and writes the output itself:
//   one kernel a call.  Every sum has a fixed order, so bits repeat.
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
constexpr int BOX_BYTES = 64 * 128;       // one box of 64 rows: Q, K and P alike
constexpr int THREADS = 256;              // two warpgroups, no producer warp
constexpr int STAGES = 2;                 // the two tile buffers
constexpr int MAX_SPLIT = 256;            // the combine's weights in shared memory
constexpr int FR = 16;                    // float32: query rows a CTA
constexpr int FK = 32;                    // float32: key positions a tile
constexpr int F_THREADS = 128;
constexpr int COMBINE_THREADS = 128;
constexpr long long NO_ROW = -(1LL << 62);  // the position of a padding row
// named barriers (0 is __syncthreads): warpgroup 0's and warpgroup 1's own
constexpr int BAR_WG = 1;

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
  int B, S, N, T, R, Rr, split, chunk, row_tiles;
  float scale;
};

// bf16 shared memory, in bytes from its start: the Q tile and the two tile
// buffers (KB boxes of 64 rows each: the latent padded to 128 NCH columns,
// then the rope box), the row exchange (each buffer's tile's max and
// rescale, then the two warpgroups' row sums: 64 floats each), three
// mbarriers a buffer (its two groups of boxes landed; its tile's max,
// rescale and P published) and the CTA's visible limit.  kernel.py's
// smem_bytes is the same formula.
struct Layout {
  int stage, buf, xch, bars, limit, total;
};

__host__ __device__ inline Layout layout_bf16(int nch) {
  const int kb = 2 * nch + 1;
  Layout l;
  l.stage = kb * BOX_BYTES;
  l.buf = l.stage;                                     // after Q
  l.xch = l.buf + STAGES * l.stage;
  l.bars = l.xch + 6 * MT * 4;
  l.limit = l.bars + 8 * 3 * STAGES;
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
// bf16: two warpgroups on wgmma in a seesaw over pairs of TMA-fed tiles
// ---------------------------------------------------------------------------

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

// d (64 x 256, four 64-column boxes) += A (64 x 16, shared, K-major) * B (16 x 256, shared,
// MN-major: four boxes LBO apart)
__device__ __forceinline__ void wgmma_n256_mn(float (&d)[4][32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]), "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]), "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]), "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]),
        "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]), "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]),
        "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]), "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]), "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256) += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[4][32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]), "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]), "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]), "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]),
        "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]), "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]),
        "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]), "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]), "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the byte of 8 bf16 columns (chunk j = col / 8 of a 64-column box) of row
// `row` in a 128-byte-swizzled box of 128-byte rows
__device__ __forceinline__ uint32_t swz(int row, int j) {
  return row * 128 + ((j ^ (row & 7)) << 4);
}

struct Maps {
  CUtensorMap ckv, krope;
};

// One group of a buffer's boxes for the tile at position t0: the latent
// boxes of half `half`, [half NCH, (half + 1) NCH), those below `boxes`
// (the ones the latent's width reaches), and with `rope` the rope box;
// completing on `bar`.  One thread calls it.
template <int NCH>
__device__ __forceinline__ void load_group(const Maps& maps, uint32_t buf, uint32_t bar, int half,
                                           bool rope, int boxes, int t0, int b) {
  int n = rope ? 1 : 0;
#pragma unroll
  for (int c = half * NCH; c < (half + 1) * NCH; ++c) n += c < boxes;
  mbar_expect_tx(bar, n * BOX_BYTES);
#pragma unroll
  for (int c = half * NCH; c < (half + 1) * NCH; ++c)
    if (c < boxes) tma_load3(buf + c * BOX_BYTES, &maps.ckv, c * BOX, t0, b, bar);
  if (rope) tma_load3(buf + 2 * NCH * BOX_BYTES, &maps.krope, 0, t0, b, bar);
}

// S (+)= Q K^T over the depth of boxes [c0, c1) of Q and of the K tile in
// `buf` (64 x 64 on m64n64k16, both K-major); the first step overwrites S
// when `fresh`.
__device__ __forceinline__ void score_boxes(float (&s)[32], uint32_t sQ, uint32_t buf, int c0,
                                            int c1, bool fresh) {
#pragma unroll
  for (int c = c0; c < c1; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64>(s, make_desc(sQ + c * BOX_BYTES + kk * 32, 16, 1024, 1),
                   make_desc(buf + c * BOX_BYTES + kk * 32, 16, 1024, 1),
                   fresh && c == c0 && kk == 0 ? 0 : 1);
}

// O (+)= P V over a warpgroup's NCH boxes of output columns, from box c0 of
// the tile in `buf` (V MN-major), P (64 x 64) as A fragments in registers.
// At R 512 one m64n256k16 a step takes the four boxes (B's boxes LBO
// apart), so A is sent once, not four times.
template <int NCH>
__device__ __forceinline__ void pv_registers(float (&acc)[NCH][32], const uint32_t (&pa)[4][4],
                                             uint32_t buf, int c0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NCH == 4) {
      wgmma_rs_n256(acc, pa[kk],
                    make_desc(buf + c0 * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024, 1));
    } else {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        wgmma_rs<64>(acc[c], pa[kk],
                     make_desc(buf + (c0 + c) * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024, 1));
    }
  }
}

// the same with P from the swizzled box at `p_box` (K-major), read once a
// step at R 512
template <int NCH>
__device__ __forceinline__ void pv_shared(float (&acc)[NCH][32], uint32_t p_box, uint32_t buf,
                                          int c0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NCH == 4) {
      wgmma_n256_mn(acc, make_desc(p_box + kk * 32, 16, 1024, 1),
                    make_desc(buf + c0 * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024, 1));
    } else {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        wgmma_n64_mn(acc[c], make_desc(p_box + kk * 32, 16, 1024, 1),
                     make_desc(buf + (c0 + c) * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024, 1));
    }
  }
}

// A 64 x 64 P held as wgmma A fragments (pack_a<8>: a[kk] keys 16 kk ..
// 16 kk + 15) into a swizzled 64 x 64 bf16 box, the layout wgmma reads as a
// K-major A: fragment register e of a[kk] holds row 16 wl + g + 8 (e & 1),
// keys 16 kk + 8 (e >> 1) + 2 t4 and one more.
__device__ __forceinline__ void store_p(unsigned char* box, const uint32_t (&a)[4][4], int wl,
                                        int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(box + swz(16 * wl + g + 8 * (e & 1), 2 * kk + (e >> 1)) +
                                   4 * t4) = a[kk][e];
}

// Scale a 64 x 64 score tile to log2 units and mask it, and leave each
// row's max in mx.  Element 4q + e is row r0 + 8 (e >> 1), key 8 q + 2 t4 +
// (e & 1) of the tile; a row sees its first lim_r keys, the cache holds the
// first lim_t (masked keys take -1e30, keys past the cache -inf).
__device__ __forceinline__ void mask_scores(float (&s)[32], float (&mx)[2], const int (&lim_r)[2],
                                            int lim_t, float qk_scale, int t4) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, kk = 8 * q + 2 * t4 + (e & 1);
      float x = s[4 * q + e] * qk_scale;
      if (kk >= lim_r[h]) x = kk < lim_t ? NEG_INF : -INFINITY;
      s[4 * q + e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

// P = 2^(S - m) of a masked score tile (m -inf: every key past the cache,
// taken as 0) and each row's sum of P, before any rounding
__device__ __forceinline__ void exponentiate(float (&s)[32], float (&sum)[2], const float (&m)[2]) {
  const float mu[2] = {m[0] == -INFINITY ? 0.f : m[0], m[1] == -INFINITY ? 0.f : m[1]};
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - mu[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
}

template <int NCH>
__device__ __forceinline__ void scale_rows(float (&acc)[NCH][32], float a0, float a1) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc[c][4 * q] *= a0;
      acc[c][4 * q + 1] *= a0;
      acc[c][4 * q + 2] *= a1;
      acc[c][4 * q + 3] *= a1;
    }
}

template <int NCH>
__device__ __forceinline__ void fence_acc(float (&acc)[NCH][32]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_regs(acc[c]);
}

// One CTA: grid (row tiles, split, B).  Rows rt*64 .. rt*64 + 63 of batch
// row b (the flattened (token, head) index), rt = row tiles - 1 - blockIdx.x
// (the heaviest first), over the positions [k chunk, (k + 1) chunk) of split
// k, cut at the CTA's visible limit.
template <int NCH>
__global__ void __launch_bounds__(THREADS, 1)
    latent_attention_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int KB = 2 * NCH + 1;         // boxes of a Q or K row; the last is the rope box
  constexpr int ROPE = KB - 1;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout lay = layout_bf16(NCH);
  const uint32_t base = smem_u32(smem);
  if (base & 1023u) __trap();
  const uint32_t sQ = base, bars = base + lay.bars;
  const uint32_t buf0 = base + lay.buf, buf1 = buf0 + lay.stage;
  float* sM = reinterpret_cast<float*>(smem + lay.xch);    // [2][64]: m0, m1 of the pair
  float* sA = sM + 2 * MT;                                   // [2][64]: their rescales a0, a1
  float* sL = sM + 4 * MT;                                   // [2][64]: each warpgroup's row sums
  int* lim = reinterpret_cast<int*>(smem + lay.limit);

  const int rt = p.row_tiles - 1 - (int)blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warpgroup as a value ptxas knows is the same across a warp (a
  // branch on threadIdx is divergent to it, and it then serializes every
  // wgmma behind fences of its own)
  const int j = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const long long r_first = (long long)rt * MT;
  // buffer s's group grp has landed (grp 0: the latent half of warpgroup s,
  // which scores the buffer's tile; grp 1: the other half and the rope box);
  // warpgroup s has published its tile's max, rescale and P
  auto full = [&](int s, int grp) { return bars + 8 * (2 * s + grp); };
  auto pub = [&](int s) { return bars + 8 * (2 * STAGES + s); };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s, 0), 1);
      mbar_init(full(s, 1), 1);
      mbar_init(pub(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *lim = 0;
  }
  __syncthreads();
  reduce_limit(p, b, r_first, MT, lim);
  __syncthreads();
  const int limit = __shfl_sync(0xffffffffu, *lim, 0);   // uniform, as j
  const int start = k * p.chunk;
  const int end = start + p.chunk < limit ? start + p.chunk : limit;
  const int tiles = end > start ? (end - start + TK - 1) / TK : 0;
  const int boxes = (p.R + BOX - 1) / BOX;             // latent boxes the TMA loads

  // tile i of the chunk goes to buffer i & 1, in its two groups of boxes
  auto load = [&](int i, int grp) {
    const int s = i & 1;
    load_group<NCH>(maps, s ? buf1 : buf0, full(s, grp), grp == 0 ? s : 1 - s, grp == 1, boxes,
                    start + i * TK, b);
  };
  if (tid == 0 && tiles > 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.ckv)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.krope)) : "memory");
    for (int i = 0; i < STAGES && i < tiles; ++i) {
      load(i, 0);
      load(i, 1);
    }
  }

  const unsigned short* ql = static_cast<const unsigned short*>(p.q_lat);
  const unsigned short* qr = static_cast<const unsigned short*>(p.q_rope);
  // Q (64 x (RP + 64), swizzled boxes) from q_lat and q_rope, 16 bytes a
  // thread a copy, all in flight at once (cp.async; a copy of 0 source
  // bytes writes zeros): columns past R or Rr and rows past S N are zeros.
  // Both buffers' boxes past the latent's loaded width are zeroed once.
  for (int i = tid; i < MT * KB * 8; i += THREADS) {
    const int r = i / (KB * 8), rest = i - r * (KB * 8), c = rest >> 3, ch = rest & 7;
    const long long rr = r_first + r;
    const unsigned short* src = ql;
    int bytes = 0;
    if (rr < (long long)p.S * p.N) {
      const int s = (int)(rr / p.N), n = (int)(rr - (long long)s * p.N);
      if (c < ROPE) {
        const int col = c * BOX + 8 * ch;
        src = ql + b * p.ql_s[0] + s * p.ql_s[1] + n * p.ql_s[2] + col;
        bytes = col < p.R ? 16 : 0;
      } else {
        src = qr + b * p.qr_s[0] + s * p.qr_s[1] + n * p.qr_s[2] + 8 * ch;
        bytes = 8 * ch < p.Rr ? 16 : 0;
      }
      if (bytes == 0) src = ql;
    }
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sQ + c * BOX_BYTES +
                                                                          swz(r, ch)),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  {
    const int per = (ROPE - boxes) * BOX_BYTES / 16;   // per buffer
    for (int i = tid; i < STAGES * per; i += THREADS) {
      const int st = i / per, off = (i - st * per) * 16;
      *reinterpret_cast<uint4*>(smem + lay.buf + st * lay.stage + boxes * BOX_BYTES + off) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  fence_async_shared();
  __syncthreads();

  // this thread's rows, in either warpgroup: 16 wl + g and + 8 of the tile,
  // and the positions each sees, [0, vis_end)
  const int r0 = 16 * wl + g;
  long long vis_end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long qp = row_position(p, b, r_first + r0 + 8 * h);
    vis_end[h] = qp == NO_ROW ? 0 : visible_end(p, b, qp);
  }
  const float qk_scale = p.scale * LOG2E;
  // warpgroup j: its own tile's buffer and the other, its latent half's first
  // box and the other half's, the thread that issues its loads
  const uint32_t own = j ? buf1 : buf0, other = j ? buf0 : buf1;
  const int c_own = j * NCH, c_other = (1 - j) * NCH;
  const bool leader = (tid & 127) == 0;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  const int pairs = (tiles + 1) / 2;

  // the scores of tile i (warpgroup i & 1's): score_tile issues and commits
  // its own half's boxes once they have landed and returns the barriers'
  // parity; score_rest the other half's and the rope box
  auto score_tile = [&](int i) {
    const int par = (i >> 1) & 1;
    wgmma_fence();
    mbar_wait(full(j, 0), par);
    score_boxes(sc, sQ, own, c_own, c_own + NCH, true);
    wgmma_commit();
    return par;
  };
  auto score_rest = [&](int par) {
    mbar_wait(full(j, 1), par);
    score_boxes(sc, sQ, own, c_other, c_other + NCH, false);
    score_boxes(sc, sQ, own, ROPE, KB, false);
    wgmma_commit();
  };
  // this warpgroup's reads of group grp of tile i's buffer are done (it has
  // waited for them): load tile i + 2 there
  auto release = [&](int i, int grp) {
    if (i + 2 < tiles) {
      bar_sync(BAR_WG + j, 128);
      if (leader) load(i + 2, grp);
    }
  };
  // the masks of tile i's rows, and its softmax from the running max m:
  // m_new, the rescale of what came before, P = 2^(S - m_new) as A fragments,
  // each row's sum of P; then P, m_new and the rescale published for the
  // other warpgroup (P into the tile's rope box, whose scores are done)
  auto softmax = [&](int i, const float (&mx)[2], float (&a)[2], float (&sum)[2]) {
    float m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_run[h], mx[h]);
      a[h] = m_run[h] == -INFINITY ? 0.f : ex2(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
    }
    exponentiate(sc, sum, m_new);
    pack_a<8>(pa, sc);
    store_p(smem + lay.buf + (i & 1) * lay.stage + ROPE * BOX_BYTES, pa, wl, g, t4);
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sM[(i & 1) * MT + r0 + 8 * h] = m_new[h];
        sA[(i & 1) * MT + r0 + 8 * h] = a[h];
      }
    }
    fence_async_shared();
    mbar_arrive(pub(i & 1));
  };
  auto mask = [&](int i, float (&mx)[2]) {
    const long long t0 = (long long)start + (long long)i * TK;
    int lim_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long v = vis_end[h] - t0;
      lim_r[h] = v < 0 ? 0 : (v > TK ? TK : (int)v);
    }
    mask_scores(sc, mx, lim_r, p.T - t0 < TK ? (int)(p.T - t0) : TK, qk_scale, t4);
  };
  // the other warpgroup's m and rescale of tile i
  auto take = [&](int i, float (&a)[2]) {
    mbar_wait(pub(i & 1), (i >> 1) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[h] = sM[(i & 1) * MT + r0 + 8 * h];
      a[h] = sA[(i & 1) * MT + r0 + 8 * h];
    }
  };
  // O *= a, row by row
  auto rescale = [&](const float (&a)[2]) { scale_rows<NCH>(acc, a[0], a[1]); };

  if (j < tiles) {
    score_rest(score_tile(j));
    wgmma_wait<0>();
    fence_regs(sc);
  }

  for (int pr = 0; pr < pairs; ++pr) {
    const int i0 = 2 * pr, i1 = i0 + 1;
    const bool has1 = i1 < tiles;
    float mx[2], a[2], sum[2];
    if (j == 0) {
      // ---- warpgroup 0: tile i0's softmax from the running max ----
      mask(i0, mx);
      softmax(i0, mx, a, sum);
      rescale(a);
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * a[h] + sum[h];
      // O_0 += P0 V0 (this half's columns), P0 from registers
      wgmma_fence();
      pv_registers<NCH>(acc, pa, own, c_own);
      wgmma_commit();
      if (has1) take(i1, a);
      wgmma_wait<0>();
      fence_acc<NCH>(acc);
      fence_regs(pa);
      release(i0, 0);                                  // this half of tile i0 is read
      if (has1) {
        // O_0 = O_0 a1 + P1 V1, P1 from the rope box of tile i1
        rescale(a);
#pragma unroll
        for (int h = 0; h < 2; ++h) l_run[h] *= a[h];
        wgmma_fence();
        pv_shared<NCH>(acc, other + ROPE * BOX_BYTES, other, c_own);
        wgmma_commit();
      }
      if (i0 + 2 < tiles) {
        // the next pair's scores, under this pair's last product
        const int next = score_tile(i0 + 2);
        wgmma_wait<1>();
        fence_acc<NCH>(acc);
        release(i1, 1);                                // tile i1's other half and P1 are read
        score_rest(next);
        wgmma_wait<0>();
        fence_regs(sc);
      } else {
        wgmma_wait<0>();
      }
      fence_acc<NCH>(acc);
    } else {
      // ---- warpgroup 1: P0 into this half, then tile i1's softmax from m0 ----
      mx[0] = mx[1] = -INFINITY;
      if (has1) mask(i1, mx);
      take(i0, a);
      rescale(a);
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] *= a[h];
      // O_1 = O_1 a0 + P0 V0, P0 from the rope box of tile i0
      wgmma_fence();
      pv_shared<NCH>(acc, other + ROPE * BOX_BYTES, other, c_own);
      wgmma_commit();
      if (has1) softmax(i1, mx, a, sum);
      wgmma_wait<0>();
      fence_acc<NCH>(acc);
      release(i0, 1);                                  // tile i0's other half and P0 are read
      if (has1) {
        // O_1 = O_1 a1 + P1 V1 (this half's columns), P1 from registers
        rescale(a);
#pragma unroll
        for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * a[h] + sum[h];
        wgmma_fence();
        pv_registers<NCH>(acc, pa, own, c_own);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<NCH>(acc);
        fence_regs(pa);
        release(i1, 0);                                // this half of tile i1 is read
        if (i1 + 2 < tiles) {
          score_rest(score_tile(i1 + 2));
          wgmma_wait<0>();
          fence_regs(sc);
        }
      }
    }
  }

  // the two warpgroups' row sums, in order
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) sL[j * MT + 16 * wl + g + 8 * h] = l_run[h];
  }
  __syncthreads();
  float l_tot[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * wl + g + 8 * h;
    l_tot[h] = sL[row] + sL[MT + row];
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
          const int col = (c_own + c) * BOX + 8 * q + 2 * t4;
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
          const int col = (c_own + c) * BOX + 8 * q + 2 * t4;
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
// block a partial row; a padding row returns.  The loops over the splits
// are unrolled by 8 so that their loads are in flight together: at the
// served decode each is a round trip to L2 the block would otherwise wait
// for in turn (a rolled loop took 7.2 of the call's 25 us on an H100).
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
#pragma unroll 8
    for (int k = 0; k < p.split; ++k) M = fmaxf(M, p.ml_part[2 * (k * P + prow)]);
    float L = 0.f;
#pragma unroll 8
    for (int k = 0; k < p.split; ++k) {
      const float2 ml = *reinterpret_cast<const float2*>(p.ml_part + 2 * (k * P + prow));
      const float wk = ml.x == -INFINITY ? 0.f : ex2(ml.x - M);
      w[k] = wk;
      L = fmaf(wk, ml.y, L);
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
#pragma unroll 8
    for (int k = 0; k < p.split; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(p.o_part + (k * P + prow) * p.R + col);
      if (w[k] == 0.f) continue;
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
// int64 at b kvl_b.  The plan (rows, split, chunk, smem) is
// kernel.py's choose_launch; with split > 1, o_part and ml_part are its
// float32 scratch and latent_combine runs after.  Returns the first
// launch error (0 on success), cudaErrorInvalidValue for a plan it cannot
// run, 9000 / 9001 when a tensor map cannot be built.
extern "C" int latent_attention(const void* q_lat, const void* q_rope, const void* ckv,
                                const void* krope, void* out, float* o_part, float* ml_part,
                                const long long* positions, const long long* kv_len,
                                const long long* strides, long long pos_b, long long pos_s,
                                long long kvl_b, int is_bf16, int B, int S, int N, int T, int R,
                                int Rr, int rows, int split, int chunk, int smem,
                                float scale, void* stream) {
  const int nch = (R + 127) / 128;
  const long long M = (long long)S * N;
  const int row_tiles = (int)((M + rows - 1) / rows);
  if (R < 16 || R > 512 || R % 16 || Rr < 16 || Rr > 64 || Rr % 16 || rows != (is_bf16 ? MT : FR) ||
      split < 1 || split > MAX_SPLIT || chunk < 1 || (is_bf16 && chunk % (split > 1 ? 2 * TK : TK)) ||
      (long long)(split - 1) * chunk >= T || (long long)split * chunk < T ||
      (split > 1 && (!is_bf16 || o_part == nullptr || ml_part == nullptr)) ||
      smem != (is_bf16 ? layout_bf16(nch).total : f32_smem_bytes(R + Rr)))
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
  p.split = split; p.chunk = chunk; p.row_tiles = row_tiles;
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
