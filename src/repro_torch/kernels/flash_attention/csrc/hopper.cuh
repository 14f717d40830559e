// Hopper (sm_90a) building blocks shared by the port's kernels (B1's
// forward and backward, B2, B3, B6, B7): mbarriers, TMA loads from tensor
// maps built on the host, named barriers and the async-proxy fence, wgmma
// descriptors and the m64nNk16 bf16 products, and the host-side helpers
// that opt a kernel into large shared memory and encode a tensor map.  Each
// .cu file includes it once; build.py hashes it with the file, so an edit
// rebuilds every library that includes it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // elements
};

// The width of a bf16 CTA's tiles for head dim hd: hd, or 128 for hd 80
// (its columns past 80 zero-filled by the TMA).
constexpr int padded_hd(int hd) { return hd == 80 ? 128 : hd; }

// One tensor-map box spans COLS bf16 columns: a 128-byte swizzle row (64
// columns), or 64 bytes for hd 32; hd 128 (and hd 80, padded to 128) takes
// two boxes side by side.
template <int HD>
struct Swz {
  static constexpr int HDP = padded_hd(HD);
  static constexpr int COLS = HD < 64 ? HD : 64;
  static constexpr int BYTES = 2 * COLS;
  static constexpr int CHUNKS = HDP / COLS;
  static constexpr uint64_t LAYOUT = BYTES == 128 ? 1 : 2;  // descriptor: B128 / B64
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed.  A lost arrival
// fails the launch (illegal instruction) after two seconds of waiting, far
// past any wait of a healthy launch, instead of spinning forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long since = 0;
  for (uint32_t tries = 1;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries % 1024 == 0) {
      long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (since == 0) since = now;
      else if (now - since > 2000000000LL) __trap();
    }
  }
}

// 4-d TMA load of box {c, s, h, b} into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int s,
                                         int h, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(s), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// 3-d TMA load of box {c0, c1, c2} into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// named barrier `id` over `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// arrive on named barrier `id` over `n` threads without waiting: the
// threads that bar_sync on it see this thread's earlier writes
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// generic-proxy writes to shared memory, made visible to the async proxy
// (wgmma's and the TMA's reads)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the CHUNKS boxes of one ROWS x HDP tile at sequence position s of (h, b)
template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int s, int h,
                                         int b, uint32_t bar) {
  using W = Swz<HD>;
#pragma unroll
  for (int c = 0; c < W::CHUNKS; ++c)
    tma_load(dst + c * ROWS * W::BYTES, map, c * W::COLS, s, h, b, bar);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// The descriptor of k-step kc (16 columns) of a ROWS x HDP tile at `tile`,
// read K-major (the head dim is the product's depth).
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kc) {
  using W = Swz<HD>;
  const int c = kc * 16 / W::COLS, off = (kc * 16 % W::COLS) * 2;
  return make_desc(tile + c * ROWS * W::BYTES + off, 16, 8 * W::BYTES, W::LAYOUT);
}

// The descriptor of k-step kc (16 rows) of a ROWS x HDP tile at `tile`,
// read MN-major (the rows are the product's depth, the head dim its N):
// 8-row groups 8 swizzle rows apart (SBO), 64-column chunks a box apart (LBO)
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kc) {
  using W = Swz<HD>;
  return make_desc(tile + kc * 16 * W::BYTES, ROWS * W::BYTES, 8 * W::BYTES, W::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of `r` across a wgmma, and keeps
// registers an asynchronous wgmma reads from being reused before it ends
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit (relative error ~2^-22; exp2f's
// accurate path costs a quarter of the forward's time); 2^(-1e30) = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A 64 x (8 * NJ) float accumulator (element 4j + e: row g + 8 (e >> 1),
// column 8j + 2 t4 + (e & 1)) rounded to bf16 A fragments of the next
// product, whose depth is those columns: 16 columns per fragment.
template <int NJ>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NJ / 2][4], const float (&acc)[4 * NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a[j / 2][2 * (j & 1)] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    a[j / 2][2 * (j & 1) + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The same accumulator as a pair of bf16 A fragments, hi = bf16(x) and
// lo = bf16(x - hi): a product over both keeps x to about 16 bits, where a
// single bf16 keeps 8.
template <int NJ>
__device__ __forceinline__ void split_a(uint32_t (&a)[2][NJ / 2][4],
                                        const float (&acc)[4 * NJ]) {
  float lo[4 * NJ];
#pragma unroll
  for (int i = 0; i < 4 * NJ; ++i) lo[i] = acc[i] - __bfloat162float(__float2bfloat16(acc[i]));
  pack_a<NJ>(a[0], acc);
  pack_a<NJ>(a[1], lo);
}

// d (64 x N) (+)= A (64 x 16, shared, K-major) * B (16 x N, shared, K-major)
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// d (64 x N) += A (64 x 16, registers) * B (16 x N, shared, MN-major)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The K/V tiles [t0, t1) of `bkv` keys that query rows [q0, q0 + bm) see:
// none wholly above the diagonal, none wholly left of row q0's window.
__device__ __forceinline__ void kv_tile_range(int Skv, int causal, int window, int q0, int bm,
                                              int bkv, int& t0, int& t1) {
  const int kv_end = causal ? min(Skv, q0 + bm) : Skv;
  t1 = (kv_end + bkv - 1) / bkv;
  t0 = 0;
  // tile t is left of every row's window iff (t + 1) * bkv <= q0 - window + 1
  if (window > 0 && q0 - window + 1 > 0) t0 = (q0 - window + 1) / bkv;
  if (t0 > t1) t0 = t1;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// above 48 KB only as opted-in dynamic shared memory, once per kernel and
// device.  The attribute is set outside stream capture only: the first call
// of every instantiation comes from an eager warm-up before any capture.
// `ready_on` is the caller's record of the device the kernel was opted in on.
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once in the libcuda the
// runtime has loaded (so the library needs no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Error codes of the entry points past cudaError_t's range: the tensor map
// could not be built (the wrappers' choosers refuse such layouts first).
constexpr int ERR_NO_ENCODER = 9000;
constexpr int ERR_ENCODE = 9001;

// the 4-d map (hd, seq, heads, batch) of a bf16 tensor, boxes of `rows`
// rows by one swizzle row of columns; for hd 80 the second box reaches past
// the row, and the TMA fills columns 80-127 with zeros (rows past S too)
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, const Strides& st,
             int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  using W = Swz<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)W::COLS, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      W::BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

}  // namespace
