// Forward flash attention for Hopper (sm_90a), bf16 in and out: both
// products on the tensor cores (wgmma, fp32 accumulation), K and V staged
// by TMA into a ring of shared-memory stages.
//
// Replaces, for bf16 inputs: src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas, the TPU kernel that the LLM tier's prefill and
// forward run per layer. fp32 inputs keep the SIMT kernel of
// flash_attention.cu, which holds the reference's 2e-5 fp32 bar.
//
// What it computes, for q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), each given
// by its strides over (b, h, s) with hd contiguous:
//   s_ij = softcap(q_i . k_j / sqrt(hd))     (softcap(x) = c * tanh(x / c), c > 0)
//   visible(i, j) = j < Sk  and (not causal or j <= i + q_offset)
//                   and (window <= 0 or j > i + q_offset - window)
//   o_i = sum_j softmax_j(s_ij over visible j) v_j,  and o_i = 0 when no key
//         is visible (the Pallas kernel's l == 0 guard).
// Query head h reads key/value head h / (H / KV) (GQA, MQA at KV = 1).
//
// Bound on an H100 SXM: 4 * hd flops per visible (query, key) pair against
// reading q, k, v once and writing o once. At the llama3.2-1b prefill shape
// (B=4, H=32, S=2048, hd=64, causal) that is 68.7 GFLOP on 84 MB, so the
// tensor cores bound it (989 TFLOP/s bf16): 0.069 ms. At hd = 64 the
// softmax's exponentials (16 a clock per SM) cost as much time as the two
// products, so the ideal kernel overlaps them.
//
// Design. A block owns BQ = 128 query rows of one (b, h): two consumer
// warpgroups of 64 rows each and one producer warpgroup (384 threads, one
// block per SM, 168 registers a thread at launch). The producer warpgroup
// gives registers back (setmaxnreg.dec to 24) and the consumers take them
// (setmaxnreg.inc to 240): 128 x 144 = 256 x 72, so the block's budget
// balances; `inc` waits for registers the block has released, so a
// smaller producer would stall it for good. At hd 256 the consumers need
// the 240 (O alone is 128 registers).
//
// The producer's thread 0 loads the Q tile once, then each key tile's K and
// V by TMA into two rings of STAGES stages, each stage with a `full`
// mbarrier (expect-tx) and an `empty` one (256 consumer arrivals). K and V
// ride separate rings because a K tile is done with after S, its V tile
// only a turn later. The tensor maps are 4-D over (hd, heads, S, B) with
// the tensors' own strides, so the model layout (B, S, H, hd) is read
// without a copy; a box is 64 columns (the 128-byte swizzle span) by BK
// rows of one head, and rows past S come back as zeros.
//
// Each consumer warpgroup, per key tile:
//   S = Q K^T    wgmma m64nBKk16, A = its 64 Q rows and B = the K tile, both
//                K-major from shared memory (128-byte swizzle);
//   softmax      online, in the log2 domain (ex2 of one FMA), statistics m
//                and l in fp32 registers, rows reduced over the quad of
//                lanes that holds them; the mask is applied only on tiles
//                it cuts (the diagonal, the window edge, the Sk tail);
//   O += P V     wgmma m64nHDk16 with P as the register A operand: the fp32
//                S fragment, rounded to bf16 and paired, is exactly the A
//                fragment, so P never touches shared memory; V is the B
//                operand in MN-major form (hd contiguous, transpose bit).
// A turn issues S of tile i together with P.V of tile i - 1, and the
// softmax of S_i runs while that P.V is on the tensor cores. The two
// warpgroups take turns at issuing (two named barriers), so one's
// products run during the other's softmax; started together they would
// multiply together and then both wait on the exponentials. Only key tiles
// that some row of the block can see are loaded; a warpgroup issues no
// product for a tile none of its rows sees. Query tiles are scheduled
// last-first so that the longest causal tiles start first. The softcap
// uses an exp2-based tanh accurate to ~1e-7 (tanh.approx's 2^-11 would
// move logits near a cap of 50 by 0.02). The output leaves the accumulator
// as bf16 pairs, in q's layout.
//
// Tiles: BK = 128 keys for hd 64 and 128, BK = 64 for hd 256 (its O
// accumulator alone is 128 fp32 registers a thread); stages: 4 at hd 64,
// 2 at hd 128 and 256 (shared memory 145, 161 and 193 KiB).

#include <cuda.h>            // CUtensorMap and its enums; the encoder is
                             // fetched at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                  // query rows per block
constexpr int WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and one producer warpgroup
constexpr int PRODUCER_REGS = 24;        // registers a thread after
constexpr int CONSUMER_REGS = 240;       // setmaxnreg: 128 x 24 + 256 x 240
                                         // = 384 x 168, the launch budget
constexpr int ROW_BYTES = 128;           // one 64-column bf16 row of a box
// error codes of our own, negative: CUDA's errors are positive
constexpr int ENCODER_MISSING = -1;      // cuTensorMapEncodeTiled not found
constexpr int ENCODE_FAILED = -1000;     // - its CUresult when it fails

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;
  static constexpr int STAGES = HD == 64 ? 4 : 2;
  static constexpr int BOXES = HD / 64;              // boxes across hd
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;       // one K or V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // + the barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 4 * STAGES) + 1024;
};

struct Params {
  void* o;
  long long os[3];         // o's strides over (b, h, s), elements
  int G, Sq, Sk, causal, window, q_offset;
  float softcap;
  float c_scale;           // log2(e) / sqrt(hd): logits in log2 units
  float c_in, c_out;       // with softcap: c_out * tanh(s * c_in)
};

enum TileKind { SKIP = 0, FULL = 1, MASKED = 2 };

// The keys [lo, hi] that some row of [r_lo, r_hi] sees (none when lo > hi).
// Each row sees a contiguous run that slides with the row, so their union
// is contiguous too. kernel.py's tile_kinds mirrors this and tile_kind,
// and its CPU tests check the mirror: change both together.
__device__ __forceinline__ void visible_keys(const Params& p, int r_lo,
                                             int r_hi, int& lo, int& hi) {
  lo = p.window > 0 ? max(0, r_lo + p.q_offset - p.window + 1) : 0;
  hi = p.causal ? min(p.Sk - 1, r_hi + p.q_offset) : p.Sk - 1;
}

__device__ __forceinline__ int tile_kind(const Params& p, int k0, int bk,
                                         int lo, int hi, int r_lo,
                                         int r_hi) {
  const int k1 = k0 + bk - 1;
  if (k1 < lo || k0 > hi) return SKIP;
  const bool full = k1 < p.Sk && (!p.causal || k1 <= r_lo + p.q_offset) &&
                    (p.window <= 0 || k0 > r_hi + p.q_offset - p.window);
  return full ? FULL : MASKED;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that has
// not completed after 2^35 cycles (~20 s) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. K-major tiles: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO unused. MN-major (V):
// LBO = the distance between 64-column boxes, SBO = between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Named barriers over the 256 consumer threads: one warpgroup syncs, the
// other arrives.
__device__ __forceinline__ void named_sync(uint32_t id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// An A operand in registers stays untouched until its product is waited
// for: fencing it after the wait keeps it live, so its registers are not
// reused while the product runs.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (exp(2y) + 1), about 1e-7 absolute
__device__ __forceinline__ float tanh_exp2(float y) {
  const float e = ex2(fminf(y, 15.0f) * 2.8853900817779268f);
  return 1.0f - __fdividef(2.0f, e + 1.0f);
}

// two fp32 values as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---- wgmma, bf16 x bf16 -> fp32, one overload per N (the D size) ----------

// D (64 x 64, fp32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) . B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// D (64 x 256, fp32) += A (64 x 16, registers) . B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the consumer's steps ---------------------------------------------------

// S = Q K^T over hd, for one warpgroup: A = its 64 Q rows (sq_wg), B = the
// K tile of a stage (sk_s); hd / 64 boxes of 128-byte rows each.
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<HD>::BK / 2],
                                        uint32_t sq_wg, uint32_t sk_s) {
  constexpr int BK = Cfg<HD>::BK;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;     // 16 columns = 32 bytes
    const uint64_t da =
        sw128_desc(sq_wg + (kk / 4) * BQ * ROW_BYTES + col, 16, 1024);
    const uint64_t db =
        sw128_desc(sk_s + (kk / 4) * BK * ROW_BYTES + col, 16, 1024);
    wgmma_ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V over the tile's keys: P from registers, V (MN-major) from the
// stage's V tile (sv_s), its hd / 64 boxes BK rows apart (LBO).
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pa)[Cfg<HD>::BK / 16][4],
    uint32_t sv_s) {
  constexpr int BK = Cfg<HD>::BK;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_rs(o, pa[j],
             sw128_desc(sv_s + j * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
  wgmma_commit();
}

// The online softmax of one S tile (keys from k0): sc becomes the tile's
// weights 2^(s cs - m cs), m and l move on, alpha is O's rescale. Logits
// are raw (cs = log2(e) / sqrt(hd)), or already through the softcap's
// transform in log2 units (cs = 1).
template <int NS>
__device__ __forceinline__ void online_softmax(
    float (&sc)[NS], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const Params& p, int k0, int kind, int qpos0, int col0, float cs) {
  if (p.softcap > 0.0f) {
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n] = p.c_out * tanh_exp2(sc[n] * p.c_in);
  }
  if (kind == MASKED) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int qpos = qpos0 + 8 * ((n >> 1) & 1);
      const int kpos = k0 + 8 * (n >> 2) + col0 + (n & 1);
      const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos) &&
                      (p.window <= 0 || kpos > qpos - p.window);
      if (!ok) sc[n] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NS; ++n)
    mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], sc[n]);
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row that has seen no key yet keeps m = -inf: subtract 0, so its
    // masked logits give exactly 0 and nothing is NaN
    sub[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * cs;
    alpha[r] = ex2(m[r] * cs - sub[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    sc[n] = ex2(fmaf(sc[n], cs, -sub[(n >> 1) & 1]));
    l[(n >> 1) & 1] += sc[n];
  }
}

// P as the A operand: S registers 8j..8j+7 are keys 16j..16j+15, and the
// fp32 accumulator's fragment paired into bf16 is the A fragment.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&sc)[NS],
                                       uint32_t (&pa)[NS / 8][4]) {
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

// ---- the kernel ------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                  // [box][BQ rows][128 B]
  const uint32_t sk = base + C::OFF_K;       // [stage][box][BK rows][128 B]
  const uint32_t sv = base + C::OFF_V;
  // K and V ride separate rings of barriers (+ 8 * stage): a K tile is
  // done with after S, its V tile only after the next turn's P.V
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t full_k = bar_q + 8;
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;
  const uint32_t empty_v = empty_k + 8 * ST;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  // the key tiles some row of this block sees: the producer loads these
  int lo, hi;
  visible_keys(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int kt_begin = lo <= hi ? lo / BK : 0;
  const int n_tiles = lo <= hi ? hi / BK - lo / BK + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS);
      mbar_init(empty_v + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: its thread 0 issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
      const int kvh = h / p.G;
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < C::BOXES; ++c)
        tma_load_4d(sq + c * BQ * ROW_BYTES, &tq, bar_q, c * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const int k0 = (kt_begin + i) * BK;
        if (i >= ST) mbar_wait(empty_k + 8 * s, ((i / ST) - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(sk + s * C::KV_BYTES + c * BK * ROW_BYTES, &tk,
                      full_k + 8 * s, c * 64, kvh, k0, b);
        if (i >= ST) mbar_wait(empty_v + 8 * s, ((i / ST) - 1) & 1);
        mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::BOXES; ++c)
          tma_load_4d(sv + s * C::KV_BYTES + c * BK * ROW_BYTES, &tv,
                      full_v + 8 * s, c * 64, kvh, k0, b);
      }
    }
  } else {
    // ---- two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    // the warpgroup index through a shuffle from lane 0: provably uniform
    // to the compiler, so branches on what derives from it (tile kinds, the
    // pending P.V) do not serialize the wgmma
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // accumulator fragment (PTX ISA, wgmma D layout): register n of a
    // thread holds row row0 + 8 * ((n >> 1) & 1) and column
    // 8 * (n >> 2) + col0 + (n & 1) of the warpgroup's 64-row tile
    const int row0 = (t / 32) * 16 + lane / 4;
    const int col0 = (lane % 4) * 2;
    const int r_lo = q0 + wg * WG_ROWS;
    const int r_hi = min(r_lo + WG_ROWS, p.Sq) - 1;  // < r_lo: no real row
    int wlo = 0, whi = -1;
    if (r_lo <= r_hi) visible_keys(p, r_lo, r_hi, wlo, whi);
    const int qpos0 = r_lo + row0 + p.q_offset;

    float o[HD / 2];
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) o[n] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};     // this thread's share of the row sums

    // Turn i issues this warpgroup's S_i = Q K_i^T and the P.V of tile
    // i - 1, then runs the softmax of S_i while that P.V is still on the
    // tensor cores. The two warpgroups take turns (named barriers 1 and 2,
    // warpgroup 0 first), so one's products run during the other's
    // softmax. Both take n_tiles + 1 turns; the tiles a warpgroup sees are
    // the run [ta, tb), its other turns issue nothing. Every product is
    // issued outside any branch, so ptxas can tell which group a wait
    // retires.
    const uint32_t my_turn = 1 + wg, their_turn = 2 - wg;
    const int nt = n_tiles;
    int ta = nt, tb = nt;          // this warpgroup's tiles: [ta, tb)
    if (wlo <= whi) {
      ta = wlo / BK - kt_begin;
      tb = whi / BK - kt_begin + 1;
    }
    // logits in raw units; p = 2^(s cs - m cs) (the softcap's transform is
    // already in log2 units)
    const float cs = p.softcap > 0.0f ? 1.0f : p.c_scale;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];       // the previous tile's P
    float alpha[2];

    auto stage_of = [&](int i) { return i % ST; };
    // wait for tile i's K (V) to land; hand its stage back
    auto wait_k = [&](int i) {
      if (i < nt) mbar_wait(full_k + 8 * stage_of(i), (i / ST) & 1);
    };
    auto wait_v = [&](int i) {
      if (i < nt) mbar_wait(full_v + 8 * stage_of(i), (i / ST) & 1);
    };
    auto release_k = [&](int i) {
      if (i < nt) mbar_arrive(empty_k + 8 * stage_of(i));
    };
    auto release_v = [&](int i) {
      if (i < nt) mbar_arrive(empty_v + 8 * stage_of(i));
    };
    // warpgroup 1 owes warpgroup 0 one arrival fewer: it gave the first
    auto pass_turn = [&](int i) {
      if (wg == 0 || i < nt) named_arrive(their_turn);
    };
    auto kind_of = [&](int i) {
      return tile_kind(p, (kt_begin + i) * BK, BK, wlo, whi, r_lo, r_hi);
    };
    // this warpgroup's 64 rows of the Q tile
    const uint32_t sq_wg = sq + wg * WG_ROWS * ROW_BYTES;
    // a turn that issues nothing: wait for the tile even so, since an
    // `empty` arrival must not count toward the stage's previous use
    auto idle_turn = [&](int i) {
      wait_k(i);
      wait_v(i);
      named_sync(my_turn);
      pass_turn(i);
      release_k(i);
      release_v(i);
    };
    if (nt > 0) {
      mbar_wait(bar_q, 0);
      if (wg == 1) named_arrive(1);
      for (int i = 0; i < ta; ++i) idle_turn(i);
      if (ta < tb) {
        // turn ta: the first S, no P.V yet (O is 0)
        wait_k(ta);
        named_sync(my_turn);
        wgmma_fence();
        issue_s<HD>(sc, sq_wg, sk + stage_of(ta) * C::KV_BYTES);
        pass_turn(ta);
        wgmma_wait<0>();
        fence_regs(sc);
        release_k(ta);
        online_softmax(sc, m, l, alpha, p, (kt_begin + ta) * BK, kind_of(ta),
                       qpos0, col0, cs);
        pack_p(sc, pa);
        for (int i = ta + 1; i < tb; ++i) {
          wait_k(i);
          wait_v(i - 1);
          named_sync(my_turn);
          wgmma_fence();
          issue_s<HD>(sc, sq_wg, sk + stage_of(i) * C::KV_BYTES);
          issue_pv<HD>(o, pa, sv + stage_of(i - 1) * C::KV_BYTES);
          pass_turn(i);
          wgmma_wait<1>();               // S_i done; the P.V may still run
          fence_regs(sc);
          release_k(i);
          online_softmax(sc, m, l, alpha, p, (kt_begin + i) * BK, kind_of(i),
                         qpos0, col0, cs);
          wgmma_wait<0>();               // the P.V of tile i - 1 is done
          fence_regs(o);
          fence_regs(pa);
          release_v(i - 1);
#pragma unroll
          for (int n2 = 0; n2 < HD / 2; ++n2) o[n2] *= alpha[(n2 >> 1) & 1];
          pack_p(sc, pa);
        }
        // turn tb: the last P.V; tile tb, if any, is not this warpgroup's
        wait_v(tb - 1);
        wait_k(tb);
        wait_v(tb);
        named_sync(my_turn);
        wgmma_fence();
        issue_pv<HD>(o, pa, sv + stage_of(tb - 1) * C::KV_BYTES);
        pass_turn(tb);
        wgmma_wait<0>();
        fence_regs(o);
        release_v(tb - 1);
        release_k(tb);
        release_v(tb);
        for (int i = tb + 1; i <= nt; ++i) idle_turn(i);
      } else {
        idle_turn(nt);
      }
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    }
    __nv_bfloat16* ob =
        static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
    for (int n = 0; n < HD / 2; n += 2) {
      const int r = (n >> 1) & 1;
      const int row = r_lo + row0 + 8 * r;
      if (row < p.Sq) {
        const int col = 8 * (n >> 2) + col0;
        *reinterpret_cast<__nv_bfloat162*>(ob + row * p.os[2] + col) =
            __floats2bfloat162_rn(o[n] * inv[r], o[n + 1] * inv[r]);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (hd, heads, S, B) of a bf16 tensor with element strides
// st = (b, h, s), hd contiguous; boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle, zeros past every edge. Returns 0 or an error code.
int encode_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
               int B, const long long* st, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ENCODER_MISSING;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED - (int)r;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, int H, int KV, const long long* strides,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  int rc = encode_map(&tq, q, HD, H, p.Sq, B, strides, BQ);
  if (rc == 0) rc = encode_map(&tk, k, HD, KV, p.Sk, B, strides + 3, C::BK);
  if (rc == 0) rc = encode_map(&tv, v, HD, KV, p.Sk, B, strides + 6, C::BK);
  if (rc != 0) return rc;
  static bool attr_set = false;   // opt in above 48 KiB once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_wgmma<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel_wgmma<HD><<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv,
                                                                 p);
  return (int)cudaGetLastError();
}

bool tma_ready(const void* ptr, const long long* st) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || st[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// q, k, v, o: bf16 device pointers laid out by `strides`: 12 element
// strides, (b, h, s) for q, k, v and o in that order, with hd contiguous.
// q, k and v are read by TMA: 16-byte aligned, their strides positive
// multiples of 8 (the wrapper copies any view that is not, and gives a
// size-1 dimension a legal stride). Launches on `stream` and returns 0 on
// success, a CUDA error, ENCODER_MISSING, or ENCODE_FAILED - the CUresult
// of cuTensorMapEncodeTiled; the shape checks raise in the Python wrapper
// first.
extern "C" int flash_attention_fwd_bf16_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int hd, const long long* strides, int causal,
    int window, float softcap, int q_offset, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535 || !tma_ready(q, strides) ||
      !tma_ready(k, strides + 3) || !tma_ready(v, strides + 6))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = o;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.G = H / KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.softcap = softcap;
  const float log2e = 1.4426950408889634f;
  const float scale = 1.0f / sqrtf((float)hd);
  p.c_scale = scale * log2e;
  p.c_in = softcap > 0.0f ? scale / softcap : 0.0f;
  p.c_out = softcap * log2e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(q, k, v, p, B, H, KV, strides, s);
    case 128: return launch<128>(q, k, v, p, B, H, KV, strides, s);
    case 256: return launch<256>(q, k, v, p, B, H, KV, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
