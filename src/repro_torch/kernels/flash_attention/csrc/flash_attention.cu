// Forward flash attention (online softmax) for Hopper (sm_90a), fp32 in and
// out: both products on the tensor cores in 3xTF32, fp32 statistics and
// accumulator.
//
// Replaces, for fp32 inputs: src/repro/kernels/flash_attention/kernel.py:97
// flash_attention_pallas, the TPU kernel that the LLM tier's prefill and
// forward run per layer. bf16 inputs run flash_attention_wgmma.cu.
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
// reading q, k, v once and writing o once. At every shape of the LLM tier
// the work bounds it: fp32-accurate products run as FFMA (67 TFLOP/s) or as
// three TF32 products on the tensor cores (495 TFLOP/s dense, 165 TFLOP/s
// of fp32 work), so the least time is 3 * flops / 495 TFLOP/s: 1.25 / 1.67
// ms at gemma2-2b's local / global layers (1 x 8192, hd 256), 0.42 ms at
// the llama3.2-1b prefill shape (4 x 2048, hd 64).
//
// Design, and what it does about that:
// - 3xTF32 on mma.sync.m16n8k8 (the recipe of gram.cu): each operand x is
//   split in registers into hi = x with its low 13 bits cleared (exactly a
//   TF32 value) and lo = x - hi (exact in fp32), and lo*hi' + hi*lo' +
//   hi*hi' runs on the tensor cores. The mma reads lo as TF32 too (its low
//   13 bits dropped), so a product errs by at most ~2^-20 of |x y| (lo*lo'
//   is left out, ~2^-20 too); two operations a split (a logic AND and a
//   subtract) instead of cvt.rna's four or five, because at hd 256 the
//   splits, not the tensor cores, would otherwise set the pace. A logit
//   sums 64-256 such products: its error is ~1e-6 of |q||k| / sqrt(hd),
//   against the reference's 2e-5 fp32 bar (the kernel's output errs by at
//   most ~4e-6 at the LLM tier's shapes on random inputs).
// - The tensor core adds into its accumulator rounding toward zero (gram.cu
//   found it at r = 8192). S = Q K^T accumulates hi*hi' and the two cross
//   terms in separate fragments over a warp's share of hd (at most 16 k8
//   steps, a bias of ~1e-6 of |s|; the two fragments also double the
//   independent mma chains) and adds them in fp32: at hd 256 that holds
//   the bar with room (scripts/flash_f32_variants.py times the choices:
//   one fragment for all three terms raises the error ~1.7x, a fresh
//   fragment every k8 step costs ~3%). Each key tile's P.V starts from a
//   zero fragment (BK / 8 k8 steps of three products) and joins O as
//   O * alpha + tile, to nearest: the rescale's FMA, no more.
// - Why mma.sync and not wgmma: wgmma's tf32 form takes B only from shared
//   memory, K-major, so 3xTF32 would keep hi and lo copies of K and of a
//   transposed V resident in shared memory; at hd 256 that does not fit
//   beside two stages. mma.sync takes its operands from registers, loaded
//   from the raw fp32 tiles in any layout, and the split happens there.
// - A warp owns 16 query rows (an m16 tile: little waste on a short prompt
//   or the ragged q tail); a block owns BQ = 64 rows of one (b, h) and
//   walks the key tiles that some row of it sees. The row statistics
//   reduce over the quad of lanes that holds a row. At hd 256 the Q tile
//   and two K/V stages fill an SM's shared memory, so one block of four
//   warps would be all an SM runs, with O alone 128 registers a thread:
//   there two warps share each 16 rows (SPLIT), each summing half of hd
//   into the logits and owning half of O's columns; they swap their
//   partial logits through shared memory (one named barrier a tile) and
//   both run the softmax. Eight warps an SM at 222 registers, no spills,
//   and 1.35x faster than four at gemma2's shapes. Masks apply only on
//   the tiles they cut (the diagonal, the window edge, the Sk tail); a warp
//   none of whose rows sees a tile issues no product for it. Query tiles
//   run last-first, so the longest causal tiles start first.
// - P never leaves registers: the S fragment (row g, columns 2t, 2t+1 of
//   each 8 keys) is the A fragment of P.V once the keys of each 8 are taken
//   in the order 0, 2, 4, 6, 1, 3, 5, 7, and V's B fragment is loaded in
//   that order (rows 2t and 2t+1). Q K^T takes hd in the same order, so a
//   thread's two elements of a Q or K fragment are neighbours: one 8-byte
//   shared load each.
// - Loads overlap the products: the Q tile once, then each key tile's K
//   and V through a ring of STAGES stages of cp.async (16 bytes a thread,
//   rows past Sq or Sk zero-filled), one barrier a tile. Row pitches of
//   hd + 8 (Q, K: 8-byte fragment loads) and hd + 4 (V: 4-byte loads in
//   pairs of rows) keep every fragment load free of bank conflicts.
// - Exponentials in the log2 domain with ex2.approx (relative error ~2^-22;
//   the row max is subtracted first, and alpha scales O and l alike). The
//   softcap keeps the accurate tanhf: tanh.approx errs by ~2^-11, 0.02 on a
//   logit near a cap of 50.
// Tiles (Cfg below): BQ 64; hd 64: 4 warps, BK 64; hd 128: 4 warps, BK 32;
// hd 256: 8 warps (SPLIT 2), BK 32; two stages. Shared memory 88, 101 and
// 217 KiB: two blocks an SM at hd 64 and 128, one at 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARP_ROWS = 16;
constexpr int MAX_DEVICES = 64;

template <int HD>
struct Cfg {
  static constexpr int ROW_GROUPS = 4;             // of WARP_ROWS query rows
  static constexpr int SPLIT = HD == 256 ? 2 : 1;  // warps per row group
  static constexpr int WARPS = ROW_GROUPS * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = WARP_ROWS * ROW_GROUPS;
  static constexpr int HDW = HD / SPLIT;           // hd columns a warp owns
  static constexpr int BK = HD == 64 ? 64 : 32;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = HD == 256 ? 1 : 2;
  static constexpr int PG = 64;                    // O columns per P.V pass
  static constexpr int QP = HD + 8;                // row pitches, floats
  static constexpr int KP = HD + 8;
  static constexpr int VP = HD + 4;
  static constexpr int XP = BK + 8;
  static constexpr int Q_FLOATS = BQ * QP;
  static constexpr int STAGE_FLOATS = BK * KP + BK * VP;
  // partial logits exchanged between the warps of a row group
  static constexpr int X_FLOATS = SPLIT > 1 ? WARPS * WARP_ROWS * XP : 0;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)Q_FLOATS + (size_t)STAGES * STAGE_FLOATS +
                       (size_t)X_FLOATS);
  static_assert(QP % 32 == 8 && VP % 16 == 4 && XP % 32 == 8,
                "conflict-free pitches");
  static_assert(HDW % PG == 0 && BK % 8 == 0 && SPLIT <= 2,
                "whole fragments");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long qs[3], ks[3], vs[3], os[3];   // strides over (b, h, s), elements
  int G, Sq, Sk, causal, window, q_offset;
  float softcap;
  float c_scale;         // log2(e) / sqrt(hd): logits in log2 units
  float c_in, c_out;     // with softcap: c_out * tanh(s * c_in), log2 units
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

// 16 bytes from global to shared memory; `ok` false zero-fills them
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// `rows` rows of HD floats from src (row stride `stride` elements), those
// at or past `limit` zero-filled, into shared memory at dst (pitch P)
template <int HD, int P, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int rows, int limit, int tid) {
  constexpr int PER_ROW = HD / 4;
  for (int c = tid; c < rows * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * 4;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * P + col,
               ok ? src + (long long)(row0 + r) * stride + col : src, ok);
  }
}

// x = hi + lo exactly: hi is x with its low 13 bits cleared (a TF32
// value); the mma reads lo as TF32 too, dropping lo's own low 13 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the kernel ------------------------------------------------------------
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32), for lane = 4 g + t: A (16 x 8)
// a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4);
// B (8 x 8) b0 = (t, g), b1 = (t + 4, g); C (16 x 8) c0 = (g, 2t),
// c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1). The k index t
// stands for element 2t of each 8 (of hd in Q K^T, of keys in P.V) and
// t + 4 for element 2t + 1.

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::MIN_BLOCKS)
flash_fwd_kernel_3xtf32(const Params p) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;        // 8-key fragments of a tile
  constexpr int ND = C::HDW / 8;    // this warp's 8-column fragments of
                                    // O, and its k8 steps of S
  constexpr int NG = C::PG / 8;     // O fragments per P.V pass
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                  // [BQ][QP]
  float* ring = smem + C::Q_FLOATS;                  // [STAGES][K | V]
  float* xch = ring + C::STAGES * C::STAGE_FLOATS;   // [WARPS][16][XP]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int group = warp / C::SPLIT;     // the warp's 16 query rows
  const int half = warp % C::SPLIT;      // and its share of hd
  const int col0 = half * C::HDW;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * C::BQ;
  const int kvh = h / p.G;
  const float* qb = p.q + b * p.qs[0] + h * p.qs[1];
  const float* kb = p.k + b * p.ks[0] + kvh * p.ks[1];
  const float* vb = p.v + b * p.vs[0] + kvh * p.vs[1];

  // the key tiles some row of this block sees: the block loads these
  int lo, hi;
  visible_keys(p, q0, min(q0 + C::BQ, p.Sq) - 1, lo, hi);
  const int kt_begin = lo <= hi ? lo / BK : 0;
  const int n_tiles = lo <= hi ? hi / BK - lo / BK + 1 : 0;

  // this warp's rows and the keys they see
  const int r_lo = q0 + group * WARP_ROWS;
  const int r_hi = min(r_lo + WARP_ROWS, p.Sq) - 1;   // < r_lo: no real row
  int wlo = 0, whi = -1;
  if (r_lo <= r_hi) visible_keys(p, r_lo, r_hi, wlo, whi);
  const int qpos0 = r_lo + g + p.q_offset;            // row g; g + 8 is +8

  auto stage = [&](int i) { return ring + (i % C::STAGES) * C::STAGE_FLOATS; };
  auto load_tile = [&](int i) {
    const int k0 = (kt_begin + i) * BK;
    float* st = stage(i);
    load_rows<HD, C::KP, C::THREADS>(st, kb, p.ks[2], k0, BK, p.Sk, tid);
    load_rows<HD, C::VP, C::THREADS>(st + BK * C::KP, vb, p.vs[2], k0, BK,
                                     p.Sk, tid);
  };

  if (n_tiles > 0)
    load_rows<HD, C::QP, C::THREADS>(sq, qb, p.qs[2], q0, C::BQ, p.Sq, tid);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};      // this thread's share of the row sums
  // logits in raw units, p = 2^(s cs - m cs); with the softcap its
  // transform is already in log2 units
  const float cs = p.softcap > 0.0f ? 1.0f : p.c_scale;
  const float* qw = sq + (group * WARP_ROWS + g) * C::QP + col0 + 2 * t;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();     // tile i landed; every warp is done with tile i - 1
    if (i + C::STAGES - 1 < n_tiles) load_tile(i + C::STAGES - 1);
    cp_async_commit();

    const int k0 = (kt_begin + i) * BK;
    const int kind = tile_kind(p, k0, BK, wlo, whi, r_lo, r_hi);
    if (kind == SKIP) continue;
    const float* sk = stage(i);
    const float* sv = sk + BK * C::KP;

    // ---- S = Q K^T: hi*hi' and the cross terms in separate fragments ----
    float sb[NT][4], sx[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[j][e] = sx[j][e] = 0.0f;
    const float* kw = sk + g * C::KP + col0 + 2 * t;
#pragma unroll 4
    for (int d = 0; d < ND; ++d) {
      uint32_t ah[4], al[4];
      const float2 q_g = *reinterpret_cast<const float2*>(qw + 8 * d);
      const float2 q_g8 =
          *reinterpret_cast<const float2*>(qw + 8 * C::QP + 8 * d);
      split(q_g.x, ah[0], al[0]);
      split(q_g8.x, ah[1], al[1]);
      split(q_g.y, ah[2], al[2]);
      split(q_g8.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 kk =
            *reinterpret_cast<const float2*>(kw + 8 * j * C::KP + 8 * d);
        uint32_t bh[2], bl[2];
        split(kk.x, bh[0], bl[0]);
        split(kk.y, bh[1], bl[1]);
        mma_tf32(sx[j], al, bh);
        mma_tf32(sx[j], ah, bl);
        mma_tf32(sb[j], ah, bh);
      }
    }

    // ---- online softmax over the tile ----
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sb[j][e] + sx[j][e];
    if (C::SPLIT > 1) {
      // the two warps of a row group each summed half of hd: swap the
      // halves through shared memory (the barrier at the tile's top keeps
      // the next tile's writes behind these reads) and add; a + b is b + a
      // bit for bit, so both warps hold the same logits
      float* mine = xch + (warp * WARP_ROWS + g) * C::XP + 2 * t;
      const float* theirs = xch + ((warp ^ 1) * WARP_ROWS + g) * C::XP + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(mine + 8 * r * C::XP + 8 * j) =
              make_float2(s[j][2 * r], s[j][2 * r + 1]);
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "r"(64)
                   : "memory");
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 x = *reinterpret_cast<const float2*>(
              theirs + 8 * r * C::XP + 8 * j);
          s[j][2 * r] += x.x;
          s[j][2 * r + 1] += x.y;
        }
    }
    if (p.softcap > 0.0f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p.c_out * tanhf(s[j][e] * p.c_in);
    }
    if (kind == MASKED) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qpos0 + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || kpos > qpos - p.window);
          if (!ok) s[j][e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float sub[2], alpha[2];
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
    // P as the A operand of P.V, split: a0 = c0, a1 = c2, a2 = c1, a3 = c3
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = ex2(fmaf(s[j][e], cs, -sub[e >> 1]));
        l[e >> 1] += pr[e];
      }
      split(pr[0], ph[j][0], pl[j][0]);
      split(pr[2], ph[j][1], pl[j][1]);
      split(pr[1], ph[j][2], pl[j][2]);
      split(pr[3], ph[j][3], pl[j][3]);
    }

    // ---- O = O * alpha + P V, each pass of NG fragments from zero ----
    const float* vw = sv + 2 * t * C::VP + col0 + g;
#pragma unroll
    for (int c = 0; c < C::HDW / C::PG; ++c) {
      float acc[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float* vp = vw + 8 * j * C::VP + c * C::PG + 8 * n;
          uint32_t bh[2], bl[2];
          split(vp[0], bh[0], bl[0]);
          split(vp[C::VP], bh[1], bl[1]);
          mma_tf32(acc[n], pl[j], bh);
          mma_tf32(acc[n], ph[j], bl);
          mma_tf32(acc[n], ph[j], bh);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[c * NG + n][e] = fmaf(o[c * NG + n][e], alpha[e >> 1],
                                  acc[n][e]);
    }
  }
  cp_async_wait<0>();

  if (r_lo > r_hi) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
  }
  float* ob = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r_lo + g + 8 * r;
    if (qi >= p.Sq) continue;
    float* orow = ob + (long long)qi * p.os[2] + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

template <int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  using C = Cfg<HD>;
  // the shared-memory limit is a per-device attribute of the function
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel_3xtf32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const dim3 grid((p.Sq + C::BQ - 1) / C::BQ, H, B);
  flash_fwd_kernel_3xtf32<HD><<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: fp32 device pointers laid out by `strides`: 12 element
// strides, (b, h, s) for q, k, v and o in that order, with hd contiguous;
// q, k and v 16-byte aligned with strides that are multiples of 4 elements,
// o 8-byte aligned with even strides (the wrapper copies what is not).
// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// shape checks raise in the Python wrapper first.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KV,
                                   int Sq, int Sk, int hd,
                                   const long long* strides, int causal,
                                   int window, float softcap, int q_offset,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.o = (float*)o;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.G = H / KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  const float scale = 1.0f / sqrtf((float)hd);
  const float log2e = 1.4426950408889634f;
  p.softcap = softcap;
  p.c_scale = scale * log2e;
  p.c_in = softcap > 0.0f ? scale / softcap : 0.0f;
  p.c_out = softcap * log2e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(p, B, H, s);
    case 128: return launch<128>(p, B, H, s);
    case 256: return launch<256>(p, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
