// Pieces shared by the chunked WKV6 kernels for Hopper (sm_90a): the
// forward (wkv6.cu) and the gradient (wkv6_bwd.cu).
//
// Both work the reference's chunked form (src/repro/kernels/rwkv6/kernel.py,
// _wkv6_kernel): per chunk of L <= 16 steps, with c the inclusive cumsum of
// log_w over the chunk, cs = c - log_w and c_L its last value,
//   rt = r e^{cs},  kt = k e^{-c},  ke = k e^{c_L - c} (= kt decay),
//   decay = e^{c_L},
//   A  = strict-lower(rt kt^T)            (L x L: the pairwise decays),
// and a (K, V) matrix carried from chunk to chunk: the state S forward, its
// gradient G backward. A block owns W = 16 rows or columns of that matrix
// (a slice of V or of K) with the full width D = 64 of the other dimension,
// 1024 values in the registers of 128 threads, 8 each. A product that
// contracts over D is a few FMAs a thread and a butterfly over the lanes
// that share its rows (reduce_scatter16, reduce_scatter32); a product that
// contracts over the chunk updates the registers in place. K and V below 64
// and chunks below 16 are zero padding that adds nothing (r = k = v = dO =
// 0, log_w = 0).
//
// Per chunk the factors, then A, then the products with the carried matrix
// depend on each other, but not across chunks except through the matrix.
// So the kernels run them as a pipeline three chunks deep: in one step the
// block computes the factors of chunk x + 2, the L x L product of chunk
// x + 1 and the carried products of chunk x, with one barrier a step;
// buffers rotate by chunk, and the tiles of a later chunk load by cp.async
// meanwhile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv6 {

constexpr int LT = 16;        // rows of a chunk tile: the chunk length L <= 16
constexpr int D = 64;         // K and V, padded
constexpr int W = 16;         // rows of the carried matrix a block owns
constexpr int THREADS = 128;  // W rows x 8 lanes
constexpr int NM = D / 8;     // values of the carried matrix a thread holds
constexpr int PF = D + 4;     // pitch of a full-width tile (no bank conflicts)
constexpr int PS = W;         // pitch of a slice tile
constexpr int PL = LT + 1;    // pitch of an L x L product
constexpr unsigned FULL = 0xffffffffu;

// a (B, S, H, X) fp32 array: base pointer and (b, t, h) element strides,
// the last dim contiguous
struct Seq {
  const float* p;
  long long sb, st, sh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a thread's 8 values of row `row` of a full-width tile, in col(m) order
__device__ __forceinline__ void row8(const float* tile, int row, int cg,
                                     float (&x)[NM]) {
  const float4 a = ld4(tile + row * PF + cg * 4);
  const float4 b = ld4(tile + row * PF + 32 + cg * 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float dot8(const float (&a)[NM],
                                      const float (&b)[NM]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < NM; ++m) s = fmaf(a[m], b[m], s);
  return s;
}

// Rows [0, L) of columns [c0, c0 + WT) of the (b, h) sequence x, from step
// t0, into dst (pitch P) by cp.async; rows at or past L and columns at or
// past X stay as they are (zero). 16 bytes a copy when vec (X, c0, the
// strides and the base are multiples of 4 floats), else 4. WT is 16 or 64,
// so a copy's row and column come from shifts.
template <int WT>
__device__ __forceinline__ void load_tile(float* dst, int P, const Seq& x,
                                          int b, int h, long long t0, int L,
                                          int c0, int X, bool vec, int tid) {
  const int lim = X - c0;
  const float* src = x.p + b * x.sb + h * x.sh + t0 * x.st + c0;
  if (vec) {
    constexpr int PER = WT / 4;
#pragma unroll
    for (int it = 0; it < (LT * PER + THREADS - 1) / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int t = i / PER;
      const int c = (i % PER) * 4;
      if (i < LT * PER && t < L && c < lim)
        cp_async16(dst + t * P + c, src + t * x.st + c);
    }
  } else {
#pragma unroll
    for (int it = 0; it < LT * WT / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int t = i / WT;
      const int c = i % WT;
      if (t < L && c < lim) cp_async4(dst + t * P + c, src + t * x.st + c);
    }
  }
}

// x[0..7]: one value per row, summed over the 32 lanes of the warp: the rows
// halve over lane bits 4, 3, 2, then bits 1 and 0 add up; every lane gets
// the sum of row 4 (lane bit 4) + 2 (bit 3) + (bit 2).
__device__ __forceinline__ float reduce8_over_warp(const float (&x)[8],
                                                   int lane) {
  float a[4], b[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h16 ? x[i] : x[i + 4];
    a[i] = (h16 ? x[i + 4] : x[i]) + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h8 ? a[i] : a[i + 2];
    b[i] = (h8 ? a[i + 2] : a[i]) + __shfl_xor_sync(FULL, send, 8);
  }
  float y = (h4 ? b[1] : b[0]) + __shfl_xor_sync(FULL, h4 ? b[0] : b[1], 4);
  y += __shfl_xor_sync(FULL, y, 2);
  y += __shfl_xor_sync(FULL, y, 1);
  return y;
}

// The chunk factors over the full key width (sr, sk, sw full-width tiles),
// all 128 threads: key column k = tid % 64, rows 8 (tid / 64) .. + 7, each
// thread running the cumsum from row 0 itself: rt, kt and decay (ke = kt
// decay is formed where it is used), and diagp[h * LT + t] = the sum of
// r_t u k_t over the 32 keys of half h.
__device__ __forceinline__ void full_factors(const float* sr, const float* sk,
                                             const float* sw, const float* su,
                                             float* rt, float* kt,
                                             float* decay, float* diagp,
                                             int tid) {
  const int k = tid & (D - 1);
  const int upper = tid >> 6;
  const int t0 = upper * 8;
  float c = 0.f;
  if (upper) {
#pragma unroll
    for (int t = 0; t < 8; ++t) c += sw[t * PF + k];
  }
  const float uk = su[k];
  float d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + i;
    const float cs = c;
    c += sw[t * PF + k];
    const float r = sr[t * PF + k], kv = sk[t * PF + k];
    rt[t * PF + k] = r * expf(cs);
    kt[t * PF + k] = kv * expf(-c);
    d[i] = r * uk * kv;
  }
  if (upper) decay[k] = expf(c);
  const int lane = tid & 31;
  const float y = reduce8_over_warp(d, lane);
  if ((lane & 3) == 0)
    diagp[((tid >> 5) & 1) * LT + t0 + ((lane >> 4) & 1) * 4 +
          ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1)] = y;
}

// The chunk factors of a 16-key slice (sr, sk, sw slice tiles), all 128
// threads: key kk = tid % 16, rows 2 (tid / 16) and + 1, each thread
// running the cumsum from row 0 itself: rt = r e^{cs}, kt = k e^{-c},
// ecs = e^{cs}, emc = e^{-c}, ecl = e^{c_L - c}, decay = e^{c_L}.
__device__ __forceinline__ void slice_factors(const float* sr,
                                              const float* sk,
                                              const float* sw, float* rt,
                                              float* kt, float* ecs,
                                              float* emc, float* ecl,
                                              float* decay, int tid) {
  const int kk = tid & (W - 1);
  const int ta = 2 * (tid >> 4), tb = ta + 1;
  float tot = 0.f, pre = 0.f;
#pragma unroll
  for (int t = 0; t < LT; ++t) {
    if (t == ta) pre = tot;
    tot += sw[t * PS + kk];
  }
  const int a = ta * PS + kk, b = tb * PS + kk;
  const float ca = pre + sw[a];
  const float cb = ca + sw[b];
  const float esa = expf(pre), esb = expf(ca);
  const float ema = expf(-ca), emb = expf(-cb);
  ecs[a] = esa;
  ecs[b] = esb;
  emc[a] = ema;
  emc[b] = emb;
  rt[a] = sr[a] * esa;
  rt[b] = sr[b] * esb;
  kt[a] = sk[a] * ema;
  kt[b] = sk[b] * emb;
  ecl[a] = expf(tot - ca);
  ecl[b] = expf(tot - cb);
  if (ta == 0) decay[kk] = expf(tot);
}

// X[t][i] = sum_d P[t][d] Q[i][d] over d < D (P, Q full-width tiles) for
// i < t; on the diagonal dsrc[t] + dsrc[LT + t] (the two halves of diagp)
// when dsrc is given, else zero; dout[t] = the diagonal's own dot product
// when dout is given. Only the 36 tiles of 2 x 2 on and below the diagonal
// are computed, each by two neighbouring lanes (threads 0..71) that take
// alternate float4 groups of d (no bank conflict between them) and join
// their sums by a shuffle; X above them is never written, so the caller
// zeroes it once.
__device__ __forceinline__ void pair_products(const float* P, const float* Q,
                                              float* X, const float* dsrc,
                                              float* dout, int tid) {
  if (tid >= 96) return;   // warps 0-2 take part in the shuffle
  const int tile = min(tid >> 1, 35);
  const int odd = tid & 1;
  int T = 0;
  while ((T + 1) * (T + 2) / 2 <= tile) ++T;
  const int t0 = 2 * T, t1 = t0 + 1;
  const int i0 = 2 * (tile - T * (T + 1) / 2), i1 = i0 + 1;
  float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
  for (int g = 0; g < D; g += 8) {
    const int d = g + 4 * odd;
    const float4 p0 = ld4(P + t0 * PF + d), p1 = ld4(P + t1 * PF + d);
    const float4 q0 = ld4(Q + i0 * PF + d), q1 = ld4(Q + i1 * PF + d);
    a00 = fmaf(p0.x, q0.x, fmaf(p0.y, q0.y, fmaf(p0.z, q0.z,
          fmaf(p0.w, q0.w, a00))));
    a01 = fmaf(p0.x, q1.x, fmaf(p0.y, q1.y, fmaf(p0.z, q1.z,
          fmaf(p0.w, q1.w, a01))));
    a10 = fmaf(p1.x, q0.x, fmaf(p1.y, q0.y, fmaf(p1.z, q0.z,
          fmaf(p1.w, q0.w, a10))));
    a11 = fmaf(p1.x, q1.x, fmaf(p1.y, q1.y, fmaf(p1.z, q1.z,
          fmaf(p1.w, q1.w, a11))));
  }
  a00 += __shfl_xor_sync(FULL, a00, 1);
  a01 += __shfl_xor_sync(FULL, a01, 1);
  a10 += __shfl_xor_sync(FULL, a10, 1);
  a11 += __shfl_xor_sync(FULL, a11, 1);
  if (tid >= 72 || odd) return;
  const float tiles[4] = {a00, a01, a10, a11};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = e < 2 ? t0 : t1;
    const int i = e & 1 ? i1 : i0;
    float x = 0.f;
    if (i < t) {
      x = tiles[e];
    } else if (i == t) {
      if (dsrc != nullptr) x = dsrc[t] + dsrc[LT + t];
      if (dout != nullptr) dout[t] = tiles[e];
    }
    X[t * PL + i] = x;
  }
}

// p[0..15]: one partial per chunk row, summed over the 8 lanes of a group
// (lane bits 0-2 = cg) by a butterfly that halves the rows at each step; on
// return y0, y1 hold the group's sums for rows 2 cg and 2 cg + 1.
__device__ __forceinline__ void reduce_scatter16(const float (&p)[LT],
                                                 float& y0, float& y1,
                                                 int cg) {
  float q[8], r[4];
  const bool h4 = cg & 4, h2 = cg & 2, h1 = cg & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = h4 ? p[i] : p[i + 8];
    q[i] = (h4 ? p[i + 8] : p[i]) + __shfl_xor_sync(FULL, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h2 ? q[i] : q[i + 4];
    r[i] = (h2 ? q[i + 4] : q[i]) + __shfl_xor_sync(FULL, send, 2);
  }
  const float s0 = h1 ? r[0] : r[2];
  const float s1 = h1 ? r[1] : r[3];
  y0 = (h1 ? r[2] : r[0]) + __shfl_xor_sync(FULL, s0, 1);
  y1 = (h1 ? r[3] : r[1]) + __shfl_xor_sync(FULL, s1, 1);
}

// p[0..31]: one partial per (chunk row t, column c) at 2 t + c, summed
// over the 16 lanes that share lane bit 4 (lane bits 0-3 = kq) by a
// butterfly that halves the values at each step; on return y0, y1 hold the
// sums for row kq, columns 0 and 1.
__device__ __forceinline__ void reduce_scatter32(const float (&p)[2 * LT],
                                                 float& y0, float& y1,
                                                 int kq) {
  float q[16], r[8], s4[4];
  const bool h8 = kq & 8, h4 = kq & 4, h2 = kq & 2, h1 = kq & 1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float send = h8 ? p[i] : p[i + 16];
    q[i] = (h8 ? p[i + 16] : p[i]) + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = h4 ? q[i] : q[i + 8];
    r[i] = (h4 ? q[i + 8] : q[i]) + __shfl_xor_sync(FULL, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h2 ? r[i] : r[i + 4];
    s4[i] = (h2 ? r[i + 4] : r[i]) + __shfl_xor_sync(FULL, send, 2);
  }
  const float send0 = h1 ? s4[0] : s4[2];
  const float send1 = h1 ? s4[1] : s4[3];
  y0 = (h1 ? s4[2] : s4[0]) + __shfl_xor_sync(FULL, send0, 1);
  y1 = (h1 ? s4[3] : s4[1]) + __shfl_xor_sync(FULL, send1, 1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The block that carries W columns of V with all of K: the forward's state
// (wkv6.cu) and, run last chunk first, the gradient's G for dv (wkv6_bwd.cu's
// value blocks). Shared memory, in floats: r, k, log_w tiles of SLICE_NR
// chunks; slices of the carried sequence (v, or dO) of SLICE_NY; rt and kt
// of three chunks; decay and the diag halves of three; A of two; u.
constexpr int SLICE_RING = 3 * LT * PF;
constexpr int SLICE_NR = 3;
constexpr int SLICE_NY = 5;
constexpr int SLICE_SMEM = SLICE_NR * SLICE_RING + SLICE_NY * LT * PS +
                           6 * LT * PF + 3 * D + 3 * 2 * LT + 2 * LT * PL +
                           D;

// That layout, and the steps such a block's loop shares: step x (from -2)
// loads the tiles of the (x + 4)-th chunk (issue), forms the factors of the
// (x + 2)-th and A of the (x + 1)-th (front), and then the caller works
// the x-th with rt(x), kt(x), decay(x), A(x) and y(x).
struct SliceBlock {
  float *ring, *ys, *rt_, *kt_, *decay_, *diagp, *A_, *su;

  __device__ __forceinline__ explicit SliceBlock(float* smem)
      : ring(smem),
        ys(ring + SLICE_NR * SLICE_RING),
        rt_(ys + SLICE_NY * LT * PS),
        kt_(rt_ + 3 * LT * PF),
        decay_(kt_ + 3 * LT * PF),
        diagp(decay_ + 3 * D),
        A_(diagp + 3 * 2 * LT),
        su(A_ + 2 * LT * PL) {}

  // rows past L and columns past K or V are never loaded, A above its
  // diagonal never written: zero them once (all but u, which is written
  // beside, so no barrier is needed between the two)
  __device__ __forceinline__ void init(const float* u, int h, int K,
                                       int tid) {
    for (int i = tid; i < su - ring; i += THREADS) ring[i] = 0.f;
    if (tid < D) su[tid] = tid < K ? u[(long long)h * K + tid] : 0.f;
  }

  // chunk c (steps from t0) into stage x: r, k, log_w at full width and
  // columns j0 .. j0 + 15 of y
  __device__ __forceinline__ void issue(int x, long long t0, const Seq& r,
                                        const Seq& k, const Seq& w,
                                        const Seq& y, int b, int h, int L,
                                        int j0, int K, int V, bool vec,
                                        int tid) {
    float* at = ring + (x % SLICE_NR) * SLICE_RING;
    load_tile<D>(at, PF, r, b, h, t0, L, 0, K, vec, tid);
    load_tile<D>(at + LT * PF, PF, k, b, h, t0, L, 0, K, vec, tid);
    load_tile<D>(at + 2 * LT * PF, PF, w, b, h, t0, L, 0, K, vec, tid);
    load_tile<W>(ys + (x % SLICE_NY) * LT * PS, PS, y, b, h, t0, L, j0, V,
                 vec, tid);
  }

  // the factors of stage x + 2 and A of stage x + 1, those below n
  __device__ __forceinline__ void front(int x, int n, int tid) {
    const int f = x + 2;
    if (f < n) {
      const float* at = ring + (f % SLICE_NR) * SLICE_RING;
      full_factors(at, at + LT * PF, at + 2 * LT * PF, su,
                   rt_ + (f % 3) * LT * PF, kt_ + (f % 3) * LT * PF,
                   decay_ + (f % 3) * D, diagp + (f % 3) * 2 * LT, tid);
    }
    const int g = x + 1;
    if (g >= 0 && g < n)
      pair_products(rt_ + (g % 3) * LT * PF, kt_ + (g % 3) * LT * PF,
                    A_ + (g & 1) * LT * PL, diagp + (g % 3) * 2 * LT,
                    nullptr, tid);
  }

  // stage x's rt and kt (pitch PF), decay, A with diag(r u k) on its
  // diagonal (pitch PL) and slice (pitch PS)
  __device__ __forceinline__ const float* rt(int x) const {
    return rt_ + (x % 3) * LT * PF;
  }
  __device__ __forceinline__ const float* kt(int x) const {
    return kt_ + (x % 3) * LT * PF;
  }
  __device__ __forceinline__ const float* decay(int x) const {
    return decay_ + (x % 3) * D;
  }
  __device__ __forceinline__ const float* A(int x) const {
    return A_ + (x & 1) * LT * PL;
  }
  __device__ __forceinline__ const float* y(int x) const {
    return ys + (x % SLICE_NY) * LT * PS;
  }
};

}  // namespace wkv6
