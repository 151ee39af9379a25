// WKV6 recurrence (RWKV-6 "Finch" time mix), gradient, fp32, for Hopper
// (sm_90a): one call, two kernels, for dr, dk, dv, dlog_w and the
// per-batch shares of du, the chunked form with the state and its gradient
// carried inside the block.
//
// Replaces: nothing on the TPU. The reference has no backward kernel: it
// trains with use_pallas=False and takes jax.grad of
// src/repro/kernels/rwkv6/ref.py::wkv6_chunked. This is the gradient of the
// forward in wkv6.cu (the same function), and ref.py::wkv6_grad is its plain
// version: per (b, h), with S_{t-1} the state before step t and G_t = dL/dS_t
// (G_{S-1} = 0, G_{t-1} = diag(w_t) G_t + r_t dO_t^T),
//   dr_t = S_{t-1} dO_t + u ⊙ k_t (v_t·dO_t)     (dr°: the first term)
//   dk_t = G_t v_t      + u ⊙ r_t (v_t·dO_t)     (dk°: the first term)
//   dv_t = G_t^T k_t    + (Σ r_t u k_t) dO_t
//   dlog_w_t = Σ_{s>t} (r_s ⊙ dr°_s − k_s ⊙ dk°_s) − k_t ⊙ dk°_t
//   du = Σ_{b,t} r_t ⊙ k_t (v_t·dO_t)
// Inputs as in wkv6.cu plus dO (B, S, H, V), read through strides; dr, dk,
// dlog_w (B, S, H, K) and dv (B, S, H, V) are written contiguous, du's
// share of each batch row to dup (B, H, K) (the wrapper sums it over B).
//
// Bound on an H100 SXM: r, k, log_w, v, dO and u read once, dr, dk, dv,
// dlog_w and du written once, 4 (6K + 3V) bytes per (token, head); 10 K V
// flops (the states recomputed, G carried back, dr°, dk° and dv: 2 K V
// each; the dlog_w identity and the u terms need no K V product): at the
// train shape (2, 1024, 40, 64, 64), 189 MB, 56 us at 3.35 TB/s, against
// 3.4 GFLOP, 50 us of FFMA at 67 TFLOP/s (20 us as 3xTF32 at 495): bytes
// bound it. As in the forward, the chains over chunks and the number of
// blocks limit, and the chunked algebra of the forward serves here too.
// Per chunk, with the factors of wkv6_common.cuh and B[t][i] = dO_t · v_i
// (an L x L product):
//   dr°_t = e^{cs_t} ⊙ (S0 dO_t + Σ_{i<t} B[t][i] kt_i)   (S0: the state at
//                                                         the chunk's start)
//   dk°_t = e^{c_L − c_t} ⊙ G v_t + e^{−c_t} ⊙ Σ_{s>t} B[s][t] rt_s
//   dv_t  = ke_t^T G + Σ_{s>t} A[s][t] dO_s + diag_t dO_t   (G: dL/dS at the
//                                                         chunk's end)
//   G <- decay ⊙ G + rt^T dO,   S <- decay ⊙ S + ke^T v.
// Design, and what it does about that:
// - dr° and dk° contract over V, dv over K. So two kinds of blocks, one
//   (b, h) each: "key" blocks own 16 rows of K (S and G with all of V: dr,
//   dk, dlog_w and du are theirs alone, with no partial sums), and "value"
//   blocks own 16 columns of V (G with all of K: dv). At the train shape
//   4 + 4 blocks per (b, h), 320 of each kind, three an SM: each kind fills
//   the card once. Each kind is a kernel of its own, the key kernel first,
//   on one stream: fused into one kernel, the two paths shared one register
//   allocation, which moved (142 to 168 registers, spills or none) with
//   small edits to either path or to the dispatch, and the launch took
//   0.76-0.85 ms where the two kernels take the sum of their times alone.
// - A key block needs S0 in reverse order. It sweeps forward once, carrying
//   S in registers and storing each chunk's S0 (4 KiB a chunk and block:
//   B H ceil(K/16) (S/L) 4 KiB, 84 MB at the train shape, scratch that the
//   wrapper allocates for the call; nothing is kept between forward and
//   backward), then backward, carrying G and reading S0 back: each thread
//   reads only what it wrote. The forward sweep does little a chunk, so its
//   loads run two chunks ahead. The backward sweep is the three-deep
//   pipeline of wkv6_common.cuh (the slice factors, B and its diagonal
//   v·dO, then the products with S0 and G), and it has dr° and dk° of
//   the same step at hand, and G and the state at each chunk's end, so it
//   writes dlog_w complete: no epilogue kernel. dlog_w_t = a_t − k_t ⊙
//   dk°_t with a_t = Σ_v G_t ⊙ S_t, and a_{t-1} = a_t + r_t ⊙ dr°_t − k_t ⊙
//   dk°_t; a is formed directly at each chunk's last step (8 FMAs and a
//   butterfly) and carried back only within the chunk, by a suffix over the
//   8 lanes of a group (shuffles). Carried over the whole sequence instead,
//   the sum cancels: its terms are large where a is small (early steps),
//   and in fp32 its error grows with the sequence.
// - A value block is the forward's pipeline run backward over the chunks,
//   with dO in place of v and G in place of S.
// - Accurate expf, as in the forward.

#include "wkv6_common.cuh"

namespace {

using namespace wkv6;

struct BwdParams {
  Seq r, k, v, w, g;   // w: log_w; g: dO
  const float* u;      // (H, K)
  float *dr, *dk, *dw; // (B, S, H, K) contiguous
  float* dv;           // (B, S, H, V) contiguous
  float* dup;          // (B, H, K)
  float* states;       // (B, H, nks, S / L, THREADS * NM) scratch
  int S, H, K, V, L, nks;   // nks: key blocks of a (b, h)
  bool vec;
};

// shared memory, in floats, of a key block: NS stages of r, k, log_w
// slices and v, dO full width; the slice factors of three chunks; B and
// v·dO of two; u
constexpr int NS = 4;
constexpr int KSTAGE = 3 * LT * PS + 2 * LT * PF;
constexpr int KFAC = 5 * LT * PS + W;   // rt, kt, ecs, emc, ecl, decay
constexpr int KEY_SMEM = NS * KSTAGE + 3 * KFAC + 2 * LT * PL + 2 * LT + W;
// (a value block's is the forward's, SLICE_SMEM)

// rows k0 .. k0 + 15 of S and G, all of V: dr, dk, dlog_w, du
__device__ __forceinline__ void key_block(const BwdParams& p, float* smem,
                                          int ks, int h, int b, int tid) {
  constexpr int SK = LT * PS, SW = 2 * LT * PS, SV = 3 * LT * PS,
                SG = SV + LT * PF;
  float* ring = smem;
  float* fac = ring + NS * KSTAGE;
  float* Bm = fac + 3 * KFAC;
  float* vdo = Bm + 2 * LT * PL;
  float* su = vdo + 2 * LT;
  const int k0 = ks * W;
  const int n = p.S / p.L;

  // rows past L and columns past K or V are never loaded, B above its
  // diagonal never written: zero them once (all but u, which is written
  // beside, so no barrier is needed between the two)
  for (int i = tid; i < su - smem; i += THREADS) smem[i] = 0.f;
  if (tid < W)
    su[tid] = k0 + tid < p.K ? p.u[(long long)h * p.K + k0 + tid] : 0.f;

  // chunk c into stage x % NS: k, log_w slices and v, and for the backward
  // sweep r and dO too
  auto issue = [&](int x, int c, bool back) {
    const long long t0 = (long long)c * p.L;
    float* at = ring + (x % NS) * KSTAGE;
    if (back) load_tile<W>(at, PS, p.r, b, h, t0, p.L, k0, p.K, p.vec, tid);
    load_tile<W>(at + SK, PS, p.k, b, h, t0, p.L, k0, p.K, p.vec, tid);
    load_tile<W>(at + SW, PS, p.w, b, h, t0, p.L, k0, p.K, p.vec, tid);
    load_tile<D>(at + SV, PF, p.v, b, h, t0, p.L, 0, p.V, p.vec, tid);
    if (back)
      load_tile<D>(at + SG, PF, p.g, b, h, t0, p.L, 0, p.V, p.vec, tid);
  };
  auto factors = [&](int x) {  // of the chunk in stage x % NS
    const float* at = ring + (x % NS) * KSTAGE;
    float* fx = fac + (x % 3) * KFAC;
    slice_factors(at, at + SK, at + SW, fx, fx + LT * PS, fx + 2 * LT * PS,
                  fx + 3 * LT * PS, fx + 4 * LT * PS, fx + 5 * LT * PS, tid);
  };

  const int kk = tid >> 3;            // the row k0 + kk this thread carries
  const int cg = tid & 7;             // its values: col(m), m < 8
  const int ta = 2 * cg, tb = ta + 1; // its chunk rows after the butterfly
  float* states = p.states +
                  (((long long)b * p.H + h) * p.nks + ks) * n * (THREADS * NM)
                  + tid * NM;
  float x8[NM], y8[NM];

  // forward sweep, step x: the factors of chunk x + 1, S0 of chunk x into
  // the scratch and S through chunk x; chunk x + 1 landed during step x - 2
  // (this sweep does little a chunk, so its loads run two steps ahead)
  float st[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) st[m] = 0.f;
  __syncthreads();  // the zeros land before the copies
  issue(0, 0, false);
  cp_async_commit();
  if (n > 1) issue(1, 1, false);
  cp_async_commit();
  for (int x = -1; x < n; ++x) {
    cp_async_wait<1>();
    __syncthreads();
    if (x + 3 < n) issue(x + 3, x + 3, false);
    cp_async_commit();
    if (x + 1 < n) factors(x + 1);
    if (x < 0) continue;
    float4* out =
        reinterpret_cast<float4*>(states + (long long)x * THREADS * NM);
    out[0] = make_float4(st[0], st[1], st[2], st[3]);
    out[1] = make_float4(st[4], st[5], st[6], st[7]);
    const float* at = ring + (x % NS) * KSTAGE;
    const float* ecl = fac + (x % 3) * KFAC + 4 * LT * PS;
    float acc[NM];
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[m] = 0.f;
#pragma unroll
    for (int t = 0; t < LT; ++t) {
      const float ket = at[SK + t * PS + kk] * ecl[t * PS + kk];
      row8(at + SV, t, cg, x8);
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[m] = fmaf(ket, x8[m], acc[m]);
    }
    const float dec = ecl[LT * PS + kk];
#pragma unroll
    for (int m = 0; m < NM; ++m) st[m] = fmaf(dec, st[m], acc[m]);
  }

  // backward sweep, step x over chunk n - 1 - x: the factors of step x + 2,
  // B = dO v^T and v·dO of step x + 1, then G, dr, dk, dlog_w, du
  cp_async_wait_all();
  __syncthreads();  // the forward sweep's tiles and factors are consumed
  issue(0, n - 1, true);
  cp_async_commit();
  float G[NM], s_end[NM];  // s_end: the state at the chunk's end
#pragma unroll
  for (int m = 0; m < NM; ++m) G[m] = s_end[m] = 0.f;
  float du = 0.f;
  const int k = k0 + kk;
  const long long step = (long long)p.H * p.K;
  for (int x = -2; x < n; ++x) {
    const int c = n - 1 - x;
    float S0[NM];
    if (x >= 0) {  // each thread reads back what it wrote
      const float4* in = reinterpret_cast<const float4*>(
          states + (long long)c * THREADS * NM);
      const float4 a = in[0], bq = in[1];
      S0[0] = a.x; S0[1] = a.y; S0[2] = a.z; S0[3] = a.w;
      S0[4] = bq.x; S0[5] = bq.y; S0[6] = bq.z; S0[7] = bq.w;
    }
    cp_async_wait_all();
    __syncthreads();
    if (x + 3 < n) issue(x + 3, c - 3, true);
    cp_async_commit();
    if (x + 2 < n) factors(x + 2);
    const int y = x + 1;
    if (y >= 0 && y < n) {
      const float* at = ring + (y % NS) * KSTAGE;
      pair_products(at + SG, at + SV, Bm + (y & 1) * LT * PL, nullptr,
                    vdo + (y & 1) * LT, tid);  // B[t][i] = dO_t · v_i
    }
    if (x < 0) continue;

    const float* at = ring + (x % NS) * KSTAGE;
    const float* r = at;
    const float* kv = at + SK;
    const float* v = at + SV;
    const float* g = at + SG;
    const float* rts = fac + (x % 3) * KFAC;   // rt, kt of the slice
    const float* kts = rts + LT * PS;
    const float* ecs = kts + LT * PS;
    const float* emc = ecs + LT * PS;
    const float* ecl = emc + LT * PS;
    const float dec = ecl[LT * PS + kk];
    const float* Bx = Bm + (x & 1) * LT * PL;
    const float* vd = vdo + (x & 1) * LT;

    // a = Σ_v G ⊙ S at the chunk's last step, formed directly (G is dL/dS
    // there; zero after the last chunk): the suffix sum of the dlog_w
    // identity restarts from it at every chunk, since summed over the whole
    // sequence the identity's terms, large where a is small, cancel
    float a_end = dot8(G, s_end);
    a_end += __shfl_xor_sync(FULL, a_end, 1);
    a_end += __shfl_xor_sync(FULL, a_end, 2);
    a_end += __shfl_xor_sync(FULL, a_end, 4);

    // S0 dO_t and G v_t over this thread's 8 values, summed over the group;
    // G <- decay ⊙ G + Σ_t rt_t dO_t^T (after G v_t)
    float px[LT], py[LT], acc[NM];
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[m] = 0.f;
#pragma unroll
    for (int t = 0; t < LT; ++t) {
      row8(g, t, cg, x8);
      px[t] = dot8(S0, x8);
      const float rtt = rts[t * PS + kk];
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[m] = fmaf(rtt, x8[m], acc[m]);
      row8(v, t, cg, y8);
      py[t] = dot8(G, y8);
    }
    float xa, xb, ya, yb;
    reduce_scatter16(px, xa, xb, cg);
    reduce_scatter16(py, ya, yb, cg);

    float ia = 0.f, ib = 0.f, ja = 0.f, jb = 0.f;
#pragma unroll
    for (int i = 0; i < LT; ++i) {
      const float rti = rts[i * PS + kk];
      const float kti = kts[i * PS + kk];
      ia = fmaf(Bx[ta * PL + i], kti, ia);   // Σ_{i<t} B[t][i] kt_i
      ib = fmaf(Bx[tb * PL + i], kti, ib);
      ja = fmaf(Bx[i * PL + ta], rti, ja);   // Σ_{s>t} B[s][t] rt_s
      jb = fmaf(Bx[i * PL + tb], rti, jb);
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) G[m] = fmaf(dec, G[m], acc[m]);

    const float ra = r[ta * PS + kk], rb = r[tb * PS + kk];
    const float ka = kv[ta * PS + kk], kb = kv[tb * PS + kk];
    const float dra0 = ecs[ta * PS + kk] * (xa + ia);
    const float drb0 = ecs[tb * PS + kk] * (xb + ib);
    const float dka0 = fmaf(ecl[ta * PS + kk], ya, emc[ta * PS + kk] * ja);
    const float dkb0 = fmaf(ecl[tb * PS + kk], yb, emc[tb * PS + kk] * jb);
    const float uk = su[kk];
    du = fmaf(ra * ka, vd[ta], du);
    du = fmaf(rb * kb, vd[tb], du);

    // dlog_w_t = a_t − p_t, a_t = a_end + Σ_{s>t} e_s over the chunk, with
    // p = k ⊙ dk°, e = r ⊙ dr° − p: a suffix over the group's lanes (rows
    // 2 cg', 2 cg' + 1)
    const float pa = ka * dka0, pb = kb * dkb0;
    const float ea = fmaf(ra, dra0, -pa), eb = fmaf(rb, drb0, -pb);
    float suf = ea + eb;   // then Σ over lanes cg' >= cg
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const float up = __shfl_down_sync(FULL, suf, d, 8);
      if (cg + d < 8) suf += up;
    }
    float later = __shfl_down_sync(FULL, suf, 1, 8);  // lanes > cg
    if (cg == 7) later = 0.f;
    const float gtb = later + a_end;   // a_tb
    const float gta = eb + gtb;        // a_ta
#pragma unroll
    for (int m = 0; m < NM; ++m) s_end[m] = S0[m];

    if (k < p.K) {
      const long long at0 = (((long long)b * p.S + (long long)c * p.L) *
                             p.H + h) * p.K + k;
      if (ta < p.L) {
        p.dr[at0 + ta * step] = fmaf(uk * ka, vd[ta], dra0);
        p.dk[at0 + ta * step] = fmaf(uk * ra, vd[ta], dka0);
        p.dw[at0 + ta * step] = gta - pa;
      }
      if (tb < p.L) {
        p.dr[at0 + tb * step] = fmaf(uk * kb, vd[tb], drb0);
        p.dk[at0 + tb * step] = fmaf(uk * rb, vd[tb], dkb0);
        p.dw[at0 + tb * step] = gtb - pb;
      }
    }
  }
  du += __shfl_xor_sync(FULL, du, 1);
  du += __shfl_xor_sync(FULL, du, 2);
  du += __shfl_xor_sync(FULL, du, 4);
  if (cg == 0 && k < p.K) p.dup[((long long)b * p.H + h) * p.K + k] = du;
}

// columns j0 .. j0 + 15 of G, all of K: dv. The forward's loop (wkv6.cu)
// run backward over the chunks, dO in place of v.
__device__ __forceinline__ void value_block(const BwdParams& p, float* smem,
                                            int vs, int h, int b, int tid) {
  SliceBlock sb(smem);
  const int j0 = vs * W;
  const int n = p.S / p.L;

  sb.init(p.u, h, p.K, tid);
  auto issue = [&](int x, int c) {  // chunk c into stage x
    sb.issue(x, (long long)c * p.L, p.r, p.k, p.w, p.g, b, h, p.L, j0, p.K,
             p.V, p.vec, tid);
  };
  __syncthreads();  // the zeros land before the copies
  issue(0, n - 1);
  cp_async_commit();
  if (n > 1) issue(1, n - 2);
  cp_async_commit();

  // this thread carries G at keys 4 kq .. + 3 and columns j0 + 2 jp, + 1
  // (G[2 q + c]); after the butterfly it holds dv's row kq there
  const int kq = tid & 15;
  const int jp = tid >> 4;
  float G[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) G[m] = 0.f;

  // step x over chunk n - 1 - x: the factors of step x + 2, A of step
  // x + 1, then dv and G
  for (int x = -2; x < n; ++x) {
    const int c = n - 1 - x;
    cp_async_wait<1>();
    __syncthreads();
    if (x + 4 < n) issue(x + 4, c - 4);
    cp_async_commit();
    sb.front(x, n, tid);
    if (x < 0) continue;

    // dv_t = ke_t^T G (4 keys here, summed over 16 lanes below), then
    // G <- decay ⊙ G + Σ_s rt_s dO_s
    const float* rtc = sb.rt(x);
    const float* ktc = sb.kt(x);
    const float* Ac = sb.A(x);
    const float* g = sb.y(x);
    const float4 dk = ld4(sb.decay(x) + 4 * kq);
    float part[2 * LT], acc[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m] = 0.f;
#pragma unroll
    for (int t = 0; t < LT; ++t) {
      float4 e = ld4(ktc + t * PF + 4 * kq);
      e.x *= dk.x;   // ke = kt decay
      e.y *= dk.y;
      e.z *= dk.z;
      e.w *= dk.w;
      part[2 * t] = fmaf(e.w, G[6], fmaf(e.z, G[4],
                    fmaf(e.y, G[2], e.x * G[0])));
      part[2 * t + 1] = fmaf(e.w, G[7], fmaf(e.z, G[5],
                        fmaf(e.y, G[3], e.x * G[1])));
      const float4 x4 = ld4(rtc + t * PF + 4 * kq);
      const float2 gt = ld2(g + t * PS + 2 * jp);
      acc[0] = fmaf(x4.x, gt.x, acc[0]);
      acc[1] = fmaf(x4.x, gt.y, acc[1]);
      acc[2] = fmaf(x4.y, gt.x, acc[2]);
      acc[3] = fmaf(x4.y, gt.y, acc[3]);
      acc[4] = fmaf(x4.z, gt.x, acc[4]);
      acc[5] = fmaf(x4.z, gt.y, acc[5]);
      acc[6] = fmaf(x4.w, gt.x, acc[6]);
      acc[7] = fmaf(x4.w, gt.y, acc[7]);
    }
    const float dq[4] = {dk.x, dk.y, dk.z, dk.w};
#pragma unroll
    for (int m = 0; m < 8; ++m) G[m] = fmaf(dq[m >> 1], G[m], acc[m]);

    // + Σ_{s >= t} A'[s][t] dO_s (A' = A with diag(r u k) on its diagonal)
    float z0, z1;
    reduce_scatter32(part, z0, z1, kq);
#pragma unroll
    for (int i = 0; i < LT; ++i) {
      const float a = Ac[i * PL + kq];
      const float2 gi = ld2(g + i * PS + 2 * jp);
      z0 = fmaf(a, gi.x, z0);
      z1 = fmaf(a, gi.y, z1);
    }

    const int j = j0 + 2 * jp;
    if (kq < p.L && j < p.V) {
      float* dv = p.dv + (((long long)b * p.S + (long long)c * p.L + kq) *
                          p.H + h) * p.V + j;
      dv[0] = z0;
      if (j + 1 < p.V) dv[1] = z1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
wkv6_chunked_bwd_key_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  key_block(p, smem, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);
}

__global__ void __launch_bounds__(THREADS)
wkv6_chunked_bwd_value_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  value_block(p, smem, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);
}

}  // namespace

// r, k, lw: (B, S, H, K); v, dO: (B, S, H, V); u: (H, K) contiguous.
// strides holds the (b, t, h) element strides of r, k, v, lw, dO in that
// order (15 values); the last dim of each is contiguous. dr, dk, dlw: (B, S,
// H, K), dv: (B, S, H, V), dup: (B, H, K), all contiguous; states: scratch
// of B * H * ceil(K / 16) * (S / L) * 1024 floats. L is the chunk length
// (<= 16, dividing S). Returns a cudaError_t.
extern "C" int wkv6_bwd_f32(const float* r, const float* k, const float* v,
                            const float* lw, const float* u, const float* dO,
                            float* dr, float* dk, float* dv, float* dlw,
                            float* dup, float* states, int B, int S, int H,
                            int K, int V, int L, const long long* strides,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > D || V > D ||
      L <= 0 || L > LT || S % L != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  const float* ptr[5] = {r, k, v, lw, dO};
  Seq* seq[5] = {&p.r, &p.k, &p.v, &p.w, &p.g};
  bool vec = K % 4 == 0 && V % 4 == 0;
  for (int i = 0; i < 5; ++i) {
    *seq[i] = Seq{ptr[i], strides[3 * i], strides[3 * i + 1],
                  strides[3 * i + 2]};
    vec = vec && reinterpret_cast<uintptr_t>(ptr[i]) % 16 == 0 &&
          strides[3 * i] % 4 == 0 && strides[3 * i + 1] % 4 == 0 &&
          strides[3 * i + 2] % 4 == 0;
  }
  p.u = u;
  p.dr = dr;
  p.dk = dk;
  p.dw = dlw;
  p.dv = dv;
  p.dup = dup;
  p.states = states;
  p.S = S;
  p.H = H;
  p.K = K;
  p.V = V;
  p.L = L;
  p.nks = (K + W - 1) / W;
  p.vec = vec;
  const int key_bytes = KEY_SMEM * (int)sizeof(float);
  const int value_bytes = SLICE_SMEM * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // above 48 KiB of shared memory a kernel must ask, once per device (not
  // inside a CUDA graph's capture, which the first call precedes)
  static bool asked[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!asked[dev]) {
    err = cudaFuncSetAttribute(wkv6_chunked_bwd_key_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               key_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(wkv6_chunked_bwd_value_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               value_bytes);
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  wkv6_chunked_bwd_key_kernel<<<dim3(p.nks, H, B), THREADS, key_bytes, st>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_chunked_bwd_value_kernel<<<dim3((V + W - 1) / W, H, B), THREADS,
                                  value_bytes, st>>>(p);
  return (int)cudaGetLastError();
}
