// WKV6 recurrence (RWKV-6 "Finch" time mix), forward, fp32, for Hopper
// (sm_90a): the chunked form, the state carried inside the block.
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:70 (wkv6_pallas), the TPU
// kernel the reference's time mix runs under use_pallas.
//
// What it computes, per batch b and head h, with a (K, V) state S = 0:
//   o_t = r_t^T (S + diag(u) k_t v_t^T)
//   S   = diag(exp(log_w_t)) S + k_t v_t^T
// over t = 0 .. S-1, as wkv6_pallas does: chunk by chunk (L <= 16 steps,
// S a whole number of chunks), with the factors of wkv6_common.cuh,
//   o   = rt S + A v + diag(r u k) v,    S <- decay ⊙ S + ke^T v.
// r, k, log_w are (B, S, H, K), v is (B, S, H, V), read through their
// strides in the model layout (the last dim contiguous), so no folded copy
// is made; u is (H, K) contiguous; o is (B, S, H, V) fp32 contiguous. K and
// V are at most 64. The factoring is exact within the reference's fp32
// domain: log_w >= -e^{1.6} and L <= 16 keep |c| <= 79.2 (ref.py).
//
// Bound on an H100 SXM: the function moves 4 (3K + 2V) bytes per (token,
// head) (r, k, log_w, v read once, o written once) and needs 4 K V flops
// (the per-step form); the chunked form does 2 L K + 2 L V + 4 K V. At the
// rwkv6-3b train shape (B 2, S 1024, H 40, K = V = 64) that is 105 MB, 31
// us at 3.35 TB/s, against 1.7 GFLOP of FFMA, 25 us at 67 TFLOP/s: bytes
// bound it, and the FP32 pipe is not what limits. The chain over chunks,
// the few blocks that one (b, h) gives and the latency of each chunk's
// steps are what limit, so:
// - One block per (b, h, 16-column slice of V): column j of S and of o
//   depends only on column j of v, so a block carries its K x 16 part of S,
//   thread (kq = tid % 16, jp = tid / 16) holding keys 4 kq .. + 3 at
//   columns 2 jp, + 1 (a row of rt or kt is one 16-byte load for 8 FMAs).
//   The train shape gives 320 blocks (one block per (b, h) would give 80,
//   leaving 52 of the 132 SMs idle). Each block computes the
//   chunk's factors and A for itself; the four blocks of one (b, h) run
//   side by side, so their common r, k, log_w come from L2.
// - The three-deep pipeline of wkv6_common.cuh (SliceBlock): a step
//   computes the factors of chunk c + 2 (all 128 threads, each a key and 8 rows, 2 expf a value;
//   diag(r u k) by a warp butterfly), A of chunk c + 1 (72 threads, two to
//   a 2 x 2 tile on or below the diagonal, diag(r u k) written on A's
//   diagonal) and o and S of chunk c (rt S over 4 keys and a butterfly over
//   16 lanes, then A v; ke = kt decay formed there), with one barrier; the
//   tiles of chunk c + 4 load by cp.async (16 bytes a copy) meanwhile, two
//   steps ahead of their use. Full-width tiles have a pitch of K + 4
//   floats, so the row-wise reads are free of bank conflicts. 74 KB of
//   shared memory, three blocks an SM.
// - Accurate expf (2 ulp): e^{-c} reaches e^{79}, where ex2.approx with a
//   rounded argument would err by ~5e-6.

#include "wkv6_common.cuh"

namespace {

using namespace wkv6;

struct FwdParams {
  Seq r, k, v, w;   // w: log_w
  const float* u;   // (H, K)
  float* o;         // (B, S, H, V) contiguous
  int S, H, K, V, L;
  bool vec;
};

__global__ void __launch_bounds__(THREADS)
wkv6_chunked_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  SliceBlock sb(smem);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * W;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = p.S / p.L;

  sb.init(p.u, h, p.K, tid);
  auto issue = [&](int x) {  // chunk x into stage x
    sb.issue(x, (long long)x * p.L, p.r, p.k, p.w, p.v, b, h, p.L, j0, p.K,
             p.V, p.vec, tid);
  };
  __syncthreads();  // the zeros land before the copies
  issue(0);
  cp_async_commit();
  if (n > 1) issue(1);
  cp_async_commit();

  // this thread carries S at keys 4 kq .. + 3 and columns j0 + 2 jp, + 1
  // (st[2 q + c]); after the butterfly it holds o's row kq at those columns
  const int kq = tid & 15;
  const int jp = tid >> 4;
  float st[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) st[m] = 0.f;

  // step c: the factors of chunk c + 2, A of chunk c + 1, o and S of chunk
  // c; chunk c + 2 landed during steps c - 2 and c - 1, chunk c + 4 starts
  // loading now
  for (int c = -2; c < n; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    if (c + 4 < n) issue(c + 4);
    cp_async_commit();
    sb.front(c, n, tid);
    if (c < 0) continue;

    // o_t = rt_t S (this thread's 4 keys; summed over 16 lanes below) and
    // S <- decay ⊙ S + sum_t ke_t v_t
    const float* rtc = sb.rt(c);
    const float* ktc = sb.kt(c);
    const float* Ac = sb.A(c);
    const float* v = sb.y(c);
    const float4 dk = ld4(sb.decay(c) + 4 * kq);
    float part[2 * LT], acc[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m] = 0.f;
#pragma unroll
    for (int t = 0; t < LT; ++t) {
      const float4 x = ld4(rtc + t * PF + 4 * kq);
      part[2 * t] = fmaf(x.w, st[6], fmaf(x.z, st[4],
                    fmaf(x.y, st[2], x.x * st[0])));
      part[2 * t + 1] = fmaf(x.w, st[7], fmaf(x.z, st[5],
                        fmaf(x.y, st[3], x.x * st[1])));
      float4 e = ld4(ktc + t * PF + 4 * kq);
      e.x *= dk.x;   // ke = kt decay
      e.y *= dk.y;
      e.z *= dk.z;
      e.w *= dk.w;
      const float2 vt = ld2(v + t * PS + 2 * jp);
      acc[0] = fmaf(e.x, vt.x, acc[0]);
      acc[1] = fmaf(e.x, vt.y, acc[1]);
      acc[2] = fmaf(e.y, vt.x, acc[2]);
      acc[3] = fmaf(e.y, vt.y, acc[3]);
      acc[4] = fmaf(e.z, vt.x, acc[4]);
      acc[5] = fmaf(e.z, vt.y, acc[5]);
      acc[6] = fmaf(e.w, vt.x, acc[6]);
      acc[7] = fmaf(e.w, vt.y, acc[7]);
    }
    const float dq[4] = {dk.x, dk.y, dk.z, dk.w};
#pragma unroll
    for (int m = 0; m < 8; ++m) st[m] = fmaf(dq[m >> 1], st[m], acc[m]);

    // + sum_{i <= t} A'[t][i] v_i (A' = A with diag(r u k) on its diagonal)
    float y0, y1;
    reduce_scatter32(part, y0, y1, kq);
#pragma unroll
    for (int i = 0; i < LT; ++i) {
      const float a = Ac[kq * PL + i];
      const float2 vi = ld2(v + i * PS + 2 * jp);
      y0 = fmaf(a, vi.x, y0);
      y1 = fmaf(a, vi.y, y1);
    }

    const int j = j0 + 2 * jp;
    if (kq < p.L && j < p.V) {
      float* o = p.o + (((long long)b * p.S + (long long)c * p.L + kq) * p.H
                        + h) * p.V + j;
      o[0] = y0;
      if (j + 1 < p.V) o[1] = y1;
    }
  }
}

}  // namespace

// r, k, lw: (B, S, H, K); v: (B, S, H, V); u: (H, K) contiguous; o: (B, S,
// H, V) contiguous. strides holds the (b, t, h) element strides of r, k, v,
// lw in that order (12 values); the last dim of each is contiguous. L is
// the chunk length (<= 16, dividing S). Returns a cudaError_t.
extern "C" int wkv6_fwd_f32(const float* r, const float* k, const float* v,
                            const float* lw, const float* u, float* o, int B,
                            int S, int H, int K, int V, int L,
                            const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > D || V > D ||
      L <= 0 || L > LT || S % L != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  const float* ptr[4] = {r, k, v, lw};
  Seq* seq[4] = {&p.r, &p.k, &p.v, &p.w};
  bool vec = K % 4 == 0 && V % 4 == 0;
  for (int i = 0; i < 4; ++i) {
    *seq[i] = Seq{ptr[i], strides[3 * i], strides[3 * i + 1],
                  strides[3 * i + 2]};
    vec = vec && reinterpret_cast<uintptr_t>(ptr[i]) % 16 == 0 &&
          strides[3 * i] % 4 == 0 && strides[3 * i + 1] % 4 == 0 &&
          strides[3 * i + 2] % 4 == 0;
  }
  p.u = u;
  p.o = o;
  p.S = S;
  p.H = H;
  p.K = K;
  p.V = V;
  p.L = L;
  p.vec = vec;
  const int bytes = SLICE_SMEM * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // above 48 KiB of shared memory a kernel must ask, once per device (not
  // inside a CUDA graph's capture, which the first call precedes)
  static bool asked[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!asked[dev]) {
    err = cudaFuncSetAttribute(wkv6_chunked_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    asked[dev] = true;
  }
  const dim3 grid((V + W - 1) / W, H, B);
  wkv6_chunked_fwd_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
