// WKV6 recurrence (RWKV-6 "Finch" time mix), forward, fp32, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6/kernel.py:70 (wkv6_pallas), the TPU
// kernel the reference's time mix runs under use_pallas.
//
// What it computes, per batch b and head h, with a (K, V) state S = 0:
//   o_t = r_t^T (S + diag(u) k_t v_t^T)
//   S   = diag(exp(log_w_t)) S + k_t v_t^T
// over t = 0 .. S-1: the exact per-step form of the reference's
// ref.py::wkv6_scan. r, k, log_w are (B, S, H, K), v is (B, S, H, V), read
// through their strides in the model layout (the last dim contiguous), so no
// folded copy is made; u is (H, K) contiguous; o is (B, S, H, V) fp32.
// K and V are at most 64.
//
// Bound on an H100 SXM: per (token, head) the function does 4*K*V flops
// (k v^T, u-weighted sum, r contraction, decayed update) and moves
// 4*(3K + 2V) bytes (r, k, log_w, v read once, o written once): at
// K = V = 64, 16384 flops on 1280 bytes, 12.8 flops per byte, below the fp32
// FFMA ridge of 67 TFLOP/s over 3.35 TB/s = 20 flops per byte, so the ideal
// kernel is bound by bytes.
//
// Design: the TPU grid (B*H, S/L) ran its chunk axis in order and kept the
// state in VMEM scratch across grid steps, with the within-chunk decay
// factored onto the MXU. Blocks on the GPU run in no order, so one block
// owns one (b, h) and loops over time itself. Thread j of the block's 64
// owns the state's column j in registers (KP floats, KP = K rounded up to
// 16, 32 or 64) and u in registers; the block stages T = 32 time steps of
// r, k, exp(log_w) and v in shared memory (32 KiB at KP = 64) with loads
// coalesced along the contiguous dim, then walks the 32 steps out of
// shared memory: every thread reads the same r, k, w words (broadcast, in
// 16-byte loads) and writes o[t, j], coalesced across the block. Keys past
// K are staged as zeros, so their state stays 0 and adds nothing. The dot
// product over K is split over four partial sums to shorten the dependent
// chain. This is simple, not fast: at the train shape only B*H = 80 blocks
// of 2 warps run on 132 SMs, and each step's K-long loop is serial within
// a thread. Splitting each column over several threads with a shuffle
// reduction of r.S, and double-buffering the staged steps, are for a
// later redesign.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;         // time steps staged per round
constexpr int THREADS = 64;   // one per value column, V <= 64
constexpr int MAX_KV = 64;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  float* o;
  long long rs[3], ks[3], vs[3], ws[3], os[3];  // (b, t, h) strides
  int S, K, V;
};

template <int KP>
__global__ void __launch_bounds__(THREADS) wkv6_fwd_kernel(Params p) {
  __shared__ __align__(16) float sr[T][KP];
  __shared__ __align__(16) float sk[T][KP];
  __shared__ __align__(16) float sw[T][KP];
  __shared__ float sv[T][THREADS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const bool has_col = j < p.V;

  float u[KP];
  float state[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    u[i] = i < p.K ? p.u[(long long)h * p.K + i] : 0.f;
    state[i] = 0.f;
  }

  const long long rb = b * p.rs[0] + h * p.rs[2];
  const long long kb = b * p.ks[0] + h * p.ks[2];
  const long long wb = b * p.ws[0] + h * p.ws[2];
  const long long vb = b * p.vs[0] + h * p.vs[2];
  const long long ob = b * p.os[0] + h * p.os[2];

  for (int t0 = 0; t0 < p.S; t0 += T) {
    const int nt = min(T, p.S - t0);
    __syncthreads();  // the previous round's steps are consumed
    for (int idx = threadIdx.x; idx < T * KP; idx += THREADS) {
      const int tt = idx / KP;
      const int i = idx % KP;
      const bool ok = tt < nt && i < p.K;
      const long long t = t0 + tt;
      sr[tt][i] = ok ? p.r[rb + t * p.rs[1] + i] : 0.f;
      sk[tt][i] = ok ? p.k[kb + t * p.ks[1] + i] : 0.f;
      sw[tt][i] = ok ? expf(p.lw[wb + t * p.ws[1] + i]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < T * THREADS; idx += THREADS) {
      const int tt = idx / THREADS;
      const int c = idx % THREADS;
      const bool ok = tt < nt && c < p.V;
      sv[tt][c] = ok ? p.v[vb + (long long)(t0 + tt) * p.vs[1] + c] : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float vj = sv[tt][j];
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i = 0; i < KP; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i]);
        float a;
        a = k4.x * vj;
        o0 = fmaf(r4.x, fmaf(u[i], a, state[i]), o0);
        state[i] = fmaf(w4.x, state[i], a);
        a = k4.y * vj;
        o1 = fmaf(r4.y, fmaf(u[i + 1], a, state[i + 1]), o1);
        state[i + 1] = fmaf(w4.y, state[i + 1], a);
        a = k4.z * vj;
        o2 = fmaf(r4.z, fmaf(u[i + 2], a, state[i + 2]), o2);
        state[i + 2] = fmaf(w4.z, state[i + 2], a);
        a = k4.w * vj;
        o3 = fmaf(r4.w, fmaf(u[i + 3], a, state[i + 3]), o3);
        state[i + 3] = fmaf(w4.w, state[i + 3], a);
      }
      if (has_col)
        p.o[ob + (long long)(t0 + tt) * p.os[1] + j] = (o0 + o1) + (o2 + o3);
    }
  }
}

template <int KP>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  wkv6_fwd_kernel<KP><<<dim3(H, B), THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, lw: (B, S, H, K); v, o: (B, S, H, V); u: (H, K) contiguous. strides
// holds (b, t, h) element strides of r, k, v, lw, o in that order (15
// values); the last dim of each is contiguous. Returns a cudaError_t.
extern "C" int wkv6_fwd_f32(const float* r, const float* k, const float* v,
                            const float* lw, const float* u, float* o, int B,
                            int S, int H, int K, int V,
                            const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || V <= 0 || K > MAX_KV ||
      V > MAX_KV || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.lw = lw;
  p.u = u;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ws[i] = strides[9 + i];
    p.os[i] = strides[12 + i];
  }
  p.S = S;
  p.K = K;
  p.V = V;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 16) return launch<16>(p, B, H, s);
  if (K <= 32) return launch<32>(p, B, H, s);
  return launch<64>(p, B, H, s);
}
