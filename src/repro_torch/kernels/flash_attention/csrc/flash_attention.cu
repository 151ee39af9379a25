// Forward flash attention (online softmax) for Hopper (sm_90a), fp32 in and
// out, fp32 statistics and accumulator.
//
// Replaces, for fp32 inputs: src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas, the TPU kernel that the LLM tier's prefill and
// forward run per layer. bf16 inputs run flash_attention_wgmma.cu (wgmma
// and TMA); this SIMT kernel holds the reference's 2e-5 fp32 bar, which
// TF32 on the tensor cores cannot.
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
// (B=4, H=32, S=2048, hd=64, causal) that is 68.7 GFLOP on 168 MB in fp32,
// so the ideal kernel is bound by operations at the 67 TFLOP/s FFMA peak.
//
// Design: the TPU grid (B, H, Sq/BQ, Sk/BK) ran the key axis as a sequential
// grid axis into VMEM scratch. Here a block owns one BQ-row query tile of one
// (b, h) and loops over key tiles of BK = 64 itself, keeping the running max
// m, normalizer l and the (BQ, hd) accumulator in registers (fp32). 128
// threads as 8 row groups x 16 column groups: a thread holds R = BQ/8 query
// rows, 4 keys of the logit tile and hd/16 columns of the accumulator, so the
// row max and sum reduce over 16 lanes of one warp with shuffles. Q is staged
// once, transposed, in shared memory; K (transposed) and then V (row-major)
// share one shared buffer per key tile, and the probabilities go through
// shared memory for the P.V product. Key tiles beyond the causal frontier or
// before the window are never visited; ragged Sq and Sk are masked in the
// kernel. Query tiles are scheduled last-first so that the longest (causal)
// tiles start first. Plain fp32 FFMA throughout (SIMT, no tensor cores).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 8 row groups x 16 column groups
constexpr int TY = 8;
constexpr int TX = 16;
constexpr int CK = BK / TX;     // keys of the logit tile per thread
constexpr float NEG = -1e30f;   // the Pallas kernel's masked logit

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];   // strides over (b, h, s), elements
  int G, Sq, Sk, causal, window, q_offset;
  float scale, softcap;
};


template <int HD, int BQ>
constexpr size_t smem_bytes() {
  // Qt [HD][BQ+1], K^T [HD][BK+1] shared with V [BK][HD], P [BQ][BK+1]
  return sizeof(float) * ((size_t)HD * (BQ + 1) + (size_t)HD * (BK + 1) +
                          (size_t)BQ * (BK + 1));
}

template <int HD, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int R = BQ / TY;      // query rows per thread
  constexpr int CD = HD / TX;     // accumulator columns per thread
  constexpr int QP = BQ + 1;      // padded pitches: the transposed stores
  constexpr int KP = BK + 1;      // below hit distinct banks
  extern __shared__ float smem[];
  float* Qt = smem;                       // [HD][QP]
  float* KV = Qt + HD * QP;               // K^T [HD][KP], then V [BK][HD]
  float* Ps = KV + HD * KP;               // [BQ][KP]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / p.G;

  const float* qb = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
  const float* kb = (const float*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const float* vb = (const float*)p.v + b * p.vs[0] + kvh * p.vs[1];
  float* ob = (float*)p.o + b * p.os[0] + h * p.os[1];

  // stage Q transposed: consecutive threads read consecutive columns
  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    const int qi = q0 + i;
    Qt[d * QP + i] = qi < p.Sq ? qb[qi * p.qs[2] + d] : 0.0f;
  }

  float m[R], l[R], acc[R][CD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.0f;
  }

  // the key tiles any row of this query tile can see
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's P.V is done with KV and Ps
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int kj = k0 + j;
      KV[d * KP + j] = kj < p.Sk ? kb[kj * p.ks[2] + d] : 0.0f;
    }
    __syncthreads();

    float s[R][CK];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[R], kv[CK];
#pragma unroll
      for (int r = 0; r < R; ++r) qv[r] = Qt[d * QP + ty + TY * r];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = KV[d * KP + tx + TX * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + ty + TY * r + p.q_offset;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kpos = k0 + tx + TX * c;
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        float x = s[r][c] * p.scale;
        if (p.softcap > 0.0f) x = tanhf(x / p.softcap) * p.softcap;
        s[r][c] = ok ? x : NEG;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        // masked keys weigh exactly 0, so a row that sees no key keeps l = 0
        const float pv = s[r][c] > 0.5f * NEG ? expf(s[r][c] - m_new) : 0.0f;
        Ps[(ty + TY * r) * KP + tx + TX * c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();   // everyone is done with K^T

    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int kj = k0 + j;
      KV[j * HD + d] = kj < p.Sk ? vb[kj * p.vs[2] + d] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[R], vv[CD];
#pragma unroll
      for (int r = 0; r < R; ++r) pr[r] = Ps[(ty + TY * r) * KP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = KV[j * HD + tx + TX * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + ty + TY * r;
    if (qi >= p.Sq) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      ob[qi * p.os[2] + tx + TX * c] = acc[r][c] * inv;
  }
}

template <int HD, int BQ>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ>();
  static bool attr_set = false;   // opt in above 48 KiB once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD, BQ><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, int B, int H, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64, 64>(p, B, H, stream);
    case 128: return launch<128, 64>(p, B, H, stream);
    case 256: return launch<256, 32>(p, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: fp32 device pointers laid out by `strides`: 12 element
// strides, (b, h, s) for q, k, v and o in that order, with hd contiguous. Launches on `stream` and returns cudaGetLastError()
// (0 on success); the shape checks raise in the Python wrapper first.
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
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  p.scale = 1.0f / sqrtf((float)hd);
  p.softcap = softcap;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(p, B, H, hd, s);
}
