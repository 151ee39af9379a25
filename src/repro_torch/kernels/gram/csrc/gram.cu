// Batched Gram reduction out[b] = a[b]^T a[b] in fp32 for Hopper (sm_90a),
// on the tensor cores in 3xTF32.
//
// Replaces: src/repro/kernels/gram/kernel.py:47 gram_batched_pallas (and
// its B=1 case gram_pallas, :77), the TPU kernel of FedDCL step 3.
//
// What it computes: out[b, i, j] = sum_k a[b, k, i] * a[b, k, j] for a
// (B, r, m) fp32 stack, giving (B, m, m) fp32, exactly symmetric and
// bitwise the same from call to call.
//
// Bound on an H100 SXM: the output is symmetric, so the function needs
// B*r*m*(m+1) flops (one triangle and the diagonal) on (B*r*m + B*m*m)*4
// bytes. fp32-accurate products run either as FFMA (67 TFLOP/s) or as
// three TF32 products on the tensor cores (495 TFLOP/s dense, so 165
// TFLOP/s of fp32 work); the least time is the larger of the bytes at
// 3.35 TB/s and the work on the faster route: 0.5-2.6 us at the fit's
// shapes, (B, r, m) = (1-5, 2000, 200-250), and 0.83 ms of 3xTF32 work at
// (16, 8192, 1024). At the fit's shapes a call is bound by how much of the
// card it fills and by latency, not by either rate.
//
// Design, and what it does about that:
// - Only upper-triangle tiles run (I <= J, a linear tile index decoded in
//   the kernel): half the work of computing every tile. Each tile is
//   written to (I, J) and, transposed, to (J, I) from the same sums; a
//   diagonal tile writes its upper half and mirrors it. So the output is
//   exactly symmetric by construction, which the 3xTF32 terms would
//   otherwise break (hi*lo' and lo*hi' land in (i, j) and (j, i) in
//   different orders).
// - r is split into `split` contiguous slices of 64-row panels, one block
//   each, so that the fit's 10-50 triangle tiles fill the card (kernel.plan
//   picks the split on the host: about 1.5 blocks an SM, at most 8). The
//   blocks of one tile form a thread-block cluster along the split axis;
//   each parks its partial 64x64 tile in its shared memory, and after a
//   cluster barrier each block sums a share of the tile's rows over the
//   cluster's ranks in rank order, with 16-byte loads from distributed
//   shared memory, and stores them. No workspace, no atomics: the sum is in
//   a fixed order, so the result is deterministic. Clusters are held to the
//   portable 8: 10-16 blocks ran slower on the card.
// - Products on the tensor cores in 3xTF32: every operand x is split into
//   hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna.tf32.f32's
//   rounding, done in integer operations), and lo*hi' + hi*lo' + hi*hi'
//   goes through the tensor cores (about 2^-21 per product; TF32 alone,
//   ~1e-3, would fail the 1e-5 bars). The tensor core adds into its
//   accumulator rounding toward zero, which over all of r biases the sum
//   by about an ulp an add; so the three products of each 8 rows start
//   from zero and are added to the running sum in fp32, to nearest.
// - The route is mma.sync.m16n8k8.tf32, not wgmma: wgmma's tf32 form needs
//   both shared-memory operands K-major (r-contiguous), which a's
//   m-contiguous rows are not, so it would need transposed staging and
//   separate hi and lo tiles; mma.sync takes fragments loaded from shared
//   memory in any layout, and the split happens in registers. Its cost:
//   TF32 mma.sync issues slowly on Hopper. At (16, 8192, 1024) this kernel
//   runs some 133 TFLOP/s of TF32 products on an H100 SXM (chip_smoke.py),
//   a quarter of the tensor cores' 495, so three products come near
//   FFMA's rate; wgmma is the way past it.
// - Loads overlap the products: 64-row panels of a slice go through a
//   3-stage cp.async ring (one barrier per panel). Rows of a are
//   m * 4 bytes, which is not a multiple of 16 at m = 250 (the central
//   Gram) or 77; the copy width is a template (16, 8 or 4 bytes) that the
//   wrapper picks from m and the pointer's alignment, and the ragged edges
//   of r and m are zero-filled by cp.async's source size. No padded copy.
// - 256 threads, a 64x64 tile: each warp a 32x32 quarter (2 x 4 fragments
//   of m16n8, 24 mma.sync per 8 rows) over one half of every panel, the
//   two halves' sums added at the end in a fixed order. Two warps a
//   quarter hide the latency one warp could not. On a diagonal tile the
//   warps whose quarter lies strictly below the diagonal do no products.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 64;       // output tile edge
constexpr int BK = 64;         // rows of a per staged panel
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int KSTEPS = BK / 16;  // k8 steps of a panel for each warp group
constexpr int LDS = TILE + 8;  // staged row stride: fragment loads hit 32 banks
constexpr int LDP = TILE + 4;  // partial tile row stride, 16-byte rows
constexpr int THREADS = 256;   // 8 warps: 4 quarters x 2 halves of a panel
constexpr int MAX_SPLIT = 8;   // cluster size, portable
constexpr int MAX_DEVICES = 64;
constexpr int STAGE_FLOATS = 2 * BK * LDS;  // row panel + column panel
constexpr int SMEM_FLOATS = STAGES * STAGE_FLOATS;
static_assert(2 * TILE * LDP <= SMEM_FLOATS,
              "the partial tiles and the summed rows reuse the ring");

constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

// The block's shared memory (dynamic, SMEM_BYTES), at namespace scope so
// that every access below indexes it directly and compiles to shared (not
// generic) loads.
extern __shared__ __align__(16) float smem[];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One VEC-float copy into shared memory; `ok` false zero-fills it.
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const uint32_t d = smem_u32(dst);
  const int n = ok ? 4 * VEC : 0;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  } else if constexpr (VEC == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [k0, k0 + BK) of the column panels at i0 and j0 into smem at As and
// Bs (j0's only if the tile is off the diagonal), zero past r and m.
template <int VEC>
__device__ __forceinline__ void load_stage(int As, int Bs, const float* ab,
                                           int k0, int r, int m, int i0,
                                           int j0, bool diag, int tid) {
  constexpr int PER_ROW = TILE / VEC;
  constexpr int CHUNKS = BK * PER_ROW;
#pragma unroll
  for (int l = 0; l < CHUNKS / THREADS; ++l) {
    const int c = tid + l * THREADS;
    const int row = c / PER_ROW;
    const int col = (c % PER_ROW) * VEC;
    const int k = k0 + row;
    const float* rowp = ab + (size_t)k * (size_t)m;
    const bool ok_a = k < r && i0 + col < m;
    cp_async<VEC>(&smem[As + row * LDS + col], ok_a ? rowp + i0 + col : ab,
                  ok_a);
    if (!diag) {
      const bool ok_b = k < r && j0 + col < m;
      cp_async<VEC>(&smem[Bs + row * LDS + col],
                    ok_b ? rowp + j0 + col : ab, ok_b);
    }
  }
}

// x = hi + lo + O(2^-22 |x|): hi and lo rounded to TF32 (10 mantissa bits,
// low 13 bits zero) to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds, in two integer operations each instead of a conversion.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's 32x32 quarter over rows kk..kk+7 of a staged panel. A = X^T
// (16x8 fragments of rows wm..), B = X (8x8 fragments of columns wn..); X
// is stored k-major (row k of a at smem[As + k * LDS]), so A[i][k] =
// smem[As + k * LDS + i].
__device__ __forceinline__ void k8_products(int As, int Bs,
                                            float (&acc)[2][4][4], int kk,
                                            int wm, int wn, int g, int tq) {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* p = smem + As + (kk + tq) * LDS + wm + mi * 16 + g;
    split_tf32(p[0], ah[mi][0], al[mi][0]);              // (g,   t)
    split_tf32(p[8], ah[mi][1], al[mi][1]);              // (g+8, t)
    split_tf32(p[4 * LDS], ah[mi][2], al[mi][2]);        // (g,   t+4)
    split_tf32(p[4 * LDS + 8], ah[mi][3], al[mi][3]);    // (g+8, t+4)
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const float* p = smem + Bs + (kk + tq) * LDS + wn + ni * 8 + g;
    split_tf32(p[0], bh[ni][0], bl[ni][0]);              // (t,   g)
    split_tf32(p[4 * LDS], bh[ni][1], bl[ni][1]);        // (t+4, g)
  }
  // The tensor core adds into its accumulator rounding toward zero: over
  // all of r that biases the sum by ~1 ulp an add. So the three products
  // of 8 rows start from zero, and the running sum takes them by an fp32
  // add, to nearest.
  float d[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mi][ni][e] = 0.0f;
      mma_tf32(d[mi][ni], al[mi], bh[ni]);
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_tf32(d[mi][ni], ah[mi], bl[ni]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_tf32(d[mi][ni], ah[mi], bh[ni]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[mi][ni][e];
}

__device__ __forceinline__ void store_quarter(int P,
                                              const float (&acc)[2][4][4],
                                              int wm, int wn, int g, int tq) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      float* p = smem + P + (wm + mi * 16 + g) * LDP + wn + ni * 8 + 2 * tq;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mi][ni][0],
                                                  acc[mi][ni][1]);
      *reinterpret_cast<float2*>(p + 8 * LDP) = make_float2(acc[mi][ni][2],
                                                            acc[mi][ni][3]);
    }
}

// grid (split * tiles, B); cluster (split, 1, 1): block x = tile * split + q
// reduces slice q of r for triangle tile `tile` of batch blockIdx.y.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
gram_tc_kernel(const float* __restrict__ a, float* __restrict__ out, int r,
               int m, int nt, int split) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();          // == blockIdx.x % split
  // The tile decode and the r slices below are mirrored in kernel.py
  // (triangle_tile, slices), which the CPU tests check: change them
  // together.
  int t = blockIdx.x / split;                       // upper-triangle tile
  int I = 0;
  while (t >= nt - I) {                             // row-major over I <= J
    t -= nt - I;
    ++I;
  }
  const int J = I + t;
  const bool diag = I == J;
  const int i0 = I * TILE;
  const int j0 = J * TILE;
  const int b = blockIdx.y;
  const float* ab = a + (size_t)b * (size_t)r * (size_t)m;

  const int nk = (r + BK - 1) / BK;                 // panels in all of r
  const int kb = q * nk / split;
  const int n = (q + 1) * nk / split - kb;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int half = warp >> 2;                       // which half of a panel
  const int wm = ((warp >> 1) & 1) * 32;
  const int wn = (warp & 1) * 32;
  const bool active = !(diag && wm > wn);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto stage_a = [&](int s) { return s * STAGE_FLOATS; };
  auto stage_b = [&](int s) {
    return diag ? s * STAGE_FLOATS : s * STAGE_FLOATS + BK * LDS;
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n)
      load_stage<VEC>(stage_a(s), stage_b(s), ab, (kb + s) * BK, r, m, i0,
                      j0, diag, tid);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // panel `it` landed; panel it-1 is consumed
    const int nx = it + STAGES - 1;
    if (nx < n)
      load_stage<VEC>(stage_a(nx % STAGES), stage_b(nx % STAGES), ab,
                      (kb + nx) * BK, r, m, i0, j0, diag, tid);
    cp_async_commit();
    if (active) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        k8_products(stage_a(it % STAGES), stage_b(it % STAGES), acc,
                    8 * (half * KSTEPS + ks), wm, wn, g, tq);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this slice's partial tile: the second half's warps park their sums,
  // the first half's add them to their own (a fixed order) and park the
  // tile in P
  constexpr int P = 0;
  constexpr int P1 = TILE * LDP;
  if (half == 1) store_quarter(P1, acc, wm, wn, g, tq);
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* p =
            smem + P1 + (wm + mi * 16 + g) * LDP + wn + ni * 8 + 2 * tq;
        acc[mi][ni][0] += p[0];
        acc[mi][ni][1] += p[1];
        acc[mi][ni][2] += p[8 * LDP];
        acc[mi][ni][3] += p[8 * LDP + 1];
      }
    store_quarter(P, acc, wm, wn, g, tq);
  }
  cluster.sync();            // release P to the cluster, acquire theirs

  // Block q sums rows [r0, r1) of the tile over the cluster's ranks in rank
  // order (16-byte loads from distributed shared memory) into S, then
  // stores S to (I, J) and, transposed, to (J, I): both copies of an entry
  // are one sum, so the output is exactly symmetric. A diagonal tile stores
  // the upper half of S and mirrors it.
  float* S = smem + P1;             // free since the cluster barrier
  const int r0 = q * TILE / split;
  const int rows = (q + 1) * TILE / split - r0;
  for (int e = tid; e < rows * (TILE / 4); e += THREADS) {
    const int u = e / (TILE / 4);
    const int off = (r0 + u) * LDP + (e % (TILE / 4)) * 4;
    const uint32_t local = smem_u32(smem + P + off);
    float4 part[MAX_SPLIT];
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (s < split) {
        uint32_t remote;
        asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
            : "=r"(remote) : "r"(local), "r"(s));
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(part[s].x), "=f"(part[s].y), "=f"(part[s].z),
                       "=f"(part[s].w)
                     : "r"(remote));
      }
    }
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (s < split) {
        sum.x += part[s].x;
        sum.y += part[s].y;
        sum.z += part[s].z;
        sum.w += part[s].w;
      }
    }
    *reinterpret_cast<float4*>(S + u * LDP + (e % (TILE / 4)) * 4) = sum;
  }
  __syncthreads();
  float* ob = out + (size_t)b * (size_t)m * (size_t)m;
  for (int e = tid; e < rows * TILE; e += THREADS) {
    const int u = e / TILE;           // (I, J): row r0 + u, column v
    const int v = e % TILE;
    if ((!diag || v >= r0 + u) && i0 + r0 + u < m && j0 + v < m)
      ob[(size_t)(i0 + r0 + u) * (size_t)m + j0 + v] = S[u * LDP + v];
  }
  for (int e = tid; e < rows * TILE; e += THREADS) {
    const int v = e / rows;           // (J, I): row v, column r0 + u
    const int u = e % rows;
    if ((!diag || v > r0 + u) && j0 + v < m && i0 + r0 + u < m)
      ob[(size_t)(j0 + v) * (size_t)m + i0 + r0 + u] = S[u * LDP + v];
  }
  // no block leaves while its tile is read; nothing to order but the reads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int VEC>
int launch(const float* a, float* out, int B, int r, int m, int split,
           cudaStream_t stream) {
  // the shared-memory limit is a per-device attribute of the function
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(gram_tc_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  const int nt = (m + TILE - 1) / TILE;
  const long long tiles = (long long)nt * (nt + 1) / 2;
  if (tiles * split > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split), (unsigned)B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gram_tc_kernel<VEC>, a, out, r, m, nt,
                           split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// a: (B, r, m) contiguous fp32 on the device; out: (B, m, m) contiguous fp32.
// split: r slices per tile, 1..8 (the cluster size; kernel.plan picks it);
// vec: floats per cp.async, 4, 2 or 1, dividing m and the pointer's
// alignment. Launches on `stream` and returns the launch's CUDA error (0 on
// success).
extern "C" int gram_batched_f32(const float* a, float* out, int B, int r,
                                int m, int split, int vec, void* stream) {
  if (B <= 0 || m <= 0 || r < 0 || B > 65535 || split < 1 ||
      split > MAX_SPLIT || vec < 1 || m % vec != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 4: return launch<4>(a, out, B, r, m, split, s);
    case 2: return launch<2>(a, out, B, r, m, split, s);
    case 1: return launch<1>(a, out, B, r, m, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
