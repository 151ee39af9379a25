// Batched Gram reduction out[b] = a[b]^T a[b] in fp32 for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram/kernel.py::gram_batched_pallas (and its
// B=1 case gram_pallas), the TPU kernel of FedDCL step 3.
//
// What it computes: out[b, i, j] = sum_k a[b, k, i] * a[b, k, j] for a
// (B, r, m) fp32 stack, giving (B, m, m) fp32. Plain fp32 FFMA, no TF32: the
// incremental-onboarding bar (maintained Gram == recomputed Gram, 1e-5) does
// not survive TF32's ~1e-3.
//
// Bound on an H100 SXM: the output is symmetric, so the function needs
// B*r*m*(m+1) flops (one triangle and the diagonal) on (B*r*m + B*m*m)*4
// bytes, ((m+1)/4)*r/(r+m) flops per byte: ~46 at the protocol's (r, m) =
// (2000, 200), above the fp32 FFMA ridge of 67 TFLOP/s over 3.35 TB/s = 20
// flops per byte, so the ideal kernel is bound by operations. This kernel
// computes every tile, twice that work. At the protocol's sizes the whole
// call is well under a millisecond and launch latency dominates.
//
// Design: the TPU grid (B, m/BM, m/BN, r/BR) ran its r-reduction as a
// sequential grid axis into a VMEM accumulator. Blocks on the GPU run in no
// order, so each block owns one 64x64 output tile and loops over r itself,
// keeping the sum in registers: 256 threads, each a 4x4 accumulator. Each
// step stages a TILE_K x 64 slab of the row and column panels in shared
// memory with loads coalesced along m, and masks the ragged edges of r and
// m itself (the Pallas wrapper copied a zero-padded array instead). There
// are no atomics, so the result is deterministic, and tile (I, J) and tile
// (J, I) sum the same products in the same order, so the output is exactly
// symmetric. Tensor cores (3xTF32 or wgmma) and computing only the upper
// tiles are left for a later change.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;       // output tile edge
constexpr int TILE_K = 16;     // rows of a staged per step
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
gram_batched_kernel(const float* __restrict__ a, float* __restrict__ out,
                    int r, int m) {
  __shared__ float As[TILE_K][TILE];
  __shared__ float Bs[TILE_K][TILE];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* ab = a + (size_t)b * (size_t)r * (size_t)m;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;

  for (int k0 = 0; k0 < r; k0 += TILE_K) {
    // TILE_K x TILE = 1024 values per panel, 4 per thread; neighbouring
    // threads read neighbouring columns of one row of a.
#pragma unroll
    for (int l = 0; l < (TILE_K * TILE) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int row = idx / TILE;
      const int col = idx % TILE;
      const int k = k0 + row;
      const bool k_ok = k < r;
      const size_t base = (size_t)k * (size_t)m;
      As[row][col] = (k_ok && i0 + col < m) ? ab[base + i0 + col] : 0.0f;
      Bs[row][col] = (k_ok && j0 + col < m) ? ab[base + j0 + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE_K; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) x[ii] = As[kk][ty + 16 * ii];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) y[jj] = Bs[kk][tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[ii][jj] = fmaf(x[ii], y[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * (size_t)m * (size_t)m;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty + 16 * ii;
    if (i >= m) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if (j < m) ob[(size_t)i * (size_t)m + j] = acc[ii][jj];
    }
  }
}

}  // namespace

// a: (B, r, m) contiguous fp32 on the device; out: (B, m, m) contiguous fp32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gram_batched_f32(const float* a, float* out, int B, int r,
                                int m, void* stream) {
  if (B <= 0 || m <= 0 || r < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + TILE - 1) / TILE, (m + TILE - 1) / TILE, B);
  gram_batched_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, out, r, m);
  return (int)cudaGetLastError();
}
