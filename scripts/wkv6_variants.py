"""Time the WKV6 kernels on one GPU: as committed, and with parts of them
taken out, to see which part takes the time.

    python3 scripts/wkv6_variants.py

Builds src/repro_torch/kernels/rwkv6/csrc/wkv6.cu (forward) and
wkv6_bwd.cu (gradient) as committed and as variants of them (text
substitutions in the source or its header, each variant in a directory
of its own under the ignored kernels/build/variants/, by
kernel_variants.py), then runs each through the port's wrappers at
rwkv6-3b's train shape (2, 1024, 40, 64, 64): the median time per call by
CUDA events (variants in turns, twice: a, b, ..., b, a), and the largest
error against the plain version (ref.wkv6_chunked, ref.wkv6_grad). Prints
the card's name and power limit, each variant's ptxas report, then one
JSON line per kernel.

The variants other than "committed" and "pairs_one_lane" are ablations:
they skip work, so
their results are wrong and only their times mean something (the time a
part takes is about the committed time less the time without it).
- fwd no_factors: the chunk factors (cumsum, expf) are not computed;
- fwd no_pairs: A = strict-lower(rt kt^T) is not computed;
- fwd no_state: the products with the state (rt S, ke^T v) are skipped;
- fwd loads_only: all three are skipped (the tiles' loads, the barriers,
  A v and the stores are left);
- fwd no_butterfly, no_loads: the butterfly over 16 lanes, the tiles'
  loads after the first three chunks;
- fwd quarter_loads: each block loads a quarter of the key columns of r,
  k, log_w (a fourth of the bytes the four V-slice blocks of a (b, h)
  read);
- bwd keys_only / values_only: only the kernel of the blocks for dr, dk,
  dlog_w (K slices), or only that for dv (V slices), runs;
- bwd no_fwd_sweep: the key blocks skip the sweep that stores the states;
- bwd fwd_sweep_no_store, fwd_sweep_no_update: that sweep without storing
  the states, or without updating them.
The bwd variant fused keeps the result: both kinds of blocks in one
kernel, interleaved (b, h) by (b, h), as one launch (the design before
the kinds were split into two kernels).
The variant pairs_one_lane keeps the result: each of the L x L products'
2 x 2 tiles in one lane instead of two (both kernels).
"""
from __future__ import annotations

import json
import sys

import torch

from kernel_variants import card, build_all, in_turns, variant_sources
from repro_torch.kernels.rwkv6 import kernel as wk
from repro_torch.kernels.rwkv6 import ref

HEADER = wk.CSRC / "wkv6_common.cuh"


def _function(text: str, signature: str) -> str:
    """The source of the function that starts with `signature`."""
    start = text.index(signature)
    return text[start:text.index("\n}\n", start) + 3]


PAIRS = _function(HEADER.read_text(),
                  "__device__ __forceinline__ void pair_products(")
# each of the 36 tiles' dot products in one lane (threads 0..35)
PAIRS_ONE_LANE = """__device__ __forceinline__ void pair_products(const float* P, const float* Q,
                                              float* X, const float* dsrc,
                                              float* dout, int tid) {
  if (tid >= 36) return;
  int T = 0;
  while ((T + 1) * (T + 2) / 2 <= tid) ++T;
  const int t0 = 2 * T, t1 = t0 + 1;
  const int i0 = 2 * (tid - T * (T + 1) / 2), i1 = i0 + 1;
  float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 p0 = ld4(P + t0 * PF + d), p1 = ld4(P + t1 * PF + d);
    const float4 q0 = ld4(Q + i0 * PF + d), q1 = ld4(Q + i1 * PF + d);
    a00 = fmaf(p0.x, q0.x, a00);
    a01 = fmaf(p0.x, q1.x, a01);
    a10 = fmaf(p1.x, q0.x, a10);
    a11 = fmaf(p1.x, q1.x, a11);
    a00 = fmaf(p0.y, q0.y, a00);
    a01 = fmaf(p0.y, q1.y, a01);
    a10 = fmaf(p1.y, q0.y, a10);
    a11 = fmaf(p1.y, q1.y, a11);
    a00 = fmaf(p0.z, q0.z, a00);
    a01 = fmaf(p0.z, q1.z, a01);
    a10 = fmaf(p1.z, q0.z, a10);
    a11 = fmaf(p1.z, q1.z, a11);
    a00 = fmaf(p0.w, q0.w, a00);
    a01 = fmaf(p0.w, q1.w, a01);
    a10 = fmaf(p1.w, q0.w, a10);
    a11 = fmaf(p1.w, q1.w, a11);
  }
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
"""
FWD = {
    "committed": [],
    "no_factors": [("    if (f < n) {\n      const float* at = ring",
                    "    if (f < 0) {\n      const float* at = ring")],
    "no_pairs": [("    if (g >= 0 && g < n)\n      pair_products(",
                  "    if (g < 0)\n      pair_products(")],
    "no_state": [("    for (int t = 0; t < LT; ++t) {\n"
                  "      const float4 x = ld4(rtc",
                  "    for (int t = 0; t < 2 * LT; ++t) part[t] = 0.f;\n"
                  "    for (int t = 0; t < 0; ++t) {\n"
                  "      const float4 x = ld4(rtc")],
    "loads_only": [("    if (f < n) {\n      const float* at = ring",
                    "    if (f < 0) {\n      const float* at = ring"),
                   ("    if (g >= 0 && g < n)\n      pair_products(",
                    "    if (g < 0)\n      pair_products("),
                   ("    for (int t = 0; t < LT; ++t) {\n"
                    "      const float4 x = ld4(rtc",
                    "    for (int t = 0; t < 2 * LT; ++t) part[t] = 0.f;\n"
                    "    for (int t = 0; t < 0; ++t) {\n"
                    "      const float4 x = ld4(rtc")],
    "pairs_one_lane": [(PAIRS, PAIRS_ONE_LANE)],
    "no_butterfly": [("    reduce_scatter32(part, y0, y1, kq);",
                      "    y0 = part[0];\n    y1 = part[1];")],
    "no_loads": [("    if (c + 4 < n) issue(c + 4);", "")],
}
QUARTER = [(f"    load_tile<D>({dst}, PF, {x}, b, h, t0, L, 0, K,",
            f"    load_tile<W>({dst}, PF, {x}, b, h, t0, L, 0, K,")
           for dst, x in (("at", "r"), ("at + LT * PF", "k"),
                          ("at + 2 * LT * PF", "w"))]
FWD["quarter_loads"] = QUARTER
BWD = {
    "committed": [],
    "keys_only": [("  wkv6_chunked_bwd_value_kernel<<<",
                   "  if (0) wkv6_chunked_bwd_value_kernel<<<")],
    "values_only": [("  wkv6_chunked_bwd_key_kernel<<<",
                     "  if (0) wkv6_chunked_bwd_key_kernel<<<")],
    "no_fwd_sweep": [("  for (int x = -1; x < n; ++x) {",
                      "  for (int x = -1; x < -1; ++x) {")],
    "fwd_sweep_no_store": [(
        "    out[0] = make_float4(st[0], st[1], st[2], st[3]);\n"
        "    out[1] = make_float4(st[4], st[5], st[6], st[7]);\n", "")],
    "fwd_sweep_no_update": [(
        "      const float ket = at[SK + t * PS + kk] * ecl[t * PS + kk];",
        "      const float ket = 0.f;\n      if (LT) continue;")],
    "pairs_one_lane": [(PAIRS, PAIRS_ONE_LANE)],
}
BWD_LAUNCH = _function(wk.BWD_SOURCE.read_text(),
                       "  const cudaStream_t st")
BWD_LAUNCH = BWD_LAUNCH[:BWD_LAUNCH.index("  return")]
# both kinds of blocks in one kernel, interleaved (b, h) by (b, h)
BWD["fused"] = [
    ("""  value_block(p, smem, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);
}
""", """  value_block(p, smem, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);
}

__global__ void __launch_bounds__(THREADS)
wkv6_chunked_bwd_fused_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < p.nks)
    key_block(p, smem, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x);
  else
    value_block(p, smem, blockIdx.x - p.nks, blockIdx.y, blockIdx.z,
                threadIdx.x);
}
"""),
    (BWD_LAUNCH, """\
  const int fused = key_bytes > value_bytes ? key_bytes : value_bytes;
  err = cudaFuncSetAttribute(wkv6_chunked_bwd_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fused);
  if (err != cudaSuccess) return (int)err;
  wkv6_chunked_bwd_fused_kernel<<<dim3(p.nks + (V + W - 1) / W, H, B),
                                  THREADS, fused, (cudaStream_t)stream>>>(p);
""")]
SHAPE = (2, 1024, 40, 64, 64)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_variants: needs a CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    kinds = {"fwd": (wk.SOURCE, FWD, "wkv6_fwd_f32", 6),
             "bwd": (wk.BWD_SOURCE, BWD, "wkv6_bwd_f32", 12)}
    libs = {kind: build_all(variant_sources(src, variants), {"kernel": kind})
            for kind, (src, variants, _, _) in kinds.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, H, K, V = SHAPE
    n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    lw = -torch.exp(torch.clamp(n(B, S, H, K), -8.0, 1.6))
    args = (n(B, S, H, K), n(B, S, H, K), n(B, S, H, V), lw, n(H, K) * 0.3)
    dO = n(B, S, H, V)
    want = {"fwd": ref.wkv6_chunked(*args), "bwd": ref.wkv6_grad(*args, dO)}
    calls = {"fwd": lambda: wk.wkv6_cuda(*args),
             "bwd": lambda: wk.wkv6_grad_cuda(*args, dO)}
    for kind, (_, variants, entry, n_ptrs) in kinds.items():
        names = list(variants)
        fns = {name: wk.bind(lib, entry, n_ptrs)
               for name, lib in libs[kind].items()}

        def use(name):
            wk._fns[entry] = fns[name]     # the wrapper's entry point

        err = {}
        for name in names:
            use(name)
            got = calls[kind]()
            err[name] = (rel(got, want[kind]) if kind == "fwd" else
                         max(rel(g, w) for g, w in zip(got, want[kind])))
        ms = in_turns(names, use, calls[kind], 20)
        wk._fns.pop(entry, None)
        print(json.dumps({"kernel": kind, "shape": SHAPE, "ms": ms,
                          "rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
