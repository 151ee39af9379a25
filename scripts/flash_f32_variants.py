"""Time design variants of the fp32 flash-attention kernel on one GPU.

    python3 scripts/flash_f32_variants.py

Builds src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu as
committed and as a few variants of it (text substitutions, built by
kernel_variants.py under the ignored kernels/build/variants/), then runs
each through the port's wrapper at the five flash shapes of chip_smoke.py in fp32: the median time
per call by CUDA events (variants in turns, twice: a, b, ..., b, a), and
the largest error against the plain version with its share of the
reference's 2e-5 fp32 bar. Prints the card's name and power limit, each
variant's ptxas report, then one JSON line per shape.

Variants:
- committed: the source as it is;
- no_split: at hd 256 one warp per 16 query rows (four warps a block)
  instead of two sharing them;
- s_one_fragment: Q K^T's three products accumulate in one fragment over
  the warp's share of hd (the tensor core rounds each add toward zero);
- s_depth1: Q K^T's three products start from zero every k8 step and join
  the logits by an fp32 add (gram.cu's recipe).
"""
from __future__ import annotations

import json
import sys

import torch

from kernel_variants import card, build_all, in_turns, variant_sources
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ops

S_PRODUCTS = """        mma_tf32(sx[j], al, bh);
        mma_tf32(sx[j], ah, bl);
        mma_tf32(sb[j], ah, bh);"""
VARIANTS = {
    "committed": [],
    "no_split": [("static constexpr int SPLIT = HD == 256 ? 2 : 1;",
                  "static constexpr int SPLIT = 1;")],
    "s_one_fragment": [(S_PRODUCTS, S_PRODUCTS.replace("sx[j]", "sb[j]"))],
    "s_depth1": [(S_PRODUCTS, """        float d_[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d_, al, bh);
        mma_tf32(d_, ah, bl);
        mma_tf32(d_, ah, bh);
        for (int e = 0; e < 4; ++e) sb[j][e] += d_[e];""")],
}
# (name, B, H, KV, Sq, Sk, hd, window, softcap, q_offset), as chip_smoke.py
SHAPES = [
    ("llama3.2-1b prefill", 4, 32, 8, 2048, 2048, 64, 0, 0.0, 0),
    ("gemma2-2b local layer", 1, 8, 4, 8192, 8192, 256, 4096, 50.0, 0),
    ("gemma2-2b global layer", 1, 8, 4, 8192, 8192, 256, 0, 50.0, 0),
    ("q tail at q_offset", 4, 32, 8, 256, 2048, 64, 0, 0.0, 1792),
    ("ragged", 2, 4, 2, 1000, 1000, 64, 0, 0.0, 0),
]
TOL = 2e-5


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_variants: needs a CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    libs = build_all(variant_sources(fa.SOURCE, VARIANTS), {})
    fns = {name: fa.bind(lib, fa.F32_ROUTE) for name, lib in libs.items()}

    def use(name):
        fa._fns[fa.F32_ROUTE] = fns[name]     # the wrapper's entry point

    def run(name, q, k, v, kw):
        use(name)
        return ops.flash_attention(q, k, v, **kw)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    names = list(VARIANTS)
    try:
        for name, B, H, KV, Sq, Sk, hd, window, softcap, q_offset in SHAPES:
            q = torch.randn((B, Sq, H, hd), generator=gen, device=dev)
            k = torch.randn((B, Sk, KV, hd), generator=gen, device=dev)
            v = torch.randn((B, Sk, KV, hd), generator=gen, device=dev)
            kw = dict(causal=True, window=window, softcap=softcap,
                      q_offset=q_offset)
            ref = ops.flash_attention(q, k, v, backend="ref", **kw)
            err, over = {}, {}
            for n in names:
                diff = (run(n, q, k, v, kw) - ref).abs()
                err[n] = float(diff.max())
                over[n] = float((diff / (TOL + TOL * ref.abs())).max())
            del ref
            ms = in_turns(names, use,
                          lambda: ops.flash_attention(q, k, v, **kw),
                          5 if hd == 256 else 20)
            print(json.dumps({"shape": name, "ms": ms, "max_abs_err": err,
                              "err_over_bar": over}), flush=True)
            del q, k, v
    finally:
        fa._fns.pop(fa.F32_ROUTE, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
