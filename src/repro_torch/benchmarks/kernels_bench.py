"""Kernel micro-benchmarks, in the reference's rows (counterpart of its
``benchmarks/kernels_bench.py``): microseconds per call, best of
`repeats` means over `iters` calls, each mean ending in a device sync.

On the CPU the rows time the plain versions, as the reference times its
jnp paths. On a card they time the port's hand-written kernels — the
fp32 flash route, Gram (one matrix, and the batched d = 16 stack against a
loop of 16 single calls) and the chunked WKV6 forward — and each row's
`derived` column adds its plain version's time on the same inputs.

  python -m repro_torch.benchmarks.kernels_bench [--fast] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import DeviceLike, resolve_device


def _time(fn, *args, iters: int = 5, repeats: int = 3) -> float:
    """Best-of-`repeats` mean over `iters` calls (us) — the min filters out
    host scheduling noise that would otherwise swamp sub-ms kernels. A
    CUDA tensor among `args` makes each mean end in a device sync."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    return best


def run(fast: bool = False, device: DeviceLike = None):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gram import ops as gr
    from repro_torch.kernels.rwkv6 import ops as rw

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def vs_plain(us_kernel, us_plain):
        return (f";plain_us={us_plain:.1f};"
                f"vs_plain={us_plain / max(us_kernel, 1e-9):.1f}x"
                if on_card else "")

    rows = []
    B, S, H, KV, hd = 1, 512 if fast else 1024, 8, 4, 64
    q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    with torch.no_grad():
        us = _time(lambda a, b, c: fa.flash_attention(a, b, c), q, k, v)
        us_ref = (_time(lambda a, b, c: fa.flash_attention(
            a, b, c, backend="ref"), q, k, v) if on_card else us)
    flops = 4 * B * S * S * H * hd
    rows.append(("flash_attention_ref_xla", us,
                 f"{flops/us/1e3:.1f}GFLOP/s" + vs_plain(us, us_ref)))

    a = randn(2000, 256)
    us = _time(lambda x: gr.gram(x), a)
    us_ref = _time(lambda x: gr.gram(x, backend="ref"), a) if on_card else us
    rows.append(("gram_ref_xla", us,
                 f"{2*2000*256*256/us/1e3:.1f}GFLOP/s" + vs_plain(us, us_ref)))

    # the batched collaboration engine vs the per-group Python loop
    # (d groups of stacked anchor representations, protocol step 3a sizes)
    d, r, m = 16, 2000, 32
    ab = randn(d, r, m)
    us_loop = _time(lambda x: [gr.gram(x[i]) for i in range(d)], ab,
                    iters=10)
    us_bat = _time(lambda x: gr.gram_batched(x), ab, iters=10)
    us_ref = (_time(lambda x: gr.gram_batched(x, backend="ref"), ab,
                    iters=10) if on_card else us_bat)
    rows.append(("gram_group_loop_d16", us_loop, f"{d}x dispatch"))
    rows.append(("gram_batched_d16", us_bat,
                 f"speedup={us_loop/max(us_bat,1e-9):.1f}x"
                 + vs_plain(us_bat, us_ref)))

    B, S, Hh, K = 1, 256 if fast else 1024, 4, 64
    r, kk, vv = randn(B, S, Hh, K), randn(B, S, Hh, K), randn(B, S, Hh, K)
    lw = -torch.exp(torch.clamp(randn(B, S, Hh, K), -8, 1.6))
    u = randn(Hh, K) * 0.3
    with torch.no_grad():
        us_scan = _time(lambda *x: rw.wkv6(*x, backend="scan"), r, kk, vv, lw,
                        u, iters=2, repeats=1)
        us_chunk = _time(lambda *x: rw.wkv6(*x), r, kk, vv, lw, u,
                         iters=2, repeats=1)
        us_ref = (_time(lambda *x: rw.wkv6(*x, backend="chunked"), r, kk, vv,
                        lw, u, iters=2, repeats=1) if on_card else us_chunk)
    rows.append(("wkv6_scan_oracle", us_scan, "sequential"))
    rows.append(("wkv6_chunked_xla", us_chunk,
                 f"speedup={us_scan/max(us_chunk,1e-9):.1f}x"
                 + vs_plain(us_chunk, us_ref)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    rows = run(fast=args.fast, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
