"""Benchmark entry point — one function per paper table/figure (counterpart
of the reference's ``benchmarks/run.py``). Prints ``name,us_per_call,derived``
CSV (fast variants by default; --full for the paper-scale runs).

  python -m repro_torch.benchmarks.run [--full] [--only exp1|exp2|exp3|comm|kernels|noniid]
      [--device cpu] [--out-dir results_torch]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.device import resolve_device


def _timed(name, fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    us = (time.perf_counter() - t0) * 1e6
    return name, us, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale runs (minutes on the CPU)")
    ap.add_argument("--only", default=None,
                    choices=["exp1", "exp2", "exp3", "comm", "kernels", "noniid"])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    fast = not args.full
    dev = resolve_device(args.device)
    kw = dict(device=dev, out_dir=args.out_dir)
    rows = []

    if args.only in (None, "kernels"):
        from repro_torch.benchmarks import kernels_bench
        for name, us, derived in kernels_bench.run(fast=fast, device=dev):
            rows.append((name, us, derived))

    if args.only in (None, "exp1"):
        from repro_torch.benchmarks import exp1_convergence
        name, us, (res, claims) = _timed("exp1_convergence(fig4)",
                                         exp1_convergence.run, fast=fast, **kw)
        rows.append((name, us, f"claims_pass={all(claims.values())}"))

    if args.only in (None, "exp2"):
        from repro_torch.benchmarks import exp2_datasets
        name, us, res = _timed("exp2_datasets(fig5)", exp2_datasets.run,
                               fast=fast, **kw)
        ok = all(r["metrics"]["FedDCL"] < r["metrics"]["Local"]
                 if r["task"] == "regression"
                 else r["metrics"]["FedDCL"] > r["metrics"]["Local"]
                 for r in res.values())
        rows.append((name, us, f"feddcl_beats_local_all={ok}"))

    if args.only in (None, "exp3"):
        from repro_torch.benchmarks import exp3_groups
        name, us, out = _timed("exp3_groups(fig6)", exp3_groups.run,
                               fast=fast, **kw)
        ds = sorted(out)
        rows.append((name, us,
                     f"feddcl_d{ds[0]}={out[ds[0]]['FedDCL']:.3f};"
                     f"d{ds[-1]}={out[ds[-1]]['FedDCL']:.3f}"))

    if args.only == "noniid":
        from repro_torch.benchmarks import ablation_noniid
        name, us, out = _timed("ablation_noniid(beyond-paper)",
                               ablation_noniid.run, fast=fast, **kw)
        rows.append((name, us,
                     f"feddcl_iid={out['iid']['FedDCL']:.3f};"
                     f"dir0.1={out['dir0.1']['FedDCL']:.3f}"))

    if args.only in (None, "comm"):
        from repro_torch.benchmarks import comm_cost
        name, us, (rows_c, table) = _timed("comm_cost(sec3.2)", comm_cost.run,
                                           fast=fast, **kw)
        rows.append((name, us, "user_traffic_reduction="
                     f"{comm_cost.user_traffic_reduction(rows_c):.1f}x"))

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
