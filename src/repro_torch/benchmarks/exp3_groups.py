"""Experiment III (paper Fig. 6): accuracy vs number of groups d for the
MNIST stand-in, c_i=4 users per group. Claim under test: FedDCL accuracy
increases with d (more total data), tracking Centralized/DC.

`scenarios()` also sweeps the batched collaboration engine over a scenario
matrix — d ∈ {2..32} groups × c ∈ {1..8} users/group × IID vs Dirichlet
non-IID — timing protocol steps 1–3 on the "host" (serial NumPy float64)
and "device" (one batched Gram+eigh for all groups, one batched QR solve;
on a card the Gram kernel) backends and recording their agreement.

  python -m repro_torch.benchmarks.exp3_groups [--fast] [--engine=scan]
      [--cache] [--scenarios] [--device cpu] [--out-dir results_torch]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.benchmarks.common import OUT_DIR, run_all_methods
from repro_torch.device import DeviceLike, resolve_device


def run(fast: bool = False, engine: str = "host", cache: bool = False,
        device: DeviceLike = None, out_dir: str = OUT_DIR):
    """The d-grid rides the generic sweep loop (experiments/sweep.run_sweep);
    engine="scan", cache=True also share plans across the grid through the
    plan cache."""
    from repro_torch.experiments.sweep import run_sweep

    ds_grid = [1, 2, 4] if fast else [1, 2, 4, 6, 8, 10]

    def one_d(case):
        d = case["d"]
        methods = ["Centralized", "DC", "FedDCL"] if d == 1 else \
            ["Centralized", "FedAvg", "DC", "FedDCL"]
        res = run_all_methods(
            "mnist", d=max(d, 1), c=4, n_ij=100,
            rounds=4 if fast else 15, local_epochs=2 if fast else 4,
            epochs=8 if fast else 30, n_test=500 if fast else 1000,
            methods=methods, engine=engine, cache=cache, device=device)
        print(f"d={d}: " + "  ".join(f"{k}={v:.4f}"
                                     for k, v in res["metrics"].items()))
        return res["metrics"]

    rows = run_sweep([{"d": d} for d in ds_grid], one_d, label="exp3",
                     verbose=False)
    out = {r["d"]: {k: v for k, v in r.items() if k not in ("d", "time_s")}
           for r in rows}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "exp3_groups.json"), "w") as f:
        json.dump(out, f, indent=1)
    feddcl = [out[d]["FedDCL"] for d in ds_grid]
    increasing = feddcl[-1] > feddcl[0]
    print(f"FedDCL acc d={ds_grid[0]} -> d={ds_grid[-1]}: "
          f"{feddcl[0]:.4f} -> {feddcl[-1]:.4f} (increasing={increasing})")
    return out


M, M_TILDE, N_IJ, ANCHOR_R = 32, 8, 50, 1000     # the scenario matrix's cells


def scenario_cell(X, Y, d: int, c: int, part: str, seed: int = 0,
                  device: DeviceLike = None):
    """One cell of the matrix: steps 1–3 on both backends (the device one
    after a warm-up call that absorbs its one-time set-up, the kernel's
    build included). Returns (row, {backend: setup})."""
    from repro_torch.core.protocol import run_protocol
    from repro_torch.data.partition import split_dirichlet, split_iid

    split = split_iid if part == "iid" else split_dirichlet
    Xs, Ys = split(X, Y, d, [c] * d, N_IJ, seed=seed)
    res = {"d": d, "c": c, "partition": part}
    setups = {}
    for backend in ("host", "device"):
        kw = dict(m_tilde=M_TILDE, anchor_r=ANCHOR_R, seed=seed,
                  svd_backend=backend, device=device)
        if backend == "device":
            run_protocol(Xs, Ys, **kw)
        t0 = time.perf_counter()
        setups[backend] = run_protocol(Xs, Ys, **kw)
        res[f"{backend}_s"] = time.perf_counter() - t0
    rel = max(
        float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12))
        for a, b in zip(setups["host"].collab_X, setups["device"].collab_X))
    res["rel_frobenius"] = rel
    res["speedup"] = res["host_s"] / max(res["device_s"], 1e-12)
    return res, setups


def scenarios(fast: bool = False, seed: int = 0, device: DeviceLike = None,
              out_dir: str = OUT_DIR, d_grid=None, c_grid=None):
    """Backend scenario matrix: setup (steps 1–3) wall time, host vs device,
    and the relative Frobenius disagreement of the collab representations.
    `d_grid` / `c_grid` replace the grid that `fast` picks."""
    device = resolve_device(device)
    d_grid = d_grid or ([2, 4, 8] if fast else [2, 4, 8, 16, 32])
    c_grid = c_grid or ([1, 4] if fast else [1, 2, 4, 8])
    rng = np.random.default_rng(seed)
    rows = []
    for d in d_grid:
        for c in c_grid:
            n = d * c * N_IJ
            X = rng.standard_normal((n + 64, M))
            Y = rng.integers(0, 5, size=n + 64).astype(np.float64)
            for part in ("iid", "dirichlet"):
                res, _ = scenario_cell(X, Y, d, c, part, seed, device)
                rows.append(res)
                print(f"d={d:<3} c={c} {part:<9} host={res['host_s']:.3f}s "
                      f"device={res['device_s']:.3f}s "
                      f"speedup={res['speedup']:.2f}x "
                      f"rel={res['rel_frobenius']:.2e}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "exp3_scenarios.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--scenarios", action="store_true")
    ap.add_argument("--engine", default="host", choices=["host", "scan"])
    ap.add_argument("--cache", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.scenarios:
        return scenarios(fast=args.fast, device=args.device,
                         out_dir=args.out_dir)
    return run(fast=args.fast, engine=args.engine, cache=args.cache,
               device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
