"""Experiment I (paper Fig. 4, Tables 1–2): proof-of-concept on the
BatterySmall stand-in — 4 users in 2 groups, convergence per round of all
five methods. Claim under test: FedDCL converges at least as fast per round
as FedAvg and reaches comparable final RMSE.

  python -m repro_torch.benchmarks.exp1_convergence [--fast]
      [--engine host|scan] [--svd-backend host|device] [--device cpu]
      [--out-dir results_torch]

`--engine` selects the federated trainer: "host" is the per-batch loop,
"scan" replays one captured round (the same schedule and results).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.benchmarks.common import OUT_DIR, run_all_methods
from repro_torch.device import DeviceLike


def run(fast: bool = False, engine: str = "host", svd_backend: str = "host",
        device: DeviceLike = None, out_dir: str = OUT_DIR):
    res = run_all_methods(
        "battery_small", d=2, c=2, n_ij=100,
        rounds=6 if fast else 20, local_epochs=4,
        epochs=12 if fast else 40, n_test=1000, track_rounds=True,
        engine=engine, svd_backend=svd_backend, device=device)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "exp1_convergence.json"), "w") as f:
        json.dump(res, f, indent=1)
    m = res["metrics"]
    print(f"Exp I — BatterySmall RMSE (lower better), engine={engine}:")
    for k, v in m.items():
        print(f"  {k:12s} {v:.4f}")
    claims = {
        "feddcl_beats_local": m["FedDCL"] < m["Local"],
        "feddcl_comparable_fedavg": m["FedDCL"] < 1.5 * m["FedAvg"],
        "feddcl_comparable_dc": m["FedDCL"] < 1.5 * m["DC"],
    }
    print("claims:", claims)
    return res, claims


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--engine", default="host", choices=["host", "scan"])
    ap.add_argument("--svd-backend", default="host",
                    choices=["host", "device"])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    return run(fast=args.fast, engine=args.engine,
               svd_backend=args.svd_backend, device=args.device,
               out_dir=args.out_dir)


if __name__ == "__main__":
    main()
