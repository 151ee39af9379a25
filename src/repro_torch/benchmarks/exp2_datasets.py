"""Experiment II (paper Fig. 5, Table 3): all six datasets × five methods,
d=5 groups × c=4 users (paper layout). Claim under test: FedDCL ≫ Local and
comparable to FedAvg / DC on every dataset.

  python -m repro_torch.benchmarks.exp2_datasets [--fast] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.benchmarks.common import OUT_DIR, run_all_methods
from repro_torch.device import DeviceLike

DATASETS = ["battery_small", "credit_rating", "eicu", "human_activity",
            "mnist", "fashion_mnist"]


def run(fast: bool = False, datasets=None, engine: str = "host",
        svd_backend: str = "host", device: DeviceLike = None,
        out_dir: str = OUT_DIR):
    datasets = datasets or (DATASETS[:3] if fast else DATASETS)
    all_res = {}
    for name in datasets:
        n_ij = 1000 if name == "fashion_mnist" and not fast else 100
        res = run_all_methods(
            name, d=5, c=4, n_ij=n_ij,
            rounds=5 if fast else 20, local_epochs=2 if fast else 4,
            epochs=10 if fast else 40,
            n_test=500 if fast else 1000, engine=engine,
            svd_backend=svd_backend, device=device)
        all_res[name] = res
        m = res["metrics"]
        unit = "RMSE" if res["task"] == "regression" else "acc"
        print(f"{name:16s} ({unit}): " + "  ".join(
            f"{k}={v:.4f}" for k, v in m.items()))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "exp2_datasets.json"), "w") as f:
        json.dump({k: {"metrics": v["metrics"], "task": v["task"]}
                   for k, v in all_res.items()}, f, indent=1)
    return all_res


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
