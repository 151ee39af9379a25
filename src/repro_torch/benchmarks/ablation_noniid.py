"""BEYOND-PAPER ablation: non-IID robustness (the paper defers this to
future work, §5). FedDCL vs FedAvg vs DC under Dirichlet label skew on the
human_activity stand-in.

Mechanistic expectation: FedDCL's alignment step is computed from the SHARED
anchor (distribution-independent), so the collaboration representation
quality should degrade less with skew than FedAvg's averaged weights
(client drift).

  python -m repro_torch.benchmarks.ablation_noniid [--fast] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.benchmarks.common import OUT_DIR, run_all_methods
from repro_torch.device import DeviceLike


def run(fast: bool = False, engine: str = "host", device: DeviceLike = None,
        out_dir: str = OUT_DIR):
    out = {}
    grid = [("iid", False, None), ("dir0.5", True, 0.5), ("dir0.1", True, 0.1)]
    for name, non_iid, alpha in grid:
        kw = dict(d=4, c=3, n_ij=100,
                  rounds=5 if fast else 15, local_epochs=2 if fast else 4,
                  epochs=10 if fast else 30, n_test=500 if fast else 1000,
                  methods=["Local", "FedAvg", "DC", "FedDCL"])
        res = run_all_methods("human_activity", non_iid=non_iid,
                              dirichlet_alpha=alpha or 0.5, engine=engine,
                              device=device, **kw)
        out[name] = res["metrics"]
        print(f"{name:8s}: " + "  ".join(f"{k}={v:.4f}"
                                         for k, v in res["metrics"].items()))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ablation_noniid.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--engine", default="host", choices=["host", "scan"])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    return run(fast=args.fast, engine=args.engine, device=args.device,
               out_dir=args.out_dir)


if __name__ == "__main__":
    main()
