"""Five-method comparison on one tabular dataset (paper Experiment II, one
column of Fig. 5): Centralized / Local / FedAvg / DC / FedDCL, through
``benchmarks.common.run_all_methods`` at the reference example's settings
(1,000 test rows, 20 rounds × 4 local epochs, 40 epochs, batch 32).

  python -m repro_torch.examples.feddcl_tabular --dataset human_activity
      [--engine host|scan] [--device cpu]
"""
import argparse

from repro_torch.benchmarks.common import run_all_methods
from repro_torch.configs.feddcl_mlp import PAPER_MLPS
from repro_torch.device import DeviceLike


def run(dataset: str, d: int = 5, c: int = 4, n_ij: int = 100, seed: int = 0,
        engine: str = "host", device: DeviceLike = None):
    res = run_all_methods(dataset, d=d, c=c, n_ij=n_ij, seed=seed,
                          engine=engine, device=device)
    results = res["metrics"]
    metric = "RMSE" if res["task"] == "regression" else "Accuracy"
    print(f"\n{dataset} ({metric}):")
    for k, v in results.items():
        print(f"  {k:12s} {v:.4f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="battery_small",
                    choices=sorted(PAPER_MLPS))
    ap.add_argument("--engine", default="host", choices=["host", "scan"])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    return run(args.dataset, engine=args.engine, device=args.device)


if __name__ == "__main__":
    main()
