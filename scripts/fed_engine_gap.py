"""How far apart two runs of FedDCL's step 4 land, engine against engine
and card against CPU, round by round.

    python3 scripts/fed_engine_gap.py [--rounds 1 2 4] [--opts adamw sgd]

At the mnist-width Experiment II layout (chip_smoke.py's: 5 groups x 4
users x 100 samples, m̃ = m̂ = 50, MLP 50-500-100-10, 4 local epochs,
batch 32, the collaboration solve on the host), runs the host and the scan
engine (cache off, the same numpy schedule) on the GPU and on the CPU from
the same initial params, for each optimizer and round count, and prints
the card's name and power limit, then one JSON line per (optimizer,
rounds): the largest leaf gap of the final params (max |a - b| over
max(1, max |b|), the bar's measure) between the two engines on each
device, between the two devices for each engine, the relative Frobenius
gap of the engines on the card, and the last round's loss. Where the gap
of one engine across devices is as large as that of two engines on one
device, it measures the conditioning of the run (fp32 rounding amplified
by the optimizer), not a difference between the engines.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import federated as fed, protocol  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

OPTS = {"adamw": lambda: adamw(1e-3), "sgd": lambda: sgd(0.05)}


def leaf_gap(a, b) -> float:
    return max(float((x.cpu() - y.cpu()).abs().max())
               / max(1.0, float(y.abs().max()))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def frobenius_gap(a, b) -> float:
    return max(float(torch.linalg.norm(x.cpu() - y.cpu())
                     / torch.linalg.norm(y.cpu()))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--opts", nargs="+", default=list(OPTS), choices=OPTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fed_engine_gap: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    Xs, Ys, _, _ = cs.mnist_exp2_layout()
    silos = protocol.run_protocol(Xs, Ys, m_tilde=cs.M_TILDE,
                                  anchor_r=cs.ANCHOR_R, seed=0,
                                  svd_backend="host").fed_silos()
    loss = partial(mlp.mlp_per_example_loss, task="classification")
    layout = fed.padded_layout(silos, batch_size=32)
    sched = np.stack([fed.round_perms(7, r, layout.num_silos, 4,
                                      layout.n_slots)
                      for r in range(max(args.rounds))])
    for name in args.opts:
        for rounds in args.rounds:
            res = {}
            for dev in ("cuda", "cpu"):
                gen = torch.Generator().manual_seed(3)
                p0 = mlp.init_mlp_params(gen, cs.M_TILDE, (500, 100), 10,
                                         device=dev)
                for engine in ("host", "scan"):
                    res[dev, engine] = fed.run_federated(
                        loss, p0, silos, opt=OPTS[name](), rounds=rounds,
                        local_epochs=4, batch_size=32, seed=7, engine=engine,
                        schedule=sched[:rounds], device=dev)
            p = {k: v.params for k, v in res.items()}
            print(json.dumps({
                "opt": name, "rounds": rounds,
                "scan_vs_host_cuda": leaf_gap(p["cuda", "scan"],
                                              p["cuda", "host"]),
                "scan_vs_host_cpu": leaf_gap(p["cpu", "scan"],
                                             p["cpu", "host"]),
                "host_cuda_vs_cpu": leaf_gap(p["cuda", "host"],
                                             p["cpu", "host"]),
                "scan_cuda_vs_cpu": leaf_gap(p["cuda", "scan"],
                                             p["cpu", "scan"]),
                "frobenius_scan_vs_host_cuda": frobenius_gap(
                    p["cuda", "scan"], p["cuda", "host"]),
                "last_loss": res["cuda", "host"].history[-1]["loss"]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
