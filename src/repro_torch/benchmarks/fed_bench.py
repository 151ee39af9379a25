"""Federated-engine benchmark on the port (counterpart of the reference's
``benchmarks/fed_bench.py``): the scan engine (one captured round,
replayed every round) against the per-batch host loop
(``core/federated.py``) across silo counts and round budgets.

For each (d, rounds) case both engines train the same MLP on the same
ragged silo stack with the same seed and schedule. The row keeps:

  * ``t_host_total_s``: one host-engine call (the best of 3);
  * ``t_host_dispatch_s`` = (t(3R) − t(R)) / 2, the reference's formula.
    The reference uses it to cancel the host step's re-jit; the port's
    host engine compiles nothing, so here it is the marginal cost of R
    rounds of eager steps, a call's fixed set-up cancelled;
  * ``t_scan_cold_s``: one scan-engine call, which builds the plan and,
    on CUDA, warms up and captures its round;
  * ``t_scan_warm_s``: the SAME plan run again (``make_scan_runner``), the
    best of `warm_iters` runs, each ending in a device sync;
  * speedup_warm = host dispatch / scan warm (steady state) and
    speedup_cold = host total / scan cold (one-shot), and the host / scan
    parameter agreement ``rel_param_diff`` (the reference's bar: <= 1e-4).

  python -m repro_torch.benchmarks.fed_bench [--fast] [--device cpu]
      [--out-dir results_torch]

Writes ``BENCH_fed.json`` under the output directory. The reference's
``--sharded`` rows wait for silo sharding (ROADMAP.md, Queue 1,
multi-process silo sharding).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.core import federated
from repro_torch.core.federated import (Schedule, make_scan_runner,
                                        pad_silo_data, run_federated)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.sweep import device_meta
from repro_torch.models import mlp
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves
from repro_torch.weights import mlp_params_from_numpy

M_FEAT = 16
LOCAL_EPOCHS = 4
BATCH = 32

loss = partial(mlp.mlp_per_example_loss, task="regression")


def _make_silos(d: int, seed: int = 0):
    """d ragged silos (84..116 samples) of a linear-regression task."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((M_FEAT, 1))
    silos = []
    for i in range(d):
        n = 84 + 8 * (i % 5)
        r = np.random.default_rng(seed * 1009 + i)
        X = r.standard_normal((n, M_FEAT))
        silos.append((X, X @ w + 0.01 * r.standard_normal((n, 1))))
    return silos


def _rel_diff(a, b) -> float:
    return max(float(torch.max(torch.abs(x - y)) /
                     (torch.max(torch.abs(x)) + 1e-12))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_case(d: int, rounds: int, *, warm_iters: int = 3,
               init_params: Any = None, schedule: Optional[Schedule] = None,
               device: DeviceLike = None,
               results: Optional[Dict[str, Any]] = None) -> Dict:
    """One row. The MLP (16 -> 32 -> 1) is `init_params` (a tree of arrays,
    e.g. the reference's PRNGKey(0) draw), else the port's own draw from
    seed 0; `schedule` (a function of the round) replaces the minibatch
    draw of seed 0 in every run. `results`, when given, receives the host
    and the scan engine's ``FLResult`` under "host" and "scan"."""
    dev = resolve_device(device)
    silos = _make_silos(d)
    params = (mlp_params_from_numpy(init_params, dev)
              if init_params is not None else mlp.init_mlp_params(
                  torch.Generator().manual_seed(0), M_FEAT, (32,), 1,
                  device=dev))
    kw = dict(opt=adamw(1e-3), rounds=rounds, local_epochs=LOCAL_EPOCHS,
              batch_size=BATCH, seed=0, schedule=schedule, device=dev)

    def _host_time(r):
        best, res = float("inf"), None
        for _ in range(3):
            t0 = time.perf_counter()
            out = run_federated(loss, params, silos, engine="host",
                                **{**kw, "rounds": r})
            _sync(dev)
            dt = time.perf_counter() - t0
            if dt < best:
                best, res = dt, out
        return best, res

    t_host_total, host = _host_time(rounds)
    t_3r, _ = _host_time(3 * rounds)
    t_host = max((t_3r - t_host_total) / 2.0, 1e-4)

    t0 = time.perf_counter()
    scan = run_federated(loss, params, silos, engine="scan", **kw)
    _sync(dev)
    t_cold = time.perf_counter() - t0

    # warm: the SAME plan run again (on CUDA, its captured graph replayed)
    padded = pad_silo_data(silos, BATCH)
    batch_loss = federated._make_batch_loss(loss, True, 0.0)
    runner = make_scan_runner(batch_loss, padded, opt=adamw(1e-3),
                              rounds=rounds, local_epochs=LOCAL_EPOCHS, seed=0,
                              schedule=schedule, device=dev)
    runner(params)                                  # build and capture
    t_warm = float("inf")
    for _ in range(warm_iters):
        t0 = time.perf_counter()
        runner(params)
        _sync(dev)
        t_warm = min(t_warm, time.perf_counter() - t0)

    if results is not None:
        results.update(host=host, scan=scan)
    dispatches = d * rounds * LOCAL_EPOCHS * padded.num_batches
    return {
        "d": d, "rounds": rounds, "local_epochs": LOCAL_EPOCHS,
        "batch_size": BATCH, "host_step_dispatches": dispatches,
        "t_host_dispatch_s": round(t_host, 4),
        "t_host_total_s": round(t_host_total, 4),
        "t_scan_cold_s": round(t_cold, 4),
        "t_scan_warm_s": round(t_warm, 4),
        "speedup_warm": round(t_host / t_warm, 1),
        "speedup_cold": round(t_host_total / t_cold, 1),
        "rel_param_diff": _rel_diff(host.params, scan.params),
        "final_loss_host": host.history[-1]["loss"],
        "final_loss_scan": scan.history[-1]["loss"],
    }


def run(fast: bool = False, device: DeviceLike = None) -> List[Dict]:
    cases = ([(2, 5), (8, 5)] if fast
             else [(d, r) for d in (2, 8, 32) for r in (5, 20)])
    rows = []
    for d, rounds in cases:
        row = bench_case(d, rounds, device=device)
        rows.append(row)
        print(f"d={d:3d} rounds={rounds:3d}  host {row['t_host_dispatch_s']:8.3f}s "
              f"dispatch ({row['host_step_dispatches']} steps, "
              f"{row['t_host_total_s']:.3f}s a call)  "
              f"scan cold {row['t_scan_cold_s']:7.3f}s  "
              f"warm {row['t_scan_warm_s']:7.4f}s  "
              f"speedup {row['speedup_warm']:6.1f}x (cold "
              f"{row['speedup_cold']:.1f}x)  "
              f"agree {row['rel_param_diff']:.2e}")
    return rows


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="CI smoke: d<=8, rounds=5 only")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--sharded", action="store_true",
                    help="sharded-vs-vmap rows (not ported)")
    ap.add_argument("--sharded-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sharded or args.sharded_worker:
        raise NotImplementedError(
            "fed_bench --sharded compares sharded plans with unsharded "
            "ones; silo sharding is not ported to repro_torch yet "
            "(ROADMAP.md, Queue 1, multi-process silo sharding)")
    dev = resolve_device(args.device)
    out = {"bench": "fed_engine_scan_vs_host", **device_meta(dev),
           "fast": args.fast, "cases": run(fast=args.fast, device=dev)}
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "BENCH_fed.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {path}")
    return out


if __name__ == "__main__":
    main()
