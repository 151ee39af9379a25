"""Hostile-world ablation on the port (counterpart of the reference's
``experiments/robust_ablation.py``): fedavg vs the robust aggregators
under active attack and silo dropout.

Grid: d = 6 ragged regression silos × {clean, 1 or 2 gradient-scaling
silos (scale −5, the sign-flip attacker), 1 label-flipping silo} ×
{fedavg, median, trimmed_mean, krum}, clean and with 30% dropout, each
cell with its per-round loss curve and the final global model's loss on
the HONEST silos' pooled data (the reported round loss averages in the
corrupted silo's own objective, which under label-flip hides the damage).
Every cell runs on the scan engine (on CUDA, one captured round a cell).

The script ASSERTS the acceptance criteria:

  * under >= 1 gradient-scaling silo, the best robust aggregator reaches a
    final loss and an honest loss <= 0.5x plain fedavg's, and an honest
    loss <= 4x the clean run's + 0.1;
  * under label-flip, the best robust aggregator beats fedavg on honest
    data;
  * host == scan <= 1e-4 for every robust aggregator under dropout with a
    scaled silo.

The reference also holds sharded == unsharded; silo sharding is not
ported (ROADMAP.md, Queue 1, multi-process silo sharding), so without
``--skip-sharded`` the script raises before it runs anything.

  python -m repro_torch.experiments.robust_ablation --skip-sharded [--fast]
      [--device cpu] [--out-dir results_torch]

Writes ``BENCH_fed_robust.json`` under the output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.core.federated import (ROBUST_AGGREGATORS, Schedule,
                                        run_federated)
from repro_torch.core.privacy import SiloAttack, apply_attack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves
from repro_torch.weights import mlp_params_from_numpy

AGGREGATORS = ("fedavg", "median", "trimmed_mean", "krum")
TRIM_FRAC = 0.25          # d=6: trims floor(6·0.25)=1 silo per tail
KRUM_F = 2                # tolerate up to 2 Byzantine silos
GRID_SEED = 17            # the grid's minibatch and dropout draws
ENGINE_SEED = 23          # the engine check's

loss = partial(mlp.mlp_per_example_loss, task="regression")


def make_silos(sizes, m=4, seed=0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Ragged linear-regression silos sharing one true w (the honest
    signal every attacker tries to bury)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, 1))
    out = []
    for k, n in enumerate(sizes):
        r = np.random.default_rng(seed * 97 + k + 1)
        X = r.standard_normal((n, m))
        out.append((X, X @ w + 0.01 * r.standard_normal((n, 1))))
    return out


def scenarios(d: int):
    return [
        ("clean", SiloAttack()),
        ("grad_scale_x1", SiloAttack(corrupted=(2,), kind="grad_scale",
                                     scale=-5.0)),
        ("grad_scale_x2", SiloAttack(corrupted=(1, 4), kind="grad_scale",
                                     scale=-5.0)),
        ("label_flip_x1", SiloAttack(corrupted=(3,), kind="label_flip")),
    ]


def _init(init_params: Any, dev: torch.device):
    """The 4 -> 8 -> 1 MLP: `init_params` (a tree of arrays, e.g. the
    reference's PRNGKey(4) draw), else the port's own draw from seed 4."""
    if init_params is not None:
        return mlp_params_from_numpy(init_params, dev)
    return mlp.init_mlp_params(torch.Generator().manual_seed(4), 4, (8,), 1,
                               device=dev)


def run_cell(sizes, rounds: int, epochs: int, scenario: str, aggregator: str,
             *, seed: int = GRID_SEED, dropout_rate: float = 0.0,
             init_params: Any = None, schedule: Optional[Schedule] = None,
             device: DeviceLike = None) -> Dict:
    """One (scenario, aggregator) cell of the grid on the scan engine.
    `schedule` replaces the cell's minibatch draw, so a parity run can
    inject the reference's ``round_perms``."""
    dev = resolve_device(device)
    silos = make_silos(sizes, seed=9)
    attack = dict(scenarios(len(sizes)))[scenario]
    data, scale = apply_attack(silos, attack)
    t0 = time.perf_counter()
    res = run_federated(
        loss, _init(init_params, dev), data, opt=adamw(1e-2), rounds=rounds,
        local_epochs=epochs, batch_size=16, aggregator=aggregator, seed=seed,
        engine="scan", silo_scale=scale, dropout_rate=dropout_rate,
        trim_frac=TRIM_FRAC, krum_f=KRUM_F, schedule=schedule, device=dev)
    # the final global model on the honest silos' pooled data
    bad = set(attack.corrupted)
    Xh, Yh = (torch.as_tensor(np.concatenate(
        [s[k] for i, s in enumerate(silos) if i not in bad]),
        dtype=torch.float32, device=dev) for k in (0, 1))
    with torch.no_grad():
        honest = float(torch.mean(loss(res.params, Xh, Yh)))
    row = {
        "scenario": scenario, "aggregator": aggregator,
        "dropout_rate": dropout_rate, "corrupted": list(attack.corrupted),
        "final_loss": round(res.history[-1]["loss"], 6),
        "honest_loss": round(honest, 6),
        "loss_curve": [round(h["loss"], 6) for h in res.history],
        "time_s": round(time.perf_counter() - t0, 4),
    }
    print(f"[{scenario:>14s}] {aggregator:<13s} dropout={dropout_rate:.2f} "
          f"final={row['final_loss']:.4f} honest={row['honest_loss']:.4f}")
    return row


def run_grid(sizes, rounds: int, epochs: int, *, seed: int = GRID_SEED,
             dropout_rate: float = 0.0, init_params: Any = None,
             schedules: Optional[Mapping[str, Schedule]] = None,
             device: DeviceLike = None) -> List[Dict]:
    """Every (scenario, aggregator) cell; `schedules` maps an aggregator
    to its injected schedule."""
    schedules = schedules or {}
    return [run_cell(sizes, rounds, epochs, name, agg, seed=seed,
                     dropout_rate=dropout_rate, init_params=init_params,
                     schedule=schedules.get(agg), device=device)
            for name, _ in scenarios(len(sizes)) for agg in AGGREGATORS]


def check_engine_agreement(sizes, rounds: int, epochs: int, *,
                           init_params: Any = None,
                           schedules: Optional[Mapping[str, Schedule]] = None,
                           device: DeviceLike = None) -> Dict[str, float]:
    """host == scan <= 1e-4 for every robust aggregator on the ragged
    grid, with dropout and one scaled silo riding along."""
    dev = resolve_device(device)
    silos = make_silos(sizes, seed=9)
    params = _init(init_params, dev)
    schedules = schedules or {}
    scale = [1.0] * len(sizes)
    scale[1] = -5.0
    out = {}
    for agg in ROBUST_AGGREGATORS:
        kw = dict(opt=adamw(1e-2), rounds=rounds, local_epochs=epochs,
                  batch_size=16, aggregator=agg, seed=ENGINE_SEED,
                  dropout_rate=0.3, silo_scale=scale, trim_frac=TRIM_FRAC,
                  krum_f=KRUM_F, schedule=schedules.get(agg), device=dev)
        host = run_federated(loss, params, silos, engine="host", **kw)
        scan = run_federated(loss, params, silos, engine="scan", **kw)
        diff = max(float(torch.max(torch.abs(a - b)))
                   for a, b in zip(tree_leaves(host.params),
                                   tree_leaves(scan.params)))
        assert diff <= 1e-4, f"host/scan disagree for {agg}: {diff}"
        out[agg] = diff
        print(f"[engines] {agg:<13s} host==scan diff {diff:.2e}")
    return out


def check_sharded_agreement(sizes, rounds: int, epochs: int):
    raise NotImplementedError(
        "the sharded == unsharded check needs silo sharding, which is not "
        "ported to repro_torch yet (ROADMAP.md, Queue 1, multi-process "
        "silo sharding); run with --skip-sharded")


def _cell(rows, scenario, agg):
    return next(r for r in rows
                if r["scenario"] == scenario and r["aggregator"] == agg)


def best_robust(rows, scenario) -> Dict:
    """The robust aggregator with the lowest honest loss in `scenario`."""
    return min((_cell(rows, scenario, a) for a in AGGREGATORS[1:]),
               key=lambda r: r["honest_loss"])


def acceptance(rows) -> Dict[str, Dict]:
    """The acceptance asserts on the clean grid; returns what they read.
    Under gradient scaling the best robust aggregator lands <= 0.5x fedavg
    on the reported loss (the corrupted silo's data is honest under
    grad_scale) AND on honest data, and stays comparable to the clean-run
    reference, not merely "less bad"."""
    checks = {}
    ref = _cell(rows, "clean", "fedavg")["honest_loss"]
    for scen in ("grad_scale_x1", "grad_scale_x2"):
        fed = _cell(rows, scen, "fedavg")
        best = best_robust(rows, scen)
        assert best["final_loss"] <= 0.5 * fed["final_loss"], \
            (scen, best, fed)
        assert best["honest_loss"] <= 0.5 * fed["honest_loss"], \
            (scen, best, fed)
        assert best["honest_loss"] <= 4.0 * ref + 0.1, (scen, best, ref)
        checks[scen] = {"fedavg": fed["final_loss"],
                        "best_robust": best["aggregator"],
                        "best_final_loss": best["final_loss"],
                        "ratio": round(best["final_loss"] /
                                       max(fed["final_loss"], 1e-12), 4)}
        print(f"[accept] {scen}: {best['aggregator']} "
              f"{best['final_loss']:.4f} vs fedavg {fed['final_loss']:.4f} "
              f"(x{checks[scen]['ratio']:.3f})")
    # label-flip: judged on honest data only (see run_grid)
    fed = _cell(rows, "label_flip_x1", "fedavg")
    best = best_robust(rows, "label_flip_x1")
    assert best["honest_loss"] < fed["honest_loss"], (best, fed)
    checks["label_flip_x1"] = {"fedavg_honest": fed["honest_loss"],
                               "best_robust": best["aggregator"],
                               "best_honest_loss": best["honest_loss"]}
    return checks


def layout(fast: bool):
    """(silo sizes, rounds, local epochs) of the grid."""
    if fast:
        return (16, 12, 20, 14, 18, 15), 6, 2
    return (40, 28, 52, 33, 45, 37), 12, 2


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="CI smoke grid")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--skip-sharded", action="store_true",
                    help="skip the sharded == unsharded check (required: "
                         "silo sharding is not ported)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    sizes, rounds, epochs = layout(args.fast)
    engine_rounds = max(rounds // 2, 2)
    if not args.skip_sharded:
        check_sharded_agreement(sizes, engine_rounds, epochs)
    dev = resolve_device(args.device)
    rows = run_grid(sizes, rounds, epochs, device=dev)
    drop_rows = run_grid(sizes, rounds, epochs, dropout_rate=0.3, device=dev)
    engines = check_engine_agreement(sizes, engine_rounds, epochs,
                                     device=dev)
    checks = acceptance(rows)
    out = {
        "bench": "fed_robust_ablation", "device": str(dev),
        "sizes": list(sizes), "rounds": rounds, "local_epochs": epochs,
        "trim_frac": TRIM_FRAC, "krum_f": KRUM_F,
        "grid": rows, "dropout_grid": drop_rows,
        "engine_agreement_maxdiff": engines,
        "sharded_agreement_maxdiff": None,
        "acceptance": checks,
    }
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "BENCH_fed_robust.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[robust-ablation] -> {path}")
    return out


if __name__ == "__main__":
    main()
