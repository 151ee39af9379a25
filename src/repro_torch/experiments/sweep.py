"""Sweep script: many FedDCL configs through ONE plan cache (counterpart of
the reference's ``experiments/sweep.py``).

Every config runs the full pipeline through the public ``FedDCL.fit()``
with the shared plan cache, so configs whose padded shapes land in the same
bucket reuse one plan, and on CUDA its one captured round: the 2nd–Nth
calls skip the warm-up and the capture.

Two artifacts, under ``--out-dir`` (default ``results_torch``; the
reference's committed ``results/BENCH_*.json`` stay untouched):

  BENCH_sweep.json      cold pass vs warm pass over the 6-config sweep;
                        plans (= cache misses) strictly fewer than configs
  BENCH_api_cache.json  one config's fit() called N times: the first call
                        builds and captures, the rest hit

The script asserts the reference's cache invariants (fewer plans than
configs, every warm fit a hit, the warm-over-cold speedup floor: 3x with
``--fast``, 20x without). The floor measures what a hit saves, the
capture; on the CPU nothing is captured and the floor is not expected to
hold. There is no persistent cache across processes (the reference's
``FEDDCL_COMPILATION_CACHE``): a captured graph lives as long as its
process.

  python -m repro_torch.experiments.sweep [--fast] [--device cpu]
      [--out-dir results_torch]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

OUT_DIR = "results_torch"


def run_sweep(cases: List[Dict], run_case: Callable[[Dict], Dict], *,
              label: str = "sweep", out_path: Optional[str] = None,
              verbose: bool = True) -> List[Dict]:
    """Generic timed config-grid loop: run `run_case` on each case dict,
    recording wall time per case. Returns rows = case ∪ result ∪ {time_s};
    writes them as JSON when out_path is given."""
    rows = []
    for case in cases:
        t0 = time.perf_counter()
        res = run_case(case)
        dt = time.perf_counter() - t0
        row = {**case, **(res or {}), "time_s": round(dt, 4)}
        rows.append(row)
        if verbose:
            desc = " ".join(f"{k}={v}" for k, v in case.items())
            print(f"[{label}] {desc}  ({dt:.3f}s)")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1)
        if verbose:
            print(f"[{label}] -> {out_path}")
    return rows


# --------------------------------------------------------------------------
# The FedDCL 6-config sweep (BENCH_sweep) + api-cache bench (BENCH_api_cache)
# --------------------------------------------------------------------------

M_FEAT = 16          # raw feature dim m
M_TILDE = 8          # intermediate dim m̃ = m̂
ANCHOR_R = 512


def _make_groups(d: int, c: int, n_ij: int, seed: int = 0):
    """Synthetic (Xs, Ys) in the protocol layout: group i, user j."""
    r = np.random.default_rng(seed)
    w = r.standard_normal((M_FEAT, 1))
    Xs, Ys = [], []
    for i in range(d):
        gx, gy = [], []
        for j in range(c):
            X = r.standard_normal((n_ij, M_FEAT))
            gx.append(X)
            gy.append(X @ w + 0.05 * r.standard_normal((n_ij, 1)))
        Xs.append(gx)
        Ys.append(gy)
    return Xs, Ys


def sweep_configs(fast: bool = False) -> List[Dict]:
    """Six tenant configs spanning three shape buckets — two configs per
    (silo-bucket, batch-bucket) pair, so the cache must land 3 plans and
    3 hits on the cold pass (and 6 hits warm)."""
    if fast:
        return [dict(d=2, c=2, n_ij=40, seed=0), dict(d=2, c=2, n_ij=34, seed=1),
                dict(d=3, c=2, n_ij=40, seed=2), dict(d=4, c=2, n_ij=34, seed=3)]
    return [dict(d=2, c=2, n_ij=60, seed=0), dict(d=2, c=2, n_ij=50, seed=1),
            dict(d=3, c=2, n_ij=60, seed=2), dict(d=4, c=2, n_ij=50, seed=3),
            dict(d=6, c=2, n_ij=50, seed=4), dict(d=8, c=2, n_ij=40, seed=5)]


def _fit_case(case: Dict, rounds: int, local_epochs: int,
              device: DeviceLike = None) -> Dict:
    from repro_torch.api import FedDCL

    Xs, Ys = _make_groups(case["d"], case["c"], case["n_ij"], case["seed"])
    model = FedDCL(m_tilde=M_TILDE, anchor_r=ANCHOR_R, rounds=rounds,
                   local_epochs=local_epochs, seed=case["seed"],
                   device=device)
    t0 = time.perf_counter()
    _, res = model.fit(Xs, Ys)     # ends in a device sync
    fit_s = time.perf_counter() - t0
    return {"fit_s": round(fit_s, 4), "hit": res.cache_stats["hit"],
            "final_loss": res.history[-1]["loss"],
            "score": model.score(Xs[0][0], Ys[0][0])}


def bench_sweep(fast: bool = False, device: DeviceLike = None) -> Dict:
    from repro_torch.core.federated import default_plan_cache

    rounds, epochs = (4, 2) if fast else (15, 4)
    cases = sweep_configs(fast)
    cache = default_plan_cache()
    cache.clear()

    def fit(c):
        return _fit_case(c, rounds, epochs, device)

    cold = run_sweep(cases, fit, label="sweep:cold")
    cold_stats = cache.stats()
    warm = run_sweep(cases, fit, label="sweep:warm")
    warm_stats = cache.stats()

    t_cold = sum(r["fit_s"] for r in cold)
    t_warm = sum(r["fit_s"] for r in warm)
    out = {
        "bench": "feddcl_api_sweep",
        "configs": len(cases),
        "rounds": rounds, "local_epochs": epochs,
        "executables": cold_stats["misses"],
        "cold_pass": cold, "warm_pass": warm,
        "t_cold_total_s": round(t_cold, 4),
        "t_warm_total_s": round(t_warm, 4),
        "speedup": round(t_cold / max(t_warm, 1e-9), 1),
        "cache_cold": cold_stats, "cache_warm": warm_stats,
    }
    assert cold_stats["misses"] < len(cases), \
        f"bucketing broken: {cold_stats['misses']} executables for {len(cases)} configs"
    assert all(r["hit"] for r in warm), "warm pass missed the plan cache"
    floor = 3.0 if fast else 20.0
    assert out["speedup"] >= floor, \
        f"warm sweep only {out['speedup']}x over cold (floor {floor}x)"
    print(f"[sweep] {len(cases)} configs -> {out['executables']} executables; "
          f"cold {t_cold:.2f}s warm {t_warm:.3f}s ({out['speedup']}x)")
    return out


def bench_api_cache(fast: bool = False, device: DeviceLike = None) -> Dict:
    """One shape bucket, N fresh fit() calls: call 1 builds the plan (and on
    CUDA warms up and captures its round), calls 2..N only replay."""
    from repro_torch.core.federated import default_plan_cache

    rounds, epochs = (4, 2) if fast else (15, 4)
    n_calls = 4 if fast else 6
    default_plan_cache().clear()
    calls = []
    for k in range(n_calls):
        case = dict(d=3, c=2, n_ij=50 + 2 * k, seed=k)   # same bucket, new tenant
        calls.append({**case, **_fit_case(case, rounds, epochs, device)})
        print(f"[api-cache] call {k}: {calls[-1]['fit_s']:.4f}s "
              f"hit={calls[-1]['hit']}")
    t_first = calls[0]["fit_s"]
    t_rest = [c["fit_s"] for c in calls[1:]]
    out = {
        "bench": "feddcl_api_cache",
        "calls": calls,
        "t_first_s": round(t_first, 4),
        "t_warm_mean_s": round(float(np.mean(t_rest)), 4),
        "speedup": round(t_first / max(float(np.mean(t_rest)), 1e-9), 1),
        "cache": default_plan_cache().stats(),
    }
    assert not calls[0]["hit"] and all(c["hit"] for c in calls[1:]), \
        "api-cache: expected exactly one miss then all hits"
    floor = 3.0 if fast else 20.0
    assert out["speedup"] >= floor, \
        f"warm fit() only {out['speedup']}x over cold (floor {floor}x)"
    print(f"[api-cache] first {t_first:.3f}s, warm mean "
          f"{out['t_warm_mean_s']*1000:.1f}ms ({out['speedup']}x)")
    return out


def device_meta(device: torch.device) -> Dict:
    """What ran the benchmark: torch's version, the device, and on CUDA the
    card's name and power limit as nvidia-smi reports them."""
    meta = {"platform": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        meta["device"] = torch.cuda.get_device_name(device)
        meta["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="CI smoke grid")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    meta = {**device_meta(dev), "fast": args.fast}
    os.makedirs(args.out_dir, exist_ok=True)
    outs = {}
    for name, bench in (("BENCH_sweep", bench_sweep),
                        ("BENCH_api_cache", bench_api_cache)):
        out = outs[name] = {**meta, **bench(fast=args.fast, device=dev)}
        path = os.path.join(args.out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"-> {path}")
    return outs


if __name__ == "__main__":
    main()
