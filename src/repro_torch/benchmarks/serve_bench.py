"""Collaboration-serving benchmark on the port (counterpart of the
reference's ``benchmarks/serve_bench.py``): warm vs cold bucketed
dispatch, and incremental onboarding vs a from-scratch protocol recompute.

For a mixed multi-tenant request stream on a `ServeCollab` server:

  * cold sweep: the first traffic of each shape bucket, which builds the
    bucket's plan and, on CUDA, captures its graph;
  * warm sweep: the same traffic again. The bar is EXACTLY 0 plans built
    and 0 graphs captured across the sweep (``analysis.CompileCounter``);
    p50 / p99 request latency and rows/s at steady state;
  * artifact hygiene: ``assert_no_baked_data`` on every group's lowered
    step (tenant tables are arguments of the step, never data it holds);
  * onboarding: new users admitted onto the LIVE server (blocked Gram and
    cached-factor update, tables refreshed), timed against the full
    ``run_protocol`` recompute of the grown deployment on the same anchor;
    they agree to <= 1e-5 and the incremental path is >= 5x faster.

The server gets a plan cache of its own, so the cold sweep builds every
bucket it meets whatever ran before in the process. Steps 1-3 and
onboarding are host NumPy (the host collaboration backend, as in the
reference); the tables, the MLP and every served step live on `device`.

  python -m repro_torch.benchmarks.serve_bench [--fast] [--device cpu]
      [--out-dir results_torch]

Writes ``BENCH_serve.json`` under the output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import CompileCounter, assert_no_baked_data
from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.core import protocol
from repro_torch.core.federated import PlanCache
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp
from repro_torch.serve_collab import ServeCollab
from repro_torch.weights import mlp_params_from_numpy

M_RAW = 20
M_TILDE = 16
MAX_BATCH = 64
ONBOARD_SPEEDUP_BAR = 5.0
ONBOARD_AGREE_BAR = 1e-5


def layout(fast: bool) -> Dict[str, int]:
    """The deployment and its traffic. The incremental path's floor is the
    shared central refresh (Z and every group's G re-solved), so at tiny
    layouts that dominates both sides; at these sizes the recompute's
    per-user step-2/3 work (mapping SVDs, full Grams, full QRs) dominates
    and the gap is real."""
    return dict(d=4 if fast else 5, c=10, n_ij=120 if fast else 200,
                n_req=24 if fast else 96, max_rows=24 if fast else 48,
                anchor_r=1024 if fast else 2048, n_onboard=2 if fast else 3)


def _make_data(rng, d: int, c: int, n_ij: int):
    Xs = [[rng.standard_normal((n_ij, M_RAW)) for _ in range(c)]
          for _ in range(d)]
    Ys = [[rng.standard_normal((n_ij, 1)) for _ in range(c)] for _ in range(d)]
    return Xs, Ys


def _sweep(srv: ServeCollab, rng, d: int, c: int, n_req: int, max_rows: int):
    """Submit a mixed-tenant stream and drain it; returns (dt, stats, the
    served outputs)."""
    for _ in range(n_req):
        g = int(rng.integers(0, d))
        u = int(rng.integers(0, c))
        srv.submit(rng.standard_normal(
            (int(rng.integers(1, max_rows + 1)), M_RAW)), g, u)
    t0 = time.perf_counter()
    out = srv.serve()
    dt = time.perf_counter() - t0
    assert all(s == "done" for s in out.status.values())
    return dt, srv.stats(), out


def _setup_agreement(inc, ref) -> float:
    """Max relative difference between an incrementally grown setup and a
    from-scratch one over Z, every G and every X̂."""

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    worst = rel(inc.Z, ref.Z)
    for i in range(ref.num_groups):
        for j in range(ref.num_users(i)):
            worst = max(worst, rel(inc.Gs[i][j], ref.Gs[i][j]))
        worst = max(worst, rel(inc.collab_X[i], ref.collab_X[i]))
    return worst


def build(fast: bool = False, *, init_params: Any = None,
          device: DeviceLike = None) -> SimpleNamespace:
    """The deployment's setup (steps 1-3 with onboarding state, timed) and
    its server. The MLP (m̂ -> 32 -> 1) is `init_params` (a tree of arrays,
    e.g. the reference's PRNGKey(0) draw), else the port's own draw from
    seed 0."""
    dev = resolve_device(device)
    lay = layout(fast)
    rng = np.random.default_rng(0)
    Xs, Ys = _make_data(rng, lay["d"], lay["c"], lay["n_ij"])
    t0 = time.perf_counter()
    setup = protocol.run_protocol(Xs, Ys, m_tilde=M_TILDE,
                                  anchor_r=lay["anchor_r"], seed=0,
                                  onboard=True, device=dev)
    t_setup = time.perf_counter() - t0
    params = (mlp_params_from_numpy(init_params, dev)
              if init_params is not None else mlp.init_mlp_params(
                  torch.Generator().manual_seed(0), setup.m_hat, (32,), 1,
                  device=dev))
    srv = ServeCollab.from_setup(setup, params, max_batch=MAX_BATCH,
                                 cache=PlanCache(), device=dev)
    return SimpleNamespace(lay=lay, rng=rng, Xs=Xs, Ys=Ys, setup=setup,
                           srv=srv, t_setup=t_setup, device=dev)


def serve_sweeps(b: SimpleNamespace) -> Dict[str, Any]:
    """The cold then the warm sweep, on the same stream (seed 1): the cold
    pass builds every bucket; the warm pass is steady state (tail-batch
    pow2 buckets follow the traffic, so another stream could rightly build
    an unseen one). The warm pass's outputs stay on ``b.out_warm``."""
    lay, srv = b.lay, b.srv
    traffic = (lay["d"], lay["c"], lay["n_req"], lay["max_rows"])
    with CompileCounter() as cold:
        t_cold, st_cold, _ = _sweep(srv, np.random.default_rng(1), *traffic)
    srv.latencies.clear()
    with CompileCounter() as warm:
        t_warm, st, b.out_warm = _sweep(srv, np.random.default_rng(1),
                                        *traffic)
    warm_rows = st["rows_served"] - st_cold["rows_served"]
    return {
        "t_cold_s": round(t_cold, 4),
        "t_warm_s": round(t_warm, 4),
        "compiles_cold": cold.count, "plans_cold": cold.plans,
        "captures_cold": cold.captures,
        "compiles_warm": warm.count, "plans_warm": warm.plans,
        "captures_warm": warm.captures,
        "rows_per_s_warm": round(warm_rows / t_warm, 1),
        "p50_latency_ms": round(st["p50_latency_s"] * 1e3, 3),
        "p99_latency_ms": round(st["p99_latency_s"] * 1e3, 3),
        "buckets": st["buckets"],
        "cache": st["cache"],
    }


def audit(b: SimpleNamespace) -> None:
    """No tenant data held by any group's step at the full batch bucket."""
    for g in range(b.setup.num_groups):
        assert_no_baked_data(b.srv.lower_step(g, MAX_BATCH))


def onboard(b: SimpleNamespace) -> Dict[str, Any]:
    """Admit new users onto the live server, each timed with its table
    refresh (the best of them), then recompute the grown deployment from
    scratch on the same anchor (the best of 3)."""
    lay, srv, rng = b.lay, b.srv, b.rng
    grown_X = [list(row) for row in b.Xs]
    grown_Y = [list(row) for row in b.Ys]
    t_onboards: List[float] = []
    for k in range(lay["n_onboard"]):
        Xn = rng.standard_normal((lay["n_ij"], M_RAW))
        Yn = rng.standard_normal((lay["n_ij"], 1))
        tgt = k % lay["d"]
        t0 = time.perf_counter()
        srv.onboard_user(tgt, Xn, Yn)
        if b.device.type == "cuda":
            torch.cuda.synchronize(b.device)
        t_onboards.append(time.perf_counter() - t0)
        grown_X[tgt].append(Xn)
        grown_Y[tgt].append(Yn)
    t_onboard = min(t_onboards)
    t_recompute, ref = float("inf"), None
    for _ in range(3):
        t0 = time.perf_counter()
        ref = protocol.run_protocol(grown_X, grown_Y, m_tilde=M_TILDE,
                                    anchor_r=lay["anchor_r"], seed=0,
                                    anchor=b.setup.anchor, device=b.device)
        t_recompute = min(t_recompute, time.perf_counter() - t0)
    return {
        "n_onboarded": lay["n_onboard"],
        "t_incremental_s": round(t_onboard, 5),
        "t_full_recompute_s": round(t_recompute, 4),
        "speedup": round(t_recompute / t_onboard, 1),
        "agreement_max_rel": _setup_agreement(b.setup, ref),
    }


def run(fast: bool = False, *, init_params: Any = None,
        device: DeviceLike = None) -> Dict[str, Any]:
    b = build(fast, init_params=init_params, device=device)
    serve = serve_sweeps(b)
    assert serve["compiles_warm"] == 0, (
        f"warm mixed-tenant sweep built {serve['plans_warm']} plans and "
        f"captured {serve['captures_warm']} graphs")
    audit(b)
    ob = onboard(b)
    assert ob["agreement_max_rel"] <= ONBOARD_AGREE_BAR, \
        f"onboarded setup drifted {ob['agreement_max_rel']:.2e} from full recompute"
    assert ob["speedup"] >= ONBOARD_SPEEDUP_BAR, \
        f"incremental onboarding only {ob['speedup']:.1f}x cheaper than recompute"
    lay = b.lay
    return {
        "layout": {"groups": lay["d"], "users_per_group": lay["c"],
                   "n_ij": lay["n_ij"], "m_raw": M_RAW, "m_tilde": M_TILDE,
                   "anchor_r": lay["anchor_r"]},
        "traffic": {"requests_per_sweep": lay["n_req"],
                    "max_rows": lay["max_rows"], "max_batch": MAX_BATCH},
        "t_setup_s": round(b.t_setup, 4),
        "device": str(b.device),
        "serve": serve,
        "onboard": ob,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="small layout + fewer requests (CI)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    result = run(fast=args.fast, device=args.device)
    result["fast"] = args.fast
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, "BENCH_serve.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    s, o = result["serve"], result["onboard"]
    print(f"warm sweep: {s['t_warm_s']}s ({s['rows_per_s_warm']} rows/s), "
          f"builds cold->warm {s['compiles_cold']}->{s['compiles_warm']} "
          f"(plans {s['plans_cold']}, captures {s['captures_cold']} cold)")
    print(f"latency p50 {s['p50_latency_ms']}ms / p99 {s['p99_latency_ms']}ms")
    print(f"onboard: {o['t_incremental_s']}s incremental vs "
          f"{o['t_full_recompute_s']}s recompute = {o['speedup']}x, "
          f"agreement {o['agreement_max_rel']:.2e}")
    print(f"wrote {os.path.abspath(out_path)}")
    return result


if __name__ == "__main__":
    main()
