"""Multi-tenant collaboration serving CLI (counterpart of
``repro.launch.serve_collab``).

Fits a small FedDCL model on synthetic tabular data, stands up a
`ServeCollab` server over it, and pushes a mixed stream of heterogeneous
requests (random tenants, random row counts) through the bucketed resident
step — then optionally onboards a new user onto the LIVE server and keeps
serving. Prints latency percentiles, per-bucket dispatch counts, and the
plan-cache tally (warm steady state should show no further misses or
captures).

  PYTHONPATH=src python -m repro_torch.launch.serve_collab --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve_collab --device cpu --onboard
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import FedDCL
from repro_torch.data.partition import split_iid
from repro_torch.data.tabular import make_dataset, train_test_split
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="battery_small")
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--users", type=int, default=2, help="users per group")
    ap.add_argument("--n-ij", type=int, default=80, help="rows per user")
    ap.add_argument("--m-tilde", type=int, default=None,
                    help="default: the dataset's paper reduced dim")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-rows", type=int, default=48,
                    help="max rows per request")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--backend", default="host", choices=["host", "device"])
    ap.add_argument("--onboard", action="store_true",
                    help="onboard a new user onto the live server mid-run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)

    # ---- fit a small model ----------------------------------------------
    dev = resolve_device(args.device)
    ds = make_dataset(args.dataset, n=4000, seed=args.seed)
    need = args.groups * args.users * args.n_ij
    (Xtr, Ytr), (Xte, _) = train_test_split(ds, need + args.n_ij, 512,
                                            seed=args.seed)
    Xs, Ys = split_iid(Xtr[:need], Ytr[:need], d=args.groups,
                       c=[args.users] * args.groups, n_ij=args.n_ij,
                       seed=args.seed)
    m_tilde = args.m_tilde or ds.cfg.reduced_dim
    model = FedDCL(m_tilde=m_tilde, rounds=args.rounds, task=ds.task,
                   svd_backend=args.backend, seed=args.seed, device=dev)
    t0 = time.perf_counter()
    model.fit(Xs, Ys)
    print(f"fit: {args.groups} groups x {args.users} users "
          f"in {time.perf_counter() - t0:.2f}s (device={dev})")

    # ---- serve a mixed-tenant stream ------------------------------------
    srv = model.serve(max_batch=args.max_batch)
    rng = np.random.default_rng(args.seed + 1)
    m = Xs[0][0].shape[1]
    for _ in range(args.requests):
        g = int(rng.integers(0, args.groups))
        u = int(rng.integers(0, args.users))
        n = int(rng.integers(1, args.max_rows + 1))
        srv.submit(rng.standard_normal((n, m)), g, u)
    t0 = time.perf_counter()
    out = srv.serve()
    dt = time.perf_counter() - t0
    done = sum(1 for s in out.status.values() if s == "done")
    st = srv.stats()
    print(f"served {done}/{len(out)} requests, {st['rows_served']} rows "
          f"in {dt:.3f}s ({st['rows_served'] / dt:.0f} rows/s)")
    print(f"  p50 latency {st['p50_latency_s'] * 1e3:.2f}ms | "
          f"p99 {st['p99_latency_s'] * 1e3:.2f}ms")
    print(f"  buckets: {st['buckets']}")
    print(f"  plan cache: {st['cache']}")

    # ---- live onboarding -------------------------------------------------
    if args.onboard:
        Xn = Xtr[need:need + args.n_ij]
        Yn = Ytr[need:need + args.n_ij]
        t0 = time.perf_counter()
        j = srv.onboard_user(0, Xn, Yn)
        dt = time.perf_counter() - t0
        print(f"onboarded user {j} into group 0 in {dt * 1e3:.1f}ms "
              f"(incremental — no full protocol recompute)")
        for _ in range(8):
            srv.submit(rng.standard_normal(
                (int(rng.integers(1, args.max_rows + 1)), m)), 0, j)
        out2 = srv.serve()
        print(f"served {len(out2)} requests through the new tenant; "
              f"cache now: {srv.stats()['cache']}")


if __name__ == "__main__":
    main()
