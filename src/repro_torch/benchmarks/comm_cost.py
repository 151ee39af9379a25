"""Communication-cost accounting (the paper's §3.2 claim and the systems
point of the whole method): per-user cross-institution round trips and
bytes, FedDCL vs FedAvg, plus the mesh-level per-step collective
amortization (cross-silo bytes / H) read from the port's dry-run records
(``launch.dryrun``) when there are any.

  python -m repro_torch.benchmarks.comm_cost [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.configs.feddcl_mlp import PAPER_MLPS
from repro_torch.core import protocol
from repro_torch.data.partition import split_iid
from repro_torch.data.tabular import make_dataset, train_test_split
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp
from repro_torch.tree import tree_leaves


def protocol_comm(dataset: str = "mnist", d: int = 5, c: int = 4,
                  n_ij: int = 100, rounds: int = 20,
                  device: DeviceLike = None):
    dev = resolve_device(device)
    cfg = PAPER_MLPS[dataset]
    ds = make_dataset(dataset, n=d * c * n_ij + 100, seed=0)
    (Xtr, Ytr), _ = train_test_split(ds, d * c * n_ij, 64, seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d, [c] * d, n_ij, seed=0)
    setup = protocol.run_protocol(Xs, Ys, m_tilde=cfg.reduced_dim, seed=0,
                                  device=dev)
    params = mlp.for_config(torch.Generator().manual_seed(0), cfg,
                            reduced=True, device=dev)
    # the reference counts every parameter as 4 bytes (fp32)
    pbytes = sum(l.numel() * 4 for l in tree_leaves(params))
    protocol.finalize_user_models(setup, h=lambda z: z,
                                  h_params_bytes=int(pbytes))

    trips = setup.comm.user_round_trips()
    user_bytes = setup.comm.total_bytes(
        lambda e: e.src.startswith("user") or e.dst.startswith("user"))
    # FedAvg: every user exchanges model params twice per round
    fedavg_user_msgs = 2 * rounds
    fedavg_user_bytes = int(2 * rounds * pbytes * d * c)
    feddcl_server_bytes = setup.comm.total_bytes(
        lambda e: not (e.src.startswith("user") or e.dst.startswith("user")))
    # DC-server <-> FL-server federated phase (rounds × params × d × 2)
    feddcl_server_bytes += int(2 * rounds * pbytes * d)

    return {
        "users": d * c,
        "feddcl_msgs_per_user": max(trips.values()),
        "fedavg_msgs_per_user": fedavg_user_msgs,
        "feddcl_user_bytes_total": user_bytes,
        "fedavg_user_bytes_total": fedavg_user_bytes,
        "feddcl_server_bytes_total": int(feddcl_server_bytes),
        "model_bytes": int(pbytes),
    }


def mesh_amortization(result_dir: str = "results_torch/dryrun", H: int = 4):
    """Per-step collective bytes: baseline vs feddcl local + sync / H, from
    the dry-run's train_4k records. Only a record of a mesh of more than
    one rank with a measured ``collective_bytes_per_device`` counts: the
    one-card mesh moves nothing between ranks, and a pair whose per-rank
    trace failed keeps a specs-only record (null costs). The production
    meshes' records are traced per rank (``launch.dryrun``), so a sweep
    with ``--both-meshes`` in the three modes gives a row per arch and
    mesh."""
    out = {}
    for f in glob.glob(os.path.join(result_dir, "*__train_4k__*__*.json")):
        with open(f) as fh:
            rec = json.load(fh)
        if rec["chips"] > 1 and rec["collective_bytes_per_device"] is not None:
            out[(rec["arch"], rec["mesh"], rec["mode"])] = \
                rec["collective_bytes_per_device"]
    rows = {}
    for (arch, mesh, mode), v in sorted(out.items()):
        rows.setdefault((arch, mesh), {})[mode] = v
    table = []
    for (arch, mesh), modes in rows.items():
        if "feddcl" in modes and "feddcl_sync" in modes and "baseline" in modes:
            amort = modes["feddcl"] + modes["feddcl_sync"] / H
            table.append({
                "arch": arch, "mesh": mesh,
                "baseline_coll_bytes_per_step": modes["baseline"],
                "feddcl_amortized_coll_bytes_per_step": amort,
                "reduction_x": modes["baseline"] / max(amort, 1.0),
            })
    return table


def user_traffic_reduction(rows) -> float:
    return rows["fedavg_user_bytes_total"] / max(
        rows["feddcl_user_bytes_total"], 1)


def run(fast: bool = False, device: DeviceLike = None,
        out_dir: str = OUT_DIR):
    rows = protocol_comm(device=device)
    print("Protocol communication (mnist stand-in, d=5, c=4, 20 FL rounds):")
    for k, v in rows.items():
        print(f"  {k:32s} {v:,}")
    print(f"  user-traffic reduction vs FedAvg: "
          f"{user_traffic_reduction(rows):.1f}x, "
          f"msgs {rows['fedavg_msgs_per_user']} -> "
          f"{rows['feddcl_msgs_per_user']}")
    table = mesh_amortization()
    if table:
        print("\nMesh-level per-step cross-silo bytes (dry-run):")
        for r in table:
            print(f"  {r['arch']:24s} baseline="
                  f"{r['baseline_coll_bytes_per_step']:.3e} "
                  f"feddcl(H=4)={r['feddcl_amortized_coll_bytes_per_step']:.3e}"
                  f" ({r['reduction_x']:.2f}x)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "comm_cost.json"), "w") as f:
        json.dump({"protocol": rows, "mesh": table}, f, indent=1)
    return rows, table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
