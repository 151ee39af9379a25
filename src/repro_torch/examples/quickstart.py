"""Quickstart: the full FedDCL protocol (Algorithm 1) on a BatterySmall-like
synthetic regression task — 4 user institutions in 2 groups, exactly the
paper's Experiment I layout.

  python -m repro_torch.examples.quickstart [--device cpu]
  FEDDCL_BACKEND=device python -m repro_torch.examples.quickstart

FEDDCL_BACKEND selects the step-3 collaboration backend: "host" (serial
NumPy float64, default) or "device" (one batched Gram+eigh, on a card the
Gram kernel, and one batched QR solve). FEDDCL_ENGINE selects the step-4
federated engine: "host" (per-batch dispatch, default) or "scan" (one
captured round replayed every round). Without --device the run takes the
card, and raises without one.
"""
import argparse
import os
from functools import partial

import numpy as np
import torch

from repro_torch.configs.feddcl_mlp import PAPER_MLPS
from repro_torch.core import protocol
from repro_torch.core.federated import run_federated
from repro_torch.data.partition import split_iid
from repro_torch.data.tabular import make_dataset, train_test_split
from repro_torch.device import resolve_device
from repro_torch.models import mlp
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- data: paper Exp I — d=2 groups, c_i=2 users, n_ij=100 ----------
    cfg = PAPER_MLPS["battery_small"]
    ds = make_dataset("battery_small", n=1500, seed=0)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, 400, 1000, seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d=2, c=[2, 2], n_ij=100, seed=0)

    # ---- FedDCL steps 1-3: anchor, private maps, SVD alignment ----------
    backend = os.environ.get("FEDDCL_BACKEND", "host")
    setup = protocol.run_protocol(Xs, Ys, m_tilde=cfg.reduced_dim,
                                  anchor_r=2000, seed=0,
                                  svd_backend=backend, device=dev)
    print(f"collab backend: {backend} | anchor:", setup.anchor.shape,
          "| collab reps per group:", [x.shape for x in setup.collab_X])

    # ---- FedDCL step 4: FedAvg between the intra-group DC servers -------
    # the per-example loss lets the engine zero-pad and mask ragged silos
    params = mlp.for_config(torch.Generator().manual_seed(0), cfg,
                            reduced=True, device=dev)
    loss = partial(mlp.mlp_per_example_loss, task=cfg.task)
    engine = os.environ.get("FEDDCL_ENGINE", "host")
    res = run_federated(
        loss, params, setup.fed_silos(),
        opt=adamw(1e-3), rounds=20, local_epochs=4, batch_size=32,
        engine=engine, device=dev)

    # ---- step 5: per-user integrated model t(X) = h(f(X) G) -------------
    def h(Z):
        return mlp.mlp_forward(
            res.params, torch.as_tensor(np.asarray(Z, np.float32), device=dev))

    models = protocol.finalize_user_models(setup, h)
    with torch.no_grad():
        pred = models[0][0](Xte).cpu().numpy()
    rmse = float(np.sqrt(np.mean((pred - Yte) ** 2)))
    print(f"FedDCL test RMSE: {rmse:.4f}")

    # ---- the paper's headline communication property --------------------
    trips = setup.comm.user_round_trips()
    print("cross-institution communications per user:", trips)
    assert all(v == 2 for v in trips.values()), \
        "exactly 2 per user: one upload (step 4) + one download (step 15)"
    print("== exactly 2 per user, as the paper claims (Algorithm 1)")
    return rmse, trips


if __name__ == "__main__":
    main()
