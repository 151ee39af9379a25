"""The paper's comparison methods (§4.1): Centralized, Local, FedAvg, DC
(counterpart of ``repro.core.baselines``).

Each method trains the same MLP family (models/mlp.py) with the port's
optimizers, so differences between methods reflect the protocol, not the
trainer. FedAvg is core/federated.run_federated on raw silo data; DC is the
conventional single-central-server data collaboration (all users' anchors
to ONE server, one SVD, centralized training on X̂).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import collab
from repro_torch.core.anchor import make_anchor
from repro_torch.core.federated import run_federated
from repro_torch.core.mappings import fit_mapping
from repro_torch.device import DeviceLike
from repro_torch.optim import Optimizer


def sgd_train(loss_fn, params, X, Y, *, opt: Optimizer, epochs: int,
              batch_size: int = 32, seed: int = 0,
              eval_fn: Optional[Callable] = None,
              engine: str = "host",
              per_example: Optional[bool] = None,
              cache=None, loss_id=None, opt_id=None,
              schedule=None, device: DeviceLike = None
              ) -> Tuple[dict, List[Dict]]:
    """Plain minibatch training used by Centralized / Local / DC: the d=1
    case of the federated engine (one silo, each "round" one epoch,
    optimizer state carried across rounds, FedAvg over one silo the
    identity). engine="scan" runs every epoch as one replay of the captured
    round on a card; cache / loss_id / opt_id route it through the plan
    cache like the federated methods. `schedule` is (epochs, 1, 1, n_slots)
    or a callable, as for run_federated."""
    res = run_federated(
        loss_fn, params, [(np.asarray(X), np.asarray(Y))], opt=opt,
        rounds=epochs, local_epochs=1, batch_size=batch_size, seed=seed,
        eval_fn=eval_fn, engine=engine, per_example=per_example,
        reset_opt_per_round=False, cache=cache, loss_id=loss_id,
        opt_id=opt_id, schedule=schedule, device=device)
    history = [{"epoch": h["round"],
                **{k: v for k, v in h.items() if k != "round"}}
               for h in res.history]
    return res.params, history


def dc_setup(Xs_flat: Sequence[np.ndarray], *, m_tilde: int,
             m_hat: Optional[int] = None, anchor_r: int = 2000,
             anchor_kind: str = "uniform", mapping_kind: str = "pca_rot",
             seed: int = 0):
    """Conventional data collaboration [8, 11]: ONE central server holds all
    users' anchor representations, one rank-m̂ SVD, per-user G (NumPy
    float64 on the host, as in the reference).

    Returns (mappings, Gs, collab_X_per_user)."""
    m_hat = m_hat or m_tilde
    allX = np.concatenate(list(Xs_flat), axis=0)
    anchor = make_anchor(anchor_kind, seed, anchor_r,
                         feat_min=allX.min(0), feat_max=allX.max(0),
                         public_sample=allX[:: max(1, len(allX) // 512)])
    mappings, inter_A, inter_X = [], [], []
    for u, X in enumerate(Xs_flat):
        f = fit_mapping(mapping_kind, np.asarray(X, np.float64), m_tilde,
                        seed=seed * 1009 + u)
        mappings.append(f)
        inter_A.append(f(anchor))
        inter_X.append(f(np.asarray(X, np.float64)))

    A = np.concatenate(inter_A, axis=1)
    U, s, V = collab.get_backend("host").topk_svd(A, m_hat)
    rng = np.random.default_rng(seed * 7)
    Q, R = np.linalg.qr(rng.standard_normal((m_hat, m_hat)))
    Z = U @ (Q * np.sign(np.diag(R))[None, :]) * s[None, :]
    Gs = [collab.solve_G(a, Z) for a in inter_A]
    collab_X = [x @ g for x, g in zip(inter_X, Gs)]
    return mappings, Gs, collab_X
