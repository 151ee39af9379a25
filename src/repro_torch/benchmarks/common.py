"""Shared harness for the paper-experiment benchmarks: run all five methods
(Centralized / Local / FedAvg / DC / FedDCL) on one dataset layout
(counterpart of the reference's ``benchmarks/common.py``).

Every script of this package writes under ``OUT_DIR`` (``results_torch/``,
relative to the working directory) unless given another directory, so the
reference's committed ``results/`` artifacts are never overwritten.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.feddcl_mlp import PAPER_MLPS
from repro_torch.core import baselines, protocol
from repro_torch.core.federated import Schedule, run_federated
from repro_torch.data.partition import split_dirichlet, split_iid
from repro_torch.data.tabular import make_dataset, train_test_split
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp
from repro_torch.optim import adamw
from repro_torch.weights import mlp_params_from_numpy

OUT_DIR = "results_torch"
METHODS = ["Centralized", "Local", "FedAvg", "DC", "FedDCL"]


def as_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Features and regression targets as float32, class labels as int64:
    the dtypes the reference's ``jnp.asarray`` gives them."""
    a = np.asarray(a)
    dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
    return torch.as_tensor(a, device=device).to(dtype)


def run_all_methods(dataset: str, *, d: int = 5, c: int = 4, n_ij: int = 100,
                    rounds: int = 20, local_epochs: int = 4, epochs: int = 40,
                    n_test: int = 1000, seed: int = 0, lr: float = 1e-3,
                    non_iid: bool = False, dirichlet_alpha: float = 0.5,
                    methods=None, track_rounds: bool = False,
                    engine: str = "host", svd_backend: str = "host",
                    cache: bool = False, device: DeviceLike = None,
                    init_params: Optional[Mapping[str, Any]] = None,
                    schedules: Optional[Mapping[str, Schedule]] = None
                    ) -> Dict:
    """Returns {"metrics": {method: test metric}, "curves": {...}, "task":
    str, "times": {method: wall s}}. Paper setup: batch 32;
    Centralized / Local / DC train `epochs`; FedAvg / FedDCL run `rounds`
    rounds × `local_epochs` epochs (§4.1).

    All five methods train through the one federated engine on `device`
    (None -> CUDA): `engine` picks the host loop or the captured round,
    `svd_backend` the step-3 backend of FedDCL, and cache=True (scan engine
    only) routes every method through the shared plan cache with stable
    loss / optimizer identities.

    As in the reference, every method of one input width starts from the
    same draw of `seed` (a fresh ``torch.Generator(seed)`` per method), and
    every trainer draws its minibatch order from seed 0, whatever `seed`
    says. `init_params` ({"full": tree, "reduced": tree} of NumPy arrays)
    and `schedules` ({method: schedule}) replace those draws, so a parity
    run can inject the reference's ``jax.random`` ones."""
    cfg = PAPER_MLPS[dataset]
    methods = methods or METHODS
    dev = resolve_device(device)
    init_params = init_params or {}
    schedules = schedules or {}
    n_train = d * c * n_ij
    ds = make_dataset(dataset, n=n_train + n_test + 200, seed=seed)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, n_train, n_test, seed=seed)
    if non_iid:
        Xs, Ys = split_dirichlet(Xtr, Ytr, d, [c] * d, n_ij,
                                 alpha=dirichlet_alpha, seed=seed)
    else:
        Xs, Ys = split_iid(Xtr, Ytr, d, [c] * d, n_ij, seed=seed)
    task = cfg.task
    loss = partial(mlp.mlp_per_example_loss, task=task)
    opt = adamw(lr)
    cache_kw = (dict(cache=True, loss_id=("mlp_per_example_loss", task),
                     opt_id=("adamw", lr))
                if cache and engine == "scan" else {})
    Xte_t, Yte_t = as_tensor(Xte, dev), as_tensor(Yte, dev)

    def init(reduced: bool):
        tree = init_params.get("reduced" if reduced else "full")
        if tree is not None:
            return mlp_params_from_numpy(tree, dev)
        gen = torch.Generator().manual_seed(seed)
        return mlp.for_config(gen, cfg, reduced=reduced, device=dev)

    def metric(p, X=Xte_t):
        with torch.no_grad():
            return mlp.mlp_metric(p, X, Yte_t, task)

    def tracker(X=Xte_t):
        return (lambda pp: {"metric": metric(pp, X)}) if track_rounds else None

    def train(method, p, X, Y, X_eval=Xte_t):
        p, hist = baselines.sgd_train(
            loss, p, X, Y, opt=opt, epochs=epochs, eval_fn=tracker(X_eval),
            engine=engine, schedule=schedules.get(method), device=dev,
            **cache_kw)
        return p, [h["metric"] for h in hist] if track_rounds else None

    def federate(method, p, silos, X_eval=Xte_t):
        res = run_federated(loss, p, silos, opt=opt, rounds=rounds,
                            local_epochs=local_epochs,
                            eval_fn=tracker(X_eval), engine=engine,
                            schedule=schedules.get(method), device=dev,
                            **cache_kw)
        return res.params, ([h["metric"] for h in res.history]
                            if track_rounds else None)

    out: Dict[str, float] = {}
    curves: Dict[str, List[float]] = {}
    times: Dict[str, float] = {}

    for method in methods:
        t0 = time.perf_counter()
        X_eval = Xte_t
        if method == "Centralized":
            p, curve = train(method, init(False), Xtr, Ytr)
        elif method == "Local":
            p, curve = train(method, init(False), Xs[0][0], Ys[0][0])
        elif method == "FedAvg":
            flat = [(Xs[i][j], Ys[i][j]) for i in range(d) for j in range(c)]
            p, curve = federate(method, init(False), flat)
        elif method == "DC":
            flatX = [Xs[i][j] for i in range(d) for j in range(c)]
            flatY = [Ys[i][j] for i in range(d) for j in range(c)]
            maps, Gs, collabX = baselines.dc_setup(
                flatX, m_tilde=cfg.reduced_dim, seed=seed)
            X_eval = as_tensor(np.asarray(maps[0](Xte) @ Gs[0]), dev)
            p, curve = train(method, init(True), np.concatenate(collabX),
                             np.concatenate(flatY), X_eval)
        elif method == "FedDCL":
            setup = protocol.run_protocol(Xs, Ys, m_tilde=cfg.reduced_dim,
                                          anchor_r=2000, seed=seed,
                                          svd_backend=svd_backend,
                                          device=dev)
            X_eval = as_tensor(
                np.asarray(setup.user_transform(0, 0)(Xte)), dev)
            p, curve = federate(method, init(True), setup.fed_silos(), X_eval)
        else:
            raise ValueError(f"unknown method {method!r}; choose from "
                             f"{METHODS}")
        out[method] = metric(p, X_eval)
        if track_rounds:
            curves[method] = curve
        times[method] = time.perf_counter() - t0

    return {"metrics": out, "curves": curves, "task": task, "times": times}
