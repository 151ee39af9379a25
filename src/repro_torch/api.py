"""One-call public API: ``FedDCL(...).fit(Xs, Ys)`` — protocol steps 1–3
plus the federated phase (counterpart of ``repro.api``).

    from repro_torch.api import FedDCL
    model = FedDCL(m_tilde=8, rounds=20, local_epochs=4, task="regression")
    setup, result = model.fit(Xs, Ys)      # Xs[i][j]: raw data of user (i,j)
    yhat = model.predict(Xnew)             # through user (0,0)'s transform

Runs on CUDA unless `device="cpu"` is passed (without a card, the default
raises). As in ``repro``, step 4 runs on the scan engine through the
process-wide plan cache: the first ``fit()`` of a shape bucket captures one
federated round as a CUDA graph, and every later ``fit()`` whose padded
shapes land in the same bucket replays it (``result.cache_stats``). One
difference stays: there is no persistent compilation cache across
processes (``repro.api.enable_persistent_compilation_cache``); a captured
graph lives as long as its process.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.core.federated import FLResult, Schedule, run_federated
from repro_torch.core.protocol import FedDCLSetup
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp
from repro_torch.optim import adamw
from repro_torch.weights import mlp_params_from_numpy


class FedDCL:
    """sklearn-style facade over the full FedDCL pipeline.

    ``fit(Xs, Ys)`` runs Algorithm 1 end to end: anchor + private mappings
    (steps 1–2), the two-level collaboration solve (step 3, `svd_backend`
    "host" or "device"), then the federated phase (step 4) on the
    collaboration representations. Model head: an MLP on the m̂-dimensional
    representations (`hidden`, `task`; `out_dim` inferred from Ys when None).
    """

    def __init__(self, *, m_tilde: int, m_hat: Optional[int] = None,
                 hidden: Sequence[int] = (32,), task: str = "regression",
                 out_dim: Optional[int] = None,
                 rounds: int = 20, local_epochs: int = 4,
                 batch_size: int = 32, lr: float = 1e-3,
                 aggregator: str = "fedavg", fedprox_mu: float = 0.0,
                 anchor_r: int = 2000, anchor_kind: str = "uniform",
                 mapping_kind: str = "pca_rot", svd_backend: str = "host",
                 engine: str = "scan", seed: int = 0,
                 reset_opt_per_round: bool = True,
                 cache: Any = True,
                 eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
                 dropout_rate: float = 0.0,
                 silo_scale: Optional[Sequence[float]] = None,
                 trim_frac: float = 0.2, krum_f: int = 1,
                 onboard: bool = True,
                 device: DeviceLike = None):
        self.m_tilde = m_tilde
        self.m_hat = m_hat or m_tilde
        self.hidden = tuple(hidden)
        self.task = task
        self.out_dim = out_dim
        self.rounds = rounds
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.lr = lr
        self.aggregator = aggregator
        self.fedprox_mu = fedprox_mu
        self.anchor_r = anchor_r
        self.anchor_kind = anchor_kind
        self.mapping_kind = mapping_kind
        self.svd_backend = svd_backend
        self.engine = engine
        self.seed = seed
        self.reset_opt_per_round = reset_opt_per_round
        self.cache = cache
        self.eval_fn = eval_fn
        # hostile-world knobs: aggregator may be any of
        # federated.AGGREGATORS, the robust ones included; dropout_rate
        # simulates silo unavailability; silo_scale is the attack vector
        self.dropout_rate = dropout_rate
        self.silo_scale = silo_scale
        self.trim_frac = trim_frac
        self.krum_f = krum_f
        # onboard=True keeps the incremental-update state (cached Grams and
        # QR factors) so partial_fit() can admit tenants without a recompute
        self.onboard = onboard
        self.device = resolve_device(device)
        # one optimizer per estimator; its cache identity is ("adamw", lr)
        self._opt = adamw(lr)
        self.setup_: Optional[FedDCLSetup] = None
        self.result_: Optional[FLResult] = None

    # -- pipeline ----------------------------------------------------------

    def _infer_out_dim(self, Ys) -> int:
        if self.out_dim is not None:
            return self.out_dim
        y0 = np.asarray(Ys[0][0])
        if self.task == "classification":
            return int(max(int(np.asarray(y).max()) for g in Ys for y in g)) + 1
        return 1 if y0.ndim == 1 else int(y0.shape[-1])

    def _train(self, params, rounds: int, seed: int,
               schedule: Optional[Schedule]) -> FLResult:
        loss = partial(mlp.mlp_per_example_loss, task=self.task)
        return run_federated(
            loss, params, self.setup_.fed_silos(), opt=self._opt,
            rounds=rounds, local_epochs=self.local_epochs,
            batch_size=self.batch_size, aggregator=self.aggregator,
            fedprox_mu=self.fedprox_mu, seed=seed, eval_fn=self.eval_fn,
            engine=self.engine, reset_opt_per_round=self.reset_opt_per_round,
            schedule=schedule,
            cache=self.cache if self.engine == "scan" else None,
            loss_id=("mlp_per_example_loss", self.task),
            opt_id=("adamw", self.lr),
            dropout_rate=self.dropout_rate, silo_scale=self.silo_scale,
            trim_frac=self.trim_frac, krum_f=self.krum_f,
            device=self.device)

    def fit(self, Xs: Sequence[Sequence[np.ndarray]],
            Ys: Sequence[Sequence[np.ndarray]],
            init_params: Any = None,
            schedule: Optional[Schedule] = None) -> Tuple[FedDCLSetup, FLResult]:
        """Run the whole protocol; returns (setup, fl_result) and stores
        them on the estimator (`setup_`, `result_`, `params_`), with the wall
        seconds of steps 1–3 and of step 4 in `fit_seconds_`.

        `init_params` (a tree of arrays in the reference's layout) and
        `schedule` (see core.federated) replace the port's own seeded draws,
        which cannot reproduce the reference's ``jax.random`` ones. With the
        plan cache on (the default) a schedule is at the BUCKETED layout:
        (rounds, d', local_epochs, n_slots') with d' = bucket_pow2(d) for d
        groups and n_slots' = batch_size · bucket_pow2(⌈n_max /
        batch_size⌉) for the largest group's n_max samples
        (``federated.padded_layout(setup.fed_silos(), batch_size=...,
        aggregator=..., cache=True)`` gives it)."""
        t0 = time.perf_counter()
        self.setup_ = protocol.run_protocol(
            Xs, Ys, m_tilde=self.m_tilde, m_hat=self.m_hat,
            anchor_r=self.anchor_r, anchor_kind=self.anchor_kind,
            mapping_kind=self.mapping_kind, seed=self.seed,
            svd_backend=self.svd_backend, onboard=self.onboard,
            device=self.device)
        t1 = time.perf_counter()
        if init_params is not None:
            params = mlp_params_from_numpy(init_params, self.device)
        else:
            gen = torch.Generator().manual_seed(self.seed)
            params = mlp.init_mlp_params(gen, self.m_hat, self.hidden,
                                         self._infer_out_dim(Ys),
                                         device=self.device)
        self.result_ = self._train(params, self.rounds, self.seed, schedule)
        self.params_ = self.result_.params
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fit_seconds_ = {"protocol": t1 - t0,
                             "federated": time.perf_counter() - t1}
        return self.setup_, self.result_

    # -- incremental onboarding --------------------------------------------

    def partial_fit(self, X_new: Any, Y_new: Any, *,
                    group: Optional[int] = None,
                    refit_rounds: Optional[int] = None,
                    schedule: Optional[Schedule] = None) -> Tuple[int, int]:
        """Onboard new data onto a FITTED estimator without recomputing the
        protocol: with ``group=i``, (X_new, Y_new) is ONE new user joining
        group i; with ``group=None``, lists of per-user arrays forming a new
        silo. ``refit_rounds`` optionally continues federated training from
        the current params (seed + 1). Returns the newcomer's (group, user).
        """
        if self.setup_ is None:
            raise RuntimeError("call fit() before partial_fit()")
        if group is None:
            i = self.setup_.onboard_silo(list(X_new), list(Y_new))
            j = 0
        else:
            i = int(group)
            j = self.setup_.onboard_user(i, X_new, Y_new)
        if refit_rounds:
            self.result_ = self._train(self.params_, int(refit_rounds),
                                       self.seed + 1, schedule)
            self.params_ = self.result_.params
        return i, j

    def serve(self, **kw) -> Any:
        """A live multi-tenant ``serve_collab.ServeCollab`` over this fitted
        model (every tenant's x → f(x)·G → h, bucketed, on the estimator's
        device unless `device` says otherwise; on CUDA one captured step a
        shape bucket). Its onboarding updates this estimator's setup."""
        from repro_torch.serve_collab import ServeCollab
        return ServeCollab.from_model(self, **kw)

    # -- inference ---------------------------------------------------------

    def transform(self, X: np.ndarray, i: int = 0, j: int = 0) -> np.ndarray:
        """x → f_j^(i)(x) G_j^(i): user (i,j)'s input map (NumPy float64)."""
        if self.setup_ is None:
            raise RuntimeError("call fit() first")
        return np.asarray(self.setup_.user_transform(i, j)(X))

    def _features(self, X: np.ndarray, i: int, j: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.transform(X, i, j), np.float32),
                               device=self.device)

    def predict(self, X: np.ndarray, i: int = 0, j: int = 0) -> np.ndarray:
        """t_j^(i)(X) = h(f(X) G): regression values or class labels."""
        if self.result_ is None:
            raise RuntimeError("call fit() first")
        with torch.no_grad():
            out = mlp.mlp_forward(self.params_, self._features(X, i, j))
        out = out.cpu().numpy()
        return out.argmax(-1) if self.task == "classification" else out

    def score(self, X: np.ndarray, Y: np.ndarray, i: int = 0, j: int = 0) -> float:
        """RMSE (regression) / accuracy (classification) through (i,j)."""
        if self.result_ is None:
            raise RuntimeError("call fit() first")
        y = torch.as_tensor(np.asarray(Y), device=self.device)
        y = y.float() if y.is_floating_point() else y.long()
        with torch.no_grad():
            return mlp.mlp_metric(self.params_, self._features(X, i, j), y,
                                  self.task)
