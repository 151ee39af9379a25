"""Synthetic stand-ins for the paper's six tabular datasets (§4.3, Table 3).

The real datasets are MATLAB-toolbox / credentialed / network-gated (see
DESIGN.md §2 — data gate of the repro band). Each stand-in matches the
original's (n, m, task, #classes) and its qualitative structure:

  * an approximately low-rank latent factor structure (so PCA-based
    intermediate representations retain signal — the regime the DC family
    of methods targets and the paper's experiments exercise), plus
  * a target that is a (mildly nonlinear) function of the latents, plus
  * heteroscedastic noise and feature-range diversity.

The paper's claims we validate are RELATIVE (FedDCL ≈ FedAvg ≈ DC ≫ Local;
FedDCL faster per-round than FedAvg), which transfer to any dataset with
this structure; absolute RMSE/accuracy digits do not (documented in
EXPERIMENTS.md).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.feddcl_mlp import PAPER_MLPS, MLPConfig


@dataclass
class Dataset:
    name: str
    X: np.ndarray           # (n, m) float64
    Y: np.ndarray           # (n, out) float64 (regression) | (n,) int (classif.)
    task: str
    cfg: MLPConfig


def _latent_regression(rng, n: int, m: int, latent: int, *, noise: float,
                       nonlinearity: float = 0.3):
    """X = s(Z) @ W + eps; y = g(Z). Low-rank X with target tied to latents."""
    Z = rng.standard_normal((n, latent))
    W = rng.standard_normal((latent, m)) / np.sqrt(latent)
    X = Z @ W + noise * rng.standard_normal((n, m))
    w_y = rng.standard_normal((latent,)) / np.sqrt(latent)
    y = Z @ w_y + nonlinearity * np.tanh(Z[:, 0] * Z[:, min(1, latent - 1)])
    y = (y - y.mean()) / (y.std() + 1e-9)
    # per-feature affine ranges (like physical sensor units)
    scale = rng.uniform(0.5, 3.0, size=m)
    shift = rng.uniform(-1.0, 1.0, size=m)
    X = X * scale[None, :] + shift[None, :]
    return X, y[:, None]


def _latent_classification(rng, n: int, m: int, latent: int, classes: int, *,
                           noise: float, sep: float = 2.2):
    """Class-conditional latent Gaussians -> low-rank features."""
    y = rng.integers(0, classes, size=n)
    # scale of the raw draw is irrelevant: the next line projects centers
    # onto the radius-`sep` sphere (a dead `* sep / sqrt(l) * sqrt(l)`
    # factor used to sit here; removing it keeps the RNG draw sequence
    # identical and perturbs centers only in the last ulp of the division)
    centers = rng.standard_normal((classes, latent))
    centers = centers / np.linalg.norm(centers, axis=1, keepdims=True) * sep
    Z = centers[y] + rng.standard_normal((n, latent))
    W = rng.standard_normal((latent, m)) / np.sqrt(latent)
    X = Z @ W + noise * rng.standard_normal((n, m))
    return X, y.astype(np.int64)


_SPECS: Dict[str, Dict] = {
    # name: latent dim, noise, classes (None = regression)
    "battery_small": dict(latent=3, noise=0.15, classes=None),
    "credit_rating": dict(latent=6, noise=0.25, classes=None),
    "eicu": dict(latent=8, noise=0.40, classes=None),
    "human_activity": dict(latent=12, noise=0.35, classes=5),
    "mnist": dict(latent=30, noise=0.30, classes=10),
    "fashion_mnist": dict(latent=30, noise=0.45, classes=10),
}


def make_dataset(name: str, n: int, seed: int = 0) -> Dataset:
    cfg = PAPER_MLPS[name]
    spec = _SPECS[name]
    # zlib.crc32, not hash(): str hashing is salted per process
    # (PYTHONHASHSEED), which made every process draw a different dataset
    rng = np.random.default_rng(seed ^ zlib.crc32(name.encode()) % (2**31))
    if spec["classes"] is None:
        X, Y = _latent_regression(rng, n, cfg.in_dim, spec["latent"],
                                  noise=spec["noise"])
        task = "regression"
    else:
        X, Y = _latent_classification(rng, n, cfg.in_dim, spec["latent"],
                                      spec["classes"], noise=spec["noise"])
        task = "classification"
    return Dataset(name=name, X=X, Y=Y, task=task, cfg=cfg)


def train_test_split(ds: Dataset, n_train: int, n_test: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    assert n_train + n_test <= ds.X.shape[0]
    perm = rng.permutation(ds.X.shape[0])
    tr, te = perm[:n_train], perm[n_train : n_train + n_test]
    return (ds.X[tr], ds.Y[tr]), (ds.X[te], ds.Y[te])
