"""Step 2 of FedDCL: each user's PRIVATE dimensionality-reduction map f_j^(i).

A mapping is a linear row-wise map f(X) = (X - mu) W with W ∈ R^{m × m̃},
never shared under the protocol (privacy Layer 1). Kinds:

  pca_rot  — top-m̃ local PCA basis composed with a RANDOM ORTHOGONAL
             rotation (the paper's experimental setting): W = V_k Q.
             Range(W) = local principal subspace; the rotation makes W
             user-specific even for identical data.
  pca      — plain local PCA (used by the Theorem-1 property test: all
             users on identical data then share Range(W)).
  randproj — Gaussian random projection (Johnson-Lindenstrauss), data-free.
  fixed    — externally supplied W (test hook for same-range constructions).

Nonlinear maps are supported by composing `apply` with any row-wise
nonlinearity upstream; the paper's experiments (and ours) use linear maps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class LinearMap:
    mu: np.ndarray        # (m,)
    W: np.ndarray         # (m, m_tilde)

    def __call__(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mu[None, :]) @ self.W

    @property
    def out_dim(self) -> int:
        return self.W.shape[1]


def _random_orthogonal(rng, k: int) -> np.ndarray:
    Q, R = np.linalg.qr(rng.standard_normal((k, k)))
    return Q * np.sign(np.diag(R))[None, :]


def fit_mapping(kind: str, X: np.ndarray, m_tilde: int,
                seed: int = 0, center: bool = True,
                W: Optional[np.ndarray] = None) -> LinearMap:
    rng = np.random.default_rng(seed)
    m = X.shape[1]
    mu = X.mean(axis=0) if center else np.zeros(m)
    if kind == "fixed":
        assert W is not None
        return LinearMap(mu=mu, W=np.asarray(W, np.float64))
    if kind == "randproj":
        Wr = rng.standard_normal((m, m_tilde)) / np.sqrt(m_tilde)
        return LinearMap(mu=mu, W=Wr)
    # PCA variants
    Xc = X - mu[None, :]
    _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
    V = Vt[:m_tilde].T                                  # (m, m̃)
    if kind == "pca":
        return LinearMap(mu=mu, W=V)
    if kind == "pca_rot":
        Q = _random_orthogonal(rng, m_tilde)
        return LinearMap(mu=mu, W=V @ Q)
    raise ValueError(f"unknown mapping kind {kind!r}")
