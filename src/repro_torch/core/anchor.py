"""Step 1 of FedDCL: construction of the shareable pseudo anchor dataset A.

All users must generate the SAME anchor, so every constructor is a pure
function of a shared seed (and, for the data-informed variants, of public
statistics that the institutions agree to share).

Three constructors per the paper §3.2:
  uniform  — uniform random within per-feature value ranges (the paper's
             experimental choice, after [8, 11])
  lowrank  — low-rank-approximation-based ([5]): anchor sampled from the
             span of the top right singular vectors of a public sample
  smote    — SMOTE-based ([6]): convex combinations of nearest public
             sample pairs
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def uniform_anchor(seed: int, r: int, feat_min: np.ndarray,
                   feat_max: np.ndarray) -> np.ndarray:
    """Uniform random anchor inside the shared per-feature ranges."""
    rng = np.random.default_rng(seed)
    m = feat_min.shape[0]
    u = rng.uniform(size=(r, m))
    return feat_min[None, :] + u * (feat_max - feat_min)[None, :]


def lowrank_anchor(seed: int, r: int, public_sample: np.ndarray,
                   rank: Optional[int] = None) -> np.ndarray:
    """Anchor with the low-rank structure of a public sample [5]:
    A = mu + G (s_p ⊙ V_p)ᵀ with G standard normal."""
    rng = np.random.default_rng(seed)
    mu = public_sample.mean(axis=0)
    Xc = public_sample - mu
    U, s, Vt = np.linalg.svd(Xc, full_matrices=False)
    p = rank or max(1, min(Xc.shape) // 2)
    G = rng.standard_normal((r, p)) / np.sqrt(max(Xc.shape[0] - 1, 1))
    return mu[None, :] + G @ (s[:p, None] * Vt[:p])


def smote_anchor(seed: int, r: int, public_sample: np.ndarray,
                 k: int = 5) -> np.ndarray:
    """SMOTE-style anchor [6]: interpolate random points toward one of their
    k nearest neighbours."""
    rng = np.random.default_rng(seed)
    n = public_sample.shape[0]
    idx = rng.integers(0, n, size=r)
    base = public_sample[idx]
    # k nearest neighbours of each base point (O(r·n) — fine at anchor scale)
    d2 = ((base[:, None, :] - public_sample[None, :, :]) ** 2).sum(-1)
    d2[np.arange(r), idx] = np.inf
    nn = np.argpartition(d2, kth=min(k, n - 1) - 1, axis=1)[:, :k]
    pick = nn[np.arange(r), rng.integers(0, min(k, n - 1), size=r)]
    lam = rng.uniform(size=(r, 1))
    return base + lam * (public_sample[pick] - base)


def make_anchor(kind: str, seed: int, r: int, *, feat_min=None, feat_max=None,
                public_sample=None, rank=None) -> np.ndarray:
    if kind == "uniform":
        return uniform_anchor(seed, r, np.asarray(feat_min), np.asarray(feat_max))
    if kind == "lowrank":
        return lowrank_anchor(seed, r, np.asarray(public_sample), rank)
    if kind == "smote":
        return smote_anchor(seed, r, np.asarray(public_sample))
    raise ValueError(f"unknown anchor kind {kind!r}")
