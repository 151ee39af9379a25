"""Partition a dataset across d groups × c_i users (the paper's layout),
IID or non-IID (Dirichlet label skew / feature-cluster skew)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def split_iid(X: np.ndarray, Y: np.ndarray, d: int, c: Sequence[int],
              n_ij: int, seed: int = 0):
    """-> (Xs[i][j], Ys[i][j]) with n_ij samples per user, IID."""
    rng = np.random.default_rng(seed)
    total = n_ij * int(np.sum(c))
    assert total <= X.shape[0], f"need {total} samples, have {X.shape[0]}"
    perm = rng.permutation(X.shape[0])[:total]
    Xs, Ys, k = [], [], 0
    for i in range(d):
        gx, gy = [], []
        for _ in range(c[i]):
            sl = perm[k * n_ij : (k + 1) * n_ij]
            gx.append(X[sl])
            gy.append(Y[sl])
            k += 1
        Xs.append(gx)
        Ys.append(gy)
    return Xs, Ys


def split_dirichlet(X: np.ndarray, Y: np.ndarray, d: int, c: Sequence[int],
                    n_ij: int, alpha: float = 0.5, seed: int = 0):
    """Non-IID label-skew partition: each user's class mix ~ Dir(alpha).
    Regression targets are bucketed into quintiles first."""
    rng = np.random.default_rng(seed)
    y = Y if Y.ndim == 1 else np.digitize(
        Y[:, 0], np.quantile(Y[:, 0], [0.2, 0.4, 0.6, 0.8]))
    classes = np.unique(y)
    by_class = {cl: list(rng.permutation(np.where(y == cl)[0])) for cl in classes}
    Xs, Ys = [], []
    for i in range(d):
        gx, gy = [], []
        for _ in range(c[i]):
            p = rng.dirichlet(alpha * np.ones(len(classes)))
            idx: List[int] = []
            want = rng.multinomial(n_ij, p)
            for cl, w in zip(classes, want):
                take = by_class[cl][:w]
                by_class[cl] = by_class[cl][w:]
                idx.extend(take)
            # backfill if a class ran dry
            while len(idx) < n_ij:
                for cl in classes:
                    if by_class[cl]:
                        idx.append(by_class[cl].pop())
                        if len(idx) == n_ij:
                            break
            sl = np.asarray(idx[:n_ij])
            gx.append(X[sl])
            gy.append(Y[sl])
        Xs.append(gx)
        Ys.append(gy)
    return Xs, Ys
