"""Step 3 of FedDCL: collaboration-representation construction (eqs. 1–3).

Counterpart of ``repro.core.collab``. Two-level SVD protocol:
  intra-group (eq. 1):  Ã^(i) ≈ U^(i) Σ^(i) V^(i)ᵀ,  B̃^(i) = U^(i) C_1^(i)
  central    (eq. 2):   B̃ = [B̃^(1) … B̃^(d)] ≈ P D Qᵀ,  Z = P C_2
  per-user   (eq. 3):   G_j^(i) = argmin_G ‖Ã_j^(i) G − Z‖_F

Backends:
  "host"   — NumPy float64 LAPACK, identical to the reference's host path.
  "device" — batched fp32 on a torch device: all groups through ONE
             batched Gram reduction (the CUDA kernel on a card) + batched
             eigh, all users through ONE batched QR least-squares. Ragged
             widths are zero-padded to the max width.

The reference's legacy alias "tpu" for "device" is not carried over.
The obfuscation matrices C_1/C_2 stay on the host in both backends, so the
two share identical RNG streams (see ``repro.core.collab``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gram import ops as gram_ops


# --------------------------------------------------------------------------
# padded-ragged helpers
# --------------------------------------------------------------------------

def pad_ragged(mats: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack (r, w_b) matrices of ragged width into a zero-padded
    (B, r, w_max) array + boolean column mask (B, w_max)."""
    r = mats[0].shape[0]
    w_max = max(m.shape[1] for m in mats)
    out = np.zeros((len(mats), r, w_max), np.float32)
    mask = np.zeros((len(mats), w_max), bool)
    for b, m in enumerate(mats):
        out[b, :, : m.shape[1]] = m
        mask[b, : m.shape[1]] = True
    return out, mask


def pad_ragged2d(mats: Sequence[np.ndarray]) -> np.ndarray:
    """Stack matrices ragged in BOTH dims into a zero-padded
    (B, n_max, m_max) float32 array (see gram.ops.apply_G_batched)."""
    n_max = max(m.shape[0] for m in mats)
    m_max = max(m.shape[1] for m in mats)
    out = np.zeros((len(mats), n_max, m_max), np.float32)
    for b, m in enumerate(mats):
        out[b, : m.shape[0], : m.shape[1]] = m
    return out


def _fix_signs(U: np.ndarray, s: np.ndarray, V: np.ndarray):
    """Deterministic sign convention: make the max-|entry| of each V column
    positive, flipping the (U, V) pair jointly."""
    idx = np.argmax(np.abs(V), axis=0)
    flip = np.sign(V[idx, np.arange(V.shape[1])])
    flip = np.where(flip == 0, 1.0, flip)
    return U * flip[None, :], s, V * flip[None, :]


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------

class HostBackend:
    """NumPy float64 LAPACK — the paper-faithful serial reference."""

    name = "host"

    def topk_svd(self, A: np.ndarray, k: int):
        k = int(min(k, *A.shape))
        U, s, Vt = np.linalg.svd(np.asarray(A, np.float64), full_matrices=False)
        return _fix_signs(U[:, :k], s[:k], Vt[:k].T)

    def topk_svd_many(self, mats: Sequence[np.ndarray], k: int):
        return [self.topk_svd(A, k) for A in mats]

    def solve_G_many(self, anchors: Sequence[np.ndarray],
                     Z: np.ndarray) -> List[np.ndarray]:
        return [solve_G(A, Z) for A in anchors]

    def apply_G_many(self, Xs: Sequence[np.ndarray],
                     Gs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per-user X̂_j = X̃_j G_j — serial float64 matmuls."""
        return [np.asarray(x, np.float64) @ g for x, g in zip(Xs, Gs)]

    # -- incremental onboarding --------------------------------------------

    def gram(self, A: np.ndarray) -> np.ndarray:
        """AᵀA in float64 — the maintained state of a group's anchor stack."""
        A = np.asarray(A, np.float64)
        return A.T @ A

    def gram_update_blocked(self, gram: np.ndarray, A_old: np.ndarray,
                            A_new: np.ndarray) -> np.ndarray:
        """Gram([A_old A_new]) from the maintained Gram(A_old): only the
        cross and new blocks are computed."""
        A_old = np.asarray(A_old, np.float64)
        A_new = np.asarray(A_new, np.float64)
        cross = A_old.T @ A_new
        return np.block([[gram, cross], [cross.T, A_new.T @ A_new]])

    def topk_svd_from_gram(self, A: np.ndarray, gram: np.ndarray, k: int):
        """Rank-k singular triple recovered from the maintained Gram:
        eigh(AᵀA) gives (s², V); U = A V / s."""
        A = np.asarray(A, np.float64)
        k = int(min(k, *A.shape))
        evals, evecs = np.linalg.eigh(np.asarray(gram, np.float64))
        s = np.sqrt(np.maximum(evals[::-1][:k], 0.0))
        V = evecs[:, ::-1][:, :k]
        U = (A @ V) / np.maximum(s, 1e-12)[None, :]
        return _fix_signs(U, s, V)

    def factor_G_many(self, anchors: Sequence[np.ndarray]):
        """Per-user reduced QR of Ã_j (float64), cached across onboarding."""
        return [np.linalg.qr(np.asarray(a, np.float64)) for a in anchors]

    def factor_G_append(self, factors, a_new: np.ndarray):
        return list(factors) + [np.linalg.qr(np.asarray(a_new, np.float64))]

    def solve_G_factors(self, factors, Z: np.ndarray) -> List[np.ndarray]:
        """Eq. (3) for every user from cached factors."""
        Z = np.asarray(Z, np.float64)
        return [np.linalg.solve(r, q.T @ Z) for q, r in factors]


def _raise_non_finite(G: np.ndarray, how: str) -> None:
    bad = [b for b in range(G.shape[0]) if not np.all(np.isfinite(G[b]))]
    raise FloatingPointError(
        f"device least-squares produced non-finite G for users {bad}{how}: "
        "anchor columns are (near-)collinear, which the QR path cannot "
        "handle at ridge=0 — use collab.DeviceBackend(ridge=1e-3) as "
        "svd_backend, or svd_backend='host'")


class DeviceBackend:
    """Batched fp32 path on a torch device: one Gram+eigh launch for all
    groups, one QR solve for all users. Takes and returns NumPy."""

    name = "device"

    def __init__(self, ridge: float = 0.0, device: DeviceLike = None):
        # relative Tikhonov strength for solve_G_batched; 0.0 keeps exact
        # lstsq agreement and needs full-column-rank anchors
        self.ridge = float(ridge)
        self.device = resolve_device(device)

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def topk_svd(self, A: np.ndarray, k: int):
        return self.topk_svd_many([np.asarray(A)], k)[0]

    def topk_svd_many(self, mats: Sequence[np.ndarray], k: int):
        padded, _ = pad_ragged(mats)
        # batch at the widest feasible rank, then clamp per matrix exactly
        # like HostBackend.topk_svd (min(k, *A.shape))
        k_eff = int(min(k, padded.shape[1], padded.shape[2]))
        U, s, V = gram_ops.gram_eigh_topk_batched(self._t(padded), k_eff)
        # one pull to the host; signs are pinned there
        U, s, V = U.cpu().numpy(), s.cpu().numpy(), V.cpu().numpy()
        out = []
        for b, m in enumerate(mats):
            k_b = int(min(k, *m.shape))
            out.append(_fix_signs(U[b][:, :k_b], s[b][:k_b],
                                  V[b, : m.shape[1], :k_b]))
        return out

    def solve_G_many(self, anchors: Sequence[np.ndarray],
                     Z: np.ndarray) -> List[np.ndarray]:
        padded, mask = pad_ragged(anchors)
        G = gram_ops.solve_G_batched(self._t(padded), self._t(Z),
                                     self._t(mask, torch.bool),
                                     ridge=self.ridge).cpu().numpy()
        if not np.all(np.isfinite(G)):
            _raise_non_finite(G, "")
        return [G[b, : a.shape[1]] for b, a in enumerate(anchors)]

    def apply_G_many(self, Xs: Sequence[np.ndarray],
                     Gs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per-user X̂_j = X̃_j G_j for ALL users in ONE batched matmul."""
        Xp = pad_ragged2d(Xs)                             # (U, n_max, m̃_max)
        Gp = pad_ragged2d(Gs)                             # (U, m̃_max, m̂)
        out = gram_ops.apply_G_batched(self._t(Xp), self._t(Gp)).cpu().numpy()
        return [out[u, : x.shape[0], : g.shape[1]]
                for u, (x, g) in enumerate(zip(Xs, Gs))]

    # -- incremental onboarding --------------------------------------------

    def gram(self, A: np.ndarray) -> np.ndarray:
        """AᵀA via the device Gram reduction (fp32) — the same arithmetic
        the batched from-scratch path uses."""
        return gram_ops.gram(self._t(A)).cpu().numpy()

    def gram_update_blocked(self, gram: np.ndarray, A_old: np.ndarray,
                            A_new: np.ndarray) -> np.ndarray:
        """Blocked update computing only the cross/new blocks (B=1)."""
        out = gram_ops.gram_append_blocked(self._t(gram)[None],
                                           self._t(A_old)[None],
                                           self._t(A_new)[None])
        return out[0].cpu().numpy()

    def topk_svd_from_gram(self, A: np.ndarray, gram: np.ndarray, k: int):
        """eigh + recovery from the maintained Gram (B=1) — the same tail
        the from-scratch device SVD runs."""
        k_eff = int(min(k, *A.shape))
        U, s, V = gram_ops.eigh_topk_recover_batched(
            self._t(gram)[None], self._t(A)[None], k_eff)
        return _fix_signs(U[0].cpu().numpy(), s[0].cpu().numpy(),
                          V[0].cpu().numpy())

    def factor_G_many(self, anchors: Sequence[np.ndarray]):
        """ONE batched QR of the padded augmented anchor stack, cached."""
        padded, mask = pad_ragged(anchors)
        q, rr = gram_ops.solve_G_factor_batched(
            self._t(padded), self._t(mask, torch.bool), ridge=self.ridge)
        return {"q": q, "rr": rr, "mask": mask,
                "r": padded.shape[1],
                "widths": [a.shape[1] for a in anchors]}

    def factor_G_append(self, factors, a_new: np.ndarray):
        """Factor ONLY the joining tenant at the stack's pad width and append
        it; None when it is wider than the pad width or of another height
        (the caller re-factors the whole group then)."""
        m_max = factors["mask"].shape[1]
        if a_new.shape[1] > m_max or a_new.shape[0] != factors["r"]:
            return None
        padded, mask = pad_ragged([a_new])
        if m_max > padded.shape[2]:
            pad = m_max - padded.shape[2]
            padded = np.pad(padded, ((0, 0), (0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        q1, rr1 = gram_ops.solve_G_factor_batched(
            self._t(padded), self._t(mask, torch.bool), ridge=self.ridge)
        return {"q": torch.cat([factors["q"], q1], dim=0),
                "rr": torch.cat([factors["rr"], rr1], dim=0),
                "mask": np.concatenate([factors["mask"], mask], axis=0),
                "r": factors["r"],
                "widths": factors["widths"] + [a_new.shape[1]]}

    def solve_G_factors(self, factors, Z: np.ndarray) -> List[np.ndarray]:
        """All users of a group re-solved against a refreshed Z in ONE
        batched triangular solve from the cached factors."""
        G = gram_ops.solve_G_from_factors(
            factors["q"], factors["rr"], self._t(Z),
            self._t(factors["mask"], torch.bool)).cpu().numpy()
        if not np.all(np.isfinite(G)):
            _raise_non_finite(G, " from cached factors")
        return [G[b, :w] for b, w in enumerate(factors["widths"])]


_BACKENDS = ("host", "device")


def get_backend(name, device: DeviceLike = None):
    """Resolve a backend name ("host" | "device") or pass through an object
    already implementing the backend protocol. `device` places the device
    backend (None -> CUDA)."""
    if not isinstance(name, str):
        return name
    if name == "host":
        return HostBackend()
    if name == "device":
        return DeviceBackend(device=device)
    raise ValueError(f"unknown collab backend {name!r}; "
                     f"choose from {sorted(_BACKENDS)}")


# --------------------------------------------------------------------------
# rank-k SVD with backend dispatch (the single-matrix entry point)
# --------------------------------------------------------------------------

def topk_svd(A: np.ndarray, k: int, backend="host", device: DeviceLike = None):
    """Rank-k thin SVD. Returns (U (n,k), s (k,), V (m,k)); `device` places
    the device backend (None -> CUDA)."""
    return get_backend(backend, device=device).topk_svd(A, k)


def _random_orthogonal(rng, k: int) -> np.ndarray:
    Q, R = np.linalg.qr(rng.standard_normal((k, k)))
    return Q * np.sign(np.diag(R))[None, :]


def _obfuscation(rng, s: np.ndarray, V: np.ndarray,
                 block_cols: Sequence[int], k: int) -> np.ndarray:
    """Paper's C = Σ (V_block_j')ᵀ E construction; random-orthogonal fallback
    if the selected block yields a singular / non-square matrix."""
    j = int(rng.integers(0, len(block_cols)))
    lo = int(np.sum(block_cols[:j]))
    hi = lo + int(block_cols[j])
    Vb = V[lo:hi, :]                                  # (m̃_j, k)
    if Vb.shape[0] == k:
        C = (s[:, None] * Vb.T) @ _random_orthogonal(rng, k)
        if np.linalg.cond(C) < 1e8:
            return C
    return _random_orthogonal(rng, k) * s[:, None]


# --------------------------------------------------------------------------
# protocol messages
# --------------------------------------------------------------------------

@dataclass
class GroupBasis:
    """What intra-group DC server i sends to the central FL server."""
    B: np.ndarray                       # (r, m̂_i) = U^(i) C_1^(i)


@dataclass
class CentralTarget:
    """What the central FL server returns to every DC server."""
    Z: np.ndarray                       # (r, m̂) = P C_2


def _basis_from_svd(svd, rng, block_cols: Sequence[int]) -> GroupBasis:
    U, s, V = svd
    C1 = _obfuscation(rng, s, V, block_cols, U.shape[1])
    return GroupBasis(B=U @ C1)


def intra_group_basis(anchors: List[np.ndarray], m_hat_i: int, seed: int,
                      backend="host", device: DeviceLike = None) -> GroupBasis:
    """Eq. (1) on DC server i. anchors: per-user Ã_j^(i) of shape (r, m̃_ij)."""
    rng = np.random.default_rng(seed)
    A = np.concatenate(anchors, axis=1)               # (r, Σ m̃)
    svd = get_backend(backend, device=device).topk_svd(A, m_hat_i)
    return _basis_from_svd(svd, rng, [a.shape[1] for a in anchors])


def intra_group_bases(anchor_groups: Sequence[Sequence[np.ndarray]],
                      m_hat: int, seeds: Sequence[int],
                      backend="host") -> List[GroupBasis]:
    """Eq. (1) for ALL d DC servers at once: one batched Gram+eigh launch on
    the device backend, the serial per-group loop on host."""
    be = get_backend(backend)
    stacked = [np.concatenate(list(g), axis=1) for g in anchor_groups]
    svds = be.topk_svd_many(stacked, m_hat)
    return [
        _basis_from_svd(svd, np.random.default_rng(seed),
                        [a.shape[1] for a in group])
        for svd, seed, group in zip(svds, seeds, anchor_groups)
    ]


def central_target(bases: List[GroupBasis], m_hat: int, seed: int,
                   backend="host") -> CentralTarget:
    """Eq. (2) on the central FL server."""
    rng = np.random.default_rng(seed)
    B = np.concatenate([b.B for b in bases], axis=1)  # (r, Σ m̂_i)
    P, D, Q = get_backend(backend).topk_svd(B, m_hat)
    C2 = _obfuscation(rng, D, Q, [b.B.shape[1] for b in bases], P.shape[1])
    return CentralTarget(Z=P @ C2)


def solve_G(anchor_j: np.ndarray, Z: np.ndarray) -> np.ndarray:
    """Eq. (3): G = argmin ‖Ã_j G − Z‖_F via least squares."""
    G, *_ = np.linalg.lstsq(anchor_j, Z, rcond=None)
    return G


def solve_G_all(anchors: Sequence[np.ndarray], Z: np.ndarray,
                backend="host") -> List[np.ndarray]:
    """Eq. (3) for a flat list of users (ONE batched QR solve on device)."""
    return get_backend(backend).solve_G_many(anchors, Z)


def apply_G_all(Xs: Sequence[np.ndarray], Gs: Sequence[np.ndarray],
                backend="host") -> List[np.ndarray]:
    """Step 12: X̂_j = X̃_j G_j for a flat list of users (ONE padded batched
    matmul on device, the serial float64 loop on host)."""
    return get_backend(backend).apply_G_many(Xs, Gs)


def alignment_residual(anchor_j: np.ndarray, G: np.ndarray,
                       Z: np.ndarray) -> float:
    """Relative ‖Ã G − Z‖_F / ‖Z‖_F — 0 under Theorem-1 conditions."""
    return float(np.linalg.norm(anchor_j @ G - Z) / max(np.linalg.norm(Z), 1e-12))
