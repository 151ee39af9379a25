"""Privacy evaluation of FedDCL's double protection layer (§3.4) and the
hostile-world attacker harness (counterpart of ``repro.core.privacy``;
NumPy on the host, as there).

Layer 1 (protocol): f_j^(i) is never shared — an attacker on a DC server
sees only X̃ = (X − μ)W with unknown (μ, W).
Layer 2 (ε-DR privacy [25]): even with f stolen, W is a dimensionality
reduction (m̃ < m), so X is not recoverable beyond the best rank-m̃
approximation.

Metrics:
  recovery_error_known_map    — ‖X − X̂‖/‖X‖ with X̂ = X̃ W⁺ + μ  (Layer-2 bound)
  recovery_error_unknown_map  — same attack with a random W′ of the right
                                shape (Layer-1: attacker has no map)
  eps_dr                      — ε-DR privacy level: per-sample guaranteed
                                floor ε s.t. ‖x − x̂‖² ≥ ε‖x‖² for the optimal
                                linear reconstruction (1 − top-m̃ energy ratio)

Attacker harness (active adversaries at the FedAvg boundary; consumed by
run_federated):
  SiloAttack              — which silos are corrupted and how
  label_flip_silos        — data poisoning: corrupted silos' labels flipped
                            (classification: cyclic shift; regression:
                            negated) BEFORE training — the model update is
                            honest SGD on dishonest data
  grad_scale_vector       — model poisoning: the (d,) silo_scale argument
                            scaling corrupted silos' submitted round deltas
                            (core/federated.apply_silo_scale; scale < 0
                            pushes the global model AWAY from the honest
                            average — the classic sign-flip attacker)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.mappings import LinearMap


def recovery_error_known_map(X: np.ndarray, f: LinearMap) -> float:
    Xt = f(X)
    W_pinv = np.linalg.pinv(f.W)
    X_rec = Xt @ W_pinv + f.mu[None, :]
    return float(np.linalg.norm(X - X_rec) / max(np.linalg.norm(X), 1e-12))


def recovery_error_unknown_map(X: np.ndarray, f: LinearMap, seed: int = 0) -> float:
    """Layer-1 attack: the adversary sees X̃ but must guess the map."""
    rng = np.random.default_rng(seed)
    Xt = f(X)
    W_guess = rng.standard_normal(f.W.shape)
    X_rec = Xt @ np.linalg.pinv(W_guess)              # no μ either
    return float(np.linalg.norm(X - X_rec) / max(np.linalg.norm(X), 1e-12))


def eps_dr(X: np.ndarray, m_tilde: int) -> float:
    """ε-DR privacy level of ANY rank-m̃ linear reduction of X: the optimal
    reconstruction leaves at least the (m̃+1..m) tail energy, so
    ε = 1 − Σ_{k≤m̃} σ_k² / Σ_k σ_k²."""
    Xc = X - X.mean(0, keepdims=True)
    s = np.linalg.svd(Xc, compute_uv=False)
    total = float(np.sum(s ** 2))
    kept = float(np.sum(s[:m_tilde] ** 2))
    return max(0.0, 1.0 - kept / max(total, 1e-12))


def evaluate(X: np.ndarray, f: LinearMap, seed: int = 0) -> Dict[str, float]:
    return {
        "recovery_error_known_map": recovery_error_known_map(X, f),
        "recovery_error_unknown_map": recovery_error_unknown_map(X, f, seed),
        "eps_dr": eps_dr(X, f.out_dim),
    }


# ==========================================================================
# Active attacker harness (hostile-world federation, DESIGN.md §8)
# ==========================================================================

@dataclass(frozen=True)
class SiloAttack:
    """One adversarial configuration of a federated run.

    corrupted: indices of the Byzantine silos (empty = honest run).
    kind: "none" | "label_flip" | "grad_scale".
    scale: the delta multiplier grad_scale applies at the corrupted silos
      (−5.0 default: a sign-flipped, amplified submission — far outside the
      honest cluster, the regime robust aggregators are built for).
    num_classes: needed by label_flip on classification targets.
    """
    corrupted: Tuple[int, ...] = ()
    kind: str = "none"
    scale: float = -5.0
    num_classes: int = 0

    def __post_init__(self):
        if self.kind not in ("none", "label_flip", "grad_scale"):
            raise ValueError(f"unknown attack kind {self.kind!r}")


def label_flip_silos(
    silo_data: Sequence[Tuple[np.ndarray, np.ndarray]],
    corrupted: Sequence[int], *, num_classes: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Data-poisoning attacker: return a copy of silo_data with the
    corrupted silos' labels flipped. Classification labels are cyclically
    shifted ((y+1) mod C — every label wrong, the strongest untargeted
    flip); regression targets are negated. Honest silos share storage with
    the input (no copy)."""
    bad = set(int(i) for i in corrupted)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for i, (x, y) in enumerate(silo_data):
        if i not in bad:
            out.append((x, y))
            continue
        y = np.asarray(y)
        if num_classes > 0:
            yf = np.mod(y.astype(np.int64) + 1, num_classes).astype(y.dtype)
        else:
            yf = -y
        out.append((x, yf))
    return out


def grad_scale_vector(num_silos: int, corrupted: Sequence[int],
                      scale: float = -5.0) -> np.ndarray:
    """Model-poisoning attacker: the (num_silos,) silo_scale vector for
    run_federated — corrupted silos submit scale·delta, honest silos 1.0
    (an exact no-op, core/federated.apply_silo_scale)."""
    v = np.ones(num_silos, np.float32)
    for i in corrupted:
        if not 0 <= int(i) < num_silos:
            raise ValueError(f"corrupted silo {i} out of range "
                             f"[0, {num_silos})")
        v[int(i)] = np.float32(scale)
    return v


def apply_attack(
    silo_data: Sequence[Tuple[np.ndarray, np.ndarray]],
    attack: SiloAttack,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], "np.ndarray | None"]:
    """Materialize an attack: returns (possibly-poisoned silo_data,
    silo_scale-or-None) — the pair run_federated consumes. label_flip
    rewrites data and leaves scale honest; grad_scale leaves data intact
    and returns the scale vector."""
    if attack.kind == "none" or not attack.corrupted:
        return list(silo_data), None
    if attack.kind == "label_flip":
        return label_flip_silos(silo_data, attack.corrupted,
                                num_classes=attack.num_classes), None
    return list(silo_data), grad_scale_vector(
        len(silo_data), attack.corrupted, attack.scale)
