"""Synthetic token pipeline for LM training: the port's own copy of
``repro.data.tokens``, NumPy only, so both packages draw the same batches
bit for bit. Deterministic, seekable, silo-aware.

Generator: a hidden affine-recurrence language over an effective vocabulary
V_eff ≤ vocab: t_{k+1} = (a·t_k + b) mod V_eff with segment restarts and
per-silo (a, b) flavour under non-IID mode — learnable structure so training
loss demonstrably falls, with controllable cross-silo heterogeneity (the
paper's non-IID axis)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    v_eff: int = 2048
    segment: int = 64
    silo: int = 0
    non_iid: bool = False

    def __post_init__(self):
        self.v_eff = min(self.v_eff, self.vocab_size)
        rng = np.random.default_rng(self.seed + (self.silo if self.non_iid else 0))
        # odd multiplier -> full-period affine map mod 2^k-ish vocab
        self._a = int(rng.integers(1, self.v_eff // 2)) * 2 + 1
        self._b = int(rng.integers(0, self.v_eff))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step * 7919 + self.silo * 104729) % (2**63))
        B, S = self.batch_size, self.seq_len
        starts = rng.integers(0, self.v_eff, size=(B, (S + self.segment) // self.segment + 1))
        toks = np.empty((B, S + 1), np.int64)
        for b in range(B):
            seq = []
            si = 0
            while len(seq) < S + 1:
                t = int(starts[b, si])
                si += 1
                for _ in range(self.segment):
                    seq.append(t)
                    t = (self._a * t + self._b) % self.v_eff
            toks[b] = np.asarray(seq[: S + 1])
        # sprinkle noise tokens (makes the task non-trivial)
        mask = rng.random((B, S + 1)) < 0.02
        toks[mask] = rng.integers(0, self.vocab_size, size=int(mask.sum()))
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def silo_batches(vocab_size: int, seq_len: int, per_silo_batch: int,
                 num_silos: int, step: int, *, seed: int = 0,
                 non_iid: bool = False) -> Dict[str, np.ndarray]:
    """Stacked per-silo batches with a leading silo dim: tokens
    (d, b, S) — feeds the silo-vmapped federated train step."""
    outs = [
        TokenStream(vocab_size, seq_len, per_silo_batch, seed=seed, silo=s,
                    non_iid=non_iid).batch(step)
        for s in range(num_silos)
    ]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
