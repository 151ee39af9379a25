"""Paper-faithful tabular MLP configs — the networks of Table 3.

The paper trains fully-connected nets on (collaboration representations of)
six tabular datasets. Layer widths [{m, m_hat} - hidden... - out] per Table 3.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MLPConfig:
    name: str
    in_dim: int                 # m (raw) — replaced by m_hat for DC/FedDCL
    hidden: Tuple[int, ...]
    out_dim: int
    task: str                   # "regression" | "classification"
    reduced_dim: int            # m_hat = m_tilde (Table 3)


# Table 3 of the paper (network layers [{m, m̂}-…]).
PAPER_MLPS = {
    "battery_small": MLPConfig("battery_small", 5, (20,), 1, "regression", 4),
    "credit_rating": MLPConfig("credit_rating", 17, (50,), 1, "regression", 15),
    "eicu": MLPConfig("eicu", 24, (10,), 1, "regression", 15),
    "human_activity": MLPConfig("human_activity", 60, (80,), 5, "classification", 50),
    "mnist": MLPConfig("mnist", 784, (500, 100), 10, "classification", 50),
    "fashion_mnist": MLPConfig("fashion_mnist", 784, (500, 100), 10, "classification", 50),
}
