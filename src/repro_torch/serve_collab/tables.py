"""Device-resident tenant tables for collaboration serving (counterpart of
``repro.serve_collab.tables``).

After FedDCL setup, user (i, j)'s whole input pipeline collapses to ONE
affine map: f_j(x) G_j = (x − mu_j) (W_j G_j). A group's tenants therefore
serve from two stacked tensors

    M  (T_pad, m, m̂)   combined per-tenant maps  W_j @ G_j
    mu (T_pad, m)       per-tenant centering offsets

zero-padded on the tenant axis to the next power of two, so onboarding a
tenant usually lands in the existing padded shape (the resident step is
not captured again) and at worst doubles it (one fresh bucket). The tables
are ARGUMENTS of the serve step, copied into a captured step's buffers
before each replay, never baked into a graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from repro_torch.core.federated import bucket_pow2
from repro_torch.core.protocol import FedDCLSetup
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class TenantTable:
    """One group's resident serving state."""
    M: torch.Tensor                   # (T_pad, m, m_hat) float32
    mu: torch.Tensor                  # (T_pad, m) float32
    count: int                        # real tenants; rows past it are zeros

    @property
    def t_pad(self) -> int:
        return int(self.M.shape[0])

    @property
    def in_dim(self) -> int:
        return int(self.M.shape[1])

    @property
    def out_dim(self) -> int:
        return int(self.M.shape[2])


def combined_user_map(setup: FedDCLSetup, i: int, j: int) -> np.ndarray:
    """W_j^(i) @ G_j^(i) — the (m, m̂) matrix user (i,j) serves through."""
    return np.asarray(setup.mappings[i][j].W, np.float64) @ np.asarray(
        setup.Gs[i][j], np.float64)


def build_table(setup: FedDCLSetup, i: int,
                bucket: Callable[[int], int] = bucket_pow2, *,
                device: DeviceLike = None) -> TenantTable:
    """Stack group i's tenants into one padded table on `device`."""
    count = len(setup.mappings[i])
    m = setup.mappings[i][0].W.shape[0]
    m_hat = np.asarray(setup.Gs[i][0]).shape[1]
    t_pad = bucket(count)
    M = np.zeros((t_pad, m, m_hat), np.float32)
    mu = np.zeros((t_pad, m), np.float32)
    for j in range(count):
        M[j] = combined_user_map(setup, i, j).astype(np.float32)
        mu[j] = np.asarray(setup.mappings[i][j].mu, np.float32)
    dev = resolve_device(device)
    return TenantTable(M=torch.as_tensor(M, device=dev),
                       mu=torch.as_tensor(mu, device=dev), count=count)


def build_tables(setup: FedDCLSetup,
                 bucket: Callable[[int], int] = bucket_pow2, *,
                 device: DeviceLike = None) -> List[TenantTable]:
    """One table per DC group."""
    return [build_table(setup, i, bucket, device=device)
            for i in range(setup.num_groups)]
