"""Plain PyTorch Gram reduction G = AᵀA in fp32: what the CPU runs, and the
version the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def gram_reference(a: torch.Tensor) -> torch.Tensor:
    """a: (r, m) -> (m, m) fp32."""
    af = a.float()
    return af.T @ af


def gram_batched_reference(a: torch.Tensor) -> torch.Tensor:
    """a: (B, r, m) -> (B, m, m) fp32."""
    af = a.float()
    return torch.einsum("brm,brn->bmn", af, af)
