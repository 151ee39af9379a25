"""Gram-reduction entry points of the collaboration solve, on torch tensors.

Counterparts of ``repro.kernels.gram.ops``: the same names, arguments and
padded-ragged convention. Ragged stacks are zero-padded on the trailing
column axis; zero columns are harmless on the Gram route (eigh keeps them
in the null space) and are masked explicitly on the least-squares route
(``col_mask``, see ``solve_G_batched``).

``gram_batched`` is the one place a kernel runs: a CUDA tensor goes to the
hand-written kernel (``kernel.gram_batched_cuda``), a CPU tensor to the
plain version (``ref.gram_batched_reference``). Everything else is plain
torch (``bmm``, ``torch.linalg``), as the reference leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.gram import ref
from repro_torch.kernels.gram.kernel import gram_batched_cuda

_BACKENDS = ("auto", "ref")


def gram(a: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """a: (r, m) -> AᵀA (m, m) fp32 — the B=1 case of `gram_batched`."""
    return gram_batched(a[None], backend=backend)[0]


def gram_batched(a: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """a: (B, r, m) -> stacked AᵦᵀAᵦ (B, m, m) fp32 in ONE launch.

    backend="auto" dispatches on the tensor's device: CUDA -> the kernel
    (which raises rather than fall back), CPU -> the plain version.
    backend="ref" forces the plain version, to hold the kernel against it.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown gram backend {backend!r}; "
                         f"choose from {_BACKENDS}")
    if backend == "ref" or a.is_cpu:
        return ref.gram_batched_reference(a)
    return gram_batched_cuda(a)


def gram_eigh_topk(a: torch.Tensor, k: int, *, backend: str = "auto"):
    """Rank-k singular triple of a (r, m) via the Gram route; the B=1 case
    of `gram_eigh_topk_batched`. Returns (U (r,k), s (k,), V (m,k))."""
    U, s, V = gram_eigh_topk_batched(a[None], k, backend=backend)
    return U[0], s[0], V[0]


def gram_eigh_topk_batched(a: torch.Tensor, k: int, *, backend: str = "auto"):
    """a (B, r, m) -> (U (B,r,k), s (B,k), V (B,m,k)): one batched Gram
    reduction + one batched eigh. Zero-padded columns contribute zero
    eigenvalues and never reach the top-k slots while k ≤ rank."""
    g = gram_batched(a, backend=backend)
    return eigh_topk_recover_batched(g, a, k)


def eigh_topk_recover_batched(g: torch.Tensor, a: torch.Tensor, k: int):
    """Rank-k singular recovery from a precomputed Gram stack g (B, m, m)
    of the matrices a (B, r, m): eigh(g) -> (s², V), U = A V / s.

    The Gram is fp32, but its eigh runs in float64 (results cast back to
    fp32): the Gram route squares the condition number, and a float32 eigh
    leaves eigenvector errors near eps32·λ_max/gap. cuSOLVER's fp32 eigh
    reaches that bound at the mnist layout (1.3e-4 where onboarding must
    agree with a recompute to 1e-5); in float64 the fp32 Gram's own
    rounding is what remains.
    """
    g = g.double()
    g = 0.5 * (g + g.transpose(1, 2))       # jnp.linalg.eigh symmetrizes
    evals, evecs = torch.linalg.eigh(g)     # ascending, batched
    evals = torch.flip(evals, dims=(1,))[:, :k].float()
    V = torch.flip(evecs, dims=(2,))[:, :, :k].float()        # (B, m, k)
    s = torch.sqrt(torch.clamp(evals, min=0.0))               # (B, k)
    U = torch.bmm(a.float(), V)
    U = U / torch.clamp(s, min=1e-12)[:, None, :]
    return U, s, V


def gram_append_blocked(g: torch.Tensor, a_old: torch.Tensor,
                        a_new: torch.Tensor) -> torch.Tensor:
    """Gram([A_old A_new]) from the maintained g = A_oldᵀA_old, computing
    only the cross and new blocks. g (B,W,W), a_old (B,r,W), a_new (B,r,w)
    -> (B, W+w, W+w)."""
    a_old = a_old.float()
    a_new = a_new.float()
    cross = torch.bmm(a_old.transpose(1, 2), a_new)           # (B, W, w)
    new = torch.bmm(a_new.transpose(1, 2), a_new)             # (B, w, w)
    top = torch.cat([g.float(), cross], dim=2)
    bot = torch.cat([cross.transpose(1, 2), new], dim=2)
    return torch.cat([top, bot], dim=1)


def apply_G_batched(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """X̂_u = X̃_u G_u for a stack of users: x (U, n_max, m̃_max) zero-padded
    on both axes, g (U, m̃_max, m̂) zero-padded on rows. Padded columns of x
    only meet zero rows of g, so the real blocks are exact."""
    return torch.bmm(x.float(), g.float())


def solve_G_batched(a: torch.Tensor, z: torch.Tensor,
                    col_mask: Optional[torch.Tensor] = None,
                    ridge: float = 0.0) -> torch.Tensor:
    """Batched eq. (3): G_b = argmin ‖A_b G − Z‖_F by one batched QR solve.

    a (B, r, m_max) zero-padded anchors; z (r, m̂) shared or (B, r, m̂);
    col_mask (B, m_max) True on real columns. The system is augmented with
    diag(1 − mask) rows (plus ridge · max-colnorm on real columns), so padded
    rows of G come out exactly 0 and real rows are the least-squares
    solution. Exactly collinear real columns make the triangular factor
    singular at ridge=0; pass ridge > 0 for such inputs.
    """
    q, rr = solve_G_factor_batched(a, col_mask, ridge=ridge)
    return solve_G_from_factors(q, rr, z, col_mask)


def _mask_or_ones(col_mask, b: int, m_max: int, device) -> torch.Tensor:
    if col_mask is None:
        return torch.ones((b, m_max), dtype=torch.bool, device=device)
    return col_mask.to(device=device, dtype=torch.bool)


def solve_G_factor_batched(a: torch.Tensor,
                           col_mask: Optional[torch.Tensor] = None,
                           ridge: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor half of `solve_G_batched`: reduced QR of the augmented stack.
    Returns (q (B, r+m_max, m_max), rr (B, m_max, m_max)); independent of Z,
    so onboarding caches it."""
    a = a.float()
    b, _, m_max = a.shape
    maskf = _mask_or_ones(col_mask, b, m_max, a.device).float()
    scale = torch.sqrt(torch.amax(torch.sum(a * a, dim=1), dim=-1))  # (B,)
    diag = (1.0 - maskf) + maskf * (ridge * scale[:, None])
    aug = torch.diag_embed(diag)                              # (B, m, m)
    a_aug = torch.cat([a, aug], dim=1)
    return torch.linalg.qr(a_aug, mode="reduced")


def solve_G_from_factors(q: torch.Tensor, rr: torch.Tensor, z: torch.Tensor,
                         col_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Apply half of `solve_G_batched`: G = R⁻¹ Qᵀ [Z; 0] from cached
    factors. z: (r, m̂) shared or (B, r, m̂)."""
    b, _, m_max = rr.shape
    z = z.float()
    if z.dim() == 2:
        z = z[None].expand(b, *z.shape)
    maskf = _mask_or_ones(col_mask, b, m_max, rr.device).float()
    z_aug = torch.cat(
        [z, torch.zeros((b, m_max, z.shape[-1]), dtype=z.dtype,
                        device=z.device)], dim=1)
    rhs = torch.bmm(q.transpose(1, 2), z_aug)
    G = torch.linalg.solve_triangular(rr, rhs, upper=True)
    return G * maskf[:, :, None]
