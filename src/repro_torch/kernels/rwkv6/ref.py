"""Plain PyTorch WKV6 recurrence (RWKV-6 "Finch" time mix): what the CPU
runs, the model's path with ``use_kernels=False``, and the versions the
CUDA kernels (``csrc/wkv6.cu`` forward, ``csrc/wkv6_bwd.cu`` gradient) are
held against on the card. Counterpart of ``repro.kernels.rwkv6.ref``;
``wkv6_grad`` has none there (the reference takes ``jax.grad`` of
``wkv6_chunked``).

Recurrence (per batch, head; K = key dim, V = value dim):

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(log_w_t) in (0, 1)

``wkv6_scan`` is the exact sequential oracle. ``wkv6_chunked`` is the
chunked form used for training; within a chunk it factors the pairwise
decay exp(cs_t - c_i) into (r ⊙ e^{cs}) @ (k ⊙ e^{-c})^T.

Stability note: e^{-c_i} grows with per-step decay × chunk length. The model
clips log_w >= -e^{1.6} ~= -4.95 and we use chunk <= 16, bounding |c| <= 79.2
so every intermediate stays inside fp32 range (max ~3.4e38; worst-case
masked upper-triangle partials sum to ~1e37). The chunked result is EXACT
(the factoring is algebra, not approximation) within that domain.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_CHUNK = 16


def wkv6_scan(r, k, v, log_w, u):
    """Exact oracle. r/k/log_w: (B, S, H, K); v: (B, S, H, V); u: (H, K).
    Returns fp32 (B, S, H, V)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, lw = (t.float() for t in (r, k, v, log_w))
    uf = u.float()
    state = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf[None, :, :, None] * kv))
        state = torch.exp(lw[:, t])[..., None] * state + kv
    return torch.stack(outs, dim=1)                              # (B,S,H,V)


def wkv6_chunked(r, k, v, log_w, u, *, chunk: int = 16,
                 return_state: bool = False, shard: str = "k"):
    """Chunked exact WKV6. Same shapes as wkv6_scan; fp32 output.
    With return_state, also returns the final recurrent state (B, H, K, V).

    ``shard`` names the reference's mesh placement of the chunk tensors; the
    port runs on one card and ignores it. A ragged S is padded to a chunk
    multiple with r = k = v = 0 and log_w = 0 (w = 1): outputs at padded
    positions are dropped and the state passes through them unchanged.
    """
    from repro_torch.models.layers import _prev_states

    B, S0, H, K = r.shape
    V = v.shape[-1]
    L = min(chunk, MAX_CHUNK, S0)
    pad = (-S0) % L
    if pad:
        zpad = lambda t: F.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v, log_w = zpad(r), zpad(k), zpad(v), zpad(log_w)
    S = S0 + pad
    nc = S // L

    def fold(t, last):
        # (B,S,H,X) -> (B*H, nc, L, X)
        return (t.float().reshape(B, nc, L, H, last)
                .permute(0, 3, 1, 2, 4).reshape(B * H, nc, L, last))

    rf, kf, lw = fold(r, K), fold(k, K), fold(log_w, K)
    vf = fold(v, V)
    uf = u.float().repeat(B, 1)                                 # (B*H, K)

    c = torch.cumsum(lw, dim=2)                                 # inclusive
    cs = c - lw                                                 # exclusive
    r_t = rf * torch.exp(cs)
    k_t = kf * torch.exp(-c)

    A = torch.einsum("gntk,gnik->gnti", r_t, k_t)               # (BH,nc,L,L)
    strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=A.device), diagonal=-1)
    A = torch.where(strict, A, torch.zeros((), dtype=A.dtype,
                                           device=A.device))
    diag = torch.einsum("gntk,gk->gnt", rf * kf, uf)
    y_intra = (torch.einsum("gnti,gniv->gntv", A, vf)
               + diag[..., None] * vf)

    # chunk-final state contribution: sum_i (k_i e^{c_L - c_i}) v_i^T
    k_end = kf * torch.exp(c[:, :, -1:, :] - c)
    contrib = torch.einsum("gnik,gniv->gnkv", k_end, vf)        # (BH,nc,K,V)
    chunk_decay = torch.exp(c[:, :, -1, :])                     # (BH,nc,K)

    prev, final_state = _prev_states(chunk_decay, contrib, extra_dims=1)
    y_inter = torch.einsum("gntk,gnkv->gntv", r_t, prev)

    y = y_intra + y_inter                                       # (BH,nc,L,V)
    out = (y.reshape(B, H, nc, L, V).permute(0, 2, 3, 1, 4)
           .reshape(B, S, H, V))[:, :S0]
    if return_state:
        # the padded tail has k = 0 and unit decay, so the state after the
        # last padded position is the state after the true last token
        return out, final_state.reshape(B, H, K, V)
    return out


def wkv6_grad(r, k, v, log_w, u, dO):
    """The gradient of ``wkv6_scan``'s output against the cotangent dO, in
    closed form: (dr, dk, dv, dlog_w, du), fp32, shaped as the inputs. The
    plain version of the backward kernel (``csrc/wkv6_bwd.cu``).

    Per batch and head, with S_{t-1} the state before step t, w = e^{log_w}
    and G_t = dL/dS_t, carried back from G_{S-1} = 0:

        G_{t-1}  = diag(w_t) G_t + r_t dO_t^T
        dr_t     = S_{t-1} dO_t + u ⊙ k_t (v_t · dO_t)
        dk_t     = G_t v_t      + u ⊙ r_t (v_t · dO_t)
        dv_t     = G_t^T k_t    + (Σ_k r_t u k_t) dO_t
        du       = Σ_{b,t} r_t ⊙ k_t (v_t · dO_t)
        dlog_w_t = Σ_{s>t} r_s ⊙ dr°_s − Σ_{s≥t} k_s ⊙ dk°_s

    where dr°_s = S_{s-1} dO_s and dk°_s = G_s v_s are the terms without u.
    The last line holds because a_t = Σ_v G_t ⊙ S_t obeys a_{t-1} = a_t +
    r_t ⊙ dr°_t − k_t ⊙ dk°_t (a_{S-1} = 0), and dlog_w_t = Σ_v G_t ⊙ (w_t ⊙
    S_{t-1}) = a_t − k_t ⊙ dk°_t. Summed over the whole sequence in fp32
    that recurrence cancels (its terms are large where a is small, at early
    steps, and its error grows with the sequence), so a is formed directly
    every MAX_CHUNK steps from the state saved there, and carried back only
    in between. One step at a time, forward for dr° and the saved
    states, backward for G.
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, lw, do = (t.float() for t in (r, k, v, log_w, dO))
    uf = u.float()
    w = torch.exp(lw)
    state = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    dr0 = torch.empty_like(rf)
    saved = {}                                   # S_t at the anchors
    for t in range(S):
        dr0[:, t] = torch.einsum("bhkv,bhv->bhk", state, do[:, t])
        state = (w[:, t, :, :, None] * state
                 + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        if t % MAX_CHUNK == MAX_CHUNK - 1 and t < S - 1:
            saved[t] = state
    G = torch.zeros_like(state)
    dk0 = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    dlog_w = torch.empty_like(lw)
    a = torch.zeros_like(rf[:, 0])                                # a_{S-1}
    for t in range(S - 1, -1, -1):
        dk0[:, t] = torch.einsum("bhkv,bhv->bhk", G, vf[:, t])
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", G, kf[:, t])
        if t in saved:
            a = (G * saved.pop(t)).sum(-1)
        elif t < S - 1:
            a = a + rf[:, t + 1] * dr0[:, t + 1] - kf[:, t + 1] * dk0[:, t + 1]
        dlog_w[:, t] = a - kf[:, t] * dk0[:, t]
        G = (w[:, t, :, :, None] * G
             + rf[:, t, :, :, None] * do[:, t, :, None, :])
    vdo = (vf * do).sum(-1, keepdim=True)                       # (B,S,H,1)
    dr = dr0 + uf * kf * vdo
    dk = dk0 + uf * rf * vdo
    dv = dv + (rf * uf * kf).sum(-1, keepdim=True) * do
    du = (rf * kf * vdo).sum((0, 1))
    return dr, dk, dv, dlog_w, du
