"""Plain PyTorch fused-attention oracle (GQA + causal + sliding window +
logit softcap): what the CPU runs, and the version the CUDA kernel is held
against on the card. Layout: q (B, H, Sq, hd); k/v (B, KV, Sk, hd).

It materializes the fp32 logits. Where the reference's two versions differ
it follows the Pallas kernel: the inputs are taken to fp32 before both
products (the kernel's ``astype(float32)``), and a row that sees no key
gives 0 (the kernel's l == 0 guard; ``mha_reference`` would average v).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  q_offset: int = 0) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, Sq, hd)
    logits = torch.einsum("bhgqk,bhsk->bhgqs", qg, k.float())
    logits = logits / math.sqrt(hd)
    if softcap and softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window and window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1) * mask.any(-1, keepdim=True)
    ctx = torch.einsum("bhgqs,bhsk->bhgqk", probs, v.float())
    return ctx.reshape(B, H, Sq, hd).to(q.dtype)
