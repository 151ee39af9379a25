"""Public fused-attention entry point, model layout (B, S, H, hd).

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``: the
same name, arguments and layout. backend="auto" dispatches on the tensors'
device: CUDA -> the hand-written kernel (``kernel.flash_attention_cuda``,
which raises rather than fall back), CPU -> the plain version
(``ref.mha_reference``). backend="ref" forces the plain version, to hold
the kernel against it. The layout swap is a view on both routes.

The kernel has no backward (nor has the reference's
``flash_attention_pallas``): on the CUDA route with autograd recording
through q, k or v, the call raises instead of returning an output without
a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

_BACKENDS = ("auto", "ref")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, backend: str = "auto") -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown flash_attention backend {backend!r}; "
                         f"choose from {_BACKENDS}")
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if backend == "ref" or q.device.type == "cpu":
        out = ref.mha_reference(qh, kh, vh, causal=causal, window=window,
                                softcap=softcap, q_offset=q_offset)
    else:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError(
                "flash_attention: the CUDA kernel has no backward (the "
                "reference's flash_attention_pallas has none either), so it "
                "cannot be differentiated; train with use_kernels=False. A "
                "backward kernel is listed in ROADMAP.md, Queue 2")
        out = flash_attention_cuda(qh, kh, vh, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    return out.transpose(1, 2)
