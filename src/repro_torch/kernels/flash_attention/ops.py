"""Public fused-attention entry point, model layout (B, S, H, hd).

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``: the
same name, arguments and layout. backend="auto" dispatches on the tensors'
device: CUDA -> the hand-written kernel (``kernel.flash_attention_cuda``,
which raises rather than fall back), CPU -> the plain version
(``ref.mha_reference``). backend="ref" forces the plain version, to hold
the kernel against it. The layout swap is a view on both routes.
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
        out = flash_attention_cuda(qh, kh, vh, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    return out.transpose(1, 2)
