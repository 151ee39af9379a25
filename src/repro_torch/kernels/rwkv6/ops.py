"""Public WKV6 entry point, model layout (B, S, H, K): backend dispatch.

Counterpart of ``repro.kernels.rwkv6.ops.wkv6``: the same name, arguments
and layout. backend="auto" dispatches on the tensors' device: CUDA -> the
hand-written kernels through ``WKV6Function`` (forward and gradient; each
raises rather than fall back), CPU -> the chunked plain form
(``ref.wkv6_chunked``), as the reference's "auto" takes its chunked form off
the TPU. "chunked" and "scan" force the plain versions, to hold the kernels
against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda, wkv6_grad_cuda

_BACKENDS = ("auto", "chunked", "scan")


class WKV6Function(torch.autograd.Function):
    """The forward kernel in the forward pass, the gradient kernels in the
    backward: one call each (the gradient's launches its two kernels).

    The reference has no backward kernel for WKV6 (its ``wkv6_pallas`` has
    no ``custom_vjp``, and ``jax.grad`` through it fails; it trains on the
    plain chunked form). ``wkv6_grad_cuda`` computes the gradient of the
    same function from the saved fp32 inputs, recomputing the states
    (``ref.wkv6_grad`` is its plain version).
    """

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, log_w, u)
        return wkv6_cuda(r, k, v, log_w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_out):
        if grad_out.stride(-1) != 1:
            grad_out = grad_out.contiguous()
        grads = wkv6_grad_cuda(*ctx.saved_tensors, grad_out, chunk=ctx.chunk)
        return (*grads, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
         backend: str = "auto") -> torch.Tensor:
    """r/k/log_w: (B, S, H, K); v: (B, S, H, V); u: (H, K) -> (B, S, H, V)
    fp32. On the kernel route S must be a multiple of min(chunk, S), as the
    reference's ``wkv6_pallas`` asserts, and chunk at most 16."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown wkv6 backend {backend!r}; choose from "
                         f"{_BACKENDS}")
    if backend == "scan":
        return ref.wkv6_scan(r, k, v, log_w, u)
    if backend == "chunked" or r.device.type == "cpu":
        return ref.wkv6_chunked(r, k, v, log_w, u, chunk=chunk)
    S = r.shape[1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} % chunk {L} != 0: the kernel route takes "
                         f"a whole number of chunks, as wkv6_pallas does")
    return WKV6Function.apply(*(t.float() for t in (r, k, v, log_w, u)),
                              chunk)
