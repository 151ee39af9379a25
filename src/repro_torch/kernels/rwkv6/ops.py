"""Public WKV6 entry point, model layout (B, S, H, K): backend dispatch.

Counterpart of ``repro.kernels.rwkv6.ops.wkv6``: the same name, arguments
and layout. backend="auto" dispatches on the tensors' device: CUDA -> the
hand-written kernel through ``WKV6Function`` (which raises rather than fall
back), CPU -> the chunked plain form (``ref.wkv6_chunked``), as the
reference's "auto" takes its chunked form off the TPU. "chunked" and "scan"
force the plain versions, to hold the kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda

_BACKENDS = ("auto", "chunked", "scan")
BACKWARD_RANGE = "wkv6_backward_recompute"


class WKV6Function(torch.autograd.Function):
    """The kernel in the forward pass; the gradient of the plain chunked
    form in the backward.

    The reference has no backward kernel for WKV6 (its ``wkv6_pallas`` has
    no ``custom_vjp``, and ``jax.grad`` through it fails), so the backward
    recomputes ``ref.wkv6_chunked`` from the saved fp32 inputs under
    autograd and returns its gradients: the same function, differentiated
    exactly. A hand-written backward kernel is listed in ROADMAP.md,
    Queue 2.
    """

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, log_w, u)
        return wkv6_cuda(r, k, v, log_w, u)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        # the range names this work in a profiler trace; free when off
        with torch.enable_grad(), \
                torch.profiler.record_function(BACKWARD_RANGE):
            out = ref.wkv6_chunked(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
         backend: str = "auto") -> torch.Tensor:
    """r/k/log_w: (B, S, H, K); v: (B, S, H, V); u: (H, K) -> (B, S, H, V)
    fp32. On the kernel route S must be a multiple of min(chunk, S), as the
    reference's ``wkv6_pallas`` asserts."""
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
