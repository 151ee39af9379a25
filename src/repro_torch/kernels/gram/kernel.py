"""Python side of the hand-written CUDA Gram kernel (``csrc/gram.cu``).

``gram_batched_cuda`` is the counterpart of the TPU kernel
``repro.kernels.gram.kernel.gram_batched_pallas``: (B, r, m) -> stacked
AᵦᵀAᵦ (B, m, m) fp32 in one launch, ragged edges masked inside the kernel
(no padded copy). It takes CUDA tensors only; ``ops.gram_batched`` sends
CPU tensors to the plain version in ``ref.py``.

``launches`` counts the kernel's launches in this process, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "gram.cu"

launches = 0
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _gram_fn():
    """The C entry point, built and bound once per process: binding it on
    every call cost more host time than the kernel itself takes."""
    global _fn
    if _fn is None:
        fn = load_library(SOURCE).gram_batched_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gram_batched_cuda(a: torch.Tensor) -> torch.Tensor:
    """a: (B, r, m) CUDA tensor of any float type -> (B, m, m) fp32."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"gram_batched_cuda takes a CUDA tensor, got one on "
                         f"{a.device}")
    if a.dim() != 3:
        raise ValueError(f"expected a (B, r, m) stack, got shape "
                         f"{tuple(a.shape)}")
    if not a.is_floating_point():
        raise TypeError(f"expected a float tensor, got {a.dtype}")
    b, r, m = a.shape
    if b == 0 or m == 0:
        return torch.zeros((b, m, m), dtype=torch.float32, device=a.device)
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    a = a.float().contiguous()           # the Pallas kernel casts in-kernel
    out = torch.empty((b, m, m), dtype=torch.float32, device=a.device)
    fn = _gram_fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), out.data_ptr(), b, r, m, stream)
    if rc != 0:
        raise RuntimeError(f"gram_batched_f32 launch failed: CUDA error {rc}")
    launches += 1
    return out
