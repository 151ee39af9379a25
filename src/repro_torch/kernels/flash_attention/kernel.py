"""Python side of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

``flash_attention_cuda`` is the counterpart of the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_pallas``: forward
attention over q (B, H, Sq, hd) and k, v (B, KV, Sk, hd) in one launch,
fp32 or bf16 in, q's dtype out, with GQA, causal / sliding-window masks,
``q_offset`` and the tanh softcap. The kernel reads its inputs through
their strides (hd contiguous), so the model layout (B, S, H, hd) reaches it
as a transposed view with no copy, and the output takes q's layout. Ragged
Sq and Sk are masked in the kernel (no divisibility rule). It takes CUDA
tensors only; ``ops.flash_attention`` sends CPU tensors to ``ref.py``.

``launches`` counts the kernel's launches in this process, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _flash_fn():
    """The C entry point, built and bound once per process."""
    global _fn
    if _fn is None:
        fn = load_library(SOURCE).flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0
                         ) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Sk, hd) CUDA tensors, any strides with
    hd contiguous -> (B, H, Sq, hd) in q's dtype and q's memory layout."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda takes CUDA tensors, got "
                             f"{name} on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, heads, S, hd), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, KV, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the grid limit 65535")
    q, k, v = (_rows_contiguous(t) for t in (q, k, v))
    out = torch.empty_like(q)       # q's layout: the model's when q is a view
    if B == 0 or Sq == 0:
        return out
    if Sk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _flash_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, strides,
                int(bool(causal)), int(window), float(softcap), int(q_offset),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out
