"""Python side of the hand-written CUDA WKV6 kernel (``csrc/wkv6.cu``).

``wkv6_cuda`` is the counterpart of the TPU kernel
``repro.kernels.rwkv6.kernel.wkv6_pallas``: the WKV6 recurrence over the
whole sequence in one launch, one block per (batch, head). It takes the
model layout (B, S, H, K) through strides (the last dim contiguous), so the
(B·H, S, K) fold of the reference's wrapper is never copied, and returns
fp32 (B, S, H, V). fp32 in, K and V up to 64. It takes CUDA tensors only;
``ops.wkv6`` sends CPU tensors to the plain versions in ``ref.py``.

``launches`` counts the kernel's launches in this process, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
MAX_KV = 64

launches = 0
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def _wkv6_fn():
    """The C entry point, built and bound once per process."""
    global _fn
    if _fn is None:
        fn = load_library(SOURCE).wkv6_fwd_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/log_w (B, S, H, K), v (B, S, H, V), u (H, K): fp32 CUDA tensors,
    any strides with the last dim contiguous -> fp32 (B, S, H, V)."""
    global launches
    named = (("r", r), ("k", k), ("v", v), ("log_w", log_w), ("u", u))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6_cuda takes CUDA tensors, got {name} on "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6_cuda takes float32, got {name} in "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous, got "
                             f"strides {t.stride()}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("r, k, v, log_w and u lie on different devices")
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D (B, S, H, K), got shape "
                         f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    if (k.shape != r.shape or log_w.shape != r.shape
            or v.shape != (B, S, H, V) or u.shape != (H, K)):
        raise ValueError(
            f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, log_w {tuple(log_w.shape)}, u "
            f"{tuple(u.shape)} do not match (B, S, H, K/V) and (H, K)")
    if K > MAX_KV or V > MAX_KV:
        raise ValueError(f"key dim {K} / value dim {V}: the kernel takes up "
                         f"to {MAX_KV}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    u = u.contiguous()
    out = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, log_w, out) for s in t.stride()[:3]))
    fn = _wkv6_fn()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                u.data_ptr(), out.data_ptr(), B, S, H, K, V, strides, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd_f32 launch failed: CUDA error {rc}")
    launches += 1
    return out
