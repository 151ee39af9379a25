"""Python side of the hand-written CUDA WKV6 kernels: the forward
(``csrc/wkv6.cu``) and its gradient (``csrc/wkv6_bwd.cu``), both on the
chunked form with the state carried inside the block
(``csrc/wkv6_common.cuh``).

``wkv6_cuda`` is the counterpart of the TPU kernel
``repro.kernels.rwkv6.kernel.wkv6_pallas``: the WKV6 recurrence over the
whole sequence in one launch. ``wkv6_grad_cuda`` is the gradient of the
same function in one call of two kernels; the reference has no such
kernel (it takes ``jax.grad`` of its plain chunked form), and
``ref.wkv6_grad`` is its plain version. Both take the model layout (B, S, H, K) through strides (the last
dim contiguous), so the (B·H, S, K) fold of the reference's wrapper is
never copied, fp32 in and out, K and V up to 64, and a whole number of
chunks of L = min(chunk, S) <= 16 steps. They take CUDA tensors only;
``ops.wkv6`` sends CPU tensors to the plain versions in ``ref.py``.

``launches`` and ``grad_launches`` count the calls of the two entry points
in this process (a gradient call launches two kernels, the key blocks' and
then the value blocks'), so a run can show that its main path went through
them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "wkv6.cu"
BWD_SOURCE = CSRC / "wkv6_bwd.cu"
MAX_KV = 64
MAX_CHUNK = 16
SLICE = 16             # rows of the carried (K, V) matrix a block owns
STATE_FLOATS = 1024    # floats of one block's chunk-start state (SLICE x 64)

launches = 0
grad_launches = 0
_fns = {}


def reset_launches() -> None:
    global launches, grad_launches
    launches = grad_launches = 0


def bind(lib: ctypes.CDLL, name: str, n_ptrs: int):
    """The C entry point `name` of `lib` with its argument types: n_ptrs
    pointers, then B, S, H, K, V, L, the strides, the stream."""
    fn = getattr(lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * n_ptrs + [i] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), p])
    fn.restype = ctypes.c_int
    return fn


def _entry(source: Path, name: str, n_ptrs: int):
    """The C entry point `name` of `source`, built and bound once per
    process."""
    if name not in _fns:
        _fns[name] = bind(load_library(source), name, n_ptrs)
    return _fns[name]


def _check(what: str, named, u: torch.Tensor, chunk: int):
    """Validate the (B, S, H, X) tensors `named` and u (H, K) for a kernel
    call; returns (B, S, H, K, V, L)."""
    tensors = (*named, ("u", u))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {name} in {t.dtype}")
    for name, t in tensors:
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous, got "
                             f"strides {t.stride()}")
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what} takes CUDA tensors, got {name} on "
                             f"{t.device}")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError(f"the inputs of {what} lie on different devices")
    r = named[0][1]
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D (B, S, H, K), got shape "
                         f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    V = named[2][1].shape[-1]
    want = {"r": (B, S, H, K), "k": (B, S, H, K), "log_w": (B, S, H, K),
            "v": (B, S, H, V), "dO": (B, S, H, V)}
    if (any(tuple(t.shape) != want[name] for name, t in named)
            or tuple(u.shape) != (H, K)):
        shapes = ", ".join(f"{name} {tuple(t.shape)}"
                           for name, t in tensors)
        raise ValueError(f"shapes {shapes} do not match (B, S, H, K/V) and "
                         f"(H, K)")
    if K > MAX_KV or V > MAX_KV:
        raise ValueError(f"key dim {K} / value dim {V}: the kernel takes up "
                         f"to {MAX_KV}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 to {MAX_CHUNK} "
                         f"steps a chunk (the fp32 domain of the chunked "
                         f"form, ref.py)")
    L = min(chunk, S) if S else 1
    if S % L:
        raise ValueError(f"seq {S} % chunk {L} != 0: the kernel takes a "
                         f"whole number of chunks, as wkv6_pallas does")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} / heads {H} exceed the kernel's grid "
                         f"limit 65535")
    return B, S, H, K, V, L


def _strides(tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def _launch(fn, name, *args):
    r = args[0]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(*(t.data_ptr() if isinstance(t, torch.Tensor) else t
                  for t in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: torch.Tensor, *,
              chunk: int = MAX_CHUNK) -> torch.Tensor:
    """r/k/log_w (B, S, H, K), v (B, S, H, V), u (H, K): fp32 CUDA tensors,
    any strides with the last dim contiguous -> fp32 (B, S, H, V)."""
    global launches
    named = (("r", r), ("k", k), ("v", v), ("log_w", log_w))
    B, S, H, K, V, L = _check("wkv6_cuda", named, u, chunk)
    u = u.contiguous()
    out = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out
    _launch(_entry(SOURCE, "wkv6_fwd_f32", 6), "wkv6_fwd_f32",
            r, k, v, log_w, u, out, B, S, H, K, V, L,
            _strides((r, k, v, log_w)))
    launches += 1
    return out


def wkv6_grad_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: torch.Tensor, dO: torch.Tensor, *,
                   chunk: int = MAX_CHUNK):
    """The gradient of ``wkv6_cuda``'s output against the cotangent dO (B,
    S, H, V): (dr, dk, dv, dlog_w, du), fp32, shaped as the inputs. Same
    tensors as ``wkv6_cuda``. One call of the entry, two kernels; du's
    per-batch shares are summed here. The kernels recompute the states:
    their scratch holds each chunk's starting state,
    B·H·ceil(K/16)·(S/L)·4 KiB, for the call only."""
    global grad_launches
    named = (("r", r), ("k", k), ("v", v), ("log_w", log_w), ("dO", dO))
    B, S, H, K, V, L = _check("wkv6_grad_cuda", named, u, chunk)
    u = u.contiguous()
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dlog_w = (torch.empty((B, S, H, K), **f32) for _ in range(3))
    dv = torch.empty((B, S, H, V), **f32)
    if dr.numel() == 0 or dv.numel() == 0:
        return (dr.zero_(), dk.zero_(), dv.zero_(), dlog_w.zero_(),
                torch.zeros((H, K), **f32))
    dup = torch.empty((B, H, K), **f32)
    nks = -(-K // SLICE)
    states = torch.empty((B * H * nks * (S // L) * STATE_FLOATS,), **f32)
    _launch(_entry(BWD_SOURCE, "wkv6_bwd_f32", 12), "wkv6_bwd_f32",
            r, k, v, log_w, u, dO, dr, dk, dv, dlog_w, dup, states,
            B, S, H, K, V, L, _strides((r, k, v, log_w, dO)))
    grad_launches += 1
    return dr, dk, dv, dlog_w, dup.sum(0)
