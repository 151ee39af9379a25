"""Python side of the hand-written CUDA Gram kernel (``csrc/gram.cu``).

``gram_batched_cuda`` is the counterpart of the TPU kernel
``repro.kernels.gram.kernel.gram_batched_pallas``: (B, r, m) -> stacked
AᵦᵀAᵦ (B, m, m) fp32 in one launch, on the tensor cores in 3xTF32, upper
triangle tiles only, r split over a thread-block cluster; ragged edges are
masked inside the kernel (no padded copy). It takes CUDA tensors only;
``ops.gram_batched`` sends CPU tensors to the plain version in ``ref.py``.

``plan`` is the launch's shape, chosen on the host from (B, r, m) and
mirrored in pure Python so the CPU tests can check it: which tiles run,
how r is split, the cluster size. ``gram_3xtf32`` is the kernel's
arithmetic in plain torch, for those tests (``tf32_round``, from the
port's shared ``kernels/tf32.py``, is its operand split).

``launches`` counts the kernel's launches in this process, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.tf32 import tf32_round

SOURCE = Path(__file__).resolve().parent / "csrc" / "gram.cu"

# must match gram.cu
TILE = 64             # output tile edge
BK = 64               # rows of a per staged panel
MAX_SPLIT = 8         # cluster size: the portable limit
H100_SMS = 132

launches = 0
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


@dataclass(frozen=True)
class Plan:
    """One launch: `tiles` upper-triangle tiles (I <= J) of TILE x TILE per
    batch, each reduced by `split` blocks (one cluster) over the slices of
    r; `vec` floats per cp.async when the pointer allows it."""
    nt: int                 # tiles along m
    tiles: int              # nt (nt + 1) / 2
    split: int              # r slices per tile == cluster size
    vec: int                # 4, 2 or 1: the largest dividing m
    blocks: int             # split * tiles * B


@functools.lru_cache(maxsize=256)
def plan(B: int, r: int, m: int, sms: int = H100_SMS) -> Plan:
    """Split r until the blocks reach 1.5 per SM (two fit one SM), at most
    MAX_SPLIT ways and at least one panel a slice."""
    nt = -(-m // TILE)
    tiles = nt * (nt + 1) // 2
    panels = -(-r // BK)
    want = -(-3 * sms // (2 * max(tiles * B, 1)))
    split = max(1, min(MAX_SPLIT, want, panels))
    vec = 4 if m % 4 == 0 else 2 if m % 2 == 0 else 1
    return Plan(nt=nt, tiles=tiles, split=split, vec=vec,
                blocks=split * tiles * B)


def triangle_tile(t: int, nt: int) -> Tuple[int, int]:
    """Linear tile index -> (I, J), I <= J, row-major: the kernel's decode."""
    i = 0
    while t >= nt - i:
        t -= nt - i
        i += 1
    return i, i + t


def slices(r: int, split: int) -> List[Tuple[int, int]]:
    """The rows [start, stop) of a that each of `split` blocks reduces:
    whole panels of BK rows, the last cut at r (the kernel's bounds)."""
    nk = -(-r // BK)
    return [(min(q * nk // split * BK, r), min((q + 1) * nk // split * BK, r))
            for q in range(split)]


def gram_3xtf32(a: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: each operand split into
    TF32 hi and lo, lo·hi' + hi·lo' + hi·hi' summed in fp32 (each product
    of two TF32 values is exact in fp32), the upper triangle mirrored.
    a: (B, r, m) -> (B, m, m) fp32. Its summation order is torch's, not
    the kernel's."""
    a = a.float()
    hi = tf32_round(a)
    lo = tf32_round(a - hi)
    hit = hi.transpose(1, 2)
    g = (lo.transpose(1, 2) @ hi + hit @ lo) + hit @ hi
    upper = torch.triu(g)
    return upper + torch.triu(g, diagonal=1).transpose(1, 2)


def _gram_fn():
    """The C entry point, built and bound once per process: binding it on
    every call cost more host time than the kernel itself takes."""
    global _fn
    if _fn is None:
        fn = load_library(SOURCE).gram_batched_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


_sms = {}


def _sm_count(idx: int) -> int:
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def gram_batched_cuda(a: torch.Tensor) -> torch.Tensor:
    """a: (B, r, m) CUDA tensor of any float type -> (B, m, m) fp32.

    The fit makes its calls one at a time, and at its shapes a call's
    host path costs about as much as the kernel: so the path below builds
    no Python stream or device object and does not copy an fp32
    contiguous input."""
    global launches
    if not a.is_cuda:
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
    if a.dtype != torch.float32:         # the Pallas kernel casts in-kernel
        a = a.float()
    if not a.is_contiguous():
        a = a.contiguous()
    out = a.new_empty((b, m, m))
    idx = a.get_device()
    p = plan(b, r, m, _sm_count(idx))
    ptr = a.data_ptr()
    vec = p.vec
    while ptr % (4 * vec):               # a view may start off 16 bytes
        vec //= 2
    fn = _gram_fn()
    # the current stream's handle, as an int, without a Stream object
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch._C._cuda_getDevice():
        rc = fn(ptr, out.data_ptr(), b, r, m, p.split, vec, stream)
    else:
        with torch.cuda.device(idx):
            rc = fn(ptr, out.data_ptr(), b, r, m, p.split, vec, stream)
    if rc != 0:
        raise RuntimeError(f"gram_batched_f32 launch failed: CUDA error {rc}")
    launches += 1
    return out
