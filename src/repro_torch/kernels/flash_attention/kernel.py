"""Python side of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention_wgmma.cu`` for bf16, ``csrc/flash_attention.cu``
for fp32).

``flash_attention_cuda`` is the counterpart of the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_pallas``: forward
attention over q (B, H, Sq, hd) and k, v (B, KV, Sk, hd) in one launch,
fp32 or bf16 in, q's dtype out, with GQA, causal / sliding-window masks,
``q_offset`` and the tanh softcap. Two routes, by dtype:

- bf16: the Hopper kernel (``flash_attention_fwd_bf16_wgmma``): both
  products on the tensor cores with wgmma, K/V staged by TMA. TMA reads a
  view through its strides, so the model layout (B, S, H, hd) reaches it as
  a transposed view with no copy; a view TMA cannot address (a base that is
  not 16-byte aligned, a stride that is not a positive multiple of 8
  elements) is copied first (``tma_strides``).
- fp32: the SIMT kernel (``flash_attention_fwd``), fp32 FFMA, which holds
  the reference's 2e-5 fp32 bar (TF32 on the tensor cores cannot).

Ragged Sq and Sk are masked in the kernels (no divisibility rule). The
output takes q's layout. It takes CUDA tensors only; ``ops.flash_attention``
sends CPU tensors to ``ref.py``.

``route_launches`` counts each route's launches in this process and
``launches()`` their sum, so a run can show that its main path went
through the kernel it expects.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import load_library

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"
WGMMA_SOURCE = _CSRC / "flash_attention_wgmma.cu"
HEAD_DIMS = (64, 128, 256)
BF16_ROUTE, F32_ROUTE = "bf16_wgmma", "f32_simt"
_ENTRY = {BF16_ROUTE: (WGMMA_SOURCE, "flash_attention_fwd_bf16_wgmma"),
          F32_ROUTE: (SOURCE, "flash_attention_fwd")}

# the wgmma kernel's tiles (flash_attention_wgmma.cu): a block owns BQ query
# rows, two warpgroups of WG_ROWS each, and walks key tiles of BK[hd] keys
BQ, WG_ROWS = 128, 64
BK = {64: 128, 128: 128, 256: 64}
SKIP, FULL, MASKED = 0, 1, 2
# the bf16 entry point's own error codes, negative (CUDA's are positive)
_ENCODER_MISSING, _ENCODE_FAILED = -1, -1000

route_launches: Dict[str, int] = {BF16_ROUTE: 0, F32_ROUTE: 0}
_fns: Dict[str, object] = {}


def launches() -> int:
    """Launches of both kernels in this process."""
    return sum(route_launches.values())


def reset_launches() -> None:
    for r in route_launches:
        route_launches[r] = 0


def _entry(route: str):
    """The C entry point of `route`, built and bound once per process. Both
    take (q, k, v, o, B, H, KV, Sq, Sk, hd, strides, causal, window,
    softcap, q_offset, stream)."""
    fn = _fns.get(route)
    if fn is None:
        source, name = _ENTRY[route]
        fn = getattr(load_library(source), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fns[route] = fn
    return fn


def tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The (b, h, s) element strides the bf16 kernel's TMA maps take for the
    4-D view `t` (hd contiguous), or None when TMA cannot read the view as
    it lies and the wrapper must copy it: a base that is not 16-byte
    aligned, or a stride of a dimension longer than 1 that is not a
    positive multiple of 8 elements (16 bytes). A dimension of size 1 is
    never stepped over, so an illegal stride there is replaced by the
    view's extent."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    sizes, strides = t.shape[:3], list(t.stride()[:3])
    legal = lambda s: 0 < s < 2 ** 39 and s % 8 == 0
    if not all(legal(s) for n, s in zip(sizes, strides) if n > 1):
        return None
    extent = max([t.shape[-1]] + [n * s for n, s in zip(sizes, strides)
                                  if n > 1])
    extent = -(-extent // 8) * 8
    return tuple(s if n > 1 or legal(s) else extent
                 for n, s in zip(sizes, strides))


def tile_kinds(Sq: int, Sk: int, bq: int, bk: int, causal: bool,
               window: int, q_offset: int) -> np.ndarray:
    """(ceil(Sq / bq), ceil(Sk / bk)) labels of the (query-row block, key
    tile) pairs, as flash_attention_wgmma.cu's visible_keys and tile_kind
    compute them: SKIP (no pair visible: the tile is not loaded, or its
    products are skipped), FULL (every pair of a real row visible: no mask),
    MASKED (the mask applies). Rows past Sq are not real. A block loads the
    key tiles from its first non-SKIP one to its last at bq = BQ; each
    warpgroup classifies them at bq = WG_ROWS."""
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    out = np.full((nq, nk), SKIP, np.int8)
    for qt in range(nq):
        r_lo, r_hi = qt * bq, min(qt * bq + bq, Sq) - 1
        p_lo, p_hi = r_lo + q_offset, r_hi + q_offset
        lo = max(0, p_lo - window + 1) if window > 0 else 0
        hi = min(Sk - 1, p_hi) if causal else Sk - 1
        for kt in range(nk):
            k0, k1 = kt * bk, kt * bk + bk - 1
            if k1 < lo or k0 > hi:
                continue
            full = (k1 < Sk and (not causal or k1 <= p_lo)
                    and (window <= 0 or k0 > p_hi - window))
            out[qt, kt] = FULL if full else MASKED
    return out


def _rows_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, heads, S, hd), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16):
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


def launch_on_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     stream: int, *, causal: bool = True, window: int = 0,
                     softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """The host side of ``flash_attention_cuda`` on an explicit stream:
    checks, the route by dtype, the copies TMA needs, the output, the C
    call. It takes the tensors' device as given (the tests drive it on the
    CPU with the C entry points replaced)."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        route = BF16_ROUTE
        qkv, in_strides = [], []
        for t in (q, k, v):
            st = tma_strides(t)
            if st is None:                  # an explicit copy, never a view
                t = t.clone(memory_format=torch.contiguous_format)
                st = tma_strides(t)
            qkv.append(t)
            in_strides.append(st)
        q, k, v = qkv
    else:
        route = F32_ROUTE
        q, k, v = (_rows_contiguous(t) for t in (q, k, v))
        in_strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty_like(q)       # q's layout: the model's when q is a view
    if B == 0 or Sq == 0:
        return out
    if Sk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *(s for st in in_strides + [out.stride()[:3]] for s in st))
    rc = _entry(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, H, KV, Sq, Sk, hd, strides,
                       int(bool(causal)), int(window), float(softcap),
                       int(q_offset), stream)
    if rc == _ENCODER_MISSING:
        raise RuntimeError("flash_attention_fwd_bf16_wgmma: "
                           "cuTensorMapEncodeTiled is not available")
    if rc <= _ENCODE_FAILED:
        raise RuntimeError(f"flash_attention_fwd_bf16_wgmma: "
                           f"cuTensorMapEncodeTiled failed, CUresult "
                           f"{_ENCODE_FAILED - rc}")
    if rc != 0:
        raise RuntimeError(f"{_ENTRY[route][1]} launch failed: CUDA error "
                           f"{rc}")
    route_launches[route] += 1
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0
                         ) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Sk, hd) CUDA tensors, any strides with
    hd contiguous -> (B, H, Sq, hd) in q's dtype and q's memory layout."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda takes CUDA tensors, got "
                             f"{name} on {t.device}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return launch_on_stream(q, k, v, stream, causal=causal,
                                window=window, softcap=softcap,
                                q_offset=q_offset)
