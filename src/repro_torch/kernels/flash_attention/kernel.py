"""Python side of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention_wgmma.cu`` for bf16, ``csrc/flash_attention.cu``
for fp32).

``flash_attention_cuda`` is the counterpart of the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_pallas``: forward
attention over q (B, H, Sq, hd) and k, v (B, KV, Sk, hd) in one launch,
fp32 or bf16 in, q's dtype out, with GQA, causal / sliding-window masks,
``q_offset`` and the tanh softcap. Two routes, by dtype:

- bf16: the Hopper kernel (``flash_attention_fwd_bf16_wgmma``): both
  products on the tensor cores with wgmma, K/V staged by TMA.
- fp32: ``flash_attention_fwd``, both products on the tensor cores in
  3xTF32 (mma.sync), K/V staged by cp.async; it holds the reference's 2e-5
  fp32 bar, which plain TF32 cannot. ``flash_3xtf32`` is its arithmetic in
  plain torch, for the CPU tests.

Both read q, k, v through their strides in 16-byte pieces, so the model
layout (B, S, H, hd) reaches them as a transposed view with no copy; a view
they cannot address (a base that is not 16-byte aligned, a stride that is
not a positive multiple of 16 bytes) is copied first (``tma_strides``).

Ragged Sq and Sk are masked in the kernels (no divisibility rule). The
output takes q's layout. It takes CUDA tensors only; ``ops.flash_attention``
sends CPU tensors to ``ref.py``.

``route_launches`` counts each route's launches in this process and
``launches()`` their sum, so a run can show that its main path went
through the kernel it expects.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.tf32 import tf32_trunc

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"
WGMMA_SOURCE = _CSRC / "flash_attention_wgmma.cu"
HEAD_DIMS = (64, 128, 256)
BF16_ROUTE, F32_ROUTE = "bf16_wgmma", "f32_3xtf32"
_ENTRY = {BF16_ROUTE: (WGMMA_SOURCE, "flash_attention_fwd_bf16_wgmma"),
          F32_ROUTE: (SOURCE, "flash_attention_fwd")}

# the wgmma kernel's tiles (flash_attention_wgmma.cu): a block owns BQ query
# rows, two warpgroups of WG_ROWS each, and walks key tiles of BK[hd] keys
BQ, WG_ROWS = 128, 64
BK = {64: 128, 128: 128, 256: 64}
# the fp32 kernel's tiles (flash_attention.cu): a block owns F32_BQ query
# rows, a row group (one warp; two at hd 256) F32_WARP_ROWS of them, and
# walks key tiles of F32_BK[hd] keys
F32_BQ, F32_WARP_ROWS = 64, 16
F32_BK = {64: 64, 128: 32, 256: 32}
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


def bind(lib: ctypes.CDLL, route: str):
    """The C entry point of `route` in `lib` with its argument types. Both
    take (q, k, v, o, B, H, KV, Sq, Sk, hd, strides, causal, window,
    softcap, q_offset, stream)."""
    fn = getattr(lib, _ENTRY[route][1])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_longlong), i, i,
                   ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def _entry(route: str):
    """The C entry point of `route`, built and bound once per process."""
    fn = _fns.get(route)
    if fn is None:
        fn = _fns[route] = bind(load_library(_ENTRY[route][0]), route)
    return fn


def tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The (b, h, s) element strides the kernels' 16-byte loads take for
    the 4-D view `t` (hd contiguous): the bf16 kernel's TMA maps, the fp32
    kernel's cp.async. None when they cannot read the view as it lies and
    the wrapper must copy it: a base that is not 16-byte aligned, or a
    stride of a dimension longer than 1 that is not a positive multiple of
    16 bytes (8 bf16 or 4 fp32 elements). A dimension of size 1 is never
    stepped over, so an illegal stride there is replaced by the view's
    extent."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    sizes, strides = t.shape[:3], list(t.stride()[:3])
    unit = 16 // t.element_size()
    legal = lambda s: 0 < s < 2 ** 39 and s % unit == 0
    if not all(legal(s) for n, s in zip(sizes, strides) if n > 1):
        return None
    extent = max([t.shape[-1]] + [n * s for n, s in zip(sizes, strides)
                                  if n > 1])
    extent = -(-extent // unit) * unit
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
    warpgroup classifies them at bq = WG_ROWS. flash_attention.cu (fp32)
    computes the same at its own tiles: blocks of F32_BQ rows, row groups
    of F32_WARP_ROWS, key tiles of F32_BK[hd]."""
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


def _split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """flash_attention.cu's operand split as the tensor cores read it: hi =
    x with its low 13 bits cleared, lo = x - hi (exact), itself read as
    TF32 (its low 13 bits dropped)."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """a @ b in 3xTF32 as (hi·hi', lo·hi' + hi·lo'), each product of two
    TF32 values exact in fp32; the sums in torch's order, not the mma's."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh, al @ bh + ah @ bl


def flash_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0, softcap: float = 0.0,
                 q_offset: int = 0) -> torch.Tensor:
    """flash_attention.cu's arithmetic in plain torch, for the CPU tests:
    q (B, H, Sq, hd), k/v (B, KV, Sk, hd) -> (B, H, Sq, hd) fp32. Key tiles
    of F32_BK[hd]; per tile S = hi·hi' + (lo·hi' + hi·lo') in 3xTF32, the
    softcap, the mask, the online softmax in the log2 domain (m, l, alpha),
    P split the same way and O = O·alpha + P·V from a zero tile; o = O / l,
    0 where l = 0. It visits every tile (the kernel skips those its rows
    cannot see: there alpha is 1 and P is 0)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    bk = F32_BK[hd]
    qg = q.float().reshape(B, KV, H // KV, Sq, hd)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    log2e = 1.4426950408889634
    scale = 1.0 / math.sqrt(hd)
    cs = 1.0 if softcap > 0 else scale * log2e
    dev = q.device
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    m = torch.full((B, KV, H // KV, Sq, 1), -math.inf, device=dev)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qg)
    for k0 in range(0, Sk, bk):
        kt, vt = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
        big, cross = _mm3(qg, kt.transpose(-1, -2))
        x = big + cross
        if softcap > 0:
            x = softcap * log2e * torch.tanh(x * (scale / softcap))
        kpos = torch.arange(k0, k0 + kt.shape[-2], device=dev)[None, :]
        ok = torch.ones((Sq, kt.shape[-2]), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        x = torch.where(ok, x, -math.inf)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        sub = torch.where(mx == -math.inf, 0.0, mx * cs)
        alpha = torch.exp2(m * cs - sub)
        p = torch.exp2(x * cs - sub)
        l = l * alpha + p.sum(-1, keepdim=True)
        big, cross = _mm3(p, vt)
        o = o * alpha + (big + cross)
        m = mx
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return out.reshape(B, H, Sq, hd)


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
    checks, the route by dtype, the copies the 16-byte loads need, the
    output, the C call. It takes the tensors' device as given (the tests drive it on the
    CPU with the C entry points replaced)."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    route = BF16_ROUTE if q.dtype == torch.bfloat16 else F32_ROUTE
    qkv, in_strides = [], []
    for t in (q, k, v):
        st = tma_strides(t)
        if st is None:                  # an explicit copy, never a view
            t = t.clone(memory_format=torch.contiguous_format)
            st = tma_strides(t)
        qkv.append(t)
        in_strides.append(st)
    q, k, v = qkv
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
