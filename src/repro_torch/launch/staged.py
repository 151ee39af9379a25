"""Staged collectives for ranks that share one card: each functional
collective on a CUDA tensor copies it to pinned host memory, runs the
collective on the group's gloo backend there, and copies the result back
(the counterpart of the reference's collectives over the mesh's
devices).

NCCL refuses two ranks on one GPU, and gloo does not take every
collective for CUDA tensors: on an H100 with torch 2.11 its
``all_gather_into_tensor`` ends the process (``chip_smoke.py``'s phase
``sharded_llm`` probes the four that DTensor uses). So in a rank started
with ``launch.mesh.run_ranks(..., backend="staged")`` the group is plain
gloo and `register` gives the ``_c10d_functional`` ops DTensor issues
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast``) kernels for the CUDA dispatch key
that stage through host memory into the same group's gloo collectives on
CPU tensors. ``moe_ep``'s exchange on plain tensors calls the same
kernels directly. On CPU-only ranks the kernels take the CPU key (CPU
tensors go to gloo as they are, nothing staged), so the CPU tests run
this code. The sharded engine's ``SiloComm`` keeps its own staging: its
pinned buffers belong to a plan, are reused every round and are zeroed
with the plan's other buffers (``release``). The collectives
complete before the op returns (``wait_tensor`` finds nothing to wait
for). A failure in gloo raises; nothing falls back to another program.

``STATS`` counts, since its last ``reset``: the calls of each kind, the
bytes staged device <-> pinned host, the bytes handed to gloo (this
rank's send buffers; also by kind) and the seconds in the collectives
(host clock from the moment the device has produced the input, copies
included).
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as dist

NAME = "staged"


class StagedStats:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {}
        self.bytes_by_kind = {}
        self.staged_bytes = 0
        self.wire_bytes = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls),
                "wire_bytes_by_kind": dict(self.bytes_by_kind),
                "staged_bytes": self.staged_bytes,
                "wire_bytes": self.wire_bytes, "seconds": self.seconds}


STATS = StagedStats()
_LIB: Optional[torch.library.Library] = None
_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _start(t: torch.Tensor) -> float:
    """The clock at a collective's start, once the device has produced
    `t`: the compute before it is not the collective's time."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return time.perf_counter()


def _host(t: torch.Tensor, *, written: bool = False) -> torch.Tensor:
    """`t` on the host for gloo: a CUDA tensor copied into pinned memory
    (counted); a CPU tensor as it is, contiguous, or a copy where the
    collective writes into its buffer (`written`)."""
    if not t.is_cuda:
        return t.clone(memory_format=torch.contiguous_format) if written \
            else t.contiguous()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STATS.staged_bytes += _nbytes(h)
    return h


def _empty_host(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, pin_memory=like.is_pinned())


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The host result `h` where `like` lies (copied back to the card,
    counted)."""
    if not like.is_cuda:
        return h
    STATS.staged_bytes += _nbytes(h)
    return h.to(like.device, copy=True)


def _count(kind: str, sent: int, t0: float) -> None:
    STATS.calls[kind] = STATS.calls.get(kind, 0) + 1
    STATS.bytes_by_kind[kind] = STATS.bytes_by_kind.get(kind, 0) + sent
    STATS.wire_bytes += sent
    STATS.seconds += time.perf_counter() - t0


def _reduce(h: torch.Tensor, reduce_op: str, pg) -> None:
    """All-reduce `h` in place over `pg` (gloo has no average: a sum,
    then the division)."""
    op = reduce_op.lower()
    dist.all_reduce(h, op=_OPS[op], group=pg)
    if op == "avg":
        h /= dist.get_world_size(pg)


def all_reduce(input: torch.Tensor, reduce_op: str, group_name: str):
    t0 = _start(input)
    h = _host(input, written=True)
    _reduce(h, reduce_op, _group(group_name))
    _count("all_reduce", _nbytes(h), t0)
    return _back(h, input)


def all_gather(input: torch.Tensor, group_size: int, group_name: str):
    t0 = _start(input)
    h = _host(input)
    out = _empty_host((group_size * h.shape[0],) + tuple(h.shape[1:]), h)
    dist.all_gather_into_tensor(out, h, group=_group(group_name))
    _count("all_gather", _nbytes(h), t0)
    return _back(out, input)


def reduce_scatter(input: torch.Tensor, reduce_op: str, group_size: int,
                    group_name: str):
    t0 = _start(input)
    pg = _group(group_name)
    h = _host(input)
    out = _empty_host((h.shape[0] // group_size,) + tuple(h.shape[1:]), h)
    op = reduce_op.lower()
    dist.reduce_scatter_tensor(out, h, op=_OPS[op], group=pg)
    if op == "avg":
        out /= group_size
    _count("reduce_scatter", _nbytes(h), t0)
    return _back(out, input)


def all_to_all(input: torch.Tensor, output_split_sizes: List[int],
                input_split_sizes: List[int], group_name: str):
    t0 = _start(input)
    h = _host(input)
    rows = sum(output_split_sizes) if output_split_sizes else h.shape[0]
    out = _empty_host((rows,) + tuple(h.shape[1:]), h)
    dist.all_to_all_single(out, h, list(output_split_sizes) or None,
                           list(input_split_sizes) or None,
                           group=_group(group_name))
    _count("all_to_all", _nbytes(h), t0)
    return _back(out, input)


def broadcast(input: torch.Tensor, src: int, group_name: str):
    t0 = _start(input)
    h = _host(input, written=True)
    dist.broadcast(h, src=src, group=_group(group_name))
    _count("broadcast", _nbytes(h), t0)
    return _back(h, input)


_KERNELS = {"all_reduce": all_reduce,
            "all_gather_into_tensor": all_gather,
            "reduce_scatter_tensor": reduce_scatter,
            "all_to_all_single": all_to_all,
            "broadcast": broadcast}


def register(device_type: str = "cuda") -> None:
    """Give the functional collectives the staged kernels for
    `device_type` ("cuda", or "cpu" for ranks without a card), once a
    process. The group must be initialized with gloo."""
    global _LIB
    if _LIB is not None:
        return
    import warnings

    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    _LIB = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        # replacing the built-in kernels is the point
        warnings.simplefilter("ignore")
        for name, fn in _KERNELS.items():
            _LIB.impl(name, fn, key)
