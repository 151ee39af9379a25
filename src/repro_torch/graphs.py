"""CUDA-graph capture, shared by the port's captured paths: the federated
round (``core/federated.py``), the collaboration serve step
(``serve_collab/server.py``) and the LM decode step (``launch/steps.py``).

A function is warmed up on the device's one capture stream (first-call
allocations, cuBLAS handles and workspaces stay out of the graph), then
captured on that stream. A replay runs the captured kernels against the
addresses baked in at capture, so every caller keeps its inputs in static
buffers (or keys its graphs on the inputs' addresses). A failed capture
raises: no caller falls back to an eager step.

``graphs_captured()`` is the number of graphs captured here for the life
of the process: ``analysis.hlo_audit.CompileCounter`` reads it.
``zero_buffers`` clears static buffers once their tenant's work is done.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves

_CAPTURE_STREAMS: Dict[str, "torch.cuda.Stream"] = {}
_captured = 0


def graphs_captured() -> int:
    """Graphs captured by `capture` since the process started."""
    return _captured


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on `device` warms up and captures on.
    A stream that has run a matmul keeps a cuBLAS workspace (tens of MB)
    for the life of the process, so one stream per capture would hold one
    more each time a graph is captured."""
    key = str(device)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[key]


def capture(fn: Callable[[], Any], device: torch.device, *,
            warmup: Optional[Callable[[], Any]] = None,
            timings: Optional[Dict[str, float]] = None
            ) -> Tuple["torch.cuda.CUDAGraph", Any]:
    """Run `warmup` (default: `fn`) once on the capture stream, then capture
    `fn` into a new CUDA graph there. Returns (graph, what `fn` returned
    while captured: tensors in the graph's pool, rewritten by each replay).
    Nothing is replayed. `timings` gets ``warmup_s`` and ``capture_s``."""
    global _captured
    t0 = time.perf_counter()
    side = capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        (warmup or fn)()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    _captured += 1
    if timings is not None:
        timings["warmup_s"] = t1 - t0
        timings["capture_s"] = time.perf_counter() - t1
    return graph, out


def zero_buffers(tree: Any) -> None:
    """Zero every tensor leaf of `tree` in place (None leaves skipped), one
    ``torch._foreach_zero_`` per (device, dtype): each group is one fused
    kernel, where a list of mixed dtypes takes a kernel per tensor."""
    groups: Dict[Tuple[torch.device, torch.dtype], list] = {}
    for t in tree_leaves(tree):
        if t is not None:
            groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        torch._foreach_zero_(ts)
