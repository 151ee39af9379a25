"""Audits of what the port builds and captures (counterpart of
``repro.analysis.hlo_audit``).

The reference audits compiled XLA programs. The port builds torch plans
and, on CUDA, captures them as CUDA graphs, so its audits are these:

`CompileCounter` — a rebuild sentinel: the plans built and the CUDA graphs
    captured, process-wide, inside a `with` block (``core.federated`` counts
    every ``FLPlan`` and ``ServePlan`` built, ``graphs.capture`` every graph
    captured). Warm paths assert ``count == 0``. On the CPU nothing is
    captured and only plans count.

`find_baked_constants(obj)` — the structural half: an XLA executable
    holds its constants, a torch plan holds tensors in its attributes,
    containers, buffers and the closure cells of its functions. This walks
    what an idle plan holds and returns every non-splat tensor or array of
    ``min_elems`` or more elements, with its path. A splat (every element
    one value: the zeros a plan leaves in its buffers after a run) carries
    no information and passes at any size, as a splat constant does in the
    reference.

`assert_no_baked_data(step)` — the privacy check of the artifact, by
    behaviour and then by structure: a step that closed over a tenant's
    table (or copied it at build time) answers from that table instead of
    the one it is given. So the step runs on one set of arguments, on each
    argument changed alone, on the same buffers overwritten with other
    values and on new tensors; each output must equal an eager computation
    on the arguments it was given, and changing any floating argument
    alone must change the output. Then ``find_baked_constants`` runs over
    the idle plan the step ran through (``step.plan``).

`collective_census(lowered)` — the collectives of one round of a lowered
    plan, {kind: operands}. A sharded plan records what its round boundary
    ran (``core.federated.SiloComm``): a weighted aggregator
    {all-reduce: leaves+1} per hierarchy level, a robust one
    {all-reduce: 1, all-gather: leaves+1}; an unsharded plan runs none and
    gives {}. Operands, not operations: the port combines a tree's leaves
    into one buffer per level, as XLA combines the reference's.
"""
from __future__ import annotations

import functools
import types
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.federated import plans_built
from repro_torch.graphs import graphs_captured
from repro_torch.tree import tree_leaves, tree_map

# assert_no_baked_data draws its other argument values from this seed, and
# holds the step to the eager result within BAKED_TOL x max(1, |result|):
# a replay runs the same kernels as the eager step, so they agree to fp32
# rounding, while an answer from a held table is off by the table's scale.
BAKED_SEED = 0
BAKED_TOL = 1e-5


def _builds() -> Tuple[int, int]:
    return plans_built(), graphs_captured()


class CompileCounter:
    """Count plans built (`plans`) and CUDA graphs captured (`captures`)
    inside a `with` block; ``count`` is their sum. The counts are
    process-wide and read live while the block is open; blocks nest."""

    def __init__(self) -> None:
        self._start: Tuple[int, int] = (0, 0)
        self._end: Optional[Tuple[int, int]] = None

    def __enter__(self) -> "CompileCounter":
        self._start, self._end = _builds(), None
        return self

    def __exit__(self, *exc) -> None:
        self._end = _builds()

    def _since(self, kind: int) -> int:
        now = _builds() if self._end is None else self._end
        return now[kind] - self._start[kind]

    @property
    def plans(self) -> int:
        return self._since(0)

    @property
    def captures(self) -> int:
        return self._since(1)

    @property
    def count(self) -> int:
        return self.plans + self.captures


class BakedDataError(AssertionError):
    """A step answered from data it holds instead of the arguments it was
    given, or an idle plan still holds a non-splat array: tenant data (or
    another runtime array) was captured by closure, copied into the plan
    when it was built, or left in its buffers after a run."""


def _is_splat(a: Any) -> bool:
    if isinstance(a, torch.Tensor):
        flat = a.detach().reshape(-1)
        if flat.numel() == 0:
            return True
        same = flat == flat[0]
        if flat.is_floating_point() or flat.is_complex():
            same |= flat.isnan() & flat[0].isnan()
        return bool(same.all())
    flat = np.asarray(a).reshape(-1)
    if flat.size == 0:
        return True
    same = flat == flat[0]
    if np.issubdtype(flat.dtype, np.inexact):
        same |= np.isnan(flat) & np.isnan(flat[0])
    return bool(same.all())


def _children(obj: Any):
    """(path suffix, child) pairs of what `obj` holds."""
    if isinstance(obj, dict):
        return [(f"[{k!r}]", v) for k, v in obj.items()]
    if isinstance(obj, (list, tuple, deque)):
        return [(f"[{i}]", v) for i, v in enumerate(obj)]
    if isinstance(obj, (set, frozenset)):
        return [("{}", v) for v in obj]
    if isinstance(obj, types.FunctionType):
        out = []
        for name, cell in zip(obj.__code__.co_freevars,
                              obj.__closure__ or ()):
            try:
                out.append((f".<{obj.__name__}:{name}>", cell.cell_contents))
            except ValueError:                 # an empty cell
                pass
        out += [(f".<{obj.__name__}:default{i}>", v)
                for i, v in enumerate(obj.__defaults__ or ())]
        out += [(f".<{obj.__name__}:{k}>", v)
                for k, v in (obj.__kwdefaults__ or {}).items()]
        return out
    if isinstance(obj, functools.partial):
        return [(".func", obj.func), (".args", obj.args),
                (".keywords", obj.keywords)]
    if isinstance(obj, types.MethodType):
        return [(".__func__", obj.__func__), (".__self__", obj.__self__)]
    if isinstance(obj, types.ModuleType) or isinstance(obj, type) or \
            isinstance(obj, (types.BuiltinFunctionType, str, bytes)):
        return []
    d = getattr(obj, "__dict__", None)
    return [(f".{k}", v) for k, v in d.items()] if isinstance(d, dict) \
        else []


def find_baked_constants(obj: Any, min_elems: int = 1024
                         ) -> List[Dict[str, Any]]:
    """Every NON-SPLAT tensor or ndarray of >= `min_elems` elements that
    `obj` holds: its attributes, containers (dicts, lists, tuples, a
    ``SimpleNamespace``'s ``__dict__``) and the closure cells (and
    defaults) of its functions, recursively; each found once, as
    {"path", "shape", "dtype", "elements"}. For an idle plan
    (``FLPlan``, ``ServePlan``) the answer must be empty: a non-splat array
    there is data that outlived the run that used it, or that a function
    of the plan closed over."""
    found: List[Dict[str, Any]] = []
    seen: Set[int] = set()
    stack: List[Tuple[str, Any]] = [(type(obj).__name__, obj)]
    while stack:
        path, o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, (torch.Tensor, np.ndarray)):
            n = int(o.numel()) if isinstance(o, torch.Tensor) else int(o.size)
            if n >= min_elems and not (isinstance(o, np.ndarray)
                                       and o.dtype == object) \
                    and not _is_splat(o):
                found.append({"path": path, "shape": tuple(o.shape),
                              "dtype": str(o.dtype), "elements": n})
            continue
        stack.extend((path + sfx, c) for sfx, c in reversed(_children(o)))
    return found


def _host(out: Any) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    return np.asarray(out, np.float64)


def _other_values(a: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A tensor like `a` with other values: floats drawn at `a`'s scale
    (uniform in [0, scale) where `a` has no negative entry, so masks,
    weights and scales stay valid ones; normal otherwise), integer indices
    rolled along the first axis (so they stay valid)."""
    if not a.is_floating_point():
        return torch.roll(a, 1, dims=0)
    scale = float(a.abs().max()) if a.numel() else 1.0
    draw = torch.rand if a.numel() and float(a.min()) >= 0 else torch.randn
    return (draw(a.shape, generator=gen) * (scale or 1.0)).to(a)


def _map(fn, tree):
    """`tree_map` that leaves None leaves (an absent argument) as they are."""
    return tree_map(lambda a: None if a is None else fn(a), tree)


def assert_no_baked_data(step: Any, min_elems: int = 1024) -> None:
    """Raise `BakedDataError` unless `step` answers from its arguments and
    the plan it ran through holds no data once it is idle.

    `step` is a lowered step or plan (``ServeCollab.lower_step``,
    ``core.federated.lower_fl_plan``): ``step.args`` is the tuple of
    tensor trees it was built and run on, ``step.run(*args)`` runs it as
    served (on CUDA a replay of its captured graph), ``step.eager(*args)``
    computes the same function eagerly and ``step.plan`` is the plan
    (cached, shared by tenants) it ran through. The check works on its own
    copies of ``step.args``. It holds the step to the eager result, within
    `BAKED_TOL` × max(1, |result|), on the copies, on the copies
    overwritten in place with other values, and on new tensors of other
    values; it requires that each argument holding a floating tensor,
    changed alone, changes the output (a step that reads a closure in its
    place does not); and it requires that ``find_baked_constants(step.plan,
    min_elems)`` finds nothing once the runs have returned."""
    gen = torch.Generator().manual_seed(BAKED_SEED)
    args = _map(lambda a: a.detach().clone(), step.args)

    def agree(what: str, a) -> np.ndarray:
        got, want = _host(step.run(*a)), _host(step.eager(*a))
        err = float(np.abs(got - want).max()) / max(1.0,
                                                     float(np.abs(want).max()))
        if not err <= BAKED_TOL:
            raise BakedDataError(
                f"the step's output on {what} is {err:.3e} (relative) from "
                "an eager computation on the same arguments: it answers "
                "from data it holds, captured by closure or copied when it "
                "was built, not from its arguments (pass every tenant "
                "array as an argument)")
        return want

    first = agree("its arguments", args)
    for i, a in enumerate(args):
        if not any(t is not None and t.is_floating_point()
                   for t in tree_leaves(a)):
            continue
        alone = args[:i] + (_map(lambda t: _other_values(t, gen), a),) \
            + args[i + 1:]
        if np.array_equal(_host(step.run(*alone)), first):
            raise BakedDataError(
                f"the step's output does not move when its argument {i} "
                "alone takes other values: it answers from data it holds "
                "(a closure or a copy) in that argument's place, not from "
                "the argument")
    _map(lambda a: a.copy_(_other_values(a, gen)), args)
    moved = agree("its arguments overwritten in place", args)
    if np.array_equal(first, moved):
        raise ValueError("other argument values left the step's output "
                         "unchanged: the check would prove nothing")
    agree("new arguments", _map(lambda a: _other_values(a, gen), args))
    baked = find_baked_constants(step.plan, min_elems)
    if baked:
        detail = ", ".join(f"{b['path']} {list(b['shape'])} {b['dtype']}"
                           for b in baked[:8])
        raise BakedDataError(
            f"the idle plan holds {len(baked)} non-splat array(s) of "
            f">={min_elems} elements: {detail} — tenant data left in its "
            "buffers after a run, or closed over by one of its functions "
            "(a cached plan is handed to the next tenant of its shapes)")


COLLECTIVE_KINDS = ("all-reduce", "all-gather", "all-to-all",
                    "collective-permute", "reduce-scatter")


def collective_census(lowered: Any,
                      kinds: Tuple[str, ...] = COLLECTIVE_KINDS
                      ) -> Dict[str, int]:
    """{kind: operands} of the last round the lowered plan (or the plan
    itself) ran, zero-count kinds omitted; {} for an unsharded plan. The
    count per round cannot grow with local epochs unless a collective
    leaks into the local phase."""
    comm = getattr(getattr(lowered, "plan", lowered), "comm", None)
    if comm is None:
        return {}
    return {k: n for k, n in comm.census.items() if k in kinds and n}
