"""Audits of what the port builds and captures (counterpart of
``repro.analysis.hlo_audit``).

The reference audits compiled XLA programs. The port builds torch plans
and, on CUDA, captures them as CUDA graphs, so its audits are these:

`CompileCounter` — a rebuild sentinel: the plans built and the CUDA graphs
    captured, process-wide, inside a `with` block (``core.federated`` counts
    every ``FLPlan`` and ``ServePlan`` built, ``graphs.capture`` every graph
    captured). Warm paths assert ``count == 0``. On the CPU nothing is
    captured and only plans count.

`assert_no_baked_data(step)` — the privacy check of the artifact, by
    behaviour: a CUDA graph holds no constants to scan, but a step that
    closed over a tenant's table (or copied it at build time) answers from
    that table instead of the one it is given. So the step runs on one set
    of arguments, then on the same buffers overwritten with other values,
    then on new tensors, and each output must equal an eager computation
    on the arguments it was given.

`collective_census` waits for silo sharding (ROADMAP.md, Queue 1 item 5):
the port runs no collective yet.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.federated import plans_built
from repro_torch.graphs import graphs_captured
from repro_torch.tree import tree_map

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
    given: tenant data (or another runtime array) was captured by closure
    or copied into the plan when it was built."""


def _host(out: Any) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    return np.asarray(out, np.float64)


def _other_values(a: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A tensor like `a` with other values: floats drawn at `a`'s scale,
    integer indices rolled along the first axis (so they stay valid)."""
    if not a.is_floating_point():
        return torch.roll(a, 1, dims=0)
    scale = float(a.abs().max()) if a.numel() else 1.0
    return (torch.randn(a.shape, generator=gen) * (scale or 1.0)).to(a)


def assert_no_baked_data(step: Any) -> None:
    """Raise `BakedDataError` unless `step` answers from its arguments.

    `step` is a lowered step (``ServeCollab.lower_step``): ``step.args`` is
    the tuple of tensor trees it was built and run on, ``step.run(*args)``
    runs it as served (on CUDA a replay of its captured graph) and
    ``step.eager(*args)`` computes the same function eagerly. The check
    works on its own copies of ``step.args`` and holds the step to the
    eager result, within `BAKED_TOL` × max(1, |result|), three times: on the
    copies, on the copies overwritten in place with other values, and on
    new tensors of other values."""
    gen = torch.Generator().manual_seed(BAKED_SEED)
    args = tree_map(lambda a: a.detach().clone(), step.args)

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
    tree_map(lambda a: a.copy_(_other_values(a, gen)), args)
    moved = agree("its arguments overwritten in place", args)
    if np.array_equal(first, moved):
        raise ValueError("other argument values left the step's output "
                         "unchanged: the check would prove nothing")
    agree("new arguments", tree_map(lambda a: _other_values(a, gen), args))


def collective_census(*args, **kwargs):
    raise NotImplementedError(
        "collective_census counts the collectives of a sharded plan; silo "
        "sharding is not ported to repro_torch yet (ROADMAP.md, Queue 1 "
        "item 5)")
