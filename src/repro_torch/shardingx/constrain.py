"""Activation sharding constraints that are no-ops outside a mesh context
(counterpart of ``repro.shardingx.constrain``).

``constrain(x, "batch", None, "model", ...)`` names LOGICAL axes; under
``launch.mesh.use_mesh(mesh)`` they resolve to the mesh's physical axes
("batch" -> ("pod", "data") as available, "model" -> "model"), and
outside one they vanish. Dims whose size is not divisible by the resolved
axes are left unsharded — the same fallback as ``shardingx.policy``.

Where the reference hands the spec to ``with_sharding_constraint``, the
port redistributes a ``DTensor`` to the spec's placements; a plain tensor
(every tensor of the one-card programs) comes back unchanged, so the
model code's constraint sites cost a one-card path nothing and change
none of its bits. ``constraint_spec`` gives the spec itself.

Plain tensors that meet DTensors inside the model (RoPE tables, masks,
``arange``s, the zero pads of the MoE buffers) are taken as replicated:
a step whose arguments are DTensors runs under `replicated_plain`
(``torch.distributed.tensor.experimental.implicit_replication``), taken
at the step's boundary in ``launch.steps``, rather than each such tensor
being made a DTensor where it is built (they are built the same way on
one card, where no mesh exists).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.shardingx.policy import P, to_placements

Axis = Union[None, str, Tuple[str, ...]]


def _mesh_axes() -> dict:
    """{axis: size} of the mesh in context (``launch.mesh.use_mesh``), or
    {} outside one."""
    from repro_torch.launch.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


# Federated context: the silo mesh axis carries the silo dim, so logical
# "batch" must NOT resolve onto it (per-silo activations would move across
# the silo boundary).
_SILO_AXIS: list = [None]


@contextlib.contextmanager
def silo_context(axis: Optional[str]):
    _SILO_AXIS.append(axis)
    try:
        yield
    finally:
        _SILO_AXIS.pop()


def resolve_axis(logical: Axis, sizes: dict) -> Tuple[str, ...]:
    if logical is None:
        return ()
    excluded = _SILO_AXIS[-1]
    if logical == "batch":
        return tuple(a for a in ("pod", "data")
                     if sizes.get(a, 1) > 1 and a != excluded)
    if isinstance(logical, str):
        return (logical,) if sizes.get(logical, 1) > 1 \
            and logical != excluded else ()
    return tuple(a for a in logical if sizes.get(a, 1) > 1 and a != excluded)


def constraint_spec(shape: Tuple[int, ...], *logical: Axis) -> Optional[P]:
    """The spec ``constrain`` puts on a `shape` tensor: the `P` the
    reference hands to ``with_sharding_constraint``, or None where it
    returns its input (no mesh in context, or nothing sharded)."""
    sizes = _mesh_axes()
    if not sizes:
        return None
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical axes {logical} for a "
                         f"{len(shape)}-dim tensor {tuple(shape)}")
    entries = []
    any_sharded = False
    for dim, name in zip(shape, logical):
        axes = resolve_axis(name, sizes)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if axes and dim % prod == 0 and dim >= prod:
            entries.append(axes if len(axes) > 1 else axes[0])
            any_sharded = True
        else:
            entries.append(None)
    return P(*entries) if any_sharded else None


def is_dtensor(x: Any) -> bool:
    """Whether `x` is a ``torch.distributed.tensor.DTensor`` (a plain
    tensor answers without importing the module)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_dtensor(t: torch.Tensor, device_mesh) -> torch.Tensor:
    """`t` as a DTensor on `device_mesh`: a plain tensor (the same on every
    rank) taken as replicated, without moving data; a DTensor as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, *logical: Axis) -> torch.Tensor:
    """`x` laid out by the logical spec: a ``DTensor`` redistributed to the
    spec's placements under a mesh; anything else, or any tensor outside a
    mesh context, as it is."""
    if not is_dtensor(x):
        return x
    spec = constraint_spec(tuple(x.shape), *logical)
    if spec is None:
        return x
    from repro_torch.launch.mesh import current_mesh

    mesh = current_mesh()
    return _Constrain.apply(x, mesh.device_mesh, to_placements(spec, mesh))


class _Constrain(torch.autograd.Function):
    """A redistribution whose cotangent takes the same layout, as the
    transpose of ``with_sharding_constraint`` is the same constraint on
    the cotangent (a plain ``redistribute`` sends the gradient back in its
    input's layout, which leaves a loss's replicated cotangent whole on
    every rank of the batch axes through the backward)."""

    @staticmethod
    def forward(ctx, x, device_mesh, placements):
        ctx.device_mesh, ctx.placements = device_mesh, placements
        return x.redistribute(device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.device_mesh, ctx.placements), None, None


# the mesh axes a param is split over for FSDP (never for its compute)
FSDP_AXES = ("pod", "data")
# the weights the model casts to the compute dtype at every use (matmul
# operands): gathered in that dtype, as FSDP's mixed precision gathers
CAST_TO_COMPUTE = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out",
    "w_r", "w_k", "w_v", "w_g", "w_o", "w_uq", "w_uk", "w_uv", "w_dq",
    "w_dkv", "mix_lora_a", "mix_lora_b", "decay_lora_a", "proj"})


def fsdp_gather(tree: Any, skip: Tuple[str, ...] = (),
                dtype: Optional[torch.dtype] = None, _key: str = "") -> Any:
    """Every DTensor of a layer's param tree whole over the FSDP axes
    ("data", "pod": ``Replicate()`` there, its other placements kept), as
    the reference's FSDP all-gathers a layer's weights before it runs; the
    backward reduce-scatters the gradients back. With a compute `dtype`,
    the weights of `CAST_TO_COMPUTE` are cast to it on each rank's block
    first (the same values the model's own cast gives, half the bytes
    moved for bf16). Dict keys in `skip` keep their subtrees as they are
    (``moe_ep`` gathers its experts itself). Plain tensors are returned as
    they are.

    Left to DTensor's per-op rules, a matmul of batch-split activations
    with a weight split over the same axis on its input dim picks the
    cheaper-looking split of the contraction, leaving every rank with
    partial sums of the whole batch."""
    from torch.distributed.tensor import Replicate

    def one(t):
        if not is_dtensor(t):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        pl = [Replicate() if n in FSDP_AXES and p.is_shard() else p
              for n, p in zip(names, t.placements)]
        if tuple(pl) == tuple(t.placements):
            return t
        if dtype is not None and _key in CAST_TO_COMPUTE:
            t = t.to(dtype)
        return t.redistribute(t.device_mesh, pl)

    if isinstance(tree, dict):
        return {k: v if k in skip else fsdp_gather(v, skip, dtype, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fsdp_gather(v, skip, dtype, _key) for v in tree)
    return one(tree)


def lay_out(t: torch.Tensor, placements, *,
            reduce_grad: bool = True) -> torch.Tensor:
    """The DTensor `t` redistributed to `placements`, its gradient sent
    back in `t`'s own layout (partial sums reduced): a partial gradient
    that meets another use's split one cannot be added. For a local
    computation's inputs (``local_map``), whose gradients are partial
    where an input was whole. A weight used once (``reduce_grad=False``)
    keeps its partial gradient where `t` was whole, for the FSDP gather's
    backward to reduce-scatter."""
    return _LayOut.apply(t, tuple(placements), reduce_grad)


class _LayOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, placements, reduce_grad):
        from torch.distributed.tensor import Replicate

        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in t.placements)
        ctx.reduce_grad = reduce_grad
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        back = ctx.back if ctx.reduce_grad else tuple(
            p if p.is_partial() and b.is_replicate() else b
            for p, b in zip(g.placements, ctx.back))
        return g.redistribute(g.device_mesh, back), None, None


def replicated_plain(active: bool = True):
    """The context a step on DTensors runs in: plain tensors that meet
    DTensors are taken as replicated over the mesh
    (``implicit_replication``); a null context when not `active`."""
    if not active:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
