"""Activation sharding constraints that are no-ops outside a mesh context
(counterpart of ``repro.shardingx.constrain``).

``constrain(x, "batch", None, "model", ...)`` names LOGICAL axes; under
``launch.mesh.use_mesh(mesh)`` they resolve to the mesh's physical axes
("batch" -> ("pod", "data") as available, "model" -> "model"), and
outside one they vanish. Dims whose size is not divisible by the resolved
axes are left unsharded — the same fallback as ``shardingx.policy``.

Where the reference hands the spec to ``with_sharding_constraint``, the
port redistributes a ``DTensor`` to the spec's placements; a plain tensor
(every tensor of the port's one-card model code, which calls no
constraint) comes back unchanged. ``constraint_spec`` gives the spec
itself.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

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


def constrain(x: torch.Tensor, *logical: Axis) -> torch.Tensor:
    """`x` laid out by the logical spec: a ``DTensor`` redistributed to the
    spec's placements under a mesh; anything else, or any tensor outside a
    mesh context, as it is."""
    spec = constraint_spec(tuple(x.shape), *logical)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import current_mesh

    if not isinstance(x, DTensor):
        return x
    mesh = current_mesh()
    return x.redistribute(mesh.device_mesh, to_placements(spec, mesh))
