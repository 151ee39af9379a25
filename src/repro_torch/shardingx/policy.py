"""Per-tensor PartitionSpec resolution for the production meshes
(counterpart of ``repro.shardingx.policy``, rule for rule).

Handles the awkward real-world cases the assigned architectures hit:
  * GQA kv_heads (8, 4, 2) smaller than the 16-wide model axis — falls back
    to head_dim sharding, then to replication;
  * RWKV6's 40 heads (not divisible by 16) — shards head_dim instead;
  * granite's vocab 49155 = 3·5·29·113 — not divisible by ANY mesh axis, so
    the embedding shards d_model on the model axis instead;
  * stacked layer parameters (leading layer dim) — rules are written
    against trailing (negative) dims;
  * federated training — a leading silo dim sharded over the silo axis,
    with FSDP restricted to the intra-silo data axis.

Tensor parallelism over "model", FSDP over "data" only, "pod" pure data
parallel in baseline mode and the silo axis in federated mode.

The port's spec is `P`, a sequence of entries (None, an axis name or a tuple
of names) that compares entry for entry with ``jax.sharding.PartitionSpec``
and normalises its entries as that does. A mesh is anything with
``axis_names`` and ``devices.shape`` (``launch.mesh.HostMesh``, the
one-card planning mesh, a test's stand-in). In place of the reference's
``to_shardings`` (NamedSharding trees), `shard_shape` gives a spec's local
block and `to_placements` its ``torch.distributed.tensor`` placements; in
place of its ``device_put`` of a tree on those shardings,
`distribute_tree` lays a tree of whole tensors out as DTensors over a
``launch.mesh.HostMesh`` of running ranks, and `local_tree` gives each
leaf's local shard back.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

REPLICATE_BELOW = 4096          # leaves smaller than this stay replicated

# name -> (model-axis dim priority, data/FSDP-axis dim priority), negative
# indices relative to the trailing (per-layer) shape.
_RULES_3D = {
    # attention / rwkv projections (d, H, hd) — prefer heads, fall to head_dim
    "wq": ([-2, -1], [-3]), "wk": ([-2, -1], [-3]), "wv": ([-2, -1], [-3]),
    "w_r": ([-2, -1], [-3]), "w_k": ([-2, -1], [-3]), "w_v": ([-2, -1], [-3]),
    # output projections (H, hd, d)
    "wo": ([-3, -2], [-1]), "w_o": ([-3, -2], [-1]),
    # MoE experts (E, d, f) / (E, f, d) — expert parallelism on model axis
    "w_gate": ([-3], [-1]), "w_up": ([-3], [-1]), "w_down": ([-3], [-2]),
    # MLA up-projections (rank, H, x)
    "w_uq": ([-2], [-3]), "w_uk": ([-2], [-3]), "w_uv": ([-2], [-3]),
    # rwkv lora tails
    "decay_lora_b": ([-1], [-3]), "mix_lora_a": ([-1], [-3]),
    "mix_lora_b": ([-1], [-2]),
}

_RULES_2D_UP = {"w_gate", "w_up", "w_k", "w_g", "w_in", "w_dq", "w_dkv",
                "decay_lora_a", "proj", "w_r"}
_RULES_2D_DOWN = {"w_down", "w_v", "w_out", "lm_head"}
_EMBED = {"embed"}


def _entry(e: Any) -> Any:
    """One spec entry as PartitionSpec keeps it: a one-name tuple is the
    name, an empty one None, a list a tuple."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class P:
    """A partition spec: one entry per tensor dim, None (unsharded), a mesh
    axis name, or a tuple of names (the dim split over those axes, major
    first). Equal to a tuple, or to a ``jax.sharding.PartitionSpec`` (both
    are compared as ``tuple(spec)``), with the same entries. A leaf of a
    spec tree: it is no tuple, so ``repro_torch.tree`` does not walk it."""

    __slots__ = ("_entries",)

    def __init__(self, *entries: Any):
        self._entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, P):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self._entries)) + ")"


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def map_with_names(fn: Callable[[Tuple[str, ...], Any], Any],
                   tree: Any, names: Tuple[str, ...] = ()) -> Any:
    """``fn(dict keys on the path, leaf)`` over a tree of dicts, lists and
    tuples (the dict keys are what the reference reads from its
    ``DictKey`` path entries; list and tuple indices are not names)."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, t, names) for t in tree)
    return fn(names, tree)


def map_specs(fn: Callable[[P], Any], spec_tree: Any) -> Any:
    """`fn` over every `P` of a tree of specs (dicts, lists, tuples)."""
    if isinstance(spec_tree, P):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, t) for t in spec_tree)
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


def _divisible(shape: Sequence[int], dim: int, size: int) -> bool:
    return size > 1 and shape[dim] % size == 0


def _resolve(name: str, shape: Tuple[int, ...], trailing: int,
             model_axis: Optional[str], model_size: int,
             data_axis: Optional[str], data_size: int,
             fsdp: bool) -> list:
    """Return spec entries for the trailing `trailing` dims."""
    spec: list = [None] * trailing
    if math.prod(shape[-trailing:] or (1,)) < REPLICATE_BELOW \
            or trailing == 0:
        return spec

    def t2a(neg: int) -> int:  # negative trailing index -> index into spec
        return trailing + neg

    model_dims, data_dims = [], []
    if trailing >= 3 and name in _RULES_3D:
        model_dims, data_dims = _RULES_3D[name]
    elif trailing >= 2 and name in _EMBED:
        model_dims, data_dims = [-2, -1], [-2, -1]
    elif trailing >= 2 and name in _RULES_2D_DOWN:
        model_dims, data_dims = [-2], [-1]
    elif trailing >= 2 and (name in _RULES_2D_UP or trailing == 2):
        model_dims, data_dims = [-1], [-2]

    model_at = None
    if model_axis:
        for nd in model_dims:
            if -nd <= trailing and _divisible(shape, nd, model_size):
                spec[t2a(nd)] = model_axis
                model_at = t2a(nd)
                break
    if fsdp and data_axis:
        for nd in data_dims:
            a = t2a(nd)
            if -nd <= trailing and a != model_at \
                    and _divisible(shape, nd, data_size):
                spec[a] = data_axis
                break
        else:
            # try stacking data onto the model dim (e.g. embed vocab over both)
            if model_at is not None and \
                    shape[model_at - trailing] % (model_size * data_size) == 0:
                spec[model_at] = (data_axis, model_axis)
    return spec


_MOE_EXPERT_NAMES = {"w_gate", "w_up", "w_down"}


def param_specs(shapes: Any, mesh, *, fsdp: bool = True,
                moe_fsdp: bool = True,
                silo_dim: bool = False, silo_axis: Optional[str] = None,
                stacked_prefixes: Tuple[str, ...] = ("layers", "dense_layers",
                                                     "tail_layers")) -> Any:
    """Tree of `P` matching a tree of tensors (any device, `meta` too).

    silo_dim: params carry a leading silo dim (federated mode) sharded over
    silo_axis; FSDP then uses the remaining data axis only if distinct.
    """
    axis_sizes = _axis_sizes(mesh)
    model_axis = "model" if "model" in axis_sizes else None
    if silo_dim and silo_axis is None:
        silo_axis = "pod" if "pod" in axis_sizes else "data"
    data_axis = "data" if "data" in axis_sizes else None
    if silo_dim and silo_axis == "data":
        data_axis = None                      # data axis consumed by silos

    def one(names, leaf) -> P:
        shape = tuple(leaf.shape)
        name = names[-1] if names else ""
        if name in ("scale",) and len(names) >= 2:
            name = names[-2]                  # rmsnorm dicts
        offset = 1 if silo_dim else 0
        stacked = any(n in stacked_prefixes for n in names)
        trailing = len(shape) - offset - (
            1 if stacked and len(shape) - offset >= 1 else 0)
        trailing = max(trailing, 0)
        leaf_fsdp = fsdp
        # expert-parallel MoE needs expert weights sharded exactly
        # P(model-on-E) — no FSDP on the d/f dims
        if not moe_fsdp and name in _MOE_EXPERT_NAMES and trailing >= 3:
            leaf_fsdp = False
        entries = _resolve(name, shape, trailing, model_axis,
                           axis_sizes.get(model_axis or "", 1),
                           data_axis, axis_sizes.get(data_axis or "", 1),
                           leaf_fsdp)
        head: list = []
        if silo_dim:
            head.append(silo_axis if shape[0] > 1 else None)
        if stacked and len(shape) - offset >= 1:
            head.append(None)                 # layer-stack dim
        return P(*(head + entries))

    return map_with_names(one, shapes)


def batch_spec(mesh, *, federated: bool,
               silo_axis: Optional[Any] = None, ndim: int = 2) -> P:
    """Spec for (B, S) token batches — or federated silo stacks.

    federated with a STRING silo_axis (launch-tier LLM batches, (d, b, S)):
    silo dim over silo_axis, intra-silo batch dim over the leftover "data"
    axis, ndim counting the per-silo batch rank. federated with a TUPLE
    silo_axis (core.federated sharded plans, (d, n_slots, …) tabular
    stacks): the leading silo dim spans ALL the named axes jointly —
    ("pod", "data") on a multipod mesh — and ndim is the FULL array rank;
    every non-silo dim stays shard-local.
    """
    axis_sizes = _axis_sizes(mesh)
    if federated:
        if silo_axis is not None and not isinstance(silo_axis, str):
            return P(tuple(silo_axis), *([None] * (ndim - 1)))
        silo_axis = silo_axis or ("pod" if "pod" in axis_sizes else "data")
        rest = "data" if ("data" in axis_sizes and silo_axis != "data") \
            else None
        return P(silo_axis, rest, *([None] * (ndim - 1)))
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    return P(batch_axes if batch_axes else None, *([None] * (ndim - 1)))


def _axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    """The local block of a `shape` tensor laid out by `spec` on `mesh`:
    each dim divided by the product of its axes' sizes (what
    ``NamedSharding.shard_shape`` gives); a dim they do not divide
    raises."""
    sizes = _axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(entries) > len(shape):
        raise ValueError(f"{spec!r} has more entries than {tuple(shape)} "
                         "has dims")
    out = []
    for dim, entry in zip(shape, entries):
        k = math.prod(sizes[a] for a in _axes(entry))
        if dim % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} is not divisible "
                             f"by the {k} shards of {entry!r}")
        out.append(dim // k)
    return tuple(out)


def to_placements(spec_tree: Any, mesh) -> Any:
    """Each `P` of `spec_tree` as ``torch.distributed.tensor`` placements
    for the mesh's ``DeviceMesh``, one per mesh axis in the mesh's order:
    ``Shard(i)`` on the axes of tensor dim i, else ``Replicate()``. A dim
    split over several axes must name them in the mesh's order (DTensor
    splits the major mesh dim first, as PartitionSpec does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)

    def one(spec: P):
        out: list = [Replicate()] * len(names)
        for i, entry in enumerate(spec):
            axes = _axes(entry)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"{spec!r}: axes {axes} of dim {i} are not "
                                 f"in the mesh's order {names}")
            for j in pos:
                out[j] = Shard(i)
        return tuple(out)

    return map_specs(one, spec_tree)


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape` (what
    ``DTensor.from_local`` takes with a global shape)."""
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def distribute_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """Each tensor of `tree` as a ``DTensor`` on ``mesh.device_mesh``, laid
    out by its `P` of `spec_tree` (``to_placements``: an all-None spec is
    ``Replicate()`` on every axis). Every rank passes the same whole
    tensors and keeps its own block of each: no data moves. A leaf that
    is a DTensor already is redistributed to the spec."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.tree import tree_map

    dm = mesh.device_mesh

    def one(t, spec: P):
        pl = to_placements(spec, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(dm, pl)
        return distribute_tensor(t, dm, pl, src_data_rank=None)

    return tree_map(one, tree, spec_tree)


def local_tree(tree: Any) -> Any:
    """Each DTensor leaf of `tree` as this rank's local block (the tensor
    the DTensor holds, not a copy); other leaves as they are."""
    from repro_torch.shardingx.constrain import is_dtensor
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree)
