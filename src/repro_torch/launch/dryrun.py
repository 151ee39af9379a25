"""Dry-run: build every (architecture × input shape) plan, trace its step
on fake tensors, and record its roofline terms and memory (counterpart of
``repro.launch.dryrun``).

On the one-card mesh, ("data", "model") = (1, 1), where the port's LLM
programs run (so the federated modes get d = 1 silo, by the reference's
rule ``num_silos(mesh)``), the plan's step is traced once on fake tensors
of the plan's device (``torch._subclasses.fake_tensor.FakeTensorMode``:
shapes, dtypes and devices, no memory and no computation) under three
counters:
  * ``FlopCounterMode``: flops;
  * bytes accessed: operand plus result bytes of every aten op that is not
    a view, as XLA's cost analysis counts them op by op;
  * live bytes: every storage from the step's arguments and its ops, freed
    when the last tensor on it goes; the peak, split into argument, output
    (new storages the step returns), alias (returned storages that are
    arguments: the in-place updates) and temp (the rest of the peak) bytes.
The record adds ``peak_bytes`` and ``fits_one_card`` (the peak against the
card's memory, ``roofline.HW``); on one card ``collective_bytes_per_device``
is 0.

The reference compiles each pair twice (scan-over-layers for memory,
unrolled for costs, since XLA counts a loop body once). The port's layers
run in a Python loop, so one trace counts every layer: ``--scan-only``
has no counterpart.

With ``--multi-pod`` / ``--both-meshes`` the production meshes (16 × 16
and 2 × 16 × 16) come from ``launch.mesh.planning_mesh`` (a fake-backend
group of 256 / 512 ranks in this process, this process rank 0) and the
plan's sharded step runs for rank 0 on meta tensors of its local blocks
(``trace_sharded``: the arguments laid out by the plan's specs as
DTensors whose local tensors are on the ``meta`` device, so nothing is
allocated and no data moves). The counters then see rank 0's local ops
only (each returns NotImplemented for a DTensor op, which DTensor then
turns into local ops and collectives), and a fourth counter,
`CollectiveCounter`, records every ``_c10d_functional`` collective
DTensor issues: its kind, result bytes, and the rank groups of its mesh
axis. ``roofline.analyze`` gives the reference's per-device record from
them, ``cross_silo_bytes_per_device`` against silo blocks of 16 / 256
ranks (the ranks of one silo: a data row, a pod), and ``fits_one_card`` of the per-rank peak; ``cost_source:
"traced per rank"``. Every rank of an axis runs the same program on
blocks of the same shapes, so rank 0's trace, with its collectives'
groups given for the whole axis, stands for every rank. A pair whose
trace fails keeps the spec-level record (per-rank argument bytes, costs
null, ``cost_source: "specs only"``) with ``trace_error`` naming the op.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mode feddcl] --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu

``--device`` (default cuda) is the plan's device: fake tensors of it, so
``--device cuda`` needs a card only because the step factories do. The
exit code is non-zero if any requested pair fails to build or trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.mesh import num_silos, one_card_mesh, planning_mesh
from repro_torch.launch.specs import make_plan, resolve_arch_for_shape
from repro_torch.shardingx.policy import map_specs, shard_shape
from repro_torch.tree import tree_leaves, tree_map

OUT_DIR = "results_torch/dryrun"

# the production meshes by name: ``launch.mesh.planning_mesh``'s arguments
# (a test swaps in a small mesh of the fake backend)
PLANNING_MESHES = {"16x16": {"multi_pod": False},
                   "2x16x16": {"multi_pod": True}}


# --------------------------------------------------------------------------
# the counters
# --------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of `tree`, a DTensor as its local block."""
    from repro_torch.shardingx.constrain import is_dtensor
    return [t.to_local() if is_dtensor(t) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _is_fake(types, out) -> bool:
    """An op on fake tensors: in a per-rank trace (meta tensors), these
    are DTensor's own shape propagation, which runs each op on fake
    tensors of the global shapes, not work of the rank."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types) or any(
        isinstance(t, FakeTensor) for t in _tensors(out))


class MemoryCounter(TorchDispatchMode):
    """Bytes accessed and live storage bytes of the ops run under it.

    A storage counts from the first tensor on it that the counter sees (an
    argument given to `track`, or an op's result) until the last of those
    tensors is freed; ``peak`` is the most live at once. An op's bytes
    accessed are its distinct tensor operands' and results' bytes (an
    in-place result counts once), for every op that returns a tensor and
    is not a view."""

    def __init__(self, skip_fake: bool = False):
        super().__init__()
        # a per-rank trace on meta tensors leaves fake-tensor ops uncounted
        self.skip_fake = skip_fake
        self._live: Dict[int, List[int]] = {}   # storage -> [bytes, refs]
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0

    @staticmethod
    def key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        ent = self._live.get(st._cdata)
        if ent is None:
            ent = self._live[st._cdata] = [st.nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._drop, st._cdata)

    def _drop(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented       # counted as the local ops it runs
        out = func(*args, **(kwargs or {}))
        if self.skip_fake and _is_fake(types, out):
            return out
        results = _tensors(out)
        for t in results:
            self.track(t)
        # a view moves nothing; nor does an op that returns no tensor (a
        # metadata query such as prim.device, which only fake tensors send)
        if results and not func.is_view:
            seen = set()
            for t in _tensors((args, kwargs)) + results:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes_accessed += _nbytes(t)
        return out


class LocalFlopCounter(TorchDispatchMode):
    """``FlopCounterMode``'s count over the local ops a rank runs: a
    DTensor op is left to DTensor (NotImplemented), whose local ops come
    back through this mode on this rank's blocks."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            return NotImplemented
        packet = getattr(func, "_overloadpacket", None)
        if packet not in self.registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in self.registry and not _is_fake(types, out):
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        return out


# the reference's names of the collectives (its HLO op names)
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


class CollectiveCounter(TorchDispatchMode):
    """Every collective DTensor (or any functional-collective caller)
    issues on this rank: {"kind", "bytes" (this rank's result bytes),
    "groups" (every rank group of the collective's mesh axis, each in
    coordinate order; the group's own ranks when it is no axis of
    `mesh`)}, in ``records``, as ``roofline.analyze`` reads them."""

    def __init__(self, mesh=None):
        super().__init__()
        self.records: List[Dict[str, Any]] = []
        self._axis_groups: Dict[str, List[List[int]]] = {}
        if mesh is not None:
            for a in mesh.axis_names:
                name = mesh.device_mesh.get_group(a).group_name
                self._axis_groups[name] = mesh.axis_groups(a)

    def _groups(self, group_name: str) -> List[List[int]]:
        if group_name in self._axis_groups:
            return self._axis_groups[group_name]
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        return [dist.get_process_group_ranks(
            _resolve_process_group(group_name))]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if getattr(func, "namespace", None) == "_c10d_functional":
            kind = _COLLECTIVES.get(func._overloadpacket._qualified_op_name
                                    .split("::")[-1])
            if kind is not None:
                group = args[-1] if isinstance(args[-1], str) \
                    else kwargs["group_name"]
                self.records.append({
                    "kind": kind,
                    "bytes": sum(_nbytes(t) for t in _tensors(out)),
                    "groups": self._groups(group)})
        return out


def _storages(tensors) -> Dict[int, int]:
    return {MemoryCounter.key(t): t.untyped_storage().nbytes()
            for t in tensors}


def fake_args(args: Any, device: torch.device) -> Any:
    """Contiguous tensors of `args`' shapes and dtypes on `device`: fake
    ones when called under a ``FakeTensorMode``."""
    return tree_map(lambda a: torch.empty(tuple(a.shape), dtype=a.dtype,
                                          device=device), args)


def trace_step(step_fn, args: Any, mesh=None) -> Tuple[Any, Dict[str, Any]]:
    """Run ``step_fn(*args)`` under the flop and memory counters; returns
    its outputs and the counts (``flops``, ``bytes_accessed``,
    ``peak_bytes``, ``memory``). With fake `args` under a
    ``FakeTensorMode`` this traces the step; with real ones it runs it.
    With a `mesh` (DTensor `args`, the step run under
    ``launch.mesh.use_mesh(mesh)``) the counts are this rank's local
    ops', and ``collectives`` holds the `CollectiveCounter`'s records."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import use_mesh

    arg_store = _storages(_tensors(args))
    mem = MemoryCounter(skip_fake=mesh is not None)
    for t in _tensors(args):
        mem.track(t)
    if mesh is None:
        flops = FlopCounterMode(display=False)
        with flops, mem:
            out = step_fn(*args)
        total, records = flops.get_total_flops(), []
    else:
        flops, coll = LocalFlopCounter(), CollectiveCounter(mesh)
        with use_mesh(mesh), flops, mem, coll:
            out = step_fn(*args)
        total, records = flops.flops, coll.records
    outs = _storages(_tensors(out))
    alias = sum(n for k, n in outs.items() if k in arg_store)
    output = sum(n for k, n in outs.items() if k not in arg_store)
    argument = sum(arg_store.values())
    return out, {
        "flops": total, "collectives": records,
        "bytes_accessed": mem.bytes_accessed,
        "peak_bytes": mem.peak,
        "memory": {"argument_bytes": argument, "output_bytes": output,
                   "temp_bytes": max(mem.peak - argument - output, 0),
                   "alias_bytes": alias}}


def trace_plan(plan, device: torch.device) -> Dict[str, Any]:
    """The plan's step traced once on fake tensors of `device`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args = fake_args(plan.args, device)
        _, counts = trace_step(plan.step_fn, args)
    return counts


def trace_sharded(plan, mesh) -> Dict[str, Any]:
    """The plan's step for this rank of `mesh` (a planning mesh's rank 0)
    on meta tensors of its local blocks: the plan's arguments laid out by
    its specs as DTensors (``shardingx.policy.distribute_tree`` of its
    meta trees), the step run under ``use_mesh(mesh)`` and the counters
    of `trace_step`."""
    from repro_torch.shardingx.policy import distribute_tree

    args = tuple(distribute_tree(a, s, mesh)
                 for a, s in zip(plan.args, plan.in_specs))
    _, counts = trace_step(plan.step_fn, args, mesh)
    return counts


def _failing_op(e: BaseException) -> str:
    """The op and first line of a failed trace, for its record."""
    text = str(e).strip().splitlines()
    op = next((l for l in text if "aten." in l or "propagation" in l), "")
    return f"{type(e).__name__}: {text[0] if text else ''}" + (
        f" [{op.strip()[:300]}]" if op and op != text[0] else "")


# --------------------------------------------------------------------------
# one pair
# --------------------------------------------------------------------------

def train_config(arch: str, cfg, shape, mesh) -> TrainConfig:
    """The dry-run's training config, as the reference's: bf16 params and
    compute, H = 4, one silo per silo-axis row; deepseek-v3 keeps bf16
    AdamW moments (fp32 ones do not fit its production mesh)."""
    opt_dtype = "bfloat16" if arch == "deepseek-v3-671b" else "float32"
    return TrainConfig(model=cfg, shape=shape, param_dtype="bfloat16",
                       compute_dtype="bfloat16", opt_state_dtype=opt_dtype,
                       federated=FederatedConfig(num_silos=num_silos(mesh),
                                                 local_steps=4))


def _variant(cfg, variant: Optional[str]):
    if variant == "rwkv_seq":        # sequence-parallel WKV chunks
        return cfg.with_overrides(ssm=dataclasses.replace(cfg.ssm,
                                                          shard="seq"))
    if variant == "expand_kv":       # head-parallel decode, replicated cache
        return cfg.with_overrides(decode_expand_kv=True)
    if variant == "cache_seq":       # sequence-sharded decode cache
        return cfg.with_overrides(decode_cache_seq=True)
    return cfg


def arg_bytes_per_rank(plan, mesh) -> int:
    """Bytes of every argument's shard on one rank of `mesh`."""
    total = 0
    for args, specs in zip(plan.args, plan.in_specs):
        leaves = []
        map_specs(leaves.append, specs)
        for a, s in zip(tree_leaves(args), leaves):
            total += math.prod(shard_shape(tuple(a.shape), s, mesh)) \
                * a.element_size()
    return total


def _spec_record(plan, cfg, shape, mesh) -> Dict[str, Any]:
    mf = roofline.model_flops(cfg, shape, plan.kind)
    return {
        "arch": cfg.name, "shape": shape.name, "kind": plan.kind,
        "chips": int(mesh.devices.size),
        **{k: None for k in (
            "flops_per_device", "hlo_flops_global", "bytes_per_device",
            "collective_bytes_per_device", "collective_breakdown",
            "compute_s", "memory_s", "collective_s", "dominant",
            "useful_flops_ratio", "roofline_bound_s", "peak_bytes",
            "fits_one_card")},
        "model_flops": mf,
        "memory": {"argument_bytes": arg_bytes_per_rank(plan, mesh),
                   "output_bytes": None, "temp_bytes": None,
                   "alias_bytes": None},
    }


def run_pair(arch: str, shape_name: str, *, mesh_kind: str = "1x1",
             mode: str = "baseline", out_dir: Optional[str] = None,
             verbose: bool = True, moe_impl: Optional[str] = None,
             tag: str = "", variant: Optional[str] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    """One (arch, shape) pair on the one-card mesh ("1x1", traced) or a
    production mesh ("16x16" / "2x16x16", traced per rank, or specs only
    with the failing op where the trace fails); writes
    ``{arch}__{shape}__{mesh}__{mode}[__{tag}].json`` under `out_dir`."""
    dev = resolve_device(device)
    cfg = _variant(ARCHS[arch], variant)
    shape = INPUT_SHAPES[shape_name]
    t0 = time.perf_counter()
    if mesh_kind == "1x1":
        mesh = one_card_mesh()
        tc = train_config(arch, cfg, shape, mesh)
        plan = make_plan(cfg, shape, mesh, mode=mode, tc=tc,
                         moe_impl=moe_impl, device=dev)
        counts = trace_plan(plan, dev)
        local = tc.federated.local_steps if plan.kind == "fed_local" else 1
        # one rank: no collective, nothing crosses a silo row of one card
        rec = roofline.analyze(
            {**counts, "collectives": []},
            resolve_arch_for_shape(cfg, shape), shape, plan.kind, chips=1,
            local_steps=local, silo_block=1)
        rec["peak_bytes"] = counts["peak_bytes"]
        rec["fits_one_card"] = counts["peak_bytes"] <= roofline.HW["hbm_bytes"]
        cost_source = "fake-tensor trace"
    else:
        with planning_mesh(**PLANNING_MESHES[mesh_kind]) as mesh:
            # silo boundary: a contiguous pod block or a data row (256 /
            # 16 ranks on the production meshes)
            block = int(mesh.devices.size) // num_silos(mesh)
            tc = train_config(arch, cfg, shape, mesh)
            plan = make_plan(cfg, shape, mesh, mode=mode, tc=tc,
                             moe_impl=moe_impl, device=dev)
            rcfg = resolve_arch_for_shape(cfg, shape)
            try:
                counts = trace_sharded(plan, mesh)
            except Exception as e:  # noqa: BLE001 - the record names it
                rec = _spec_record(plan, rcfg, shape, mesh)
                rec.update(cross_silo_bytes_per_device=None,
                           silo_block=block, trace_error=_failing_op(e))
                cost_source = "specs only"
            else:
                local = tc.federated.local_steps \
                    if plan.kind == "fed_local" else 1
                rec = roofline.analyze(counts, rcfg, shape, plan.kind,
                                       chips=int(mesh.devices.size),
                                       local_steps=local, silo_block=block)
                rec["peak_bytes"] = counts["peak_bytes"]
                rec["fits_one_card"] = \
                    counts["peak_bytes"] <= roofline.HW["hbm_bytes"]
                cost_source = "traced per rank"
    rec.update({"mesh": mesh_kind, "mode": mode, "plan": plan.name,
                "compile_s": time.perf_counter() - t0,
                "cost_source": cost_source})
    if verbose:
        m = rec["memory"]
        if rec["compute_s"] is None:
            print(f"== {plan.name} mesh={mesh_kind} chips={rec['chips']} "
                  f"specs={rec['compile_s']:.1f}s args/rank="
                  f"{m['argument_bytes'] / 2**30:.2f}GiB (specs only: "
                  f"{rec.get('trace_error')})")
        else:
            print(f"== {plan.name} mesh={mesh_kind} chips={rec['chips']} "
                  f"trace={rec['compile_s']:.1f}s peak="
                  f"{rec['peak_bytes'] / 2**30:.2f}GiB "
                  f"fits={rec['fits_one_card']} useful="
                  f"{rec['useful_flops_ratio']:.3f}")
            print(f"   memory: args={m['argument_bytes'] / 2**30:.2f}GiB "
                  f"out={m['output_bytes'] / 2**30:.2f}GiB "
                  f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
                  f"alias={m['alias_bytes'] / 2**30:.2f}GiB")
            print("   " + roofline.fmt_row(rec))
        sys.stdout.flush()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = f"{arch}__{shape_name}__{mesh_kind}__{mode}{suffix}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), action="append")
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), action="append")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (traced per rank)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes (traced per rank)")
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "feddcl", "feddcl_sync"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--moe-impl", default=None,
                    choices=["gspmd", "ep", "dense"])
    ap.add_argument("--variant", default=None,
                    choices=["rwkv_seq", "expand_kv", "cache_seq"])
    ap.add_argument("--tag", default="", help="suffix for output JSON names")
    ap.add_argument("--device", default="cuda",
                    help="the plan's device (default: cuda)")
    args = ap.parse_args(argv)

    resolve_device(args.device)        # no card and no --device cpu: raise
    archs = sorted(ARCHS) if (args.all or not args.arch) else args.arch
    shapes = sorted(INPUT_SHAPES) if (args.all or not args.shape) \
        else args.shape
    if args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    else:
        meshes = ["2x16x16"] if args.multi_pod else ["1x1"]

    failures = []
    for arch in archs:
        for shape in shapes:
            if args.mode == "feddcl" and INPUT_SHAPES[shape].kind != "train":
                continue
            for mk in meshes:
                try:
                    rec = run_pair(arch, shape, mesh_kind=mk, mode=args.mode,
                                   out_dir=args.out, moe_impl=args.moe_impl,
                                   tag=args.tag, variant=args.variant,
                                   device=args.device)
                    if rec.get("trace_error"):
                        failures.append((arch, shape, mk,
                                         rec["trace_error"]))
                        print(f"!! TRACE FAILED {arch} {shape} mesh={mk} "
                              f"(specs-only record): {rec['trace_error']}")
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((arch, shape, mk, repr(e)))
                    print(f"!! FAIL {arch} {shape} mesh={mk}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall requested dry-runs traced OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
