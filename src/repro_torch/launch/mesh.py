"""Meshes of ranks, and the launcher that starts them (counterpart of
``repro.launch.mesh``).

The reference's mesh is an array of devices that one program spans under
``shard_map``. The port's mesh shard is a process: a rank of an
initialized ``torch.distributed`` group, one DC server. Every rank calls
the same entry point with the same arguments (SPMD) and holds only its
shard of the silo stack. The mesh's axes are sub-groups of the default
group, built by ``torch.distributed.device_mesh.init_device_mesh`` over
the CPU: the collectives between DC servers go over ``gloo`` through host
memory, while each rank's silo compute stays on its own device
(``cuda:{rank % device_count}``, or the CPU). One H100 means every rank
shares ``cuda:0``; NCCL refuses two ranks on one card, and gloo does not
care where the compute ran.

Meshes (as the reference prescribes them):
  single-pod : (16, 16)    axes ("data", "model")        = 256 ranks
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 ranks

``run_ranks(fn, world)`` starts `world` ranks of one group and returns
what `fn` returned on each. It is how the tests, the drivers and
``chip_smoke.py`` shard step 4, and it never hangs: when a rank raises or
dies, every other rank is ended and the caller gets that rank's
traceback; past `timeout` every rank is ended too.

``use_mesh(mesh)`` is the counterpart of the reference's ``with mesh:``:
inside it ``current_mesh()`` is the mesh (what ``moe_ep`` and
``shardingx.constrain`` read). ``one_card_mesh()`` is the ("data",
"model") = (1, 1) mesh the port's LLM programs run on, and
``planning_mesh(multi_pod)`` a production mesh in one process (a
fake-backend group of 256 / 512 ranks) for the dry-run's specs and
per-rank traces: the counterpart of the reference's 512 placeholder
devices, which compute nothing. ``make_mesh(..., device="cuda")`` is the
mesh of a sharded LLM program on cards (on one card, with
``run_ranks(..., backend="staged")``).
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# ranks a driver's sharded leg spawns unless told otherwise (``--ranks`` of
# the audit, robust_ablation and fed_bench): the fewest that shard, and
# what one card holds beside its other work
DEFAULT_RANKS = 2

# the device a rank started by `run_ranks` computes on (None elsewhere)
_RANK_DEVICE: Optional[torch.device] = None


def rank_device() -> Optional[torch.device]:
    """This rank's compute device when `run_ranks` started the process:
    ``cuda:{rank % device_count}`` or the CPU; None in any other process."""
    return _RANK_DEVICE


class HostMesh:
    """A mesh of ranks: ``axis_names`` and ``devices`` (the ranks' ids in
    the mesh's shape) as a ``jax.sharding.Mesh`` has them, plus each axis's
    process sub-group for this rank. Build it with `make_host_mesh`,
    `make_mesh` or `make_production_mesh`, on every rank of the group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh: Any):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.device_mesh = device_mesh
        self.rank = dist.get_rank()
        # a planning mesh's group computes nothing (the fake backend)
        self.planning = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def signature(self) -> Tuple:
        """(axis names, shape): what a plan cache keys a mesh on."""
        return (self.axis_names, tuple(int(s) for s in self.devices.shape))

    def contains(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.rank < self.devices.size

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis`."""
        if not self.contains():
            raise ValueError(f"rank {self.rank} is not in the "
                             f"{self.devices.shape} mesh")
        where = np.argwhere(self.devices == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def group(self, axis: str):
        """The process group of this rank's neighbours along `axis`, in
        coordinate order."""
        return self.device_mesh.get_group(axis)

    def submesh(self, axes: Sequence[str]) -> "HostMesh":
        """The mesh of `axes` that holds this rank: its ranks are those
        sharing this rank's coordinates on the other axes, its
        ``device_mesh`` the matching slice of this one's (the
        counterpart of a ``shard_map`` body's view of the mesh's other
        axes)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        sub = object.__new__(HostMesh)
        sub.axis_names = axes
        sub.devices = self.devices[tuple(
            slice(None) if a in axes else self.coordinate(a)
            for a in self.axis_names)]
        sub.device_mesh = self.device_mesh[axes if len(axes) > 1
                                           else axes[0]]
        sub.rank, sub.planning = self.rank, self.planning
        return sub

    def axis_groups(self, axis: str) -> List[List[int]]:
        """Every group of ranks along `axis`, each in coordinate order (what
        an HLO ``replica_groups`` attribute lists for a collective over
        that axis)."""
        i = self.axis_names.index(axis)
        d = np.moveaxis(self.devices, i, -1)
        return d.reshape(-1, d.shape[-1]).tolist()

    def __repr__(self) -> str:
        return f"HostMesh({self.shape}, rank={self.rank})"


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh spans the ranks of an initialized torch.distributed "
            "group: start the ranks with repro_torch.launch.mesh.run_ranks "
            "(or init_process_group) first")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: str = "cpu") -> HostMesh:
    """A mesh of the given shape and axis names over the first
    prod(shape) ranks of the default group (the counterpart of
    ``jax.sharding.Mesh(devices.reshape(shape), axis_names)``). Every rank
    of the group calls it; a rank past the mesh holds no coordinate.

    `device` is the ``DeviceMesh``'s device type: "cpu" (the default: the
    sharded engine's collectives on host tensors) or "cuda", the mesh a
    sharded LLM program's DTensors live on, every rank's blocks on its
    ``cuda:{rank % device_count}`` (on one card all ranks share
    ``cuda:0``; start the ranks with ``run_ranks(..., backend="staged")``
    so DTensor's collectives stage through host memory into gloo,
    ``launch.staged``)."""
    shape = tuple(int(s) for s in shape)
    n = _world()
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes "
                         f"{tuple(axis_names)}")
    if math.prod(shape) > n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, but only {n} are "
                         "running")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"a mesh lives on 'cpu' or 'cuda', not {device!r}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device, shape, mesh_dim_names=tuple(axis_names))
    return HostMesh(shape, axis_names, dm)


def host_mesh_shape(n: int, model: int = 1,
                    data: Optional[int] = None) -> Tuple[int, int]:
    """The (data, model) shape `make_host_mesh` builds over `n` ranks:
    `model` must divide into the count; `data` defaults to the largest
    count with data x model ranks. A shape that cannot exist raises at
    once, naming the rank count."""
    if model < 1 or n // model < 1:
        raise ValueError(
            f"make_host_mesh: model={model} needs at least {model} ranks, "
            f"but only {n} are running")
    if data is None:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(
            f"make_host_mesh: requested {data}×{model} mesh needs "
            f"{data * model} ranks, but only {n} are running "
            f"(largest valid data for model={model} is {n // model})")
    return data, model


def make_host_mesh(model: int = 1, data: Optional[int] = None) -> HostMesh:
    """Small ("data", "model") mesh over the running ranks (tests,
    examples): ``host_mesh_shape`` over the group's size, e.g. 6 ranks
    with model=2 give a 3×2 mesh, model=4 a 1×4 one over the first 4."""
    data, model = host_mesh_shape(_world(), model, data)
    return make_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, need = _world(), math.prod(shape)
    if n != need:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"production mesh needs {need} ranks; {n} are "
                         "running")
    return make_mesh(shape, axes)


class PlanMesh:
    """A mesh of axis names and a shape, with no ranks behind it: what the
    specs and the one-card dry-run read (``axis_names``,
    ``devices.shape``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"PlanMesh({self.shape})"


def one_card_mesh() -> PlanMesh:
    """("data", "model") = (1, 1): the mesh the port's LLM programs run on
    (whole tensors on one card)."""
    return PlanMesh((1, 1), ("data", "model"))


_MESHES: List[Any] = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """``with use_mesh(mesh):`` — the counterpart of the reference's ``with
    mesh:``; nests, and the innermost mesh is `current_mesh()`."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The mesh of the innermost `use_mesh`, or None outside one (the
    counterpart of the reference's ``moe_ep._physical_mesh()``)."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def planning_mesh(multi_pod: bool = False, *, rank: int = 0,
                  shape: Optional[Sequence[int]] = None,
                  axis_names: Optional[Sequence[str]] = None
                  ) -> Iterator[HostMesh]:
    """The production mesh in this process, for specs and per-rank traces:
    when no group is initialized, a group of 256 (512 with `multi_pod`)
    ranks on torch's fake backend, this process `rank`, torn down on
    exit; else the running group's `make_production_mesh`. `shape` and
    `axis_names` give another mesh on the fake backend (a test's small
    one). A fake group's collectives move no data, so the mesh is marked
    ``planning``: the sharded engine refuses it, and ``moe_ep``'s
    exchange runs on it only on fake or meta tensors (a trace)."""
    own = not (dist.is_available() and dist.is_initialized())
    if shape is not None and not own:
        raise ValueError("a planning mesh of another shape needs no group "
                         "running")
    if own:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        world = math.prod(shape) if shape is not None \
            else (512 if multi_pod else 256)
        dist.init_process_group("fake", rank=rank, world_size=world,
                                store=FakeStore())
    try:
        mesh = make_production_mesh(multi_pod=multi_pod) if shape is None \
            else make_mesh(shape, axis_names)
        mesh.planning = own
        yield mesh
    finally:
        if own:
            dist.destroy_process_group()


def refuse_planning(mesh, what: str) -> None:
    """Raise when `mesh` is a `planning_mesh` of the fake backend: `what`
    would exchange data its group cannot move."""
    if getattr(mesh, "planning", False):
        raise ValueError(f"{what} needs ranks that move data; {mesh!r} is a "
                         "planning mesh on the fake backend (specs and "
                         "traces only)")


def silo_axis_name(mesh) -> str:
    return "pod" if "pod" in mesh.axis_names else "data"


def silo_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the compiled engine shards the silo dim over —
    ("pod", "data") jointly when both exist (hierarchical aggregation:
    intra-pod first, cross-pod second), else the first axis."""
    from repro_torch.core.federated import default_silo_axes
    return default_silo_axes(mesh)


def num_silos(mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes[silo_axis_name(mesh)]


# ==========================================================================
# The launcher
# ==========================================================================

class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback."""

    def __init__(self, rank: int, detail: str):
        super().__init__(f"rank {rank} failed:\n{detail}")
        self.rank = rank
        self.detail = detail


def _target_name(fn: Union[str, Callable]) -> str:
    """'package.module:function' for `fn`. A spawned rank imports the
    module by name, so it must be a module of an installed package (or of
    the path the parent runs with), never ``__main__`` or a test file."""
    if isinstance(fn, str):
        return fn if ":" in fn else "%s:%s" % tuple(fn.rsplit(".", 1))
    mod = getattr(fn, "__module__", None)
    if not mod or mod == "__main__" or "<locals>" in fn.__qualname__:
        raise ValueError(
            f"run_ranks needs a module-level function of an importable "
            f"module (got {fn!r} in {mod!r}); pass 'package.module:name'")
    return f"{mod}:{fn.__qualname__}"


def _resolve(target: str) -> Callable:
    mod, name = target.split(":")
    obj: Any = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _write(path: str, data: bytes) -> None:
    with open(path + ".part", "wb") as f:
        f.write(data)
    os.replace(path + ".part", path)


def _watch_parent(parent: int) -> None:
    """End this rank if the process that started it goes away."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(3)


def _rank_entry(spec_path: str, rank: int) -> None:
    """A rank's process: one thread, its device, the group, the target."""
    global _RANK_DEVICE
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    tmp, world = spec["tmp"], spec["world"]
    threading.Thread(target=_watch_parent, args=(spec["parent"],),
                     daemon=True).start()
    torch.set_num_threads(1)
    try:
        if spec["kind"] == "cuda":
            idx = rank % torch.cuda.device_count()
            torch.cuda.set_device(idx)
            _RANK_DEVICE = torch.device("cuda", idx)
        else:
            _RANK_DEVICE = torch.device("cpu")
        if spec["backend"] == "staged":
            from repro_torch.launch import staged
            staged.register(spec["kind"])
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=world,
            # past the launcher's own deadline: it ends a hung group first
            timeout=datetime.timedelta(seconds=spec["timeout"] + 60.0))
        out = _resolve(spec["target"])(*spec["args"], **spec["kwargs"])
        _write(os.path.join(tmp, f"result_{rank}.pkl"), pickle.dumps(out))
        dist.destroy_process_group()
    except BaseException:
        # the rank's outermost boundary: report for the launcher, then end
        # the process at once (a gloo thread may still wait on a peer)
        _write(os.path.join(tmp, f"error_{rank}.txt"),
               # the system-wide monotonic clock orders the ranks' failures
               f"{time.monotonic()!r}\n{traceback.format_exc()}".encode())
        sys.stderr.flush()
        os._exit(1)


def _first_error(tmp: str, codes: List[Optional[int]]) -> Tuple[int, str]:
    """The rank whose failure came first (the others' are often a broken
    connection to it), with its traceback."""
    errs = []
    for r in range(len(codes)):
        path = os.path.join(tmp, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                stamp, _, tb = f.read().partition("\n")
            errs.append((float(stamp), r, tb))
    if errs:
        _, r, tb = min(errs)
        return r, tb
    r = next(r for r, c in enumerate(codes) if c not in (None, 0))
    return r, f"rank {r} died with exit code {codes[r]}"


def run_ranks(fn: Union[str, Callable], world: int, *, args: Tuple = (),
              kwargs: Optional[Dict] = None, device: DeviceLike = None,
              timeout: float = 600.0, backend: str = "gloo") -> List[Any]:
    """Start `world` ranks of one gloo group and run ``fn(*args,
    **kwargs)`` on each; returns the list of what each rank returned
    (picklable; tensors on the CPU), by rank. ``backend="staged"``
    also gives each rank ``launch.staged``'s kernels for the functional
    collectives on its device type (host staging into the gloo group,
    for DTensors on a card).

    `fn` is a module-level function or its 'package.module:name'. Ranks
    are fresh Python processes (they import the target's module, never the
    caller's script) of one thread each, meeting at a ``file://`` store in
    a fresh temporary directory, with `timeout` on their group. They
    compute on the card (``rank_device()``: ``cuda:{rank %
    device_count}``) unless ``device="cpu"``; without a card and without
    ``device="cpu"`` this raises before starting anything.

    When a rank raises or dies, every rank still running is ended and
    `RankError` carries the failing rank's traceback; when `timeout`
    seconds pass first, every rank is ended and `TimeoutError` names the
    ranks still running. No process outlives the call."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    kind = resolve_device(device).type
    if backend not in ("gloo", "staged"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'staged'")
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"ranks compute on 'cpu' or 'cuda', not {kind!r}")
    target = _target_name(fn)
    tmp = tempfile.mkdtemp(prefix="ranks-")
    spec_path = os.path.join(tmp, "spec.pkl")
    _write(spec_path, pickle.dumps({
        "target": target, "args": tuple(args),
        "kwargs": dict(kwargs or {}), "kind": kind, "tmp": tmp,
        "world": world, "timeout": timeout, "parent": os.getpid(),
        "backend": backend}))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [p for p in sys.path if p and os.path.isdir(p)]))
    code = ("import sys; from repro_torch.launch.mesh import _rank_entry; "
            "_rank_entry(sys.argv[1], int(sys.argv[2]))")
    procs: List[subprocess.Popen] = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, spec_path, str(r)], env=env,
                stdin=subprocess.DEVNULL))
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                time.sleep(0.2)          # let a root cause write its report
                raise RankError(*_first_error(tmp, [p.poll()
                                                    for p in procs]))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(
                    f"run_ranks: ranks {running} of {world} still running "
                    f"after {timeout:.0f} s; every rank ended")
            time.sleep(0.02)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def launcher_selfcheck(fail_rank: int = -1, hang_rank: int = -1) -> int:
    """A rank target that checks the launcher: rank `fail_rank` raises,
    and rank `hang_rank` sleeps, while every other rank waits in an
    all-reduce that can only finish with them; with neither, the
    all-reduce gives the rank count."""
    if dist.get_rank() == fail_rank:
        raise ValueError(f"rank {fail_rank} fails before the collective")
    if dist.get_rank() == hang_rank:
        time.sleep(3600.0)
    x = torch.ones(1)
    dist.all_reduce(x)
    return int(x.item())
