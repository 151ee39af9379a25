"""Rank targets for step 4 across DC-server processes: what each rank of
``launch.mesh.run_ranks`` runs when the tests, the drivers and
``chip_smoke.py`` shard FedDCL's federated phase (and, in `moe_ep_layer`,
the expert-parallel MoE layer over the model ranks).

Every target takes one picklable `spec` dict, runs on every rank of the
group (SPMD: the same spec everywhere) and returns NumPy results, so the
parent process, which may hold the JAX reference as its oracle, compares
them. The ranks import nothing of JAX or of the reference.

spec keys shared by the targets:
  mesh   {"model": m[, "data": d]} for ``make_host_mesh``, or
         {"shape": (...), "names": (...)} for ``make_mesh``;
  silos  a list of (X, Y) arrays, or the path of an ``.npz`` holding
         X0, Y0, X1, Y1, … (``save_silos``);
  task   the MLP's loss: "regression" or "classification";
  params the MLP's initial params, a tree of NumPy arrays;
  device a torch device; default: the rank's own (``rank_device()``).
"""
from __future__ import annotations

import os
import tempfile
from functools import partial
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import federated
from repro_torch.launch.mesh import (make_host_mesh, make_mesh, rank_device,
                                     silo_axis_name, num_silos)
from repro_torch.models import mlp
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy, params_to_numpy


def save_silos(path: str, silos: Sequence[Tuple[np.ndarray, np.ndarray]]
               ) -> str:
    """Write silos for the `silos` key of a spec (through a temporary
    file moved into place); returns `path`."""
    arrays = {}
    for i, (X, Y) in enumerate(silos):
        arrays[f"X{i}"], arrays[f"Y{i}"] = np.asarray(X), np.asarray(Y)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _silos(spec: Dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    src = spec["silos"]
    if not isinstance(src, str):
        return list(src)
    with np.load(src) as f:
        return [(f[f"X{i}"], f[f"Y{i}"]) for i in range(len(f.files) // 2)]


def _mesh(spec: Dict):
    m = spec["mesh"]
    if "shape" in m:
        return make_mesh(m["shape"], m["names"])
    return make_host_mesh(model=m.get("model", 1), data=m.get("data"))


def _device(spec: Dict) -> torch.device:
    return torch.device(spec.get("device") or rank_device())


def make_opt(name: str, lr: float, momentum: float = 0.0):
    """("adamw", lr) or ("sgd", lr[, momentum]) as an optimizer."""
    if name == "adamw":
        return adamw(lr)
    if name == "sgd":
        return sgd(lr, momentum=momentum)
    raise ValueError(f"unknown optimizer {name!r}")


def _loss(task: str):
    return partial(mlp.mlp_per_example_loss, task=task)


def _first_leaf_mean_abs(p) -> Dict[str, float]:
    """The reference's streamed-eval probe: mean |first leaf|."""
    return {"w0": float(torch.mean(torch.abs(tree_leaves(p)[0])))}


def fit(spec: Dict) -> Dict[str, Any]:
    """``run_federated(engine="scan", mesh=...)`` once per entry of
    ``spec["runs"]`` (keyword arguments of run_federated; "opt" is a
    ``make_opt`` tuple, "eval": "w0" streams the reference's probe,
    "unsharded": True runs without the mesh), on one mesh, with one set of
    silos and initial params. Returns this rank's {"rank", "coords",
    "runs": [{"params", "history", "collectives", "timings",
    "cache_stats"}]}. A run with "fresh_mesh": True first destroys the
    mesh's sub-groups (all but the default group) and builds the mesh
    anew."""
    dev = _device(spec)
    mesh = _mesh(spec)
    silos = _silos(spec)
    loss = _loss(spec.get("task", "regression"))
    params = params_from_numpy(spec["params"], dev)
    out = []
    for run in spec["runs"]:
        kw = dict(run)
        opt = make_opt(*kw.pop("opt"))
        if kw.pop("fresh_mesh", False):
            world = dist.group.WORLD.group_name
            for g in {g.group_name: g for g in map(
                    mesh.group, mesh.axis_names)}.values():
                if g.group_name != world:
                    dist.destroy_process_group(g)
            mesh = _mesh(spec)
        if kw.pop("eval", None) == "w0":
            kw["eval_fn"] = _first_leaf_mean_abs
        res = federated.run_federated(
            loss, params, silos, opt=opt, engine="scan", device=dev,
            mesh=None if kw.pop("unsharded", False) else mesh, **kw)
        out.append({"params": params_to_numpy(res.params),
                    "history": res.history, "collectives": res.collectives,
                    "timings": res.timings, "cache_stats": res.cache_stats})
    return {"rank": dist.get_rank(),
            "coords": {a: mesh.coordinate(a) for a in mesh.axis_names},
            "runs": out}


def lowered(spec: Dict) -> List[Dict[str, Any]]:
    """For each (aggregator, local_epochs) of ``spec["cases"]``: a sharded
    plan over the silos (padded to the shard multiple, batch
    ``spec["batch"]``), lowered (``lower_fl_plan``, 2 rounds), held to
    ``assert_no_baked_data`` at ``spec["min_elems"]``; returns its
    ``collective_census``, what its idle plan holds
    (``find_baked_constants``) and the param leaf count."""
    from repro_torch.analysis.hlo_audit import (assert_no_baked_data,
                                                collective_census,
                                                find_baked_constants)
    dev = _device(spec)
    mesh = _mesh(spec)
    shards = federated.num_silo_shards(mesh)
    silos = _silos(spec)
    padded = federated.pad_silo_data(
        silos, spec["batch"], min_silos=-(-len(silos) // shards) * shards)
    params = params_from_numpy(spec["params"], dev)
    batch_loss = federated._make_batch_loss(_loss(spec["task"]), True, 0.0)
    min_elems = spec.get("min_elems", 512)
    out = []
    for aggregator, epochs in spec["cases"]:
        plan = federated.make_fl_plan(
            num_silos=padded.num_silos, num_batches=padded.num_batches,
            batch_size=padded.batch_size, opt=adamw(1e-2),
            batch_loss=batch_loss, local_epochs=epochs,
            aggregator=aggregator, masked=True, device=dev, mesh=mesh)
        low = federated.lower_fl_plan(plan, params, padded, rounds=2, seed=3)
        assert_no_baked_data(low, min_elems=min_elems)
        out.append({"aggregator": aggregator, "epochs": epochs,
                    "census": collective_census(low),
                    "idle": find_baked_constants(plan, min_elems),
                    "leaves": len(tree_leaves(params))})
    return out


def describe_mesh(spec: Dict) -> Dict[str, Any]:
    """What this rank sees of its mesh: axis names, shape, silo axes and
    shards, and the messages of the checks that must raise (silo axes not
    in the mesh; the host engine with a mesh); and, for each (model,
    data) of ``spec["host_meshes"]``, the shape ``make_host_mesh`` builds
    or the message it raises."""
    mesh = _mesh(spec)
    facts: Dict[str, Any] = {
        "axis_names": mesh.axis_names, "shape": mesh.devices.shape,
        "default_silo_axes": federated.default_silo_axes(mesh),
        "num_silo_shards": federated.num_silo_shards(mesh),
        "silo_axis_name": silo_axis_name(mesh), "num_silos": num_silos(mesh)}
    try:
        federated.num_silo_shards(mesh, ("nope",))
    except ValueError as e:
        facts["bad_axes"] = str(e)
    silos = _silos(spec)
    params = params_from_numpy(spec["params"], "cpu")
    try:
        federated.run_federated(_loss("regression"), params, silos,
                                opt=adamw(1e-2), rounds=1, local_epochs=1,
                                engine="host", mesh=mesh, device="cpu")
    except ValueError as e:
        facts["host_engine"] = str(e)
    facts["host_meshes"] = []
    for model, data in spec.get("host_meshes", []):
        try:
            facts["host_meshes"].append(
                make_host_mesh(model=model, data=data).devices.shape)
        except ValueError as e:
            facts["host_meshes"].append(str(e))
    return facts


def moe_ep_layer(spec: Dict) -> Dict[str, Any]:
    """The expert-parallel MoE layer (``models.moe_ep.apply_moe_ep``) on
    every ("data", "model") mesh of ``spec["meshes"]`` (each built over the
    first ranks of the group, on every rank), for every case of
    ``spec["cases"]``: {"name", "cfg" (a ModelConfig with a moe), "params"
    (the layer's moe params, NumPy), "x" and "cot" (B, S, d), "aux_coef"}.

    A rank of the mesh takes its batch block of x, runs the layer under
    ``use_mesh`` and takes gradients of its share of the loss sum(out ·
    cot) + aux_coef · aux: the out·cot terms of its own S/M slice of the
    block (the tokens it routes) plus aux_coef · aux. Returns {(mesh,
    name): {"coords", "out" (its block), "aux", "grads" (params and "x",
    its block), "stats" (the exchange's, for one forward and backward)}}
    for the meshes that hold it; with ``spec["repeats"]`` the forward and
    backward run that many more times first, and "seconds" times the
    last one."""
    import time

    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch import staged
    from repro_torch.models import moe_ep

    dev = _device(spec)
    out: Dict[Any, Any] = {}
    for shape in spec["meshes"]:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        if not mesh.contains():
            continue
        D, M = shape
        dd, m = mesh.coordinate("data"), mesh.coordinate("model")
        for case in spec["cases"]:
            cfg = case["cfg"]
            p = params_from_numpy(case["params"], dev)
            leaves = tree_leaves(p)
            x_all = torch.as_tensor(case["x"], device=dev)
            B, S, _ = x_all.shape
            rows = slice(dd * B // D, (dd + 1) * B // D)
            cols = slice(m * S // M, (m + 1) * S // M)
            cot = torch.as_tensor(case["cot"], device=dev)[rows, cols]

            def once():
                for t in leaves:
                    t.requires_grad_(True)
                x = x_all[rows].clone().requires_grad_(True)
                with use_mesh(mesh):
                    o, aux = moe_ep.apply_moe_ep(p, x, cfg)
                loss = torch.sum(o[:, cols] * cot) + case["aux_coef"] * aux
                gs = torch.autograd.grad(loss, leaves + [x],
                                         allow_unused=True)
                return o, aux, gs

            for _ in range(spec.get("repeats", 0)):
                once()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            staged.STATS.reset()
            t0 = time.perf_counter()
            o, aux, gs = once()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            it = iter(gs[:-1])
            grads = params_to_numpy(tree_map(
                lambda t: _grad_or_zeros(next(it), t), p))
            grads["x"] = gs[-1].detach().cpu().numpy()
            out[(tuple(shape), case["name"])] = {
                "coords": (dd, m), "out": o.detach().cpu().numpy(),
                "aux": float(aux.detach()), "grads": grads,
                "stats": staged.STATS.as_dict(), "seconds": seconds}
    return out


def _grad_or_zeros(g, t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t) if g is None else g.detach()


def serial(jobs: Sequence[Tuple]) -> List[Any]:
    """Several rank targets in one group, in order: ``[(name, *args),
    ...]`` -> what each returned (one spawn serves many checks). A name is
    a target of this module or 'package.module:function'."""
    from repro_torch.launch.mesh import _resolve
    return [(_resolve(name) if ":" in name else globals()[name])(*args)
            for name, *args in jobs]
