"""Rank targets of the sharded LLM program (``launch.mesh.run_ranks``).

Each rank of a ("data", "model") mesh runs the cases of a spec on its
blocks of the arguments, laid out by the plans' specs
(``launch.specs.LoweringPlan.place``) under ``launch.mesh.use_mesh``, and
returns every result gathered whole as NumPy (the same on every rank). A
spawned rank imports its target by name, so the targets live here and not
in a test module.

A case is a dict with a ``kind``:
  * ``train``: `steps` baseline train steps from ``params`` on
    ``batches``; -> each step's metrics, the first step's loss and
    gradients (``loss_and_grads`` on the initial params) and the params
    after the last step;
  * ``grads``: the loss and gradients of ``batch`` at ``params``;
  * ``serve``: a prefill of ``tokens`` into a cache of ``cache_len``, its
    state laid out by the decode plan's ``cache_specs``, then `steps`
    greedy decode steps; -> the prefill's and each step's logits and
    the tokens;
  * ``moe_ep``: granite's expert-parallel MoE layer with its FSDP gather,
    forward and gradient of sum(out · cot) + ``aux_coef`` · aux, with the
    collectives it issued by kind;
  * ``fed_local``: the FedDCL local step (the ``feddcl`` plan: each rank
    on its own silos, each silo on the sub-mesh of the other axes) on a
    silo stack ``params`` and a (d, b, S) ``batch``; -> the params after
    the step and its (d,) metrics;
  * ``sync``: the federated round boundary (``aggregator``) on a silo
    stack ``params``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import REDUCED
from repro_torch.configs.base import (FederatedConfig, InputShape,
                                      TrainConfig)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh, rank_device, use_mesh
from repro_torch.launch.specs import make_plan
from repro_torch.models import backbone as bb
from repro_torch.shardingx.constrain import is_dtensor, replicated_plain
from repro_torch.shardingx.policy import (P, distribute_tree, local_tree,
                                          param_specs)
from repro_torch.tree import tree_leaves, tree_map


def whole(tree: Any) -> Any:
    """Every tensor of `tree` whole (a DTensor gathered) as NumPy."""
    def one(t):
        if is_dtensor(t):
            t = t.full_tensor()
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return t
    return tree_map(one, tree)


def _tensors(tree: Any, dev: torch.device) -> Any:
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev), tree)


def train_config(cfg, shape: InputShape, **kw) -> TrainConfig:
    return TrainConfig(model=cfg, shape=shape, **kw)


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor], cfg,
                   compute_dtype=torch.float32, use_kernels: bool = False,
                   remat: bool = True):
    """(loss, gradients laid out as `params`) of ``bb.loss_fn``; on
    DTensor params under the mesh in context."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with replicated_plain(is_dtensor(leaves[0])):
        loss, _ = bb.loss_fn(tree, batch, cfg, use_kernels=use_kernels,
                             remat=remat, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, live)
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


def _cfg(case: Dict):
    """The case's REDUCED config: ``moe_impl`` its MoE dispatch, and
    ``no_drop`` a capacity at which no (token, expert) pair is dropped
    (capacity_factor = E / top_k)."""
    cfg = REDUCED[case["arch"]]
    if cfg.moe is not None:
        mo = cfg.moe
        if case.get("moe_impl"):
            mo = dataclasses.replace(mo, impl=case["moe_impl"])
        if case.get("no_drop"):
            mo = dataclasses.replace(
                mo, capacity_factor=mo.num_experts / mo.top_k)
        cfg = cfg.with_overrides(moe=mo)
    return cfg


def _train(case: Dict, mesh, dev) -> Dict[str, Any]:
    cfg = _cfg(case)
    B, S = np.asarray(case["batches"][0]["tokens"]).shape
    shape = InputShape("t", seq_len=S, global_batch=B, kind="train")
    tc = train_config(cfg, shape, **case["tc"])
    plan = make_plan(cfg, shape, mesh, tc=tc, device=dev)
    params = _tensors(case["params"], dev)
    opt = steps_lib.make_optimizer(tc)
    batches = [_tensors(b, dev) for b in case["batches"]]
    sp, so, b0 = plan.place((params, opt.init(params), batches[0]))
    out: Dict[str, Any] = {}
    with use_mesh(mesh):
        loss, grads = loss_and_grads(sp, b0, cfg)
        out["loss"], out["grads"] = float(whole(loss)), whole(grads)
        metrics, seconds = [], []
        for i, b in enumerate(batches):
            bi = b0 if i == 0 else distribute_tree(b, plan.in_specs[2], mesh)
            t0 = time.perf_counter()
            sp, so, m = plan.step_fn(sp, so, bi)
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
    out.update(metrics=metrics, params=whole(sp), seconds=seconds,
               step=int(whole(so["step"])))
    return out


def _grads(case: Dict, mesh, dev) -> Dict[str, Any]:
    cfg = _cfg(case)
    params = _tensors(case["params"], dev)
    batch = _tensors(case["batch"], dev)
    B = batch["tokens"].shape[0]
    specs = param_specs(params, mesh)
    bspec = P("data", None) if B % mesh.shape["data"] == 0 else P(None, None)
    sp = distribute_tree(params, specs, mesh)
    sb = distribute_tree(batch, {k: bspec for k in batch}, mesh)
    with use_mesh(mesh):
        loss, grads = loss_and_grads(sp, sb, cfg,
                                     remat=case.get("remat", True))
    return {"loss": float(whole(loss)), "grads": whole(grads)}


def _serve(case: Dict, mesh, dev) -> Dict[str, Any]:
    cfg = _cfg(case)
    tokens = torch.as_tensor(np.asarray(case["tokens"])).to(dev)
    B, S = tokens.shape
    cache_len = case["cache_len"]
    params = _tensors(case["params"], dev)
    dtype = getattr(torch, case.get("dtype", "float32"))
    pre = make_plan(cfg, InputShape("p", seq_len=S, global_batch=B,
                                    kind="prefill"), mesh, device=dev)
    dec = make_plan(cfg, InputShape("d", seq_len=cache_len, global_batch=B,
                                    kind="decode"), mesh, device=dev)
    prefill = steps_lib.make_prefill_step(
        cfg, cache_len=cache_len, compute_dtype=dtype, cache_dtype=dtype,
        use_kernels=False, device=dev)
    serve = steps_lib.make_serve_step(cfg, compute_dtype=dtype, device=dev)
    sp, sb = pre.place((params, {"tokens": tokens}))
    sspec, tspec, pspec = dec.in_specs[1:]
    with use_mesh(mesh):
        logits, state, pos = prefill(sp, sb)
        logits = logits.full_tensor()
        state = distribute_tree(state, sspec, mesh)     # cache_specs
        out = {"prefill": logits.cpu().numpy()}
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        step_logits, toks = [], [tok.cpu().numpy()]
        for _ in range(case["steps"]):
            lg, state = serve(sp, state,
                              distribute_tree(tok[:, None], tspec, mesh),
                              distribute_tree(pos, pspec, mesh))
            lg = lg.full_tensor()
            step_logits.append(lg.cpu().numpy())
            tok = lg[:, -1].argmax(-1).to(torch.int32)
            toks.append(tok.cpu().numpy())
            pos = pos + 1
    out.update(steps=step_logits, tokens=toks)
    return out


def _moe_ep(case: Dict, mesh, dev) -> Dict[str, Any]:
    from repro_torch.models import moe_ep

    cfg = _cfg(case)
    p = _tensors(case["params"], dev)
    x = torch.as_tensor(np.asarray(case["x"])).to(dev)
    cot = torch.as_tensor(np.asarray(case["cot"])).to(dev)
    specs = moe_ep.layer_specs(p, mesh)
    sp = distribute_tree(p, specs, mesh)
    sx, scot = distribute_tree((x, cot), (moe_ep.x_spec(mesh),) * 2, mesh)
    leaves = tree_leaves(sp)
    live = [t.detach().requires_grad_() for t in leaves]
    it = iter(live)
    tree = tree_map(lambda _: next(it), sp)
    xl = sx.detach().requires_grad_()
    from repro_torch.launch.dryrun import CollectiveCounter

    counter = CollectiveCounter(mesh)
    with use_mesh(mesh), replicated_plain(), counter:
        t0 = time.perf_counter()
        out, aux = moe_ep.apply_moe_ep(tree, xl, cfg)
        loss = torch.sum(out * scot) + case["aux_coef"] * aux
        grads = torch.autograd.grad(loss, live + [xl])
        seconds = time.perf_counter() - t0
    it = iter(grads[:-1])
    g = tree_map(lambda _: next(it), sp)
    g["x"] = grads[-1]
    kinds: Dict[str, int] = {}
    for r in counter.records:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return {"out": whole(out), "aux": float(whole(aux)), "grads": whole(g),
            "seconds": seconds, "collectives": kinds}


def _fed_local(case: Dict, mesh, dev) -> Dict[str, Any]:
    cfg = _cfg(case)
    stack = _tensors(case["params"], dev)
    batch = _tensors(case["batch"], dev)
    d, b, S = batch["tokens"].shape
    shape = InputShape("t", seq_len=S, global_batch=d * b, kind="train")
    tc = train_config(cfg, shape, federated=FederatedConfig(num_silos=d),
                      **case["tc"])
    plan = make_plan(cfg, shape, mesh, mode="feddcl", tc=tc, device=dev)
    opt = steps_lib.make_optimizer(tc)
    sp, so, sb = plan.place((stack, steps_lib.silo_opt_init(opt, stack),
                             batch))
    with use_mesh(mesh):
        sp, so, m = plan.step_fn(sp, so, sb)
    return {"params": whole(sp), "metrics": whole(m),
            "step": whole(so["step"])}


def _sync(case: Dict, mesh, dev) -> Dict[str, Any]:
    cfg = _cfg(case)
    stack = _tensors(case["params"], dev)
    d = tree_leaves(stack)[0].shape[0]
    tc = TrainConfig(model=cfg, shape=InputShape("t", 8, d, "train"),
                     federated=FederatedConfig(
                         num_silos=d, aggregator=case["aggregator"],
                         krum_f=case.get("krum_f", 1)))
    specs = param_specs(stack, mesh, fsdp=tc.fsdp, silo_dim=True,
                        silo_axis="data")
    opt = steps_lib.make_optimizer(tc)
    so = steps_lib.silo_opt_init(opt, stack)
    sync = steps_lib.make_fedavg_sync_step(tc, device=dev)
    sp = distribute_tree(stack, specs, mesh)
    so = distribute_tree(so, {"step": P("data"), "m": specs, "v": specs},
                         mesh)
    with use_mesh(mesh):
        sp, so = sync(sp, so)
    return {"params": whole(sp),
            "opt_zero": all(float(t.abs().max()) == 0.0
                            for t in tree_leaves(local_tree(so)))}


_KINDS = {"train": _train, "grads": _grads, "serve": _serve,
          "moe_ep": _moe_ep, "fed_local": _fed_local, "sync": _sync}


def sharded_cases(spec: Dict) -> List[Dict[str, Any]]:
    """Every case of `spec` on a ("data", "model") mesh of
    ``spec["mesh"]``; -> their results, in order, each with its
    ``seconds`` on this rank."""
    dev = rank_device() or torch.device("cpu")
    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"),
                     device=dev.type)
    out = []
    for case in spec["cases"]:
        t0 = time.perf_counter()
        res = _KINDS[case["kind"]](case, mesh, dev)
        res["case_seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


# --------------------------------------------------------------------------
# the card: a probe of gloo, and the full-width program on ranks of one card
# --------------------------------------------------------------------------

PROBED = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single")


def gloo_probe(names: Tuple[str, ...]) -> Dict[str, str]:
    """Whether a plain gloo group takes this rank's CUDA tensors for each
    functional collective of `names` (of `PROBED`), one after the other:
    "ok" with the result right, else the error's first line. A crash of
    gloo itself ends the rank and so the group's remaining probes."""
    return {name: _probe_one(name) for name in names}


def _probe_one(name: str) -> str:
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    dev = rank_device()
    g, n, r = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * n, dtype=torch.float32, device=dev) + r
    base = torch.arange(2 * n, dtype=torch.float32)
    calls = {
        "all_reduce": (lambda: funcol.all_reduce(x, "sum", g),
                       n * base + n * (n - 1) / 2),
        "all_gather_into_tensor": (
            lambda: funcol.all_gather_tensor(x, 0, g),
            torch.cat([base + i for i in range(n)])),
        "reduce_scatter_tensor": (
            lambda: funcol.reduce_scatter_tensor(x, "sum", 0, g),
            (n * base + n * (n - 1) / 2).chunk(n)[r]),
        "all_to_all_single": (
            lambda: funcol.all_to_all_single(x, None, None, g),
            torch.cat([(base + i).chunk(n)[r] for i in range(n)]))}
    fn, want = calls[name]
    try:
        got = funcol.wait_tensor(fn())
        _sync(dev)
    except Exception as e:  # noqa: BLE001 - the probe reports it
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"[:200]
    if not torch.equal(got.cpu(), want):
        return f"wrong result {got.cpu().tolist()} (want {want.tolist()})"
    return "ok"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def card_llama(spec: Dict) -> Dict[str, Any]:
    """llama3.2-1b at full width and depth on a ("data", "model") mesh of
    the running ranks, every rank on its card (``chip_smoke.py``'s phase
    ``sharded_llm``): one fp32 loss and gradient at ``check`` tokens held
    to the unsharded computation on rank 0's card (gaps over every leaf,
    gathered leaf by leaf), then one fp32 train step of the plan there
    (``check_tc``: its TrainConfig overrides) held to ``make_train_step``,
    then ``steps`` train steps at ``train`` tokens
    in ``compute_dtype``, timed, with the staged collectives' counts; then
    granite's expert-parallel MoE layer (``ep``) with its FSDP gather,
    held to the per-block emulation on rank 0."""
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import staged
    from repro_torch.models import layers as model_layers, moe_ep

    dev = rank_device()
    rank = dist.get_rank()
    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"),
                     device=dev.type)
    archs = REDUCED if spec.get("reduced") else ARCHS
    cfg = archs["llama3.2-1b"]
    out: Dict[str, Any] = {"rank": rank}
    params = bb.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.float32, device=dev)
    B, S = spec["check"]
    batch = _tensors(TokenStream(cfg.vocab_size, S, B, seed=3).batch(0), dev)
    ref_grads = None
    if rank == 0:
        loss0, ref_grads = loss_and_grads(params, batch, cfg)
        out["loss_unsharded"] = float(loss0)
    shape = InputShape("t", seq_len=S, global_batch=B, kind="train")
    tc = train_config(cfg, shape, compute_dtype="float32",
                      **spec.get("check_tc", {}))
    plan = make_plan(cfg, shape, mesh, tc=tc, device=dev)
    sp = distribute_tree(params, plan.in_specs[0], mesh)
    sb = distribute_tree(batch, plan.in_specs[2], mesh)
    if rank != 0:
        del params
    staged.STATS.reset()
    _sync(dev)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        loss, grads = loss_and_grads(sp, sb, cfg)
        loss = float(whole(loss))
    _sync(dev)
    out["check_s"] = time.perf_counter() - t0
    out["check_collectives"] = staged.STATS.as_dict()
    gaps = []
    for g_sh, g_ref in zip(tree_leaves(grads),
                           tree_leaves(ref_grads) if rank == 0
                           else [None] * len(tree_leaves(grads))):
        full = g_sh.full_tensor()
        if rank == 0:
            gaps.append(_max_gap(full, g_ref) / max(
                1.0, float(g_ref.abs().max())))
        del full
    del grads, ref_grads
    if rank == 0:
        out["loss_gap"] = abs(loss - out["loss_unsharded"]) / max(
            1.0, abs(out["loss_unsharded"]))
        out["grad_gap"] = max(gaps)
    out["loss_sharded"] = loss

    # one fp32 train step of the plan against the unsharded step
    out.update(_check_step(cfg, tc, plan, mesh, sp, sb,
                           params if rank == 0 else None, batch, dev))
    if rank == 0:
        del params

    # the timed steps, in the spec's compute dtype
    B, S = spec["train"]
    shape = InputShape("t", seq_len=S, global_batch=B, kind="train")
    tc = train_config(cfg, shape, compute_dtype=spec["compute_dtype"])
    plan = make_plan(cfg, shape, mesh, tc=tc, device=dev)
    opt = steps_lib.make_optimizer(tc)
    so = _opt_init_sharded(opt, sp, plan.in_specs[1], mesh)
    stream = TokenStream(cfg.vocab_size, S, B, seed=5)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    with use_mesh(mesh):
        for i in range(spec["steps"]):
            b = distribute_tree(_tensors(stream.batch(i), dev),
                                plan.in_specs[2], mesh)
            staged.STATS.reset()
            _sync(dev)
            t0 = time.perf_counter()
            sp, so, m = plan.step_fn(sp, so, b)
            _sync(dev)
            steps.append({"s": time.perf_counter() - t0,
                          "loss": float(m["loss"]),
                          "collectives": staged.STATS.as_dict()})
    out["steps"] = steps
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else None
    del sp, so
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # granite's expert-parallel layer with the FSDP gather
    gcfg = archs["granite-moe-1b-a400m"]
    gcfg = gcfg.with_overrides(moe=dataclasses.replace(gcfg.moe, impl="ep"))
    p = model_layers.init_moe(torch.Generator(device=dev).manual_seed(11),
                              gcfg, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    EB, ES = spec["ep"]
    x = torch.randn((EB, ES, gcfg.d_model), generator=gen, device=dev)
    sp = distribute_tree(p, moe_ep.layer_specs(p, mesh), mesh)
    sx = distribute_tree(x, moe_ep.x_spec(mesh), mesh)
    times = []
    with use_mesh(mesh), torch.no_grad():
        for _ in range(spec["ep_repeats"]):
            staged.STATS.reset()
            _sync(dev)
            t0 = time.perf_counter()
            y, aux = moe_ep.apply_moe_ep(sp, sx, gcfg)
            y = y.full_tensor()
            aux = float(whole(aux))
            _sync(dev)
            times.append(time.perf_counter() - t0)
    out["ep_s"] = times
    out["ep_collectives"] = staged.STATS.as_dict()
    if rank == 0:
        D, M = spec["mesh"]
        blocks = [moe_ep.emulate_ep(p, xb, gcfg, M) for xb in x.chunk(D)]
        want = torch.cat([o for o, _ in blocks])
        want_aux = float(torch.stack([a for _, a in blocks]).mean())
        out["ep_out_gap"] = _max_gap(y, want) / max(
            1.0, float(want.abs().max()))
        out["ep_aux_gap"] = abs(aux - want_aux)
    return out


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 (the tests' relative Frobenius)."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _check_step(cfg, tc, plan, mesh, sp, sb, params, batch, dev
                ) -> Dict[str, Any]:
    """The plan's train step once on the DTensor params `sp` (updated in
    place) against ``make_train_step`` on a copy of rank 0's whole
    `params`: the loss gap and the params' gap after the step (relative
    Frobenius, the largest leaf), and the gap of the update itself."""
    import torch.distributed as dist

    rank = dist.get_rank()
    opt = steps_lib.make_optimizer(tc)
    so = _opt_init_sharded(opt, sp, plan.in_specs[1], mesh)
    res: Dict[str, Any] = {}
    before = None
    if rank == 0:
        # copies: a replicated block of `sp` may share `params`' storage,
        # and both steps update in place
        before = [t.detach().clone() for t in tree_leaves(params)]
        params = tree_map(lambda t: t.detach().clone(), params)
        step, ropt = steps_lib.make_train_step(cfg, tc, use_kernels=False,
                                               device=dev)
        _, ost, m0 = step(params, ropt.init(params), batch)
        res["step_loss_unsharded"] = float(m0["loss"])
        del ost
    _sync(dev)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        sp, so, m = plan.step_fn(sp, so, sb)
        loss = float(m["loss"])
    _sync(dev)
    res["step_check_s"] = time.perf_counter() - t0
    del so
    gaps, upd = [], []
    for i, t in enumerate(tree_leaves(sp)):
        full = t.full_tensor()
        if rank == 0:
            ref = tree_leaves(params)[i]
            gaps.append(_rel_gap(full, ref))
            upd.append(_rel_gap(full - before[i], ref - before[i]))
        del full
    if rank == 0:
        res["step_loss_gap"] = abs(loss - res["step_loss_unsharded"]) / max(
            1.0, abs(res["step_loss_unsharded"]))
        res["step_param_gap"] = max(gaps)
        res["step_update_gap"] = max(upd)
    return res


def _opt_init_sharded(opt, sp: Any, spec_tree: Any, mesh) -> Any:
    """The optimizer state of DTensor params, laid out by `spec_tree`:
    made from each rank's blocks (zeros and a step count), so no whole
    moment exists on any rank."""
    from torch.distributed.tensor import DTensor

    local = opt.init(tree_map(lambda a: a.to_local(), sp))

    def like(blocks):
        return tree_map(lambda a, ref: DTensor.from_local(
            a, ref.device_mesh, ref.placements, run_check=False,
            shape=ref.shape, stride=ref.stride()), blocks, sp)

    return {k: distribute_tree(v, spec_tree[k], mesh) if k == "step"
            else like(v) for k, v in local.items()}
