"""Lowering plans: shape stand-ins and specs for every (architecture ×
input shape × mesh × mode), the dry-run's contract (counterpart of
``repro.launch.specs``).

No memory is touched here: parameter, optimizer, batch and cache trees are
tensors on the ``meta`` device (the reference's ``ShapeDtypeStruct``
trees), made by the port's own constructors, so a plan describes the
program the step factory builds. Specs are trees of ``shardingx.policy.P``.
The port's steps update params and optimizer state in place, where the
reference's jitted step donates them; ``donate_argnums`` stays as data.

On a mesh of running ranks (``launch.mesh.HostMesh``) a plan also runs:
``plan.place(args)`` lays real arguments out by its ``in_specs`` as
DTensors (``shardingx.policy.distribute_tree``), and ``plan.step_fn(*placed)``
under ``launch.mesh.use_mesh(mesh)`` is the sharded program, the
counterpart of the reference's ``jax.jit(step, in_shardings=...)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.core.federated import silo_replicate
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import num_silos, silo_axis_name
from repro_torch.models import backbone as bb
from repro_torch.shardingx.policy import P, batch_spec, map_with_names, \
    param_specs
from repro_torch.tree import tree_map

# decode keeps params tensor-parallel-only unless they cannot fit one model
# shard (deepseek-v3: 671B bf16 / 16 shards = 84 GB ≫ HBM -> FSDP too).
DECODE_FSDP_BYTES = 12e9

META = torch.device("meta")


@dataclass
class LoweringPlan:
    name: str
    kind: str                       # train | fed_local | fed_sync | prefill | decode
    cfg: ModelConfig
    step_fn: Callable
    args: Tuple[Any, ...]           # trees of meta tensors
    in_specs: Tuple[Any, ...]       # trees of P, one per argument
    out_specs: Any                  # tree of P matching the step's outputs
    donate_argnums: Tuple[int, ...] = ()
    mesh: Any = None                # the mesh the specs are for

    def place(self, args: Tuple[Any, ...]) -> Tuple[Any, ...]:
        """`args` (trees of whole tensors shaped as ``self.args``, the same
        on every rank) laid out by ``in_specs`` on the plan's mesh of
        running ranks; raises on a mesh without ranks or a planning one."""
        from repro_torch.launch.mesh import refuse_planning
        from repro_torch.shardingx.policy import distribute_tree

        if getattr(self.mesh, "device_mesh", None) is None:
            raise ValueError(f"{self.name}: a plan for {self.mesh!r} has no "
                             "ranks to place arguments on")
        refuse_planning(self.mesh, f"placing {self.name}'s arguments")
        if len(args) != len(self.in_specs):
            raise ValueError(f"{self.name} takes {len(self.in_specs)} "
                             f"arguments, not {len(args)}")
        return tuple(distribute_tree(a, s, self.mesh)
                     for a, s in zip(args, self.in_specs))


def resolve_arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Long-context policy: at 500k decode every attention path runs
    sliding-window (ring cache); SSM/hybrid state paths unchanged."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.with_overrides(attn_variant="sliding", sliding_window=8192)
    return cfg


def decode_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.attn_variant == "sliding":
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len + (cfg.prefix_len if cfg.prefix_frontend else 0)


# --------------------------------------------------------------------------
# cache sharding
# --------------------------------------------------------------------------

def cache_specs(state_shapes: Any, mesh, replicate_model: bool = False,
                model_on_seq: bool = False) -> Any:
    """Decode-state specs. Arrays are (L, B, ...):
      batch dim over ("pod","data") when divisible; for B == 1 (long-context)
      the ring/cache length dim (index 2) is sequence-sharded instead;
      the model axis lands on the innermost divisible dim of index >= 3."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    bt = 1
    for a in batch_axes:
        bt *= sizes[a]
    msize = sizes.get("model", 1)

    def one(_names, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if len(shape) < 2:
            return P(*spec)
        model_at = None
        if model_on_seq and len(shape) >= 3 and msize > 1 \
                and shape[2] % msize == 0 and shape[2] >= msize:
            spec[2] = "model"                 # cache length dim
            model_at = 2
        elif not replicate_model:
            for i in range(len(shape) - 1, 2, -1):
                if msize > 1 and shape[i] % msize == 0:
                    spec[i] = "model"
                    model_at = i
                    break
        if batch_axes:
            if shape[1] % bt == 0 and shape[1] > 1:
                spec[1] = batch_axes
            elif len(shape) >= 3 and 2 != model_at and shape[2] % bt == 0:
                spec[2] = batch_axes
        return P(*spec)

    return map_with_names(one, state_shapes)


# --------------------------------------------------------------------------
# plan builders
# --------------------------------------------------------------------------

def _params_shapes(cfg: ModelConfig, dtype: torch.dtype) -> Any:
    return bb.init_params(cfg, None, dtype, device=META)


def _opt_specs(pspecs: Any) -> Any:
    return {"step": P(), "m": pspecs, "v": pspecs}


def _metric_specs(cfg: ModelConfig, spec: P) -> Dict[str, P]:
    return {k: spec for k in ("loss", "ce", "grad_norm")
            + (("moe_aux",) if cfg.moe else ()) + (("mtp",) if cfg.mtp_depth
                                                     else ())}


def make_plan(cfg_raw: ModelConfig, shape: InputShape, mesh, *,
              mode: str = "baseline", tc: Optional[TrainConfig] = None,
              use_pallas: bool = False, moe_impl: Optional[str] = None,
              device: DeviceLike = None) -> LoweringPlan:
    """mode: baseline | feddcl | feddcl_sync (train shapes) — decode/prefill
    ignore mode. moe_impl overrides the MoE dispatch (hillclimb: "ep").
    The step runs on `device` (CUDA unless the caller asks for the CPU),
    with ``use_kernels=use_pallas``; on a mesh of running ranks
    ``plan.place`` lays its arguments out (module docstring)."""
    cfg = resolve_arch_for_shape(cfg_raw, shape)
    if moe_impl and cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                         impl=moe_impl))
    if mode in ("feddcl", "feddcl_sync") and cfg.moe is not None \
            and cfg.moe.impl == "ep":
        # the exchange does not nest under the silo loop — fed plans use gspmd
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                         impl="gspmd"))
    tc = tc or TrainConfig(model=cfg, shape=shape)
    dev = resolve_device(device)

    if shape.kind == "train":
        if mode == "feddcl":
            plan = _fed_local_plan(cfg, shape, mesh, tc, use_pallas, dev)
        elif mode == "feddcl_sync":
            plan = _fed_sync_plan(cfg, shape, mesh, tc, dev)
        else:
            plan = _train_plan(cfg, shape, mesh, tc, use_pallas, dev)
    elif shape.kind == "prefill":
        plan = _prefill_plan(cfg, shape, mesh, tc, use_pallas, dev)
    else:
        plan = _decode_plan(cfg, shape, mesh, tc, dev)
    plan.mesh = mesh
    return plan


def _batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                  cdtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d = {
        "tokens": torch.empty((batch, seq), dtype=torch.int32, device=META),
        "labels": torch.empty((batch, seq), dtype=torch.int32, device=META),
    }
    if cfg.prefix_frontend:
        d["prefix_embeds"] = torch.empty(
            (batch, cfg.prefix_len, cfg.d_model), dtype=cdtype, device=META)
    return d


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _batch_specs(bshapes: Dict[str, torch.Tensor], bspec: P) -> Dict[str, P]:
    return {k: (bspec if v.ndim == 2 else
                P(*(tuple(bspec)[:1] + (None,) * (v.ndim - 1))))
            for k, v in bshapes.items()}


def _train_plan(cfg, shape, mesh, tc, use_pallas, dev) -> LoweringPlan:
    step, opt = steps_lib.make_train_step(cfg, tc, use_kernels=use_pallas,
                                          device=dev)
    pshapes = _params_shapes(cfg, _dtype(tc.param_dtype))
    oshapes = opt.init(pshapes)
    bshapes = _batch_shapes(cfg, shape.global_batch, shape.seq_len,
                            _dtype(tc.compute_dtype))

    pspecs = param_specs(pshapes, mesh, fsdp=tc.fsdp)
    ospecs = _opt_specs(pspecs)
    bspecs = _batch_specs(bshapes, batch_spec(mesh, federated=False))
    mspecs = _metric_specs(cfg, P())
    return LoweringPlan(
        name=f"{cfg.name}:{shape.name}:train",
        kind="train", cfg=cfg, step_fn=step,
        args=(pshapes, oshapes, bshapes),
        in_specs=(pspecs, ospecs, bspecs),
        out_specs=(pspecs, ospecs, mspecs),
        donate_argnums=(0, 1),
    )


def _fed_common(cfg, shape, mesh, tc):
    d = num_silos(mesh)
    silo_ax = silo_axis_name(mesh)
    pshapes = _params_shapes(cfg, _dtype(tc.param_dtype))
    sp_shapes = tree_map(torch.Tensor.contiguous, silo_replicate(pshapes, d))
    pspecs = param_specs(sp_shapes, mesh, fsdp=tc.fsdp, silo_dim=True,
                         silo_axis=silo_ax)
    return d, silo_ax, sp_shapes, pspecs


def _fed_local_plan(cfg, shape, mesh, tc, use_pallas, dev) -> LoweringPlan:
    """FedDCL local step (d silos × local batch, zero cross-silo traffic)."""
    d, silo_ax, sp_shapes, pspecs = _fed_common(cfg, shape, mesh, tc)
    if shape.global_batch % d:
        raise ValueError(f"global batch {shape.global_batch} is not "
                         f"divisible by {d} silos")
    local_b = shape.global_batch // d

    vstep, opt = steps_lib.make_federated_local_step(
        cfg, tc, use_kernels=use_pallas, device=dev)
    so_shapes = steps_lib.silo_opt_init(opt, sp_shapes)
    b1 = _batch_shapes(cfg, local_b, shape.seq_len, _dtype(tc.compute_dtype))
    bshapes = {k: torch.empty((d,) + tuple(v.shape), dtype=v.dtype,
                              device=META) for k, v in b1.items()}

    ospecs = {"step": P(silo_ax), "m": pspecs, "v": pspecs}
    inner_data = "data" if (silo_ax != "data"
                            and "data" in mesh.axis_names) else None
    bspecs = {k: P(silo_ax, inner_data, *([None] * (v.ndim - 2)))
              for k, v in bshapes.items()}
    mspecs = _metric_specs(cfg, P(silo_ax))
    return LoweringPlan(
        name=f"{cfg.name}:{shape.name}:feddcl-local(d={d})",
        kind="fed_local", cfg=cfg, step_fn=vstep,
        args=(sp_shapes, so_shapes, bshapes),
        in_specs=(pspecs, ospecs, bspecs),
        out_specs=(pspecs, ospecs, mspecs),
        donate_argnums=(0, 1),
    )


def _fed_sync_plan(cfg, shape, mesh, tc, dev) -> LoweringPlan:
    """FedDCL round boundary: the single cross-silo all-reduce."""
    d, silo_ax, sp_shapes, pspecs = _fed_common(cfg, shape, mesh, tc)
    sync = steps_lib.make_fedavg_sync_step(tc, device=dev)
    opt = steps_lib.make_optimizer(tc)
    so_shapes = steps_lib.silo_opt_init(opt, sp_shapes)
    ospecs = {"step": P(silo_ax), "m": pspecs, "v": pspecs}
    return LoweringPlan(
        name=f"{cfg.name}:{shape.name}:feddcl-sync"
             f"(d={d},H={tc.federated.local_steps})",
        kind="fed_sync", cfg=cfg, step_fn=sync,
        args=(sp_shapes, so_shapes),
        in_specs=(pspecs, ospecs),
        out_specs=(pspecs, ospecs),
        donate_argnums=(0, 1),
    )


def _decode_params_fsdp(cfg: ModelConfig) -> bool:
    return bb.count_params_analytic(cfg) * 2 / 16 > DECODE_FSDP_BYTES


def _prefill_plan(cfg, shape, mesh, tc, use_pallas, dev) -> LoweringPlan:
    cdtype = _dtype(tc.compute_dtype)
    cache_len = decode_cache_len(cfg, shape)
    step = steps_lib.make_prefill_step(cfg, cache_len=cache_len,
                                       compute_dtype=cdtype,
                                       use_kernels=use_pallas, device=dev)
    pshapes = _params_shapes(cfg, torch.bfloat16)
    bshapes = _batch_shapes(cfg, shape.global_batch, shape.seq_len, cdtype)
    bshapes.pop("labels")

    pspecs = param_specs(pshapes, mesh, fsdp=_decode_params_fsdp(cfg))
    bspecs = _batch_specs(bshapes, batch_spec(mesh, federated=False))
    # the state prefill returns: the decode state of its cache length
    # (the reference takes it from jax.eval_shape of the step)
    state = bb.init_decode_state(cfg, shape.global_batch, cache_len,
                                 device=META)
    out_specs = (P(), cache_specs(state, mesh), P())
    return LoweringPlan(
        name=f"{cfg.name}:{shape.name}:prefill",
        kind="prefill", cfg=cfg, step_fn=step,
        args=(pshapes, bshapes),
        in_specs=(pspecs, bspecs),
        out_specs=out_specs,
    )


def _decode_plan(cfg, shape, mesh, tc, dev) -> LoweringPlan:
    cdtype = _dtype(tc.compute_dtype)
    cache_len = decode_cache_len(cfg, shape)
    B = shape.global_batch
    step = steps_lib.make_serve_step(cfg, compute_dtype=cdtype, device=dev)
    pshapes = _params_shapes(cfg, torch.bfloat16)
    sshapes = bb.init_decode_state(cfg, B, cache_len, torch.bfloat16,
                                   device=META)
    tshape = torch.empty((B, 1), dtype=torch.int32, device=META)
    posshape = torch.empty((B,), dtype=torch.int32, device=META)

    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    bt = 1
    for a in batch_axes:
        bt *= sizes[a]
    tok_spec = P(batch_axes if B % bt == 0 and B > 1 else None, None)
    pos_spec = P(batch_axes if B % bt == 0 and B > 1 else None)

    pspecs = param_specs(pshapes, mesh, fsdp=_decode_params_fsdp(cfg))
    sspecs = cache_specs(sshapes, mesh,
                         replicate_model=cfg.decode_expand_kv,
                         model_on_seq=cfg.decode_cache_seq)
    logits_spec = P(tuple(tok_spec)[0], None, None)
    return LoweringPlan(
        name=f"{cfg.name}:{shape.name}:decode",
        kind="decode", cfg=cfg, step_fn=step,
        args=(pshapes, sshapes, tshape, posshape),
        in_specs=(pspecs, sspecs, tok_spec, pos_spec),
        out_specs=(logits_spec, sspecs),
        donate_argnums=(1,),
    )
