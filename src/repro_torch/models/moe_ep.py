"""Expert-parallel MoE: one all_to_all over the mesh's "model" ranks
(counterpart of ``repro.models.moe_ep``).

The gspmd dispatch (``layers.apply_moe_gspmd``) routes every token of the
call in one process. Under ``launch.mesh.use_mesh(mesh)`` with a "model"
axis of M > 1 ranks, where M divides the expert count E and the sequence
length S, each rank of the mesh (one process of a ``torch.distributed``
group, ``launch.mesh.run_ranks``) holds its batch block (B_loc, S, d),
whole over its model peers, and:
  1. takes its S/M slice of the sequence and routes its T_loc = B_loc·S/M
     tokens with cap = max(int(capacity_factor·T_loc·k/E), 1);
  2. packs the (E, cap, d) capacity buffers as the gspmd path does;
  3. ONE all_to_all over the model ranks gives it (E_loc, M·cap, d): the
     rows every peer routed to its E_loc = E/M experts;
  4. runs its experts' SwiGLU on its E_loc slice of the weights (each rank
     holds whole layer weights);
  5. the reverse all_to_all returns each row to its router, which
     combines its k rows a token by their gates;
  6. an all-gather of the S slices over the model ranks gives (B_loc, S, d)
     back; ``aux`` (the load-balance loss of each rank's tokens) is
     averaged over the batch and model ranks, as the reference's
     ``jnp.mean`` over ``P(aux_axes)``; shared experts are added after the
     gather, on the whole block.
Anywhere else (no mesh in context, M = 1, E % M or S % M) it is the gspmd
path, as the reference falls back.

Transport: gloo over the mesh's sub-groups through ``launch.staged``'s
kernels, called directly: a CUDA tensor goes through pinned host
buffers and back (NCCL refuses two ranks on one card), a CPU tensor to
gloo as it is; calls, bytes and seconds are counted in ``staged.STATS``.
A planning mesh (fake backend) is refused.

Autograd: each collective is a ``torch.autograd.Function``; the
exchange's backward is the same exchange of the gradient, the gather's
backward this rank's slice of the incoming gradient, and the aux sum's
backward the identity. So a rank's gradients cover the tokens it routed:
with each rank's loss taken over its own S/M slice of its block (the
split of a sequence-parallel loss), the layer's gradients summed over the
ranks, as a data-parallel step sums them, are the gradients of the whole
batch's loss (the reference's ``jax.grad``).

On DTensors (the sharded LLM program: params laid out by
``shardingx.policy.param_specs``, activations by the model's constraint
sites) the layer is the reference's ``shard_map``: a
``torch.distributed.tensor.experimental.local_map`` with the reference's
in / out specs (`x_spec`, `layer_specs`; `local_placements`): x as
P(batch axes, "model", None), so each rank holds its batch block's S/M
slice; router and bias replicated; expert weights P("model", None, "data")
for gate / up and P("model", "data", None) for down, the FSDP split of
their wide dim over "data", which each layer all-gathers before its
experts run (its gradient reduce-scattered back over "data"); out as x,
aux P(every axis), averaged. The exchange and the gather are
``torch.distributed._functional_collectives`` on the mesh's groups (on a
card, staged through host memory by ``launch.staged``). On a planning mesh it runs
only on fake or meta tensors, where nothing moves (the dry-run's
per-rank trace); real data is refused.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import staged
from repro_torch.models.layers import (apply_moe_gspmd, moe_combine,
                                       moe_experts, moe_pack, moe_shared)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """(M, ...) -> (M, ...): block j goes to the group's rank j, and block
    j of the result came from rank j."""
    return staged.all_to_all(t.contiguous(), [], [], group.group_name)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """(B, S_loc, d) slices of the group's ranks -> (B, M·S_loc, d) in
    coordinate order; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, t, group, m, M):
        ctx.m, ctx.s = m, t.shape[1]
        parts = staged.all_gather(t.contiguous(), M, group.group_name)
        return torch.cat(parts.view((M,) + tuple(t.shape)).unbind(0), dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.m * ctx.s:(ctx.m + 1) * ctx.s], None, None, None


class _SumOver(torch.autograd.Function):
    """A sum over the ranks of `groups`, one group after the other;
    backward: the identity (each rank's share of a replicated mean)."""

    @staticmethod
    def forward(ctx, t, groups):
        for g in groups:
            t = staged.all_reduce(t, "sum", g.group_name)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def apply_moe_ep(p, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B_loc, S, d), aux loss) for this rank's block `x` (or, for
    a DTensor `x`, the (B, S, d) output and aux of the sharded layer)."""
    from repro_torch.launch.mesh import current_mesh, refuse_planning
    from repro_torch.shardingx.constrain import is_dtensor

    mesh = current_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh else {}
    M = sizes.get("model", 1)
    B, S, d = x.shape
    E = cfg.moe.num_experts
    if mesh is None or M <= 1 or E % M or S % M:
        return apply_moe_gspmd(p, x, cfg)
    if is_dtensor(x):
        return _apply_sharded(p, x, cfg, mesh)
    refuse_planning(mesh, "the expert-parallel exchange")
    E_loc, S_loc = E // M, S // M
    m = mesh.coordinate("model")
    group = mesh.group("model")

    # 1-2: route this rank's slice, pack its capacity buffers
    xs = x[:, m * S_loc:(m + 1) * S_loc]
    buf, dispatch, gates, aux = moe_pack(p, xs, cfg)
    cap = buf.shape[1]

    # 3-4: one exchange; this rank's experts on every peer's rows
    recv = _AllToAll.apply(buf.reshape(M, E_loc, cap, d), group)
    y = moe_experts(p, recv.transpose(0, 1).reshape(E_loc, M * cap, d),
                    m * E_loc)

    # 5: the reverse exchange, then the combine
    back = _AllToAll.apply(y.reshape(E_loc, M, cap, d).transpose(0, 1),
                           group).reshape(E, cap, d)
    out = moe_combine(back, dispatch, gates, xs.shape)

    # 6: whole sequences back; aux averaged over the batch and model ranks
    out = _GatherSeq.apply(out, group, m, M)
    axes = [a for a in ("model", "data", "pod") if sizes.get(a, 1) > 1]
    n = 1
    for a in axes:
        n *= sizes[a]
    aux = _SumOver.apply(aux.reshape(1),
                         [mesh.group(a) for a in axes]).reshape(()) / n
    return moe_shared(p, x, cfg, out), aux


def emulate_ep(p, x: torch.Tensor, cfg: ModelConfig, M: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What M model ranks holding the block `x` compute, in one process:
    each rank's slice routed and packed, the M shards' buffers
    concatenated for each expert owner in place of the exchange, every
    owner's experts, the outputs split back and combined, the slices
    concatenated; aux the mean of the M slices' (the plain version of the
    exchange, for checks)."""
    B, S, d = x.shape
    E = cfg.moe.num_experts
    E_loc, S_loc = E // M, S // M
    packs = [moe_pack(p, x[:, m * S_loc:(m + 1) * S_loc], cfg)
             for m in range(M)]
    cap = packs[0][0].shape[1]
    ys = [moe_experts(p, torch.cat([b[j * E_loc:(j + 1) * E_loc]
                                    for b, *_ in packs], dim=1), j * E_loc)
          for j in range(M)]
    outs = [moe_combine(torch.cat([y[:, m * cap:(m + 1) * cap] for y in ys]),
                        disp, gates, (B, S_loc, d))
            for m, (_, disp, gates, _) in enumerate(packs)]
    aux = torch.stack([a for *_, a in packs]).mean()
    return moe_shared(p, x, cfg, torch.cat(outs, dim=1)), aux


# --------------------------------------------------------------------------
# the layer on DTensors: the reference's shard_map as a local_map
# --------------------------------------------------------------------------

def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)


def _data_axis(mesh):
    return "data" if mesh.shape.get("data", 1) > 1 else None


def x_spec(mesh):
    """The reference's token spec: P(batch axes, "model", None)."""
    from repro_torch.shardingx.policy import P

    ba = _batch_axes(mesh)
    return P(ba if ba else None, "model", None)


def layer_specs(p, mesh):
    """Specs of an MoE layer's params as the reference's ``in_specs``
    declare them: router (and bias) replicated, experts split over
    "model" on E and FSDP-split over "data" on their wide dim; a shared
    expert by ``param_specs``."""
    from repro_torch.shardingx.policy import P, param_specs

    da = _data_axis(mesh)
    out = {k: P(*([None] * v.ndim)) for k, v in p.items()
           if k in ("router", "router_bias")}
    out.update(w_gate=P("model", None, da), w_up=P("model", None, da),
               w_down=P("model", da, None))
    if "shared" in p:
        out["shared"] = param_specs(p["shared"], mesh)
    return {k: out[k] for k in p}


def local_placements(spec, mesh, *, grad: bool = False):
    """A spec's placements for ``local_map``; with `grad`, those of the
    gradient a rank's local function gives: a replicated input's
    gradient covers only this rank's tokens, so it is Partial (summed
    over the ranks) where the input is replicated."""
    from torch.distributed.tensor import Partial

    from repro_torch.shardingx.policy import to_placements

    pl = to_placements(spec, mesh)
    if not grad:
        return pl
    return tuple(Partial() if not q.is_shard() else q for q in pl)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return t.device.type == "meta" or isinstance(t, FakeTensor)


def _apply_sharded(p, x: torch.Tensor, cfg: ModelConfig, mesh):
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import refuse_planning
    from repro_torch.shardingx.constrain import lay_out
    from repro_torch.shardingx.policy import P

    if not _is_fake(x.to_local()):
        refuse_planning(mesh, "the expert-parallel exchange")
    mo = cfg.moe
    E, M = mo.num_experts, mesh.shape["model"]
    E_loc = E // M
    dm = mesh.device_mesh
    names = mesh.axis_names
    model_group = (dm, names.index("model"))
    da = _data_axis(mesh)
    data_group = (dm, names.index(da)) if da else None
    specs = layer_specs({k: v for k, v in p.items() if k != "shared"}, mesh)
    keys = [k for k in ("router", "router_bias", "w_gate", "w_up", "w_down")
            if k in p]
    xs = x_spec(mesh)
    aux_spec = P(tuple(a for a in names if mesh.shape[a] > 1))

    # (renamed in newer torch; the same collective)
    gather = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd

    def local_fn(xl, *ws):
        w = dict(zip(keys, ws))
        if data_group is not None:
            # the FSDP all-gather over "data", one layer at a time; its
            # backward reduce-scatters the gradient back over "data"
            w["w_gate"] = gather(w["w_gate"], 2, data_group)
            w["w_up"] = gather(w["w_up"], 2, data_group)
            w["w_down"] = gather(w["w_down"], 1, data_group)
        Bl, Sl, d = xl.shape
        buf, dispatch, gates, aux = moe_pack(w, xl, cfg)
        cap = buf.shape[1]
        recv = funcol.all_to_all_single_autograd(
            buf.reshape(M * E_loc * cap, d).contiguous(), None, None,
            model_group).reshape(M, E_loc, cap, d)
        y = moe_experts(w, recv.transpose(0, 1).reshape(E_loc, M * cap, d))
        back = funcol.all_to_all_single_autograd(
            y.reshape(E_loc, M, cap, d).transpose(0, 1).reshape(
                M * E_loc * cap, d).contiguous(), None, None,
            model_group).reshape(E, cap, d)
        out = moe_combine(back, dispatch, gates, xl.shape)
        return out, aux.reshape(1)

    in_pl = (local_placements(xs, mesh),) + tuple(
        local_placements(specs[k], mesh) for k in keys)
    fn = local_map(
        local_fn,
        out_placements=(local_placements(xs, mesh),
                        local_placements(aux_spec, mesh)),
        in_placements=in_pl,
        in_grad_placements=(local_placements(xs, mesh),)
        + tuple(local_placements(specs[k], mesh, grad=True) for k in keys),
        device_mesh=dm)
    out, aux = fn(*(lay_out(t, pl) for t, pl in
                    zip([x] + [p[k] for k in keys], in_pl)))
    return moe_shared(p, x, cfg, out), aux.mean()
