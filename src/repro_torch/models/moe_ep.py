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

Transport: gloo over the mesh's sub-groups, buffers as bytes. A CUDA
tensor goes through pinned host buffers and back (NCCL refuses two ranks
on one card), its bytes counted in ``STATS`` as ``SiloComm`` counts its
staging. A planning mesh (fake backend) is refused.

Autograd: each collective is a ``torch.autograd.Function``; the
exchange's backward is the same exchange of the gradient, the gather's
backward this rank's slice of the incoming gradient, and the aux sum's
backward the identity. So a rank's gradients cover the tokens it routed:
with each rank's loss taken over its own S/M slice of its block (the
split of a sequence-parallel loss), the layer's gradients summed over the
ranks, as a data-parallel step sums them, are the gradients of the whole
batch's loss (the reference's ``jax.grad``).

Not here: the reference's all-gather of FSDP'd expert weights over "data"
(the port's ranks hold whole weights).
"""
from __future__ import annotations

import time
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_moe_gspmd, moe_combine,
                                       moe_experts, moe_pack, moe_shared)


class ExchangeStats:
    """What the exchange moved since `reset`: calls of each collective,
    bytes staged device <-> pinned host, bytes handed to gloo (this rank's
    send buffers) and the seconds spent in the collectives."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {"all-to-all": 0, "all-gather": 0, "all-reduce": 0}
        self.staged_bytes = 0
        self.wire_bytes = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "staged_bytes": self.staged_bytes,
                "wire_bytes": self.wire_bytes, "seconds": self.seconds}


STATS = ExchangeStats()


def _host(t: torch.Tensor) -> torch.Tensor:
    """`t` as a contiguous CPU tensor for gloo (a CUDA tensor copied into
    pinned memory, counted; torch's host allocator reuses the blocks)."""
    if not t.is_cuda:
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    STATS.staged_bytes += host.numel() * host.element_size()
    return host


def _recv(shape, like: torch.Tensor) -> torch.Tensor:
    """A receive buffer for gloo: pinned for a CUDA `like`."""
    return torch.empty(shape, dtype=like.dtype, pin_memory=like.is_cuda)


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if not like.is_cuda:
        return host
    STATS.staged_bytes += host.numel() * host.element_size()
    return host.to(like.device, copy=True)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _begin(t: torch.Tensor) -> float:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return time.perf_counter()


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """(M, ...) -> (M, ...): block j goes to the group's rank j, and block
    j of the result came from rank j."""
    t0 = _begin(t)
    send = _host(t)
    recv = _recv(send.shape, t)
    dist.all_to_all_single(_bytes(recv), _bytes(send), group=group)
    STATS.calls["all-to-all"] += 1
    STATS.wire_bytes += send.numel() * send.element_size()
    out = _back(recv, t)
    STATS.seconds += time.perf_counter() - t0
    return out


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
        t0 = _begin(t)
        send = _host(t)
        parts = _recv((M,) + tuple(send.shape), t)
        dist.all_gather([_bytes(p) for p in parts.unbind(0)], _bytes(send),
                        group=group)
        STATS.calls["all-gather"] += 1
        STATS.wire_bytes += send.numel() * send.element_size()
        out = _back(torch.cat(parts.unbind(0), dim=1), t)
        STATS.seconds += time.perf_counter() - t0
        return out

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.m * ctx.s:(ctx.m + 1) * ctx.s], None, None, None


class _SumOver(torch.autograd.Function):
    """A sum over the ranks of `groups`, one group after the other;
    backward: the identity (each rank's share of a replicated mean)."""

    @staticmethod
    def forward(ctx, t, groups):
        t0 = _begin(t)
        host = _host(t).clone()
        for g in groups:
            dist.all_reduce(host, group=g)
            STATS.calls["all-reduce"] += 1
            STATS.wire_bytes += host.numel() * host.element_size()
        out = _back(host, t)
        STATS.seconds += time.perf_counter() - t0
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def apply_moe_ep(p, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B_loc, S, d), aux loss) for this rank's block `x`."""
    from repro_torch.launch.mesh import current_mesh, refuse_planning

    mesh = current_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh else {}
    M = sizes.get("model", 1)
    B, S, d = x.shape
    E = cfg.moe.num_experts
    if mesh is None or M <= 1 or E % M or S % M:
        return apply_moe_gspmd(p, x, cfg)
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
