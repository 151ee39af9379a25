"""Minimal functional optimizers on parameter trees (counterpart of
``repro.optim.optimizers``).

``opt.init(params) -> state``, ``opt.update(grads, state, params) ->
(updates, state)``; updates are ADDED to params by ``apply_updates``.
``adamw`` keeps the reference's defaults (b2=0.95, eps=1e-8, no weight
decay, bias correction by a float32 step); ``torch.optim.AdamW`` differs in
b2 and weight decay and is not used.

No ``update`` copies from the host or syncs with it: the step counter stays
a device tensor, constants enter as Python numbers or fills on the device,
and the schedules (``optim.schedules``) return a Python number, a CPU
scalar or a function of the device step. So an update can be captured in a
CUDA graph (the scan engine captures whole federated rounds).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale `grads` so their global norm is at most `max_norm`. `norm`,
    when given, is the global norm of a whole tree that `grads` is a piece
    of, so a large tree can be clipped piece by piece."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return state

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(),
                          state["mu"], grads)
            upd = tree_map(lambda m: -lr_t * m, mu)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: -lr_t * g.float(), grads)
        return upd, {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with decoupled weight decay, moments kept in `state_dtype`."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=state_dtype)
        return {"step": _step0(params),
                "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        stepf = step.float()
        # full_like fills on the device: no tensor is built from a Python
        # number on the host, so the update can be captured in a CUDA graph
        bc1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
        bc2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)

        def upd_m(m, g):
            return (b1 * m.float() + (1 - b1) * g.float()).to(state_dtype)

        def upd_v(v, g):
            gf = g.float()
            return (b2 * v.float() + (1 - b2) * gf * gf).to(state_dtype)

        m = tree_map(upd_m, state["m"], grads)
        v = tree_map(upd_v, state["v"], grads)

        def u(m_, v_, p):
            mhat = m_.float() / bc1
            vhat = v_.float() / bc2
            step_ = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return -lr_t * step_

        updates = tree_map(u, m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
