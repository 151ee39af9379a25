"""Step functions (counterpart of ``repro.launch.steps``): the
baseline train step, the prefill step and the serve (decode) step, eager
or captured. The federated round steps are not ported yet (ROADMAP.md,
Queue 1).

``make_*`` fixes the device (CUDA unless the caller asks for the CPU) and
the step moves its token inputs there, so a caller can hand over NumPy.
``make_captured_serve_step`` is the port's counterpart of the reference's
``jax.jit`` of the serve step: the same step as CUDA graphs, replayed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import capture
from repro_torch.models import backbone as bb
from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               global_norm, sgd)
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.tree import tree_leaves, tree_map

# elements of one piece of the optimizer update: bounds its temporaries
# (a few piece-sized fp32 tensors) whatever the size of a parameter
OPT_PIECE = 1 << 26


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      compute_dtype=torch.bfloat16,
                      cache_dtype=torch.bfloat16, use_kernels: bool = True,
                      device: DeviceLike = None) -> Callable:
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        return bb.prefill(params, _on(batch["tokens"], dev), cfg,
                          cache_len=cache_len, compute_dtype=compute_dtype,
                          cache_dtype=cache_dtype, use_kernels=use_kernels)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                    device: DeviceLike = None) -> Callable:
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, state, tokens, cur_pos):
        return bb.decode_step(params, state, _on(tokens, dev),
                              _on(cur_pos, dev), cfg,
                              compute_dtype=compute_dtype)

    return serve_step


def _layout(tree: Any) -> Tuple:
    """Where and how a tree's tensors lie: what a captured graph bakes in."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tree_leaves(tree))


class CapturedServeStep:
    """``make_serve_step``'s step as CUDA graphs, one per (params, state,
    batch) layout: the config and compute dtype are the step's; the batch
    and cache length are the state's shapes; params and state are keyed by
    their addresses (a per-slot view of a state is a layout of its own).

    A call moves `tokens` (B, 1) and `cur_pos` (B,) to the card (NumPy
    goes host-to-device here, outside any graph), copies them into the
    graph's static buffers and replays it. The graph writes the state in
    place, as the eager step does, and the logits it returns are the
    graph's static output buffer: the next call on the same layout
    rewrites them. The first call on a layout warms the step up on a copy
    of the state (so the state advances once, by the replay) and captures
    it; a failed capture raises. `captures` / `replays` count them.
    """

    def __init__(self, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a captured serve step needs a CUDA device, "
                             f"not {self.device}")
        self._step = make_serve_step(cfg, compute_dtype=compute_dtype,
                                     device=self.device)
        self._graphs: Dict[Tuple, Tuple] = {}
        self.captures = self.replays = 0

    def __call__(self, params, state, tokens, cur_pos):
        tokens, cur_pos = _on(tokens, self.device), _on(cur_pos, self.device)
        key = (_layout(params), _layout(state),
               (tuple(tokens.shape), tokens.dtype),
               (tuple(cur_pos.shape), cur_pos.dtype))
        entry = self._graphs.get(key)
        if entry is None:
            tok, pos = tokens.clone(), cur_pos.clone()
            warm = tree_map(torch.clone, state)
            graph, (logits, _) = capture(
                lambda: self._step(params, state, tok, pos), self.device,
                warmup=lambda: self._step(params, warm, tok, pos))
            del warm
            entry = self._graphs[key] = (graph, tok, pos, logits)
            self.captures += 1
        graph, tok, pos, logits = entry
        tok.copy_(tokens)
        pos.copy_(cur_pos)
        graph.replay()
        self.replays += 1
        return logits, state


# the make_* name of the captured serve step, beside make_serve_step
make_captured_serve_step = CapturedServeStep


def make_optimizer(tc: TrainConfig):
    sched = cosine_with_warmup(tc.learning_rate, tc.warmup_steps,
                               tc.total_steps)
    if tc.optimizer == "sgd":
        return sgd(sched, momentum=0.9)
    return adamw(sched, weight_decay=tc.weight_decay,
                 state_dtype=getattr(torch, tc.opt_state_dtype))


def _pieces(t: torch.Tensor):
    """Views of `t` along its first dim, each of at most about OPT_PIECE
    elements (at least one row)."""
    if t.dim() == 0 or t.numel() <= OPT_PIECE:
        return [t]
    return t.split(max(1, OPT_PIECE // (t.numel() // t.shape[0])))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    use_kernels: bool = True,
                    device: DeviceLike = None) -> Tuple[Callable, Any]:
    """Baseline (non-federated) step: loss, gradients over the whole params
    tree, global-norm clip, one optimizer update. Returns (train_step, opt).

    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``ce``, ``loss`` and ``grad_norm``. It updates `params`
    and `opt_state` IN PLACE and returns them (the reference's jitted step
    donates them): the update runs piece by piece (``OPT_PIECE``), so a
    full-width step holds one copy of the params, gradients and moments
    plus a few pieces. Each piece takes the same arithmetic as the
    whole-tree ``clip_by_global_norm`` -> ``opt.update`` ->
    ``apply_updates`` of the reference."""
    dev = resolve_device(device)
    opt = make_optimizer(tc)
    compute_dtype = getattr(torch, tc.compute_dtype)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        tree = tree_map(lambda _: next(it), params)
        b = {k: _on(batch[k], dev) for k in ("tokens", "labels")}
        loss, metrics = bb.loss_fn(tree, b, cfg, use_kernels=use_kernels,
                                   remat=tc.remat,
                                   compute_dtype=compute_dtype)
        grads = list(torch.autograd.grad(loss, live, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        del tree, live
        with torch.no_grad():
            gnorm = global_norm(grads)
            moments = [k for k in opt_state if k != "step"]
            moment_leaves = [tree_leaves(opt_state[k]) for k in moments]
            step = opt_state["step"]
            for j, p in enumerate(leaves):
                g, grads[j] = grads[j], None
                for p_, g_, *ms in zip(_pieces(p), _pieces(g),
                                       *(_pieces(m[j]) for m in moment_leaves)):
                    g_, _ = clip_by_global_norm(g_, tc.grad_clip, norm=gnorm)
                    upd, new = opt.update(
                        g_, {"step": step, **dict(zip(moments, ms))}, p_)
                    for k, m_ in zip(moments, ms):
                        m_.copy_(new[k])
                    p_.copy_(apply_updates(p_, upd))
            opt_state["step"] = new["step"]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step, opt
