"""Step functions (counterpart of ``repro.launch.steps``): the
baseline train step, FedDCL's federated local / phase / round / multiround
steps and their round boundary, the prefill step and the serve (decode)
step, eager or captured.

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
from repro_torch.core.federated import (AGGREGATORS, ROBUST_AGGREGATORS,
                                        krum_distances, krum_pick,
                                        masked_median, masked_trimmed_mean,
                                        scan_local_steps)
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


# the batch entries the train steps read
BATCH_KEYS = ("tokens", "labels", "prefix_embeds")


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      compute_dtype=torch.bfloat16,
                      cache_dtype=torch.bfloat16, use_kernels: bool = True,
                      device: DeviceLike = None) -> Callable:
    """``prefill_step(params, batch) -> (logits, state, next_pos)`` over
    `batch`'s tokens, after its ``prefix_embeds`` where it has them (a
    prefix family: size `cache_len` for P + S + the decode steps)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        prefix = batch.get("prefix_embeds")
        return bb.prefill(params, _on(batch["tokens"], dev), cfg,
                          cache_len=cache_len,
                          prefix_embeds=None if prefix is None
                          else _on(prefix, dev),
                          compute_dtype=compute_dtype,
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
    with ``loss_fn``'s metrics (``ce`` and ``loss``; for the moe family
    also ``moe_aux``, and ``mtp`` with an MTP head) and ``grad_norm``.
    `batch` holds ``tokens`` and ``labels``, and ``prefix_embeds`` for a
    prefix family (NumPy or tensors). It updates `params`
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
        b = {k: _on(batch[k], dev) for k in BATCH_KEYS if k in batch}
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


# --------------------------------------------------------------------------
# FedDCL's federated round (the launch tier of the paper's technique)
# --------------------------------------------------------------------------
#
# Silo-stacked trees carry a leading silo dim d, as the reference's. Where
# the reference vmaps the baseline step over that dim, the port loops over
# it: each silo runs make_train_step's in-place step on views of its slice
# of the stacked params and moments, so one silo's gradients exist at a
# time (a full-width rwkv6-3b gradient tree is 12.6 GB). The steps and the
# sync write the stacks in place, so every stacked leaf must own its
# storage: silo_replicate's broadcast views share one storage across silos,
# and a step on one silo's view would write them all.

def silo_opt_init(opt, silo_params: Any) -> Any:
    """``opt.init`` over silo-stacked params (the reference's
    ``jax.vmap(opt.init)``): the moments stacked as the params are, and
    one step counter per silo, shape (d,)."""
    state = opt.init(silo_params)
    d = tree_leaves(silo_params)[0].shape[0]
    state["step"] = state["step"].expand(d).contiguous()
    return state


def _check_stacked(tree: Any) -> None:
    for a in tree_leaves(tree):
        if not a.is_contiguous():
            raise ValueError(
                "silo-stacked leaves must be contiguous: the federated steps "
                "write each silo's slice in place (clone silo_replicate's "
                "broadcast views first)")


def _silo(tree: Any, i: int) -> Any:
    return tree_map(lambda a: a[i], tree)


def _stack(trees) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def make_federated_local_step(cfg: ModelConfig, tc: TrainConfig, *,
                              use_kernels: bool = True,
                              device: DeviceLike = None
                              ) -> Tuple[Callable, Any]:
    """FedDCL's LOCAL step: the baseline step on every silo, with no
    cross-silo communication. ``local_step(silo_params, silo_opt_state,
    batch) -> (silo_params, silo_opt_state, metrics)``: params and state
    lead with the silo dim d and are updated in place; `batch` leads with
    (d, local_batch, ...), every entry (``prefix_embeds`` too) sliced per
    silo; each metric comes back with shape (d,). Under a mesh
    (``launch.mesh.use_mesh``) each silo's step runs in
    ``shardingx.constrain.silo_context`` of the mesh's silo axis, so
    logical "batch" never resolves onto it."""
    from repro_torch.launch.mesh import current_mesh, silo_axis_name
    from repro_torch.shardingx.constrain import silo_context

    train_step, opt = make_train_step(cfg, tc, use_kernels=use_kernels,
                                      device=device)

    def local_step(silo_params, silo_opt_state, batch):
        _check_stacked(silo_params)
        _check_stacked(silo_opt_state)
        d = tree_leaves(silo_params)[0].shape[0]
        mesh = current_mesh()
        axis = silo_axis_name(mesh) if mesh is not None else None
        ms = []
        for i in range(d):
            state = {k: v[i] if k == "step" else _silo(v, i)
                     for k, v in silo_opt_state.items()}
            with silo_context(axis):
                _, state, m = train_step(_silo(silo_params, i), state,
                                         _silo(batch, i))
            # the step rebinds the counter of the per-silo dict only
            silo_opt_state["step"][i] = state["step"]
            ms.append(m)
        return silo_params, silo_opt_state, _stack(ms)

    return local_step, opt


def make_federated_local_phase_step(cfg: ModelConfig, tc: TrainConfig, *,
                                    use_kernels: bool = True,
                                    device: DeviceLike = None
                                    ) -> Tuple[Callable, Any]:
    """H silo-local steps WITHOUT the sync boundary: `batches` lead with
    (H, d, ...), metrics come back (H, d). ``train`` runs it for the
    trailing steps of an unfinished round."""
    local_step, opt = make_federated_local_step(
        cfg, tc, use_kernels=use_kernels, device=device)

    def phase(silo_params, silo_opt_state, batches):
        return scan_local_steps(local_step, silo_params, silo_opt_state,
                                batches)

    return phase, opt


def _silo_columns(a: torch.Tensor):
    """A stacked leaf as (d, n) views of its columns, each of at most about
    OPT_PIECE elements: the aggregators are elementwise over d, so a
    piece's result is the whole leaf's on those columns."""
    flat = a.view(a.shape[0], -1)
    return flat.split(max(1, OPT_PIECE // a.shape[0]), dim=1)


def make_fedavg_sync_step(tc: TrainConfig, *,
                          device: DeviceLike = None) -> Callable:
    """The round boundary, ``sync(silo_params, silo_opt_state) ->
    (silo_params, silo_opt_state)``, in place: every silo's params become
    the configured aggregate (``core.federated.robust_sync``'s semantics:
    the unweighted mean for fedavg / fedprox / fedsgd, else the median,
    trimmed mean or Krum's pick over all silos), leaf by leaf and piece by
    piece, so no second copy of the stack is held. Krum sums its (d, d)
    distances over the pieces, then copies the chosen silo. For fedavg and
    the robust aggregators the whole optimizer state, step counter
    included, is then zeroed, as the reference's sync does (so the
    learning-rate warm-up restarts every round); fedprox and fedsgd keep
    it."""
    fed = tc.federated
    if fed.aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {fed.aggregator!r}; choose "
                         f"one of {AGGREGATORS}")
    dev = resolve_device(device)

    def aggregate(cols, mask):
        if fed.aggregator == "median":
            return masked_median(cols, mask)
        if fed.aggregator == "trimmed_mean":
            return masked_trimmed_mean(cols, mask, fed.trim_frac)
        return torch.mean(cols.float(), dim=0)

    @torch.no_grad()
    def sync(silo_params, silo_opt_state):
        _check_stacked(silo_params)
        leaves = tree_leaves(silo_params)
        mask = torch.ones((leaves[0].shape[0],), dtype=torch.float32,
                          device=dev)
        pieces = [c for a in leaves for c in _silo_columns(a)]
        if fed.aggregator == "krum":
            best = krum_pick(sum(krum_distances(c) for c in pieces), mask,
                             fed.krum_f)
            for c in pieces:
                c.copy_(c.index_select(0, best.reshape(1)))
        else:
            for c in pieces:
                c.copy_(aggregate(c, mask).to(c.dtype)[None])
        if fed.aggregator == "fedavg" or fed.aggregator in ROBUST_AGGREGATORS:
            for t in tree_leaves(silo_opt_state):
                t.zero_()
        return silo_params, silo_opt_state

    return sync


def make_federated_round_step(cfg: ModelConfig, tc: TrainConfig, *,
                              use_kernels: bool = True,
                              device: DeviceLike = None
                              ) -> Tuple[Callable, Any]:
    """One FULL FedDCL round: the H-step local phase, then the sync.
    `batches` lead with (H, d, ...); metrics come back (H, d)."""
    phase, opt = make_federated_local_phase_step(
        cfg, tc, use_kernels=use_kernels, device=device)
    sync = make_fedavg_sync_step(tc, device=device)

    def round_step(silo_params, silo_opt_state, batches):
        sp, so, ms = phase(silo_params, silo_opt_state, batches)
        sp, so = sync(sp, so)
        return sp, so, ms

    return round_step, opt


def make_federated_multiround_step(cfg: ModelConfig, tc: TrainConfig, *,
                                   use_kernels: bool = True,
                                   device: DeviceLike = None
                                   ) -> Tuple[Callable, Any]:
    """R full rounds in one call: `batches` lead with (R, H, d, ...);
    metrics come back as (R, H) scalars, each silo-meaned per round, as
    the reference's scan keeps them (``train``'s
    ``--rounds-per-dispatch``)."""
    round_step, opt = make_federated_round_step(
        cfg, tc, use_kernels=use_kernels, device=device)

    def multiround(silo_params, silo_opt_state, batches):
        sp, so, out = silo_params, silo_opt_state, []
        for r in range(tree_leaves(batches)[0].shape[0]):
            sp, so, ms = round_step(sp, so, _silo(batches, r))
            out.append(tree_map(
                lambda a: torch.mean(a.reshape(a.shape[0], -1), dim=1), ms))
        return sp, so, _stack(out)

    return multiround, opt
