"""Step functions (counterpart of ``repro.launch.steps``): the
baseline train step, FedDCL's federated local / phase / round / multiround
steps and their round boundary, the prefill step and the serve (decode)
step, eager or captured.

``make_*`` fixes the device (CUDA unless the caller asks for the CPU) and
the step moves its token inputs there, so a caller can hand over NumPy.
``make_captured_serve_step`` is the port's counterpart of the reference's
``jax.jit`` of the serve step: the same step as CUDA graphs, replayed.

Sharded steps: the counterpart of the reference's ``jax.jit(step,
in_shardings=...)`` is the same step on DTensor arguments laid out by a
plan's specs (``launch.specs.LoweringPlan.place``), called under
``launch.mesh.use_mesh(mesh)`` on every rank of the mesh. The model's
``constrain`` sites then redistribute as the reference's hints lay out,
DTensor's per-op rules place everything else (GSPMD's propagation in the
reference), and plain tensors built inside the model count as replicated
(``shardingx.constrain.replicated_plain``, taken here). The train step's
gradients come back laid out as their params, its global norm reduces
across ranks, and the AdamW update runs piece by piece on each rank's
local blocks, since it is elementwise. Metrics come back as plain
tensors. The federated local step runs each rank's own silos on the
sub-mesh of the other axes (no collective spans two silo rows); the sync
gathers the silo dim over the silo axis.
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
from repro_torch.shardingx.constrain import is_dtensor, replicated_plain
from repro_torch.shardingx.policy import contiguous_strides
from repro_torch.tree import tree_leaves, tree_map

# elements of one piece of the optimizer update: bounds its temporaries
# (a few piece-sized fp32 tensors) whatever the size of a parameter
OPT_PIECE = 1 << 26


# the batch entries the train steps read
BATCH_KEYS = ("tokens", "labels", "prefix_embeds")


def _on(x, dev: torch.device) -> torch.Tensor:
    if is_dtensor(x):
        return x                      # laid out on its mesh already
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
        with replicated_plain(_sharded(params)):
            return bb.prefill(params, _on(batch["tokens"], dev), cfg,
                              cache_len=cache_len,
                              prefix_embeds=None if prefix is None
                              else _on(prefix, dev),
                              compute_dtype=compute_dtype,
                              cache_dtype=cache_dtype,
                              use_kernels=use_kernels)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                    device: DeviceLike = None) -> Callable:
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, state, tokens, cur_pos):
        with replicated_plain(_sharded(params)):
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


def _sharded(tree: Any) -> bool:
    """Whether a step's tree is laid out on a mesh (DTensor leaves)."""
    return is_dtensor(tree_leaves(tree)[0])


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated (or partial) DTensor as one plain tensor, the same on
    every rank; a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


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
        sharded = _sharded(params)
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        tree = tree_map(lambda _: next(it), params)
        b = {k: _on(batch[k], dev) for k in BATCH_KEYS if k in batch}
        with replicated_plain(sharded):
            loss, metrics = bb.loss_fn(tree, b, cfg,
                                       use_kernels=use_kernels,
                                       remat=tc.remat,
                                       compute_dtype=compute_dtype)
            grads = list(torch.autograd.grad(loss, live, allow_unused=True))
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            if sharded:
                # each gradient laid out as its param (and its moments)
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for p, g in zip(leaves, grads)]
            del tree, live
            with torch.no_grad():
                gnorm = _plain(global_norm(grads))
                metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
        with torch.no_grad():
            moments = [k for k in opt_state if k != "step"]
            moment_leaves = [tree_leaves(opt_state[k]) for k in moments]
            step = _local(opt_state["step"])
            # elementwise from here: each rank updates its own blocks, so
            # the moments must be split as their params
            for j, p in enumerate(leaves):
                if sharded and any(not is_dtensor(m[j]) or
                                   m[j].placements != p.placements
                                   for m in moment_leaves):
                    raise ValueError(
                        f"optimizer state leaf {j} is not laid out as its "
                        f"param {p.placements} (place it by the plan's "
                        "specs)")
                g, grads[j] = _local(grads[j]), None
                for p_, g_, *ms in zip(_pieces(_local(p)), _pieces(g),
                                       *(_pieces(_local(m[j]))
                                         for m in moment_leaves)):
                    g_, _ = clip_by_global_norm(g_, tc.grad_clip, norm=gnorm)
                    upd, new = opt.update(
                        g_, {"step": step, **dict(zip(moments, ms))}, p_)
                    for k, m_ in zip(moments, ms):
                        m_.copy_(new[k])
                    p_.copy_(apply_updates(p_, upd))
            if is_dtensor(opt_state["step"]):
                opt_state["step"].to_local().copy_(new["step"])
            else:
                opt_state["step"] = new["step"]
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
        mesh = current_mesh()
        axis = silo_axis_name(mesh) if mesh is not None else None
        if _sharded(silo_params):
            return _sharded_local_step(train_step, mesh, axis, silo_params,
                                       silo_opt_state, batch)
        d = tree_leaves(silo_params)[0].shape[0]
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


def _silo_dim_axes(mesh, axis: str):
    """The mesh's silo axis and the others: the sub-mesh a silo's step
    runs on."""
    if axis is None:
        raise ValueError("a silo stack of DTensors needs a mesh in context "
                         "(launch.mesh.use_mesh)")
    return mesh.submesh([a for a in mesh.axis_names if a != axis])


def _silo_view(t: torch.Tensor, i: int, sub, axis_pos: int):
    """Silo `i` of this rank's block of a silo-stacked DTensor `t` (silo
    dim split over mesh axis `axis_pos` only) as a DTensor on `sub`: a
    view of the block, so in-place writes land in the stack."""
    from torch.distributed.tensor import DTensor, Shard

    pl = list(t.placements)
    if not pl[axis_pos].is_shard(0) and t.device_mesh.size(axis_pos) > 1:
        raise ValueError(f"the silo dim of a {tuple(t.shape)} stack is not "
                         f"split over the silo axis: {t.placements}")
    if any(p.is_shard(0) for j, p in enumerate(pl) if j != axis_pos):
        raise ValueError(f"the silo dim is split over more than the silo "
                         f"axis: {t.placements}")
    del pl[axis_pos]
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in pl]
    shape = tuple(t.shape[1:])
    return DTensor.from_local(t.to_local()[i], sub.device_mesh, pl,
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def _sharded_local_step(train_step, mesh, axis, silo_params,
                        silo_opt_state, batch):
    """The local step on silo stacks of DTensors: this rank's block of the
    silo axis, each of its silos a DTensor on the sub-mesh of the other
    axes, so every collective of a silo's step stays in its silo row.
    Metrics come back as (d,) DTensors split over the silo axis."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.shardingx.constrain import silo_context
    from repro_torch.launch.mesh import use_mesh

    sub = _silo_dim_axes(mesh, axis)
    pos = mesh.axis_names.index(axis)
    step_l = silo_opt_state["step"].to_local()
    d_loc = step_l.shape[0]
    ms = []
    for i in range(d_loc):
        view = lambda t: _silo_view(t, i, sub, pos)   # noqa: E731
        state = {k: step_l[i] if k == "step" else tree_map(view, v)
                 for k, v in silo_opt_state.items()}
        with use_mesh(sub), silo_context(axis):
            _, state, m = train_step(tree_map(view, silo_params), state,
                                     tree_map(view, batch))
        step_l[i] = state["step"]
        ms.append(m)
    pl = [Shard(0) if j == pos else Replicate()
          for j in range(len(mesh.axis_names))]
    d = silo_opt_state["step"].shape[0]
    return silo_params, silo_opt_state, tree_map(
        lambda a: DTensor.from_local(a, mesh.device_mesh, pl,
                                     run_check=False, shape=(d,),
                                     stride=(1,)), _stack(ms))


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
    distances over the pieces (on a sharded stack also over the mesh axes
    a leaf is split on), then copies the chosen silo. For fedavg and
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
        d = leaves[0].shape[0]
        mask = torch.ones((d,), dtype=torch.float32,
                          device=_local(leaves[0]).device)
        gather = _silo_gather(leaves[0]) if _sharded(silo_params) else None
        # the sharded sync reads each piece gathered over the silo axis and
        # writes the result into this rank's own silos
        by_leaf = [[(c, gather(c) if gather else c)
                    for c in _silo_columns(_local(a))] for a in leaves]
        pieces = [cf for lp in by_leaf for cf in lp]
        if fed.aggregator == "krum":
            if gather:
                dist = _krum_total(leaves, [
                    sum(krum_distances(f) for _, f in lp) for lp in by_leaf])
            else:
                dist = sum(krum_distances(f) for _, f in pieces)
            best = krum_pick(dist, mask, fed.krum_f)
            for c, f in pieces:
                c.copy_(f.index_select(0, best.reshape(1)))
        else:
            for c, f in pieces:
                c.copy_(aggregate(f, mask).to(c.dtype)[None])
        if fed.aggregator == "fedavg" or fed.aggregator in ROBUST_AGGREGATORS:
            for t in tree_leaves(silo_opt_state):
                _local(t).zero_()
        return silo_params, silo_opt_state

    return sync


def _krum_total(leaves, parts) -> torch.Tensor:
    """The (d, d) Krum distances of a silo stack of DTensors from each
    leaf's distances over this rank's block (`parts`): a leaf split over
    mesh axes besides the silo axis has its partial distances summed over
    those axes, a leaf whole on an axis counts once, so every rank of a
    silo row holds the distances over all coordinates and picks the same
    silo."""
    from torch.distributed import _functional_collectives as funcol

    groups: Dict[Tuple[int, ...], torch.Tensor] = {}
    for a, part in zip(leaves, parts):
        if any(p.is_partial() for p in a.placements):
            raise ValueError(f"a partial silo stack: {a.placements}")
        axes = tuple(j for j, p in enumerate(a.placements)
                     if p.is_shard() and not p.is_shard(0))
        groups[axes] = groups.get(axes, 0) + part
    total = None
    for axes in sorted(groups):
        dist = groups[axes]
        for j in axes:
            dist = funcol.wait_tensor(funcol.all_reduce(
                dist, "sum", (leaves[0].device_mesh, j)))
        total = dist if total is None else total + dist
    return total


def _silo_gather(like: torch.Tensor) -> Callable:
    """For a silo stack of DTensors like `like` (silo dim split over one
    mesh axis): a function taking a (d_loc, n) piece of this rank's block
    to the (d, n) piece of every silo of its row, gathered over the silo
    axis in silo order, so the aggregate is computed from the same rows,
    in the same order, as on one process."""
    from torch.distributed import _functional_collectives as funcol

    axes = [j for j, p in enumerate(like.placements) if p.is_shard(0)]
    if len(axes) != 1:
        raise ValueError(f"the silo dim must be split over one mesh axis: "
                         f"{like.placements}")
    group = (like.device_mesh, axes[0])

    # (renamed in newer torch; the same collective)
    all_gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor

    def gather(piece: torch.Tensor) -> torch.Tensor:
        return funcol.wait_tensor(all_gather(piece.contiguous(), 0, group))

    return gather


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
