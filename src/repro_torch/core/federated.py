"""Step 4 of FedDCL: federated learning between intra-group DC servers
(counterpart of ``repro.core.federated``).

``run_federated`` is the one trainer: FedAvg, FedProx, FedSGD and the
robust aggregators over the zero-padded silo layout (``pad_silo_data``)
with per-sample masks, so ragged silos train exactly their real samples.
Two engines consume the same layout and the same minibatch schedule, and
agree to float tolerance:

  engine="host" — the reference's paper-faithful loop: one step per
      minibatch per epoch per silo per round, the padded silos moved to
      the device once, batches gathered there by index, one host sync per
      silo per round.
  engine="scan" — the compiled form. A PLAN (``make_fl_plan``) holds one
      whole round as a torch function: the per-silo loss vmapped over the
      silo dim (``torch.func.vmap``, gradients by autograd), epochs x
      minibatches unrolled, and the round boundary (weighted mean or robust
      statistic). On CUDA the plan captures that round ONCE into a
      ``torch.cuda.CUDAGraph`` over static buffers and replays it every
      round, with no host sync between rounds; on the CPU the same round
      runs eagerly. A capture that fails raises: nothing falls back to the
      eager round or to the host engine.

Plans take all tenant data as copies into their buffers, so one captured
graph serves every tenant whose padded shapes match: ``PlanCache`` keys
plans on the full signature with silo / batch axes rounded up to pow2
buckets (``run_federated(cache=True)``). A cached plan is not re-entrant:
a second run on it while one is live (an ``eval_fn`` that trains on the
same plan) raises.

The minibatch schedule is an argument: an array (rounds, d, epochs,
n_slots) of per-epoch slot permutations or a callable rnd -> (d, epochs,
n_slots), at the layout ``padded_layout`` gives (with ``cache``, the
bucketed one). The reference draws it with ``jax.random`` (``round_perms``),
which torch cannot reproduce, so parity runs inject the reference's
schedule; without one the port draws its own from `seed` with numpy.

Hostile-world options, in both engines: the robust aggregators
("median" / "trimmed_mean" / "krum", unweighted masked statistics over the
available silos), silo dropout (``dropout_rate`` or an explicit
``availability`` matrix, folded into per-round weights on the host) and
per-silo delta scaling (``silo_scale``, the attacker's injection point).

A plan holds no tenant data between runs: once a run has returned its
results, every buffer it filled (the silo stack, weights, scales,
schedule, carry and loss) is zeroed. ``lower_fl_plan`` binds a plan to one
tenant's arguments for ``analysis.hlo_audit``, which checks both that a
plan answers from its arguments and that an idle plan holds only splats.

Not in this port yet: mesh sharding (``mesh=`` raises NotImplementedError).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import capture, zero_buffers
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map


# ==========================================================================
# 1. Shared substrate: padded silo layout + weights + masked step
# ==========================================================================

@dataclass(frozen=True)
class PaddedSilos:
    """Zero-padded layout of the silo datasets.

    X (d, n_slots, m) float32 and Y (d, n_slots[, k]) are padded on the
    sample axis; w (d, n_slots) float32 holds 1.0 on REAL samples and 0.0 on
    padding; sizes (d,) int64 are the real sample counts (kept integral:
    float32 counts corrupt FedAvg weights above 2^24 samples).
    n_slots = num_batches * batch_size ≥ max_i n_i, so every minibatch has a
    static shape and an epoch is exactly one permutation of the slot axis.
    Trailing EMPTY silos (size 0) and all-padding batches are how the plan
    cache rounds tenants up to shared shapes.
    """
    X: np.ndarray
    Y: np.ndarray
    w: np.ndarray
    sizes: np.ndarray
    n_slots: int
    batch_size: int
    num_batches: int

    @property
    def num_silos(self) -> int:
        return self.X.shape[0]

    @property
    def has_padding(self) -> bool:
        return bool(np.any(self.sizes < self.n_slots))


def pad_silo_data(silo_data: Sequence[Tuple[np.ndarray, np.ndarray]],
                  batch_size: Optional[int] = None,
                  fill: float = 0.0,
                  min_batches: int = 0,
                  min_silos: int = 0) -> PaddedSilos:
    """Stack ragged per-silo (X_i, Y_i) into the padded engine layout.

    batch_size=None means full-batch (FedSGD): one batch of n_max slots.
    `fill` sets the value written into padded X rows. min_batches /
    min_silos round the layout UP (extra all-padding batches / zero-size
    silos, exact no-ops under the masks).
    """
    sizes = np.array([np.asarray(x).shape[0] for x, _ in silo_data], np.int64)
    n_max = int(sizes.max())
    if batch_size is None:
        bs, nb = max(n_max, 1), 1
    else:
        bs = int(batch_size)
        nb = -(-n_max // bs)
    nb = max(nb, int(min_batches), 1)
    n_slots = bs * nb
    d = max(len(silo_data), int(min_silos))
    if d > len(silo_data):
        sizes = np.concatenate([sizes, np.zeros(d - len(silo_data), np.int64)])
    x0, y0 = np.asarray(silo_data[0][0]), np.asarray(silo_data[0][1])
    X = np.full((d, n_slots) + x0.shape[1:], fill, np.float32)
    Y = np.zeros((d, n_slots) + y0.shape[1:], y0.dtype)
    w = np.zeros((d, n_slots), np.float32)
    for i, (xi, yi) in enumerate(silo_data):
        n = np.asarray(xi).shape[0]
        X[i, :n] = np.asarray(xi, np.float32)
        Y[i, :n] = np.asarray(yi)
        w[i, :n] = 1.0
    return PaddedSilos(X=X, Y=Y, w=w, sizes=sizes, n_slots=n_slots,
                       batch_size=bs, num_batches=nb)


def _norm_weights(sizes: np.ndarray) -> np.ndarray:
    """Per-silo FedAvg weights from integral sample counts: normalized on
    host in float64, then cast to float32."""
    s = np.asarray(sizes, np.float64)
    return (s / s.sum()).astype(np.float32)


# Tiny-epsilon guard for loss denominators (identical to max(Σw, 1) for
# {0,1} masks, and no deflation under fractional sample weights).
_DEN_EPS = 1e-12


def make_dropout_schedule(seed: int, rounds: int, num_silos: int,
                          rate: float,
                          sizes: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-round silo availability mask, (rounds, num_silos) float32 {0,1},
    drawn on the host with numpy (bit for bit the reference's). Each
    (round, silo) is an independent Bernoulli(1 - rate) draw; empty silos
    (sizes 0) are never available, and every round keeps at least one
    available REAL silo (the max-draw silo is resurrected)."""
    real = (np.ones(num_silos, bool) if sizes is None
            else np.asarray(sizes) > 0)
    if not real.any():
        raise ValueError("dropout schedule needs at least one real silo")
    rng = np.random.default_rng(np.asarray([seed, 0xD120], np.uint64))
    u = rng.random((rounds, num_silos))
    av = (u >= rate) & real[None, :]
    dead = ~av.any(axis=1)
    if dead.any():
        best = np.argmax(np.where(real[None, :], u, -1.0), axis=1)
        av[dead, best[dead]] = True
    return av.astype(np.float32)


def _round_weights(sizes: np.ndarray, av: Optional[np.ndarray],
                   rounds: int) -> np.ndarray:
    """Per-ROUND aggregation weights, (rounds, d) float32: sample-count
    weights masked by that round's availability and renormalized. With full
    availability every row equals `_norm_weights(sizes)` bit for bit."""
    s = np.asarray(sizes, np.float64)
    m = np.broadcast_to(s[None, :], (rounds, len(s))).copy()
    if av is not None:
        m = m * np.asarray(av, np.float64)
    tot = m.sum(axis=1, keepdims=True)
    if np.any(tot <= 0):
        bad = int(np.argmax(tot[:, 0] <= 0))
        raise ValueError(
            f"round {bad} has zero available sample mass — the availability "
            "schedule must keep at least one real silo per round")
    return (m / tot).astype(np.float32)


# --------------------------------------------------------------------------
# Robust aggregation statistics (the hostile-world round boundary)
# --------------------------------------------------------------------------

ROBUST_AGGREGATORS = ("median", "trimmed_mean", "krum")
AGGREGATORS = ("fedavg", "fedprox", "fedsgd") + ROBUST_AGGREGATORS

_MASK_BIG = 1e30        # sentinel pushed into masked-out sort slots; finite
                        # so downstream arithmetic never meets inf/nan

# The valid count k stays a device tensor and every pick is an index_select
# with a device index: no .item(), no boolean indexing, no branch on a
# value, so the statistics run inside a captured CUDA graph.


def _take(s: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """s[i] along dim 0 for a 0-dim device index."""
    return s.index_select(0, i.reshape(1).long()).squeeze(0)


def _masked_sort(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sort (d, ...) along the silo axis with masked-out silos pushed to the
    top: valid entries occupy sorted positions [0, k) for k = Σ mask."""
    m = mask.reshape((-1,) + (1,) * (vals.dim() - 1))
    v = torch.where(m > 0, vals.float(), _MASK_BIG)
    return torch.sort(v, dim=0).values


def masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over silos with mask=1 (dropped / empty /
    padded silos excluded exactly)."""
    s = _masked_sort(vals, mask)
    k = torch.sum(mask).to(torch.int32)
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, min=0)
    return 0.5 * (_take(s, lo) + _take(s, hi))


def masked_trimmed_mean(vals: torch.Tensor, mask: torch.Tensor,
                        trim_frac: float) -> torch.Tensor:
    """Coordinate-wise mean over the valid silos with the floor(k·trim_frac)
    smallest AND largest values dropped per coordinate; the trim is clamped
    so at least one value survives."""
    d = vals.shape[0]
    s = _masked_sort(vals, mask)
    k = torch.sum(mask).to(torch.int32)
    t = torch.floor(k.float() * float(trim_frac)).to(torch.int32)
    t = torch.minimum(torch.clamp(t, min=0), torch.clamp((k - 1) // 2, min=0))
    idx = torch.arange(d, dtype=torch.int32, device=vals.device)
    keep = ((idx >= t) & (idx < k - t)).float()
    kept = torch.tensordot(keep, s, dims=([0], [0]))
    return kept / torch.clamp(k - 2 * t, min=1).float()


def krum_distances(flat: torch.Tensor) -> torch.Tensor:
    """(d, d) squared distances between the rows of (d, P) flattened silo
    updates. Distances add over coordinates, so a caller that cannot hold
    the whole (d, P) may sum this over column pieces."""
    f32 = flat.float()
    sq = torch.sum(f32 * f32, dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * (f32 @ f32.T)


def krum_select(flat: torch.Tensor, mask: torch.Tensor,
                krum_f: int) -> torch.Tensor:
    """Krum selection index (a 0-dim device tensor) over (d, P) flattened
    silo updates: each valid silo is scored by the sum of its squared
    distances to its k−f−2 nearest valid peers; the lowest score wins
    (Blanchard et al., NeurIPS'17)."""
    return krum_pick(krum_distances(flat), mask, krum_f)


def krum_pick(dist: torch.Tensor, mask: torch.Tensor,
              krum_f: int) -> torch.Tensor:
    """``krum_select`` from the (d, d) squared distances."""
    d = dist.shape[0]
    valid = mask > 0
    pair = valid[:, None] & valid[None, :] & ~torch.eye(
        d, dtype=torch.bool, device=dist.device)
    dist = torch.where(pair, torch.clamp(dist, min=0.0), _MASK_BIG)
    k = torch.sum(mask).to(torch.int32)
    nn = torch.minimum(torch.clamp(k - int(krum_f) - 2, min=1),
                       torch.clamp(k - 1, min=1))
    sd = torch.sort(dist, dim=1).values
    neighbor = torch.arange(d, dtype=torch.int32, device=dist.device)[None, :] < nn
    scores = torch.sum(torch.where(neighbor, sd, 0.0), dim=1)
    scores = torch.where(valid, scores, float("inf"))
    return torch.argmin(scores)


def robust_aggregate(stacked: Any, mask: torch.Tensor, aggregator: str, *,
                     trim_frac: float = 0.2, krum_f: int = 1) -> Any:
    """Robust boundary over a (d, ...) silo-stacked tree: aggregate only the
    silos with mask=1 (available AND real), ignoring sample weights — a
    poisoned silo cannot buy influence with a large claimed sample count."""
    if aggregator == "median":
        return tree_map(lambda a: masked_median(a, mask).to(a.dtype), stacked)
    if aggregator == "trimmed_mean":
        return tree_map(
            lambda a: masked_trimmed_mean(a, mask, trim_frac).to(a.dtype),
            stacked)
    if aggregator == "krum":
        flat = torch.cat([l.reshape(l.shape[0], -1).float()
                          for l in tree_leaves(stacked)], dim=1)
        best = krum_select(flat, mask, krum_f)
        return tree_map(lambda a: _take(a, best), stacked)
    raise ValueError(f"unknown robust aggregator {aggregator!r}; "
                     f"choose one of {ROBUST_AGGREGATORS}")


def _per_silo(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A (d,) vector shaped to broadcast over a (d, ...) leaf."""
    return v.reshape((-1,) + (1,) * (a.dim() - 1))


def apply_silo_scale(stacked: Any, ref: Any, scale: torch.Tensor) -> Any:
    """Per-silo delta scaling at the boundary: silo i submits
    ref + scale_i·(p_i − ref), written p + (scale−1)·(p − ref) so honest
    silos (scale 1) add a literal 0.0: an exact no-op."""
    def leaf(s, g):
        sc = _per_silo(scale.float() - 1.0, s)
        delta = s.float() - g.float()[None]
        return (s.float() + sc * delta).to(s.dtype)
    return tree_map(leaf, stacked, ref)


# --------------------------------------------------------------------------
# The masked objective and step shared by both engines
# --------------------------------------------------------------------------

def fedprox_regularizer(params: Any, ref_params: Any, mu: float) -> torch.Tensor:
    return 0.5 * mu * sum(
        torch.sum(torch.square(a.float() - b.float()))
        for a, b in zip(tree_leaves(params), tree_leaves(ref_params)))


def _make_batch_loss(loss_fn, per_example: bool, fedprox_mu: float):
    """Masked batch objective: per-example losses weighted by the sample
    mask (padded slots contribute exactly zero to value and gradient);
    FedProx adds the proximal pull toward the round-start params."""
    def batch_loss(p, x, y, w, ref):
        if per_example:
            l = loss_fn(p, x, y)
            loss = torch.sum(w * l) / torch.clamp(torch.sum(w), min=_DEN_EPS)
        else:
            loss = loss_fn(p, x, y)
        if fedprox_mu:
            loss = loss + fedprox_regularizer(p, ref, fedprox_mu)
        return loss

    return batch_loss


def _grads_and_loss(loss_of: Callable[[Any], torch.Tensor], params: Any):
    """(gradient tree, loss) of `loss_of(params)` by torch.autograd. A
    per-silo loss vector (d,) over silo-stacked params gives each silo's
    own gradient (the gradient of its sum: silo i's loss reads only
    params[i]). Plain autograd, not ``torch.func.grad``: that one imports
    torch._dynamo (and with it sympy and torch.distributed, ~800 modules,
    seconds) at the first call of a process."""
    with torch.enable_grad():
        q = tree_map(lambda a: a.detach().requires_grad_(), params)
        loss = loss_of(q)
        grads = iter(torch.autograd.grad(loss.sum(), tree_leaves(q),
                                         allow_unused=True,
                                         materialize_grads=True))
    return tree_map(lambda _: next(grads), q), loss.detach()


def _make_sgd_step(batch_loss, opt: Optimizer, masked: bool = False):
    """One optimizer step of one silo. masked=True makes batches with ZERO
    real samples exact no-ops (no step count, no moment decay) with a
    `torch.where` on the device, so the guard costs no host sync."""
    def step(p, opt_state, x, y, w, ref):
        grads, loss = _grads_and_loss(lambda q: batch_loss(q, x, y, w, ref),
                                      p)
        updates, new_state = opt.update(grads, opt_state, p)
        new_p = apply_updates(p, updates)
        if masked:
            has_real = torch.sum(w) > 0
            new_p = tree_map(lambda a, b: torch.where(has_real, a, b),
                             new_p, p)
            new_state = tree_map(lambda a, b: torch.where(has_real, a, b),
                                 new_state, opt_state)
        return new_p, new_state, loss

    return step


def _make_silo_step(batch_loss, opt: Optimizer, masked: bool = False):
    """`_make_sgd_step` for every silo at once, over silo-stacked params,
    optimizer state and batches (x (d, bs, …), y, w (d, bs); ref
    unstacked): the loss vmapped over the silo dim, each silo's gradient by
    autograd through it, the update vmapped. Returns (params, state, (d,)
    losses)."""
    silo_loss = torch.func.vmap(batch_loss, in_dims=(0, 0, 0, 0, None))
    silo_update = torch.func.vmap(opt.update)

    def step(sp, so, x, y, w, ref):
        grads, losses = _grads_and_loss(lambda q: silo_loss(q, x, y, w, ref),
                                        sp)
        updates, new_so = silo_update(grads, so, sp)
        new_sp = apply_updates(sp, updates)
        if masked:
            has_real = torch.sum(w, dim=1) > 0
            keep = lambda a, b: torch.where(_per_silo(has_real, a), a, b)
            new_sp = tree_map(keep, new_sp, sp)
            new_so = tree_map(keep, new_so, so)
        return new_sp, new_so, losses

    return step


def _weighted_silo_mean(stacked: Any, wn: torch.Tensor) -> Any:
    """Sample-weighted mean over the leading silo dim (wn sums to 1)."""
    return tree_map(
        lambda a: torch.tensordot(wn, a.float(), dims=([0], [0])).to(a.dtype),
        stacked)


def _stack_trees(trees: Sequence[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _stacked_opt_init(opt: Optimizer, params: Any, d: int) -> Any:
    """`opt.init` of d silos that start alike, stacked on a leading silo
    dim (opt.init under vmap would leave the step counter unbatched)."""
    return tree_map(lambda a: a.expand((d,) + tuple(a.shape)).contiguous(),
                    opt.init(params))


def round_perms(seed: int, rnd: int, num_silos: int, epochs: int,
                n_slots: int) -> np.ndarray:
    """The port's own minibatch schedule for one round, (d, epochs, n_slots)
    int64, drawn with numpy from (seed, round). It is NOT the reference's
    ``jax.random`` schedule; parity runs inject that one instead."""
    rng = np.random.default_rng([int(seed), int(rnd)])
    return np.stack([np.stack([rng.permutation(n_slots)
                               for _ in range(epochs)])
                     for _ in range(num_silos)])


Schedule = Union[np.ndarray, Callable[[int], np.ndarray]]


def _schedule_fn(schedule: Optional[Schedule], seed: int, d: int, epochs: int,
                 n_slots: int, rounds: int) -> Callable[[int], np.ndarray]:
    if schedule is None:
        return lambda rnd: round_perms(seed, rnd, d, epochs, n_slots)
    if callable(schedule):
        fn = schedule
    else:
        arr = np.asarray(schedule)
        if arr.shape != (rounds, d, epochs, n_slots):
            raise ValueError(f"schedule must be (rounds, d, epochs, n_slots) "
                             f"= {(rounds, d, epochs, n_slots)}; got "
                             f"{arr.shape}")
        fn = lambda rnd: arr[rnd]

    def checked(rnd: int) -> np.ndarray:
        perms = np.asarray(fn(rnd))
        if perms.shape != (d, epochs, n_slots):
            raise ValueError(f"schedule for round {rnd} must be (d, epochs, "
                             f"n_slots) = {(d, epochs, n_slots)}; got "
                             f"{perms.shape}")
        return perms.astype(np.int64)

    return checked


# ==========================================================================
# 1b. The plan cache: shape-bucketed reuse of captured rounds
# ==========================================================================

def bucket_pow2(n: int) -> int:
    """Round n up to the next power of two (the default bucket policy):
    ≤ 2× padding waste, log-many buckets over any tenant population."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _tree_def(tree: Any) -> Tuple:
    if isinstance(tree, dict):
        return ("dict", tuple((k, _tree_def(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_tree_def(t) for t in tree))
    return ("leaf",)


def _tree_signature(tree: Any) -> Tuple:
    """Hashable (structure, leaf shapes/dtypes) fingerprint of a tree."""
    return (_tree_def(tree),
            tuple((tuple(l.shape), str(l.dtype)) for l in tree_leaves(tree)))


_plans_built = 0


def plans_built() -> int:
    """Plans (``FLPlan``, ``ServePlan``) built since the process started,
    in a cache or outside one: ``analysis.hlo_audit.CompileCounter`` reads
    it."""
    return _plans_built


def _note_plan_built() -> None:
    """Called once by every plan's constructor."""
    global _plans_built
    _plans_built += 1


class PlanCache:
    """LRU cache of FL plans keyed on the full signature.

    A plan (make_fl_plan) takes all tenant data as copies into its
    buffers, so two run_federated calls whose padded layouts land in the
    same shape bucket — (num_silos, num_batches, batch_size, feature/target
    shapes, params signature) — and share the same static config
    (aggregator, rounds, epochs, reset_opt, eval mode, per_example,
    fedprox_mu, robust config, loss/opt identity, device) reuse ONE plan
    and, on CUDA, its ONE captured graph. Bucketing (bucket_silos /
    bucket_batches, default next-pow2) rounds the silo and batch axes UP.

    Counters: hits / misses / evictions; `misses` == plans built through
    this cache. `captures` counts CUDA graphs its plans captured (0 on the
    CPU, where nothing is captured) and `replays` the rounds they replayed.
    """

    def __init__(self, max_plans: int = 64,
                 bucket_silos: Callable[[int], int] = bucket_pow2,
                 bucket_batches: Callable[[int], int] = bucket_pow2):
        self._plans: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self.max_plans = max_plans
        self.bucket_silos = bucket_silos
        self.bucket_batches = bucket_batches
        self.hits = self.misses = self.evictions = 0
        self.captures = self.replays = 0

    def __len__(self) -> int:
        return len(self._plans)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "plans": len(self._plans),
                "captures": self.captures, "replays": self.replays}

    def plans(self) -> List[Any]:
        """The cached plans, least recently used first."""
        return [plan for plan, _ in self._plans.values()]

    def clear(self) -> None:
        self._plans.clear()
        self.hits = self.misses = self.evictions = 0
        self.captures = self.replays = 0

    def lookup(self, key: Tuple, build: Callable[[], "FLPlan"],
               pins: Tuple = ()) -> Tuple["FLPlan", bool]:
        """Return (plan, was_hit). `pins` holds strong references (loss_fn,
        opt) for entries keyed on object identity, so a cached id() can
        never be recycled while the entry lives."""
        if key in self._plans:
            self._plans.move_to_end(key)
            self.hits += 1
            return self._plans[key][0], True
        plan = build()
        self._plans[key] = (plan, pins)
        self.misses += 1
        while len(self._plans) > self.max_plans:
            self._plans.popitem(last=False)
            self.evictions += 1
        return plan, False


_DEFAULT_PLAN_CACHE: Optional[PlanCache] = None


def default_plan_cache() -> PlanCache:
    """The process-wide plan cache used by ``run_federated(cache=True)``
    and the FedDCL.fit() API."""
    global _DEFAULT_PLAN_CACHE
    if _DEFAULT_PLAN_CACHE is None:
        _DEFAULT_PLAN_CACHE = PlanCache()
    return _DEFAULT_PLAN_CACHE


def plan_cache_stats() -> Dict[str, int]:
    return default_plan_cache().stats()


def clear_plan_cache() -> None:
    if _DEFAULT_PLAN_CACHE is not None:
        _DEFAULT_PLAN_CACHE.clear()


# ==========================================================================
# 2. The federated engine
# ==========================================================================

@dataclass
class FLResult:
    params: Any
    history: List[Dict[str, float]]
    cache_stats: Optional[Dict[str, int]] = None   # set when a PlanCache ran
    # scan engine: host seconds of the plan's run, {"bind_s": tenant copied
    # into the plan, "warmup_s" / "capture_s": the round's CUDA-graph
    # warm-up and capture (0 without one), "rounds_s": every round, the
    # final fetches included}
    timings: Optional[Dict[str, float]] = None


def fedavg_average(params_list: Sequence[Any], weights: Sequence[float]) -> Any:
    w = np.asarray(weights, np.float64)
    w = w / max(w.sum(), _DEN_EPS)
    return tree_map(
        lambda *ps: sum(float(wi) * p.float()
                        for wi, p in zip(w, ps)).to(ps[0].dtype),
        *params_list)


def _not_in_port(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, {queue})")


def _plan_cache_of(cache: Any, engine: str) -> Optional[PlanCache]:
    if cache is None or cache is False:
        return None
    if engine != "scan":
        raise ValueError("cache=... requires engine='scan' — the plan cache "
                         "stores scan-engine plans")
    return cache if isinstance(cache, PlanCache) else default_plan_cache()


def padded_layout(silo_data: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                  batch_size: int = 32, aggregator: str = "fedavg",
                  cache: Any = None, pad_fill: float = 0.0) -> PaddedSilos:
    """The padded layout run_federated trains on. With a plan cache the
    silo count and (fedsgd: the full batch, else the batch count) are
    rounded up to its buckets: by default d' = bucket_pow2(d) silos and
    n_slots' = batch_size · bucket_pow2(⌈n_max / batch_size⌉) slots. An
    injected schedule is (rounds, d', local_epochs, n_slots') at it."""
    plan_cache = _plan_cache_of(cache, "scan")
    if plan_cache is None:
        return pad_silo_data(silo_data,
                             None if aggregator == "fedsgd" else batch_size,
                             fill=pad_fill)
    n_max = max(np.asarray(x).shape[0] for x, _ in silo_data)
    if aggregator == "fedsgd":
        bs_eff: Optional[int] = plan_cache.bucket_batches(n_max)
        min_nb = 1
    else:
        bs_eff = batch_size
        min_nb = plan_cache.bucket_batches(-(-n_max // batch_size))
    return pad_silo_data(silo_data, bs_eff, fill=pad_fill, min_batches=min_nb,
                         min_silos=plan_cache.bucket_silos(len(silo_data)))


def run_federated(
    loss_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    init_params: Any,
    silo_data: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    opt: Optimizer,
    rounds: int,
    local_epochs: int,
    batch_size: int = 32,
    aggregator: str = "fedavg",
    fedprox_mu: float = 0.0,
    seed: int = 0,
    eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
    engine: str = "host",
    per_example: Optional[bool] = None,
    reset_opt_per_round: bool = True,
    pad_fill: float = 0.0,
    schedule: Optional[Schedule] = None,
    cache: Any = None,
    loss_id: Optional[Tuple] = None,
    opt_id: Optional[Tuple] = None,
    mesh=None,
    eval_chunk: int = 8,
    dropout_rate: float = 0.0,
    availability: Optional[np.ndarray] = None,
    silo_scale: Optional[Sequence[float]] = None,
    trim_frac: float = 0.2,
    krum_f: int = 1,
    device: DeviceLike = None,
) -> FLResult:
    """Federated training over host-resident silo datasets on `device`
    (None -> CUDA, which raises without a card).

    loss_fn takes (params, x, y) and returns a (batch,) per-example loss
    (ragged silos are zero-padded and masked) or a scalar batch mean (only
    valid when no padding is needed). `per_example` is detected from the
    output shape when None. `init_params` is a tree of tensors on `device`;
    the scan engine copies it and never writes to it. `schedule` fixes the
    minibatch order at the layout ``padded_layout`` gives (see the module
    doc); fedsgd takes one full batch per silo per round and ignores it.
    reset_opt_per_round=False carries silo optimizer state across rounds.

    engine="scan" runs the compiled round (one CUDA-graph replay a round on
    a card). cache=True (or a PlanCache) routes it through the
    shape-bucketed plan cache; the bucketed layout is then the canonical
    layout of the run. loss_id / opt_id give the loss / optimizer a stable
    cache identity (e.g. ("mlp_per_example_loss", task) / ("adamw", lr));
    without them object identity is used. cache_stats on the result records
    {hit, hits, misses, evictions, plans, captures, replays}. With eval_fn,
    each round's params are copied into a device stack of eval_chunk
    rounds, and eval_fn sees them (copies no later round overwrites) once
    per chunk, after one fetch of the chunk's losses.

    Hostile-world options: aggregator may be one of ROBUST_AGGREGATORS
    ("median" / "trimmed_mean" with trim_frac per tail / "krum" with krum_f
    tolerated Byzantine silos), an unweighted statistic over the available
    silos; dropout_rate draws a per-(round, silo) availability schedule on
    the host (``make_dropout_schedule``; `availability` passes an explicit
    (rounds, num_real_silos) {0,1} matrix instead), and unavailable silos
    train nothing that round and carry zero weight; silo_scale
    (num_real_silos,) multiplies each silo's submitted round delta (1.0 is
    an exact no-op).
    """
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         f"choose one of {AGGREGATORS}")
    if engine not in ("host", "scan"):
        raise ValueError(f"unknown engine {engine!r}; choose 'host' or 'scan'")
    if mesh is not None:
        raise _not_in_port("mesh= (silo sharding)", "Queue 1, sharding")
    plan_cache = _plan_cache_of(cache, engine)
    dev = resolve_device(device)
    padded = padded_layout(silo_data, batch_size=batch_size,
                           aggregator=aggregator, cache=plan_cache,
                           pad_fill=pad_fill)
    data = _to_device(padded, dev)
    if per_example is None:
        per_example = _detect_per_example(loss_fn, init_params, data,
                                          padded.batch_size)
    if not per_example and padded.has_padding:
        raise ValueError(
            f"silo sizes {padded.sizes.astype(int).tolist()} need padding to "
            f"{padded.n_slots} slots, which a scalar (batch-mean) loss cannot "
            "mask — pass a per-example loss (returning a (batch,) vector, "
            "e.g. models.mlp.mlp_per_example_loss) or equal-size silos "
            "divisible by batch_size")
    if availability is not None and dropout_rate:
        raise ValueError("pass either dropout_rate or an explicit "
                         "availability matrix, not both")
    av: Optional[np.ndarray] = None
    d_real = len(silo_data)
    if availability is not None:
        av = np.asarray(availability, np.float32)
        if av.shape[0] != rounds or av.shape[1] > padded.num_silos:
            raise ValueError(
                f"availability must be (rounds, num_silos≤{padded.num_silos})"
                f" for rounds={rounds}; got {av.shape}")
    elif dropout_rate:
        # drawn over the REAL silo count, so bucket padding never changes it
        av = make_dropout_schedule(seed, rounds, d_real, float(dropout_rate),
                                   sizes=padded.sizes[:d_real])
    if av is not None and av.shape[1] < padded.num_silos:
        # bucket-padding silos are empty: never available
        av = np.concatenate(
            [av, np.zeros((rounds, padded.num_silos - av.shape[1]),
                          np.float32)], axis=1)
    scale_vec: Optional[np.ndarray] = None
    if silo_scale is not None:
        s = np.asarray(silo_scale, np.float32).reshape(-1)
        if s.shape[0] > padded.num_silos:
            raise ValueError(f"silo_scale has {s.shape[0]} entries for "
                             f"{padded.num_silos} silos")
        scale_vec = np.ones(padded.num_silos, np.float32)
        scale_vec[:s.shape[0]] = s
    # dropout makes whole rounds all-padding for the dropped silos, so the
    # exact-no-op step guard must be on even when the layout itself is dense
    needs_mask = padded.has_padding or (av is not None and not np.all(av > 0))
    robust = aggregator in ROBUST_AGGREGATORS
    mu = fedprox_mu if aggregator == "fedprox" else 0.0
    batch_loss = _make_batch_loss(loss_fn, per_example, mu)
    sched = _schedule_fn(schedule, seed, padded.num_silos, local_epochs,
                         padded.n_slots, rounds)
    run_kw = dict(opt=opt, rounds=rounds, local_epochs=local_epochs,
                  aggregator=aggregator, schedule=sched, eval_fn=eval_fn,
                  per_example=per_example, reset_opt=reset_opt_per_round,
                  availability=av, silo_scale=scale_vec, trim_frac=trim_frac,
                  krum_f=krum_f, device=dev)
    if engine == "host":
        return _run_host(batch_loss, init_params, padded, data,
                         masked=needs_mask, **run_kw)
    if plan_cache is None:
        return _run_scan(batch_loss, init_params, padded, data,
                         eval_chunk=eval_chunk, masked=needs_mask, **run_kw)
    mode = "chunk" if eval_fn is not None else "none"
    key = (
        padded.num_silos, padded.num_batches, padded.batch_size,
        tuple(padded.X.shape[2:]), str(padded.X.dtype),
        tuple(padded.Y.shape[2:]), str(padded.Y.dtype),
        _tree_signature(init_params),
        # a plan runs one round at a time, so rounds never enters it; the
        # key keeps the reference's (rounds only without eval_fn)
        aggregator, None if mode == "chunk" else rounds,
        local_epochs, bool(reset_opt_per_round),
        mode, bool(per_example), float(mu),
        (float(trim_frac), int(krum_f)) if robust else None,
        loss_id if loss_id is not None else ("id", id(loss_fn)),
        opt_id if opt_id is not None else ("id", id(opt)),
        str(dev),
    )
    plan, was_hit = plan_cache.lookup(
        key,
        lambda: make_fl_plan(
            num_silos=padded.num_silos, num_batches=padded.num_batches,
            batch_size=padded.batch_size, opt=opt, batch_loss=batch_loss,
            local_epochs=local_epochs, aggregator=aggregator,
            per_example=per_example, reset_opt=reset_opt_per_round,
            masked=True, trim_frac=trim_frac, krum_f=krum_f, device=dev),
        pins=(loss_fn, opt))
    captures, replays = plan.captures, plan.replays
    try:
        res = _run_scan(batch_loss, init_params, padded, data, plan=plan,
                        eval_chunk=eval_chunk, **run_kw)
    finally:
        plan_cache.captures += plan.captures - captures
        plan_cache.replays += plan.replays - replays
    res.cache_stats = {"hit": was_hit, **plan_cache.stats()}
    return res


def _to_device(padded: PaddedSilos, dev: torch.device):
    """The padded stack on the device once: X fp32, Y fp32 (regression) or
    int64 (labels), w fp32."""
    X = torch.as_tensor(padded.X, device=dev)
    Y = torch.as_tensor(padded.Y, device=dev)
    Y = Y.float() if Y.is_floating_point() else Y.long()
    w = torch.as_tensor(padded.w, device=dev)
    return X, Y, w


def _detect_per_example(loss_fn, params, data, bs: int) -> bool:
    """A loss returning shape (batch,) is per-example (maskable); shape ()
    is a black-box batch mean."""
    X, Y, _ = data
    with torch.no_grad():
        out = loss_fn(params, X[0, :bs], Y[0, :bs])
    if out.shape == ():
        return False
    if out.shape == (bs,):
        return True
    raise ValueError(
        f"loss_fn must return a scalar batch mean or a (batch,)-shaped "
        f"per-example vector; got shape {tuple(out.shape)}")


# --------------------------------------------------------------------------
# 2a. engine="host": one step per minibatch per epoch per silo per round
# --------------------------------------------------------------------------

def _run_host(batch_loss, init_params, padded: PaddedSilos, data, *, opt,
              rounds, local_epochs, aggregator, schedule, eval_fn, per_example,
              reset_opt, masked: bool, device: torch.device,
              availability: Optional[np.ndarray] = None,
              silo_scale: Optional[np.ndarray] = None,
              trim_frac: float = 0.2, krum_f: int = 1) -> FLResult:
    d, nb, bs = padded.num_silos, padded.num_batches, padded.batch_size
    step = _make_sgd_step(batch_loss, opt, masked=masked)
    X, Y, w = data
    w_host = padded.w
    robust = aggregator in ROBUST_AGGREGATORS
    wr = _round_weights(padded.sizes, availability, rounds)   # (rounds, d)
    scale = None if silo_scale is None else \
        torch.as_tensor(np.asarray(silo_scale, np.float32), device=device)

    gp = init_params
    fedsgd_state = opt.init(gp) if aggregator == "fedsgd" else None
    opt_states: List[Any] = [opt.init(gp) for _ in range(d)] if not reset_opt else []
    history: List[Dict[str, float]] = []
    for rnd in range(rounds):
        wr_r = wr[rnd]
        wr_t = torch.as_tensor(wr_r, device=device)
        if aggregator == "fedsgd":
            losses, grads = [], []
            for i in range(d):
                gi, li = _grads_and_loss(
                    lambda q: batch_loss(q, X[i], Y[i], w[i], gp), gp)
                losses.append(li)
                grads.append(gi)
            g = _stack_trees(grads)
            if scale is not None:
                g = tree_map(lambda a: (a.float() * _per_silo(scale, a))
                             .to(a.dtype), g)
            g = _weighted_silo_mean(g, wr_t)
            updates, fedsgd_state = opt.update(g, fedsgd_state, gp)
            gp = apply_updates(gp, updates)
            round_loss = float(torch.sum(wr_t * torch.stack(losses)))
        else:
            perms = schedule(rnd)
            perms_t = torch.as_tensor(perms, device=device)
            locals_: List[Any] = []
            final_losses = np.zeros(d)
            for i in range(d):
                if wr_r[i] <= 0:
                    # dropped or empty silo (wr_r > 0 ⟺ real ∧ available):
                    # trains nothing this round; the scan engine reaches the
                    # same state through zeroed masks and the masked step
                    locals_.append(gp)
                    continue
                p = gp
                o = opt.init(p) if reset_opt else opt_states[i]
                for e in range(local_epochs):
                    idx = perms_t[i, e].view(nb, bs)
                    idx_host = perms[i, e].reshape(nb, bs)
                    # per-batch losses stay on the device; the final-epoch
                    # weighted mean is pulled once per silo per round
                    ep_losses, ep_ws = [], []
                    for b in range(nb):
                        sl = idx[b]
                        p, o, loss = step(p, o, X[i][sl], Y[i][sl],
                                          w[i][sl], gp)
                        if e == local_epochs - 1:
                            ep_losses.append(loss)
                            ep_ws.append(float(w_host[i][idx_host[b]].sum())
                                         if per_example else float(bs))
                    if e == local_epochs - 1:
                        num = sum(l * bw for l, bw in zip(ep_losses, ep_ws))
                        final_losses[i] = float(num) / max(sum(ep_ws),
                                                           _DEN_EPS)
                locals_.append(p)
                if not reset_opt:
                    opt_states[i] = o
            sp = _stack_trees(locals_)
            if scale is not None:
                sp = apply_silo_scale(sp, gp, scale)
            if robust:
                mask = torch.as_tensor((wr_r > 0).astype(np.float32),
                                       device=device)
                gp = robust_aggregate(sp, mask, aggregator,
                                      trim_frac=trim_frac, krum_f=krum_f)
            else:
                gp = _weighted_silo_mean(sp, wr_t)
            round_loss = float(np.sum(np.asarray(wr_r, np.float64) * final_losses))
        rec = {"round": rnd, "loss": round_loss}
        if eval_fn is not None:
            rec.update(eval_fn(gp))
        history.append(rec)
    return FLResult(params=gp, history=history)


# --------------------------------------------------------------------------
# 2b. engine="scan": one round as a plan, captured once and replayed
# --------------------------------------------------------------------------

def _make_round_step(*, num_batches: int, batch_size: int, opt: Optimizer,
                     batch_loss, local_epochs: int, aggregator: str,
                     per_example: bool, reset_opt: bool, masked: bool,
                     trim_frac: float, krum_f: int):
    """``round_step(carry, perms, X, Y, w, wr_r, scale) -> (carry,
    round_loss, global_params)``: one full round over the silo stack, all
    device tensors in and out (perms (d, E, n_slots) this round's
    schedule, None for fedsgd; wr_r (d,) this round's weights, zero for a
    silo that is unavailable or empty; scale (d,) the delta multipliers).
    Nothing in it syncs with the host or copies from it, so it can be
    captured in a CUDA graph."""
    nb, bs, E = num_batches, batch_size, local_epochs
    silo_step = _make_silo_step(batch_loss, opt, masked=masked)
    robust = aggregator in ROBUST_AGGREGATORS

    def local_phase(gp, so, perms, X, Y, w):
        """E epochs × nb batches of vmapped silo steps; returns trained
        silo params / opt state and each silo's final-epoch loss."""
        dl = perms.shape[0]
        rows = torch.arange(dl, device=perms.device)[:, None]
        bidx = perms.reshape(dl, E, nb, bs)
        sp = silo_replicate(gp, dl)
        ls, ws = [], []
        for e in range(E):
            for b in range(nb):
                ib = bidx[:, e, b]                         # (dl, bs)
                xb, yb, wb = X[rows, ib], Y[rows, ib], w[rows, ib]
                sp, so, losses = silo_step(sp, so, xb, yb, wb, gp)
                if e == E - 1:
                    bw = torch.sum(wb, dim=1) if per_example \
                        else torch.full_like(losses, float(bs))
                    ls.append(losses * bw)
                    ws.append(bw)
        ep_loss = torch.stack(ls).sum(0) / torch.clamp(
            torch.stack(ws).sum(0), min=_DEN_EPS)
        return sp, so, ep_loss

    def boundary(sp, gp, wr_r, scale):
        sp = apply_silo_scale(sp, gp, scale)
        if not robust:
            return _weighted_silo_mean(sp, wr_r)
        return robust_aggregate(sp, (wr_r > 0).float(), aggregator,
                                trim_frac=trim_frac, krum_f=krum_f)

    if aggregator == "fedsgd":
        silo_loss = torch.func.vmap(batch_loss, in_dims=(0, 0, 0, 0, None))

        def round_step(carry, perms, X, Y, w, wr_r, scale):
            gp, fs = carry
            grads, losses = _grads_and_loss(
                lambda q: silo_loss(q, X, Y, w, gp),
                silo_replicate(gp, X.shape[0]))
            grads = tree_map(lambda a: (a.float() * _per_silo(scale, a))
                             .to(a.dtype), grads)
            updates, fs = opt.update(_weighted_silo_mean(grads, wr_r), fs, gp)
            gp = apply_updates(gp, updates)
            return (gp, fs), torch.sum(wr_r * losses), gp
        return round_step

    def round_step(carry, perms, X, Y, w, wr_r, scale):
        # absent silos get all-zero masks: every batch is an exact no-op
        w_eff = w * (wr_r > 0).to(w.dtype)[:, None]
        if reset_opt:
            gp = carry
            so = _stacked_opt_init(opt, gp, X.shape[0])
        else:
            gp, so = carry
        sp, so, final_losses = local_phase(gp, so, perms, X, Y, w_eff)
        gp = boundary(sp, gp, wr_r, scale)
        loss = torch.sum(wr_r * final_losses)
        return (gp if reset_opt else (gp, so)), loss, gp
    return round_step


class FLPlan:
    """A scan-engine PLAN (``make_fl_plan``): one round of the FL phase over
    a (num_silos, num_batches · batch_size, …) padded stack as a torch
    function (``round_step``), plus how it runs: on CUDA, captured once
    into a ``torch.cuda.CUDAGraph`` over static buffers and replayed each
    round; elsewhere, eagerly.

    All tenant data, the per-round weights wr (a zero entry drops a silo
    for that round), the delta scales and the schedule are run-time
    arguments, so every tenant of the same padded shapes, every dropout
    pattern and every attack configuration shares one plan; the robust
    config (trim_frac / krum_f) is part of it. Rounds never enter a plan,
    so one plan serves every round budget and every eval chunk.

    The buffers (silo stack, carry, one round's perms and weights, scale)
    are allocated by the first run and sized by it; a later run must have
    the same padded shapes (the plan cache guarantees it) and copies its
    tenant in. Every run ends by zeroing them (``_release``), so a plan
    waiting in the cache for its next tenant holds none of the last one's
    data. `captures` / `replays` count graphs captured and rounds
    replayed. A plan is not re-entrant: run() while another run() of the
    same plan is live raises.
    """

    def __init__(self, *, num_silos: int, num_batches: int, batch_size: int,
                 opt: Optimizer, batch_loss, local_epochs: int,
                 aggregator: str = "fedavg", per_example: bool = True,
                 reset_opt: bool = True, masked: bool = True,
                 trim_frac: float = 0.2, krum_f: int = 1,
                 device: DeviceLike = None):
        self.num_silos = num_silos
        self.num_batches = num_batches
        self.batch_size = batch_size
        self.local_epochs = local_epochs
        self.opt = opt
        self.aggregator = aggregator
        self.reset_opt = reset_opt
        self.device = resolve_device(device)
        self.round_step = _make_round_step(
            num_batches=num_batches, batch_size=batch_size, opt=opt,
            batch_loss=batch_loss, local_epochs=local_epochs,
            aggregator=aggregator, per_example=per_example,
            reset_opt=reset_opt, masked=masked, trim_frac=trim_frac,
            krum_f=krum_f)
        self.replays = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._bufs: Optional[SimpleNamespace] = None
        self._live = False
        _note_plan_built()

    @property
    def captures(self) -> int:
        """CUDA graphs this plan captured: 1 once its round is captured."""
        return int(self._graph is not None)

    # -- carry -----------------------------------------------------------

    def carry_init(self, init_params: Any) -> Any:
        """The cross-round state for `init_params` (a private copy)."""
        gp = tree_map(lambda a: a.detach().clone(), init_params)
        if self.aggregator == "fedsgd":
            return (gp, self.opt.init(gp))
        if self.reset_opt:
            return gp
        return (gp, _stacked_opt_init(self.opt, gp, self.num_silos))

    def carry_params(self, carry: Any) -> Any:
        own_state = self.aggregator == "fedsgd" or not self.reset_opt
        return carry[0] if own_state else carry

    # -- running ---------------------------------------------------------

    def run(self, init_params: Any, args: Tuple, *, rounds: int,
            eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
            eval_chunk: int = 8) -> FLResult:
        """Train `rounds` rounds from `init_params` on one tenant's device
        arguments `args` = (X, Y, w, wr, scale, perms) (``_plan_args``)."""
        if self._live:
            raise RuntimeError(
                "this FL plan is already running: a plan (and a cached "
                "plan's captured graph) serves one run at a time")
        self._live = True
        try:
            return self._run(init_params, args, rounds, eval_fn, eval_chunk)
        finally:
            self._release()
            self._live = False

    def _release(self) -> None:
        """Zero every buffer a run filled with tenant data: the silo stack
        (X, Y, w), this round's weights and schedule, the scales, the carry
        and the loss. One fused fill per dtype per run; the next run copies
        its own tenant into every one of them before its first replay."""
        b = self._bufs
        if b is not None:
            zero_buffers([b.carry, b.X, b.Y, b.w, b.wr, b.scale, b.perms,
                          b.loss])

    def _run(self, init_params, args, rounds, eval_fn, eval_chunk):
        timings = {"bind_s": 0.0, "warmup_s": 0.0, "capture_s": 0.0}
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            next_round, final = self._graph_rounds(init_params, args, timings)
        else:
            next_round, final = self._eager_rounds(init_params, args)
        t1 = time.perf_counter()
        timings["bind_s"] = t1 - t0 - timings["warmup_s"] - timings["capture_s"]
        losses = torch.empty(rounds, dtype=torch.float32, device=self.device)
        history: List[Dict[str, float]] = []
        stack, rnd0 = None, 0
        for rnd in range(rounds):
            loss, gp = next_round(rnd)
            losses[rnd] = loss
            if eval_fn is None:
                continue
            j = rnd - rnd0
            if j == 0:
                # a fresh stack per chunk: eval_fn keeps copies that no
                # later round overwrites
                nr = min(eval_chunk, rounds - rnd0)
                stack = tree_map(lambda a: a.new_empty((nr,) + a.shape), gp)
            tree_map(lambda s, a: s[j].copy_(a), stack, gp)
            if j == nr - 1:
                # feddcl-lint: disable=R008  one transfer per eval_chunk rounds (the batched form the rule asks for), not one per round
                for jj, l in enumerate(losses[rnd0:rnd + 1].tolist()):
                    rec = {"round": rnd0 + jj, "loss": l}
                    rec.update(eval_fn(tree_map(lambda s: s[jj], stack)))
                    history.append(rec)
                rnd0 = rnd + 1
        if eval_fn is None:
            history = [{"round": r, "loss": l}
                       for r, l in enumerate(losses.tolist())]
        # a copy: the carry buffers are zeroed once the run returns
        params = tree_map(lambda a: a.clone(), final())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["rounds_s"] = time.perf_counter() - t1
        return FLResult(params=params, history=history, timings=timings)

    def _eager_rounds(self, init_params, args):
        X, Y, w, wr, scale, perms = args
        carry = self.carry_init(init_params)

        def next_round(rnd):
            nonlocal carry
            carry, loss, gp = self.round_step(
                carry, None if perms is None else perms[rnd], X, Y, w,
                wr[rnd], scale)
            return loss, gp

        return next_round, lambda: self.carry_params(carry)

    def _graph_rounds(self, init_params, args, timings):
        X, Y, w, wr, scale, perms = args
        carry = self.carry_init(init_params)
        new = dict(X=X, Y=Y, w=w, scale=scale, wr=wr[0],
                   perms=None if perms is None else perms[0])
        b = self._bufs
        if b is None:
            b = self._bufs = SimpleNamespace(
                carry=carry, loss=None,
                **{k: None if v is None else v.clone()
                   for k, v in new.items()})
        else:
            for k, v in new.items():
                dst = getattr(b, k)
                if (dst is None) != (v is None) or (
                        v is not None and (dst.shape != v.shape
                                           or dst.dtype != v.dtype)):
                    raise ValueError(
                        f"plan buffers hold {k} of another shape than this "
                        "tenant's: a plan serves one padded layout")
                if v is not None:
                    dst.copy_(v)
            tree_map(lambda dst, src: dst.copy_(src), b.carry, carry)
        if self._graph is None:
            self._capture(b, timings)

        def next_round(rnd):
            if perms is not None:
                b.perms.copy_(perms[rnd])
            b.wr.copy_(wr[rnd])
            self._graph.replay()
            self.replays += 1
            return b.loss, self.carry_params(b.carry)

        return next_round, lambda: self.carry_params(b.carry)

    def _capture(self, b: SimpleNamespace, timings: Dict[str, float]) -> None:
        """Warm the round up on the side stream it is then captured on
        (autograd's and cuBLAS's first-call allocations stay out of the
        graph), then capture one round that ends by copying its carry into
        the carry buffers. A failed capture raises."""
        args = lambda: (b.carry, b.perms, b.X, b.Y, b.w, b.wr, b.scale)

        def round_into_buffers():
            carry, loss, _ = self.round_step(*args())
            tree_map(lambda dst, src: dst.copy_(src), b.carry, carry)
            return loss

        # the warm-up's results are dropped: the carry buffers stay as they are
        self._graph, b.loss = capture(
            round_into_buffers, self.device,
            warmup=lambda: self.round_step(*args()), timings=timings)


# the reference's name for building a plan
make_fl_plan = FLPlan


def _plan_args(padded: PaddedSilos, data, rounds: int, *, aggregator: str,
               schedule: Callable[[int], np.ndarray], device: torch.device,
               availability: Optional[np.ndarray] = None,
               silo_scale: Optional[np.ndarray] = None) -> Tuple:
    """Device arguments a plan consumes for one tenant's padded stack:
    (X, Y, w, wr, scale, perms). availability (rounds, d) {0,1} folds into
    the per-round weights wr (rounds, d); silo_scale (d,) defaults to
    all-ones (honest); perms (rounds, d, E, n_slots) is the whole schedule,
    uploaded once (None for fedsgd)."""
    X, Y, w = data
    wr = _round_weights(padded.sizes, availability, rounds)
    scale = (np.ones(padded.num_silos, np.float32) if silo_scale is None
             else np.asarray(silo_scale, np.float32))
    perms = None if aggregator == "fedsgd" else torch.as_tensor(
        np.stack([schedule(r) for r in range(rounds)]), device=device)
    return (X, Y, w, torch.as_tensor(wr, device=device),
            torch.as_tensor(scale, device=device), perms)


def _flat(tree: Any) -> np.ndarray:
    return np.concatenate([np.asarray(a.detach().double().cpu()).ravel()
                           for a in tree_leaves(tree)])


class LoweredPlan:
    """An FL plan bound to one tenant's padded stack and schedule
    (``lower_fl_plan``): what ``analysis.hlo_audit.assert_no_baked_data``
    takes, as it takes ``ServeCollab.lower_step``. ``args`` = (init_params,
    X, Y, w, wr, scale, perms), the device arguments ``_plan_args`` gives.
    ``run(*args)`` trains `rounds` rounds through the plan as served (on
    CUDA, replays of its captured round) and ``eager(*args)`` the same
    rounds through ``FLPlan._eager_rounds``. Each returns the final params
    and the per-round losses as one float64 vector; with an eval chunk
    (``eval_chunk=`` of ``run``, default the one lowered with) ``run``
    hands each chunk of rounds' params to an evaluation that appends them,
    and ``eager`` appends each round's params alike."""

    def __init__(self, plan: "FLPlan", args: Tuple, rounds: int,
                 eval_chunk: Optional[int]):
        self.plan = plan
        self.args = args
        self.rounds = rounds
        self.eval_chunk = eval_chunk

    def run(self, init_params, *fl_args,
            eval_chunk: Optional[int] = None) -> np.ndarray:
        chunk = self.eval_chunk if eval_chunk is None else eval_chunk
        seen: List[np.ndarray] = []

        def keep(params) -> Dict[str, float]:
            seen.append(_flat(params))
            return {}

        res = self.plan.run(init_params, fl_args, rounds=self.rounds,
                            eval_fn=None if chunk is None else keep,
                            eval_chunk=chunk or 1)
        return np.concatenate([_flat(res.params),
                               [h["loss"] for h in res.history], *seen])

    @torch.no_grad()
    def eager(self, init_params, *fl_args,
              eval_chunk: Optional[int] = None) -> np.ndarray:
        chunk = self.eval_chunk if eval_chunk is None else eval_chunk
        next_round, final = self.plan._eager_rounds(init_params, fl_args)
        losses, seen = [], []
        for rnd in range(self.rounds):
            loss, gp = next_round(rnd)
            losses.append(loss)
            if chunk is not None:
                seen.append(_flat(gp))
        return np.concatenate([_flat(final()), _flat(losses), *seen])


def lower_fl_plan(plan: FLPlan, init_params: Any, padded: PaddedSilos, *,
                  rounds: int, seed: int = 0,
                  schedule: Optional[Schedule] = None,
                  availability: Optional[np.ndarray] = None,
                  silo_scale: Optional[np.ndarray] = None,
                  eval_chunk: Optional[int] = None) -> LoweredPlan:
    """Bind `plan` to one tenant's padded stack and schedule (drawn from
    `seed` unless given) through ``_plan_args``, on the plan's device, and
    run it once (on CUDA: its build, capture and replays): the hook the
    artifact audit drives (``analysis.hlo_audit.assert_no_baked_data``).
    The counterpart of the reference's ``lower_fl_plan``; its
    ``StreamedPlan`` case has none, since the port chunks evaluation inside
    ``FLPlan.run``: `eval_chunk` (None: no evaluation) is the lowered
    plan's ``run`` option instead."""
    if (padded.num_silos, padded.num_batches, padded.batch_size) != (
            plan.num_silos, plan.num_batches, plan.batch_size):
        raise ValueError(
            f"padded layout (silos, batches, batch) = ({padded.num_silos}, "
            f"{padded.num_batches}, {padded.batch_size}) is not the plan's "
            f"({plan.num_silos}, {plan.num_batches}, {plan.batch_size})")
    dev = plan.device
    sched = _schedule_fn(schedule, seed, padded.num_silos, plan.local_epochs,
                         padded.n_slots, rounds)
    fl_args = _plan_args(padded, _to_device(padded, dev), rounds,
                         aggregator=plan.aggregator, schedule=sched,
                         device=dev, availability=availability,
                         silo_scale=silo_scale)
    params = tree_map(lambda a: a.detach().to(dev), init_params)
    lowered = LoweredPlan(plan, (params,) + fl_args, rounds, eval_chunk)
    lowered.run(*lowered.args)
    return lowered


def make_scan_runner(batch_loss, padded: PaddedSilos, *, opt, rounds,
                     local_epochs, aggregator="fedavg", seed=0,
                     schedule: Optional[Schedule] = None, per_example=True,
                     reset_opt=True, availability=None, silo_scale=None,
                     trim_frac: float = 0.2, krum_f: int = 1,
                     device: DeviceLike = None) -> Callable:
    """A ``run(init_params) -> (final_params, losses)`` with this tenant's
    padded stack bound (losses: the (rounds,) list). Calling the SAME
    runner twice reuses its plan, and on CUDA its captured graph."""
    dev = resolve_device(device)
    dropout = availability is not None and not np.all(
        np.asarray(availability) > 0)
    plan = make_fl_plan(
        num_silos=padded.num_silos, num_batches=padded.num_batches,
        batch_size=padded.batch_size, opt=opt, batch_loss=batch_loss,
        local_epochs=local_epochs, aggregator=aggregator,
        per_example=per_example, reset_opt=reset_opt,
        masked=padded.has_padding or dropout, trim_frac=trim_frac,
        krum_f=krum_f, device=dev)
    sched = _schedule_fn(schedule, seed, padded.num_silos, local_epochs,
                         padded.n_slots, rounds)
    args = _plan_args(padded, _to_device(padded, dev), rounds,
                      aggregator=aggregator, schedule=sched, device=dev,
                      availability=availability, silo_scale=silo_scale)

    def run(init_params):
        res = plan.run(init_params, args, rounds=rounds)
        return res.params, [h["loss"] for h in res.history]

    return run


def _run_scan(batch_loss, init_params, padded: PaddedSilos, data, *, opt,
              rounds, local_epochs, aggregator, schedule, eval_fn,
              per_example, reset_opt, device: torch.device,
              plan: Optional[FLPlan] = None, eval_chunk: int = 8,
              availability=None, silo_scale=None, trim_frac: float = 0.2,
              krum_f: int = 1, masked: Optional[bool] = None) -> FLResult:
    """Drive a plan over this tenant's padded stack: without eval_fn the
    rounds run back to back and only the (rounds,) loss vector comes back
    at the end; with eval_fn each chunk of eval_chunk rounds' params is
    handed over once the chunk has run."""
    if masked is None:
        masked = padded.has_padding or (
            availability is not None and not np.all(
                np.asarray(availability) > 0))
    if plan is None:
        plan = make_fl_plan(
            num_silos=padded.num_silos, num_batches=padded.num_batches,
            batch_size=padded.batch_size, opt=opt, batch_loss=batch_loss,
            local_epochs=local_epochs, aggregator=aggregator,
            per_example=per_example, reset_opt=reset_opt, masked=masked,
            trim_frac=trim_frac, krum_f=krum_f, device=device)
    args = _plan_args(padded, data, rounds, aggregator=aggregator,
                      schedule=schedule, device=device,
                      availability=availability, silo_scale=silo_scale)
    return plan.run(init_params, args, rounds=rounds, eval_fn=eval_fn,
                    eval_chunk=max(int(eval_chunk), 1))


# ==========================================================================
# 3. Silo-stacked primitives (the launch tier's federated round builds on
#    them)
# ==========================================================================

def silo_replicate(params: Any, num_silos: int) -> Any:
    """Give every leaf a leading silo dim (identical start, paper Step 4);
    a broadcast view, no copy."""
    return tree_map(lambda p: p.expand((num_silos,) + tuple(p.shape)), params)


def silo_vmap_step(step_fn: Callable) -> Callable:
    """vmap a per-silo (params, opt_state, batch) -> (params, opt_state,
    metrics) step over the leading silo dim."""
    return torch.func.vmap(step_fn, in_dims=0, out_dims=0)


def scan_local_steps(local_step: Callable, silo_params: Any,
                     silo_opt_state: Any, batches: Any):
    """Run H silo-local steps in order (the reference's lax.scan): `batches`
    is a tree with leading dim H; returns (params, opt_state, metrics)
    with metrics stacked over H."""
    h_steps = tree_leaves(batches)[0].shape[0]
    sp, so, ms = silo_params, silo_opt_state, []
    for h in range(h_steps):
        sp, so, m = local_step(sp, so, tree_map(lambda a: a[h], batches))
        ms.append(m)
    return sp, so, _stack_trees(ms)


def fedavg_sync(silo_params: Any, weights: Optional[torch.Tensor] = None) -> Any:
    """Round boundary: average parameters across the silo dim and broadcast
    back."""
    def avg(p):
        pf = p.float()
        if weights is None:
            mean = torch.mean(pf, dim=0, keepdim=True)
        else:
            w = (weights / torch.clamp(torch.sum(weights), min=_DEN_EPS)).float()
            mean = torch.tensordot(w, pf, dims=([0], [0]))[None]
        return mean.expand(p.shape).to(p.dtype)

    return tree_map(avg, silo_params)


def robust_sync(silo_params: Any, aggregator: str,
                mask: Optional[torch.Tensor] = None, *,
                trim_frac: float = 0.2, krum_f: int = 1) -> Any:
    """Robust round boundary in fedavg_sync's broadcast-back form; a
    weighted aggregator ("fedavg" / "fedprox" / "fedsgd") falls back to
    fedavg_sync."""
    if aggregator not in ROBUST_AGGREGATORS:
        return fedavg_sync(silo_params)
    lead = tree_leaves(silo_params)[0]
    m = torch.ones((lead.shape[0],), dtype=torch.float32, device=lead.device) \
        if mask is None else mask.float()
    agg = robust_aggregate(silo_params, m, aggregator,
                           trim_frac=trim_frac, krum_f=krum_f)
    return tree_map(lambda a, p: a[None].expand(p.shape).to(p.dtype),
                    agg, silo_params)
