"""Step 4 of FedDCL: federated learning between intra-group DC servers
(counterpart of ``repro.core.federated``, host engine).

``run_federated`` is the one trainer: FedAvg, FedProx and FedSGD over the
zero-padded silo layout (``pad_silo_data``) with per-sample masks, so
ragged silos train exactly their real samples. The engine is the
reference's ``engine="host"`` loop: one step per minibatch per epoch per
silo per round, with the padded silos moved to the device once, batches
gathered there by index, per-batch losses kept on the device and one host
sync per silo per round.

The minibatch schedule is an argument: an array (rounds, d, epochs,
n_slots) of per-epoch slot permutations or a callable rnd -> (d, epochs,
n_slots). The reference draws it with ``jax.random`` (``round_perms``),
which torch cannot reproduce, so parity runs inject the reference's
schedule; without one the port draws its own from `seed` with numpy.

Not in this port yet (each raises NotImplementedError): the compiled scan
engine and its plan cache, mesh sharding, the robust aggregators, silo
dropout / availability and per-silo delta scaling.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
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


ROBUST_AGGREGATORS = ("median", "trimmed_mean", "krum")
AGGREGATORS = ("fedavg", "fedprox", "fedsgd") + ROBUST_AGGREGATORS


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


def _make_sgd_step(batch_loss, opt: Optimizer, masked: bool = False):
    """One optimizer step. masked=True makes batches with ZERO real samples
    exact no-ops (no step count, no moment decay) with a `torch.where` on
    the device, so the guard costs no host sync."""
    grad_and_value = torch.func.grad_and_value(batch_loss)

    def step(p, opt_state, x, y, w, ref):
        grads, loss = grad_and_value(p, x, y, w, ref)
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


def _weighted_silo_mean(stacked: Any, wn: torch.Tensor) -> Any:
    """Sample-weighted mean over the leading silo dim (wn sums to 1)."""
    return tree_map(
        lambda a: torch.tensordot(wn, a.float(), dims=([0], [0])).to(a.dtype),
        stacked)


def _stack_trees(trees: Sequence[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


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
# 2. The federated engine
# ==========================================================================

@dataclass
class FLResult:
    params: Any
    history: List[Dict[str, float]]


def _not_in_port(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, {queue})")


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
    schedule: Optional[Schedule] = None,
    cache: Any = None,
    mesh=None,
    dropout_rate: float = 0.0,
    availability: Optional[np.ndarray] = None,
    silo_scale: Optional[Sequence[float]] = None,
    device: DeviceLike = None,
) -> FLResult:
    """Federated training over host-resident silo datasets on `device`
    (None -> CUDA, which raises without a card).

    loss_fn takes (params, x, y) and returns a (batch,) per-example loss
    (ragged silos are zero-padded and masked) or a scalar batch mean (only
    valid when no padding is needed). `per_example` is detected from the
    output shape when None. `init_params` is a tree of tensors already on
    `device`. `schedule` fixes the minibatch order (see the module doc);
    fedsgd takes one full batch per silo per round and ignores it.
    reset_opt_per_round=False carries silo optimizer state across rounds.
    """
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         f"choose one of {AGGREGATORS}")
    if engine not in ("host", "scan"):
        raise ValueError(f"unknown engine {engine!r}; choose 'host' or 'scan'")
    if engine == "scan":
        raise _not_in_port("engine='scan'", "Queue 1, the scan engine")
    if cache is not None and cache is not False:
        raise _not_in_port("cache= (the compiled-plan cache)",
                           "Queue 1, the scan engine")
    if mesh is not None:
        raise _not_in_port("mesh= (silo sharding)", "Queue 1, sharding")
    if aggregator in ROBUST_AGGREGATORS:
        raise _not_in_port(f"aggregator={aggregator!r}",
                           "Queue 1, robust aggregators")
    if dropout_rate or availability is not None or silo_scale is not None:
        raise _not_in_port("dropout_rate / availability / silo_scale",
                           "Queue 1, robust aggregators, dropout")
    dev = resolve_device(device)
    padded = pad_silo_data(silo_data,
                           None if aggregator == "fedsgd" else batch_size)
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
    mu = fedprox_mu if aggregator == "fedprox" else 0.0
    batch_loss = _make_batch_loss(loss_fn, per_example, mu)
    sched = _schedule_fn(schedule, seed, padded.num_silos, local_epochs,
                         padded.n_slots, rounds)
    return _run_host(batch_loss, init_params, padded, data, opt=opt,
                     rounds=rounds, local_epochs=local_epochs,
                     aggregator=aggregator, schedule=sched, eval_fn=eval_fn,
                     per_example=per_example, reset_opt=reset_opt_per_round,
                     masked=padded.has_padding, device=dev)


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


def _run_host(batch_loss, init_params, padded: PaddedSilos, data, *, opt,
              rounds, local_epochs, aggregator, schedule, eval_fn, per_example,
              reset_opt, masked: bool, device: torch.device) -> FLResult:
    d, nb, bs = padded.num_silos, padded.num_batches, padded.batch_size
    step = _make_sgd_step(batch_loss, opt, masked=masked)
    grad_and_value = torch.func.grad_and_value(batch_loss)
    X, Y, w = data
    w_host = padded.w
    wr = _round_weights(padded.sizes, None, rounds)   # (rounds, d)

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
                gi, li = grad_and_value(gp, X[i], Y[i], w[i], gp)
                losses.append(li)
                grads.append(gi)
            g = _weighted_silo_mean(_stack_trees(grads), wr_t)
            updates, fedsgd_state = opt.update(g, fedsgd_state, gp)
            gp = apply_updates(gp, updates)
            round_loss = float(torch.sum(wr_t * torch.stack(losses)))
        else:
            perms = schedule(rnd)
            perms_t = torch.as_tensor(perms, device=device)
            locals_: List[Any] = []
            final_losses = np.zeros(d)
            for i in range(d):
                if wr_r[i] <= 0:         # empty silo: trains nothing
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
            gp = _weighted_silo_mean(_stack_trees(locals_), wr_t)
            round_loss = float(np.sum(np.float64(wr_r) * final_losses))
        rec = {"round": rnd, "loss": round_loss}
        if eval_fn is not None:
            rec.update(eval_fn(gp))
        history.append(rec)
    return FLResult(params=gp, history=history)
