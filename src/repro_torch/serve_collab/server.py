"""Multi-tenant online inference over the collaboration pipeline
(counterpart of ``repro.serve_collab.server``).

Heterogeneous prediction requests (any tenant, any row count) share ONE
resident step per (tenant-table pad, pow2 batch pad) shape bucket:

    step(params, M, mu, x, tix) = h((x − mu[tix]) · M[tix])

Tenant dispatch is a gather along the tenant index, so a mixed batch of
users — even from different onboarding generations — is a single batched
product + model forward. Every tensor (model params, tenant tables,
request rows, tenant indices) is a runtime ARGUMENT: the plan key carries
shapes only, so steps are shared across groups with equal padded shapes,
and warm mixed-tenant traffic builds nothing (PlanCache misses and
captures stay put, tested).

On CUDA a bucket's step is one captured ``torch.cuda.CUDAGraph``
(``ServePlan``) where the reference jits one executable. A graph bakes in
addresses while the key names no group and no params, so the graph owns a
static buffer for every argument and each step copies the live arguments
in before its replay; outputs come back with one device-to-host copy a
step. On the CPU a bucket's step is the eager function.

Admission reuses the slot-table/continuous-batching idiom of
launch/serve.py, adapted to one-shot requests: a FIFO deque is scanned for
rows of the head request's group, packed up to `max_batch`, padded to the
pow2 bucket, and served in one dispatch; oversize requests are chunked
across steps and requeue implicitly (their `served` cursor advances in
place). Statuses mirror launch/serve.py: "done" / "truncated" (partially
served when `max_steps` ran out) / "pending" (never reached a batch).
"""
from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.federated import (PlanCache, _tree_signature,
                                        bucket_pow2, default_plan_cache)
from repro_torch.core.protocol import FedDCLSetup
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import capture
from repro_torch.models import mlp
from repro_torch.serve_collab.tables import TenantTable, build_tables
from repro_torch.tree import tree_map


@dataclass
class CollabRequest:
    """One prediction request: `x` rows through tenant (group, user)."""
    rid: int
    group: int
    user: int
    x: np.ndarray                      # (n, m) float; (m,) is auto-promoted
    out: Optional[np.ndarray] = None   # (n, out_dim), filled as rows serve
    served: int = 0
    status: str = "pending"            # pending | truncated | done
    t_submit: float = field(default=0.0, repr=False)
    t_done: float = field(default=0.0, repr=False)

    def __post_init__(self):
        self.x = np.asarray(self.x, np.float32)
        if self.x.ndim == 1:
            self.x = self.x[None, :]

    @property
    def rows(self) -> int:
        return int(self.x.shape[0])

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class ServeOutput(Dict[int, np.ndarray]):
    """{rid: served output rows} plus `.status`: {rid: done|truncated|pending}."""

    def __init__(self, outputs: Dict[int, np.ndarray],
                 status: Dict[int, str]):
        super().__init__(outputs)
        self.status = status


def serve_step(params, M, mu, x, tix):
    """The resident batch step — a PURE function of its arguments.

    params: MLP params tree;  M: (T_pad, m, m̂) tenant maps;  mu: (T_pad, m)
    offsets;  x: (B_pad, m) request rows;  tix: (B_pad,) int64 tenant
    indices. Padded rows carry tix 0 and produce garbage the server slices
    away.
    """
    z = x - mu[tix]                                   # (B, m)
    h = torch.einsum("bm,bmh->bh", z, M[tix])         # (B, m̂)
    return mlp.mlp_forward(params, h)


class ServePlan:
    """The resident step of one shape bucket: a PlanCache entry.

    On CUDA, ``serve_step`` captured once into a CUDA graph over static
    buffers for EVERY argument (params, M, mu, x, tix), filled from the
    live arguments before each replay: groups and servers that share the
    entry each get their own tables' and params' answer, and a table
    rebuilt by onboarding (a new tensor) is read as it is now. On the CPU,
    the eager step. `captures` / `replays` count graphs captured and steps
    replayed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.captures = self.replays = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._bufs: Optional[Dict[str, Any]] = None
        self._out: Optional[torch.Tensor] = None

    @torch.no_grad()
    def __call__(self, params, M: torch.Tensor, mu: torch.Tensor,
                 x: np.ndarray, tix: np.ndarray) -> np.ndarray:
        live = dict(params=params, M=M, mu=mu, x=torch.from_numpy(x),
                    tix=torch.from_numpy(tix).long())
        if self.device.type != "cuda":
            return serve_step(**live).numpy()
        if self._bufs is None:
            self._bufs = tree_map(
                lambda a: torch.empty(a.shape, dtype=a.dtype,
                                      device=self.device), live)
        tree_map(lambda dst, src: dst.copy_(src), self._bufs, live)
        if self._graph is None:
            self._graph, self._out = capture(
                lambda: serve_step(**self._bufs), self.device)
            self.captures += 1
        self._graph.replay()
        self.replays += 1
        return self._out.cpu().numpy()


class ServeCollab:
    """Queued, bucketed, continuously-admitted collaboration serving.

    Tables and params live on `device` (CUDA unless the caller asks for
    the CPU); request rows arrive and outputs leave as NumPy."""

    def __init__(self, tables: Sequence[TenantTable], params: Any, *,
                 setup: Optional[FedDCLSetup] = None,
                 max_batch: int = 256, cache: Optional[PlanCache] = None,
                 bucket=bucket_pow2, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tables: List[TenantTable] = list(tables)
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.setup = setup
        self.max_batch = int(max_batch)
        self.bucket = bucket
        self.cache = cache if isinstance(cache, PlanCache) \
            else default_plan_cache()
        self.queue: deque = deque()
        self._psig = _tree_signature(self.params)
        self._next_rid = 0
        self.steps = 0
        self.rows_served = 0
        self.requests_done = 0
        self.latencies: List[float] = []
        self.bucket_hist: Counter = Counter()   # (group, T_pad, B_pad) -> steps

    # -- construction ------------------------------------------------------

    @classmethod
    def from_setup(cls, setup: FedDCLSetup, params: Any,
                   **kw) -> "ServeCollab":
        return cls(build_tables(setup, kw.get("bucket", bucket_pow2),
                                device=kw.get("device")),
                   params, setup=setup, **kw)

    @classmethod
    def from_model(cls, model, **kw) -> "ServeCollab":
        """Bind to a fitted repro_torch.api.FedDCL estimator, on its device
        unless `device` says otherwise."""
        if model.setup_ is None:
            raise RuntimeError("call fit() before serve()")
        kw.setdefault("device", model.device)
        return cls.from_setup(model.setup_, model.params_, **kw)

    # -- admission ---------------------------------------------------------

    def submit(self, x: np.ndarray, group: int, user: int,
               rid: Optional[int] = None) -> CollabRequest:
        """Enqueue rows for tenant (group, user); returns the request."""
        if not 0 <= group < len(self.tables):
            raise ValueError(f"unknown group {group}")
        if not 0 <= user < self.tables[group].count:
            raise ValueError(f"unknown user {user} in group {group} "
                             f"(count={self.tables[group].count})")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = CollabRequest(rid=rid, group=group, user=user, x=x)
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        return req

    # -- the resident step -------------------------------------------------

    def _step_fn(self, t_pad: int, b_pad: int, m: int,
                 m_hat: int) -> ServePlan:
        """The step for one shape bucket, through the plan cache. The key is
        ALL-shape (no group id, no tenant identity; the device besides):
        groups with equal padded shapes share one plan, and warm lookups
        build nothing."""
        key = ("serve_collab", int(m), int(m_hat), int(t_pad), int(b_pad),
               self._psig, str(self.device))
        plan, _ = self.cache.lookup(key, lambda: ServePlan(self.device))
        return plan

    def lower_step(self, group: int, b_pad: int):
        """The reference lowers the step here for ``analysis.hlo_audit``;
        the port has no such audit yet."""
        raise NotImplementedError(
            "ServeCollab.lower_step feeds analysis.hlo_audit, which is not "
            "ported yet (ROADMAP.md, Queue 1 item 7); the port's check that "
            "no tenant data is baked into a captured step is its cuda test "
            "of a table overwritten between replays")

    # -- serving loop ------------------------------------------------------

    def step(self) -> int:
        """Serve ONE bucket: pack rows of the head request's group from the
        queue (FIFO within the group, other groups undisturbed), pad to the
        pow2 width, dispatch the resident step, scatter outputs back.
        Returns rows served (0 when idle)."""
        if not self.queue:
            return 0
        g = self.queue[0].group
        tbl = self.tables[g]
        batch: List[tuple] = []                    # (req, lo, take)
        rows = 0
        for req in self.queue:
            if req.group != g:
                continue
            take = min(req.rows - req.served, self.max_batch - rows)
            if take <= 0:
                continue
            batch.append((req, req.served, take))
            rows += take
            if rows >= self.max_batch:
                break
        b_pad = self.bucket(rows)
        x = np.zeros((b_pad, tbl.in_dim), np.float32)
        tix = np.zeros((b_pad,), np.int32)
        at = 0
        for req, lo, take in batch:
            x[at:at + take] = req.x[lo:lo + take]
            tix[at:at + take] = req.user
            at += take
        plan = self._step_fn(tbl.t_pad, b_pad, tbl.in_dim, tbl.out_dim)
        captures, replays = plan.captures, plan.replays
        y = plan(self.params, tbl.M, tbl.mu, x, tix)
        self.cache.captures += plan.captures - captures
        self.cache.replays += plan.replays - replays
        at = 0
        now = time.perf_counter()
        for req, lo, take in batch:
            if req.out is None:
                req.out = np.zeros((req.rows, y.shape[1]), np.float32)
            req.out[lo:lo + take] = y[at:at + take]
            at += take
            req.served += take
            req.status = "truncated"               # partially served so far
            if req.served == req.rows:
                req.status = "done"
                req.t_done = now
                self.latencies.append(req.latency)
                self.requests_done += 1
        self.queue = deque(r for r in self.queue if r.served < r.rows)
        self.steps += 1
        self.rows_served += rows
        self.bucket_hist[(g, tbl.t_pad, b_pad)] += 1
        return rows

    def serve(self, requests: Optional[Sequence[CollabRequest]] = None, *,
              max_steps: int = 10_000) -> ServeOutput:
        """Drain the queue (plus `requests`, submitted first) through at
        most `max_steps` dispatches. The returned mapping holds each
        request's SERVED rows; `.status` distinguishes finished requests
        from ones truncated mid-serve or never admitted."""
        tracked: List[CollabRequest] = list(self.queue)
        for req in requests or ():
            req.t_submit = time.perf_counter()
            self.queue.append(req)
            tracked.append(req)
        steps = 0
        while self.queue and steps < max_steps:
            self.step()
            steps += 1
        outputs = {r.rid: (r.out[: r.served] if r.out is not None
                           else np.zeros((0, 0), np.float32))
                   for r in tracked}
        return ServeOutput(outputs, {r.rid: r.status for r in tracked})

    # -- live onboarding ---------------------------------------------------

    def _refresh_tables(self) -> None:
        """Rebuild every group's table from the (refreshed) setup: Z moved,
        so every tenant's combined map changed — table CONTENT is runtime
        data, only a grown pow2 tenant pad can introduce a new bucket."""
        self.tables = build_tables(self.setup, self.bucket,
                                   device=self.device)

    def onboard_user(self, i: int, X_new: np.ndarray,
                     Y_new: np.ndarray) -> int:
        """Onboard a new user into group i of the LIVE server (incremental
        protocol update) and refresh the tenant tables; the queue and the
        buckets' steps stay warm. Returns the new user index."""
        if self.setup is None:
            raise RuntimeError(
                "this server was built from raw tables; onboarding needs "
                "ServeCollab.from_setup/from_model (a FedDCLSetup with "
                "onboarding state)")
        j = self.setup.onboard_user(i, X_new, Y_new)
        self._refresh_tables()
        return j

    def onboard_silo(self, Xs_new: Sequence[np.ndarray],
                     Ys_new: Sequence[np.ndarray]) -> int:
        """Onboard a whole new group onto the live server; returns its
        index (immediately servable)."""
        if self.setup is None:
            raise RuntimeError(
                "this server was built from raw tables; onboarding needs "
                "ServeCollab.from_setup/from_model")
        i = self.setup.onboard_silo(Xs_new, Ys_new)
        self._refresh_tables()
        return i

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        lat = sorted(self.latencies)

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "steps": self.steps,
            "rows_served": self.rows_served,
            "requests_done": self.requests_done,
            "queued": len(self.queue),
            "p50_latency_s": pct(0.50),
            "p99_latency_s": pct(0.99),
            "buckets": {f"g{g}/T{t}/B{b}": n
                        for (g, t, b), n in sorted(self.bucket_hist.items())},
            "cache": self.cache.stats(),
        }
