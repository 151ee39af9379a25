"""Algorithm 1: the full FedDCL protocol, end to end (counterpart of
``repro.core.protocol``).

Data layout mirrors the paper: Xs[i][j] is the raw data of user (i, j)
(group i = intra-group DC server i, user j inside it). The orchestration
below simulates the three roles in-process but preserves the exact
communication pattern — what each message contains is exactly what the
paper allows to cross each trust boundary:

  user (i,j)  --{X̃_j^(i), Ã_j^(i), Y_j^(i)}-->  DC server i      (once)
  DC server i --{B̃^(i)}------------------------>  FL server       (once)
  FL server   --{Z}----------------------------->  DC servers      (once)
  DC servers  <==federated rounds on X̂==>        FL server        (iterative)
  DC server i --{G_j^(i), h}-------------------->  user (i,j)      (once)

`CommLog` records every message and its payload bytes, which backs the
communication-cost benchmark (benchmarks/comm_cost.py) and the paper's
"each user communicates exactly twice" claim.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import collab
from repro_torch.core.anchor import make_anchor
from repro_torch.core.mappings import LinearMap, fit_mapping
from repro_torch.device import DeviceLike


@dataclass
class CommEvent:
    src: str
    dst: str
    payload: str
    nbytes: int


@dataclass
class CommLog:
    events: List[CommEvent] = field(default_factory=list)

    def log(self, src: str, dst: str, payload: str, *arrays) -> None:
        nbytes = int(sum(np.asarray(a).nbytes for a in arrays))
        self.events.append(CommEvent(src, dst, payload, nbytes))

    def user_round_trips(self) -> Dict[str, int]:
        """Cross-institution communications per user — the paper's claim is
        exactly 2 (upload step 4, download step 15)."""
        counts: Dict[str, int] = {}
        for e in self.events:
            for node in (e.src, e.dst):
                if node.startswith("user"):
                    counts[node] = counts.get(node, 0) + 1
        return counts

    def total_bytes(self, match: Optional[Callable[[CommEvent], bool]] = None) -> int:
        return sum(e.nbytes for e in self.events if match is None or match(e))


@dataclass
class OnboardState:
    """Maintained protocol state enabling incremental tenant onboarding
    (DESIGN.md §10) — everything a from-scratch `run_protocol` would have
    to recompute, kept warm so a new user/silo joins at the cost of ITS OWN
    step-2/3 work plus cheap blocked updates:

      inter_A / inter_X — every user's anchor/data intermediate
          representations (step 2 never re-run for existing tenants)
      grams     — per-group Gram of the stacked anchors, grown by blocked
          cross-products on onboarding (collab.gram_update_blocked)
      bases_B   — per-group B̃^(i); only the group that gained a tenant
          re-derives its basis (small eigh of the maintained Gram)
      g_factors — per-group cached QR factors of every user's Ã_j: a Z
          refresh re-solves ALL G's with triangular solves only
    """
    seed: int
    m_tilde: int
    m_hat: int
    mapping_kind: str
    backend: Any                                 # the resolved backend object
    inter_A: List[List[np.ndarray]]
    inter_X: List[List[np.ndarray]]
    grams: List[np.ndarray]
    bases_B: List[np.ndarray]
    g_factors: List[Any]


@dataclass
class FedDCLSetup:
    """Everything produced by protocol steps 1–3 (before model training)."""
    anchor: np.ndarray
    mappings: List[List[LinearMap]]              # f_j^(i)
    Gs: List[List[np.ndarray]]                   # G_j^(i)
    collab_X: List[np.ndarray]                   # X̂^(i) per group (stacked users)
    collab_Y: List[np.ndarray]                   # Y^(i) per group
    comm: CommLog
    m_hat: int
    Z: Optional[np.ndarray] = None               # central target (r, m̂)
    onboard: Optional[OnboardState] = None       # run_protocol(onboard=True)

    def user_transform(self, i: int, j: int) -> Callable[[np.ndarray], np.ndarray]:
        """x -> f_j^(i)(x) G_j^(i) — the per-user input map of the final
        integrated model t_j^(i)(X) = h(f(X) G)."""
        f, G = self.mappings[i][j], self.Gs[i][j]
        return lambda X: f(np.asarray(X, np.float64)) @ G

    def fed_silos(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Step 4 input: per-DC-server (X̂^(i), Y^(i)) silo pairs, ready for
        core.federated.run_federated (either engine — the scan engine pads
        and moves them device-resident in one shot)."""
        return list(zip(self.collab_X, self.collab_Y))

    @property
    def num_groups(self) -> int:
        return len(self.mappings)

    def num_users(self, i: Optional[int] = None) -> int:
        if i is not None:
            return len(self.mappings[i])
        return sum(len(row) for row in self.mappings)

    # -- incremental onboarding (DESIGN.md §10) ----------------------------

    def _require_onboard(self) -> OnboardState:
        if self.onboard is None:
            raise RuntimeError(
                "this FedDCLSetup was built without onboarding state — "
                "run_protocol(..., onboard=True) (FedDCL.fit does)")
        return self.onboard

    def onboard_user(self, i: int, X_new: np.ndarray,
                     Y_new: np.ndarray) -> int:
        """A new user joins existing group i on a LIVE setup: fits only the
        newcomer's private map, extends group i's Gram by blocked
        cross-products, re-derives that group's basis from the small
        maintained Gram (never the O(r·W²) anchor reduction), refreshes the
        tiny central SVD with the protocol's exact RNG streams, and
        re-solves G's from cached QR factors — only the newcomer is ever
        factored. Equal to a from-scratch `run_protocol` over the full
        roster against the same anchor (≤1e-8 host / ≤1e-5 device, tested).

        Returns the new user's index j within group i.
        """
        st = self._require_onboard()
        be = collab.get_backend(st.backend)
        j = len(self.mappings[i])
        X_new = np.asarray(X_new, np.float64)
        f = fit_mapping(st.mapping_kind, X_new, st.m_tilde,
                        seed=st.seed * 1009 + i * 101 + j)
        Xt, At = f(X_new), f(self.anchor)
        self.comm.log(f"user({i},{j})", f"dc({i})", "X~,A~,Y", Xt, At, Y_new)
        A_old = np.concatenate(st.inter_A[i], axis=1)
        st.grams[i] = be.gram_update_blocked(st.grams[i], A_old, At)
        st.inter_A[i].append(At)
        st.inter_X[i].append(Xt)
        self.mappings[i].append(f)
        fac = be.factor_G_append(st.g_factors[i], At)
        if fac is None:                 # wider than the factored pad width
            fac = be.factor_G_many(st.inter_A[i])
        st.g_factors[i] = fac
        self._refresh_group_basis(i)
        self._refresh_central_and_G(changed_groups=(i,))
        self.collab_Y[i] = np.concatenate(
            [self.collab_Y[i], np.asarray(Y_new)], axis=0)
        return j

    def onboard_silo(self, Xs_new: Sequence[np.ndarray],
                     Ys_new: Sequence[np.ndarray]) -> int:
        """A whole new DC group (institution) joins: step 2 runs for ITS
        users only, its Gram/basis are computed fresh (they are new), the
        central target is refreshed over d+1 bases, and every existing
        user's G is re-solved from cached factors. Returns the new group
        index i."""
        st = self._require_onboard()
        be = collab.get_backend(st.backend)
        i = len(self.mappings)
        row_f, row_x, row_a = [], [], []
        for j, X in enumerate(Xs_new):
            X = np.asarray(X, np.float64)
            f = fit_mapping(st.mapping_kind, X, st.m_tilde,
                            seed=st.seed * 1009 + i * 101 + j)
            row_f.append(f)
            Xt, At = f(X), f(self.anchor)
            row_x.append(Xt)
            row_a.append(At)
            self.comm.log(f"user({i},{j})", f"dc({i})", "X~,A~,Y",
                          Xt, At, Ys_new[j])
        A = np.concatenate(row_a, axis=1)
        st.inter_A.append(row_a)
        st.inter_X.append(row_x)
        st.grams.append(be.gram(A))
        st.g_factors.append(be.factor_G_many(row_a))
        self.mappings.append(row_f)
        self.Gs.append([])
        rng = np.random.default_rng(st.seed * 31 + i)
        svd = be.topk_svd(A, st.m_hat)
        st.bases_B.append(collab._basis_from_svd(
            svd, rng, [a.shape[1] for a in row_a]).B)
        self.collab_X.append(np.zeros((0, st.m_hat)))   # filled by refresh
        self.collab_Y.append(np.concatenate(
            [np.asarray(y) for y in Ys_new], axis=0))
        self._refresh_central_and_G(changed_groups=(i,))
        return i

    def _refresh_group_basis(self, i: int) -> None:
        """Re-derive B̃^(i) from the MAINTAINED Gram — eigh of a (W, W)
        matrix plus one (r, W)·(W, m̂) recovery matmul — replaying the same
        per-group RNG stream `run_protocol` would use."""
        st = self.onboard
        be = collab.get_backend(st.backend)
        A = np.concatenate(st.inter_A[i], axis=1)
        svd = be.topk_svd_from_gram(A, st.grams[i], st.m_hat)
        rng = np.random.default_rng(st.seed * 31 + i)
        st.bases_B[i] = collab._basis_from_svd(
            svd, rng, [a.shape[1] for a in st.inter_A[i]]).B

    def _refresh_central_and_G(self, changed_groups: Sequence[int] = ()) -> None:
        """Steps 3b/3c/12 after a basis changed: recompute the (tiny)
        central SVD → Z, re-solve every user's G from cached QR factors
        (one batched triangular solve per group), and refresh the
        collaboration representations X̂ = X̃ G from the cached X̃."""
        st = self.onboard
        be = collab.get_backend(st.backend)
        for i in changed_groups:
            self.comm.log(f"dc({i})", "fl", "B~", st.bases_B[i])
        target = collab.central_target(
            [collab.GroupBasis(B=B) for B in st.bases_B],
            st.m_hat, st.seed * 57, backend=st.backend)
        self.Z = target.Z
        d = len(st.inter_A)
        for i in range(d):
            self.comm.log("fl", f"dc({i})", "Z", target.Z)
            self.Gs[i] = be.solve_G_factors(st.g_factors[i], target.Z)
        flat_X = [x for row in st.inter_X for x in row]
        flat_G = [g for row in self.Gs for g in row]
        flat_XG = collab.apply_G_all(flat_X, flat_G, backend=st.backend)
        k = 0
        for i in range(d):
            c_i = len(st.inter_X[i])
            self.collab_X[i] = np.concatenate(flat_XG[k:k + c_i], axis=0)
            k += c_i


def run_protocol(
    Xs: Sequence[Sequence[np.ndarray]],
    Ys: Sequence[Sequence[np.ndarray]],
    *,
    m_tilde: int,
    m_hat: Optional[int] = None,
    anchor_r: int = 2000,
    anchor_kind: str = "uniform",
    mapping_kind: str = "pca_rot",
    seed: int = 0,
    svd_backend: str = "host",
    fixed_W: Optional[np.ndarray] = None,
    anchor: Optional[np.ndarray] = None,
    onboard: bool = False,
    device: DeviceLike = None,
) -> FedDCLSetup:
    """Steps 1–3 + 12 of Algorithm 1 (everything except the FL training,
    which core/federated.run_federated performs on the returned collab_X).

    `svd_backend` selects the step-3 engine (collab.CollabBackend):
    "host" is the serial NumPy float64 reference; "device" runs one batched
    Gram+eigh launch for all d groups and one batched QR least-squares for
    all users on `device` (None -> CUDA, which raises without a card) — no
    per-group or per-user Python-loop linear algebra on the hot path. A
    backend object is used as given.

    `anchor` supplies a pre-agreed anchor dataset instead of deriving one
    from the pooled data — the protocol's real deployment shape (the anchor
    is fixed once and later tenants adopt it) and what makes incremental
    onboarding exactly comparable to a from-scratch rerun.

    `onboard=True` additionally retains the `OnboardState` (per-user
    intermediate representations, per-group Grams, cached G factors) that
    `FedDCLSetup.onboard_user`/`onboard_silo` need — a little extra setup
    compute and memory, so it is opt-in (FedDCL.fit opts in)."""
    d = len(Xs)
    m_hat = m_hat or m_tilde
    comm = CommLog()
    be = collab.get_backend(svd_backend, device)

    # ---- Step 1: shared anchor (same seed everywhere) --------------------
    if anchor is None:
        allX = np.concatenate([np.concatenate(list(g), axis=0) for g in Xs],
                              axis=0)
        anchor = make_anchor(anchor_kind, seed, anchor_r,
                             feat_min=allX.min(0), feat_max=allX.max(0),
                             public_sample=allX[:: max(1, len(allX) // 512)])
    else:
        anchor = np.asarray(anchor, np.float64)

    # ---- Step 2: private maps + intermediate representations -------------
    mappings: List[List[LinearMap]] = []
    inter_X: List[List[np.ndarray]] = []
    inter_A: List[List[np.ndarray]] = []
    for i in range(d):
        row_f, row_x, row_a = [], [], []
        for j in range(len(Xs[i])):
            f = fit_mapping(mapping_kind, np.asarray(Xs[i][j], np.float64),
                            m_tilde, seed=seed * 1009 + i * 101 + j, W=fixed_W)
            row_f.append(f)
            Xt, At = f(np.asarray(Xs[i][j], np.float64)), f(anchor)
            row_x.append(Xt)
            row_a.append(At)
            comm.log(f"user({i},{j})", f"dc({i})", "X~,A~,Y", Xt, At, Ys[i][j])
        mappings.append(row_f)
        inter_X.append(row_x)
        inter_A.append(row_a)

    # ---- Step 3a: intra-group bases -> central server --------------------
    # One batched Gram+eigh launch for all d groups on the device backend
    # (zero-padded to the max group width); serial LAPACK loop on host.
    bases = collab.intra_group_bases(
        inter_A, m_hat, seeds=[seed * 31 + i for i in range(d)],
        backend=be)
    for i, gb in enumerate(bases):
        comm.log(f"dc({i})", "fl", "B~", gb.B)

    # ---- Step 3b: central target Z -> DC servers --------------------------
    target = collab.central_target(bases, m_hat, seed * 57, backend=be)
    for i in range(d):
        comm.log("fl", f"dc({i})", "Z", target.Z)

    # ---- Step 3c + 12: per-user G, collaboration representations ----------
    # All users of the protocol solved in ONE batched QR call on device, and
    # all per-user X̂ = X̃ G products computed in ONE padded batched matmul
    # (collab.apply_G_all) instead of a per-user host loop.
    flat_A = [inter_A[i][j] for i in range(d) for j in range(len(Xs[i]))]
    flat_G = collab.solve_G_all(flat_A, target.Z, backend=be)
    flat_X = [inter_X[i][j] for i in range(d) for j in range(len(Xs[i]))]
    flat_XG = collab.apply_G_all(flat_X, flat_G, backend=be)
    Gs: List[List[np.ndarray]] = []
    collab_X: List[np.ndarray] = []
    collab_Y: List[np.ndarray] = []
    k = 0
    for i in range(d):
        c_i = len(Xs[i])
        Gs.append(flat_G[k:k + c_i])
        collab_X.append(np.concatenate(flat_XG[k:k + c_i], axis=0))
        collab_Y.append(np.concatenate(list(Ys[i]), axis=0))
        k += c_i

    state = None
    if onboard:
        stacked = [np.concatenate(row, axis=1) for row in inter_A]
        state = OnboardState(
            seed=seed, m_tilde=m_tilde, m_hat=m_hat,
            mapping_kind=mapping_kind, backend=be,
            inter_A=[list(row) for row in inter_A],
            inter_X=[list(row) for row in inter_X],
            grams=[be.gram(A) for A in stacked],
            bases_B=[gb.B for gb in bases],
            g_factors=[be.factor_G_many(row) for row in inter_A])

    return FedDCLSetup(anchor=anchor, mappings=mappings, Gs=Gs,
                       collab_X=collab_X, collab_Y=collab_Y, comm=comm,
                       m_hat=m_hat, Z=target.Z, onboard=state)


def finalize_user_models(setup: FedDCLSetup, h: Callable[[np.ndarray], np.ndarray],
                         h_params_bytes: int = 0):
    """Step 5/15: return t_j^(i)(X) = h(f_j^(i)(X) G_j^(i)) per user and log
    the download leg (the user's 2nd and final communication)."""
    models = []
    for i in range(len(setup.mappings)):
        row = []
        for j in range(len(setup.mappings[i])):
            tr = setup.user_transform(i, j)
            setup.comm.log(f"dc({i})", f"user({i},{j})", "G,h",
                           setup.Gs[i][j], np.zeros(h_params_bytes // 8 + 1))
            row.append(lambda X, tr=tr: h(tr(X)))
        models.append(row)
    return models
