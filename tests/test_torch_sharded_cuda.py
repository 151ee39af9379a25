"""Step 4 across DC-server processes on the card, JAX-free: 2 ranks
(processes) share one GPU, each computing on its own CUDA context, each
round two captured graphs either side of the collective, the combined
buffers through pinned host memory over gloo. Held to the port's
unsharded scan engine on the card at the reference's sharded bar (1e-5
relative); every rank bitwise alike; idle sharded plans only splats."""
import numpy as np
import pytest
import torch

from repro_torch.core import federated as tfed
from repro_torch.launch import fed_ranks, mesh as tmesh
from repro_torch.models import mlp as tmlp
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_to_numpy

AGGREGATORS = ("fedavg", "fedprox", "fedsgd", "median", "trimmed_mean",
               "krum")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks compute on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _silos(sizes, m=4, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, 1))
    out = []
    for k, n in enumerate(sizes):
        r = np.random.default_rng(seed * 97 + k + 1)
        X = r.standard_normal((n, m))
        out.append((X, X @ w + 0.01 * r.standard_normal((n, 1))))
    return out


SILOS = _silos([12, 20, 9, 15, 11])


def _runs():
    runs = []
    for agg in AGGREGATORS:
        kw = dict(opt=("adamw", 1e-2), rounds=2, local_epochs=2,
                  batch_size=8, seed=3, aggregator=agg,
                  fedprox_mu=0.1 if agg == "fedprox" else 0.0)
        if agg in tfed.ROBUST_AGGREGATORS:
            kw.update(dropout_rate=0.25, silo_scale=[1.0, -3.0, 1.0, 1.0, 1.0])
        runs.append(kw)
    return runs


def _params(dev):
    return tmlp.init_mlp_params(torch.Generator().manual_seed(0), 4, (8,), 1,
                                device=dev)


@pytest.mark.cuda
def test_sharded_matches_unsharded_on_cuda(cuda_device):
    p = _params(cuda_device)
    spec = dict(mesh={"model": 1}, silos=SILOS, params=params_to_numpy(p),
                runs=_runs())
    per_rank = [r[0] for r in tmesh.run_ranks(
        fed_ranks.serial, 2, args=([("fit", spec)],), timeout=600)]
    loss = lambda q, x, y: tmlp.mlp_per_example_loss(q, x, y, "regression")
    for i, kw in enumerate(_runs()):
        kw = dict(kw)
        opt = fed_ranks.make_opt(*kw.pop("opt"))
        base = tfed.run_federated(loss, p, SILOS, opt=opt, engine="scan",
                                  device=cuda_device, **kw)
        got = [r["runs"][i] for r in per_rank]
        want = [a.detach().cpu().numpy() for a in tree_leaves(base.params)]
        mine = tree_leaves(got[0]["params"])
        gap = max(float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))
                  for a, b in zip(want, mine))
        print(f"cuda sharded vs unsharded {kw['aggregator']}: {gap:.2e}")
        assert gap <= 1e-5, (kw["aggregator"], gap)
        for g in got[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(
                mine, tree_leaves(g["params"])))
        c = got[0]["collectives"]
        assert c["staged_bytes_per_round"] > 0
        assert c["census"] == ({"all-reduce": 1, "all-gather": 5}
                               if kw["aggregator"] in tfed.ROBUST_AGGREGATORS
                               else {"all-reduce": 5})
        # one build, two graphs: each side of the collective
        assert got[0]["timings"]["capture_s"] > 0


@pytest.mark.cuda
def test_idle_sharded_plans_hold_only_splats_on_cuda(cuda_device):
    """Lowered on the card (built, captured, replayed, held to its eager
    rounds, no baked data): once idle, a sharded plan's buffers, its
    received stack and its pinned staging buffers are all zeros."""
    spec = dict(mesh={"model": 1}, silos=SILOS,
                params=params_to_numpy(_params("cpu")), task="regression",
                batch=8, cases=[("fedavg", 1), ("fedavg", 3), ("median", 2),
                                ("krum", 2)])
    per_rank = tmesh.run_ranks(fed_ranks.serial, 2,
                               args=([("lowered", spec)],), timeout=600)
    for rows in per_rank:
        for row in rows[0]:
            assert row["idle"] == [], row
            assert row["census"] == (
                {"all-reduce": 5} if row["aggregator"] == "fedavg"
                else {"all-reduce": 1, "all-gather": 5}), row
