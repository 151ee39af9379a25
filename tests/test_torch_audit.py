"""The port's artifact audit (``repro_torch.analysis.audit``,
``hlo_audit.find_baked_constants``, ``core.federated.lower_fl_plan``)
against the reference's (``scripts/feddcl_audit.py``, ``lower_fl_plan``).

On the CPU: every unsharded flavor of the audit's tiny FL plan, lowered,
passes ``assert_no_baked_data`` at the reference script's threshold (512
elements); the lowered plan trains what the reference's plan trains on
the reference's schedule (1e-4, the scan engine's bar); both positive
controls are caught; ``find_baked_constants`` flags non-splat tensors in
closures and buffers and passes splats; a warm run builds nothing. The
``cuda`` tests hold the repair: an idle cached plan on the card holds only
splats after ``run_federated(engine="scan", cache=True)`` and
``ServeCollab.serve()``, and a plan reused by tenant B gives tenant A
bitwise its own answer again.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import federated as jfed  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from _jax_oracle import oracle_on_cpu  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.analysis import (BakedDataError,  # noqa: E402
                                  assert_no_baked_data, find_baked_constants)
from repro_torch.analysis import audit  # noqa: E402
from repro_torch.benchmarks import serve_bench  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.graphs import zero_buffers  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve_collab import CollabRequest  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

BAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(scope="module")
def report():
    """The whole audit, once, on the CPU."""
    return audit.run("cpu")


# --------------------------------------------------------------------------
# the audit on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", [f[0] for f in audit.FLAVORS]
                         + [f[0] for f in audit.SHARDED_FLAVORS])
def test_every_flavor_passes_the_audit(report, flavor):
    """Every flavor, the sharded ones on 2 CPU ranks, with its census: none
    unsharded; {all-reduce: leaves+1} for a sharded weighted plan and
    {all-reduce: 1, all-gather: leaves+1} for a sharded robust one (one
    level: a 2 x 1 ("data", "model") mesh)."""
    row = next(r for r in report["flavors"] if r["flavor"] == flavor)
    assert row["baked"] == [] and row["plans"] == 1
    assert row["captures"] == 0              # nothing is captured on the CPU
    assert row["max_rel_err_vs_eager"] == 0.0
    leaves = 4                               # the 16 -> 8 -> 1 MLP
    assert row["collectives"] == row["expected_collectives"] == (
        {} if not flavor.startswith("sharded/") else
        {"all-reduce": 1, "all-gather": leaves + 1}
        if "trimmed_mean" in flavor else {"all-reduce": leaves + 1})


@pytest.mark.parametrize("aggregator,dropout",
                         [("fedavg", False), ("median", False),
                          ("fedavg", True)])
def test_lowered_plan_matches_reference_plan(aggregator, dropout):
    """The same tenant, init params and schedule through the reference's
    plan and the port's lowered one: final params and per-round losses."""
    padded = tfed.pad_silo_data(audit.tenant(), audit.BATCH)
    av = audit.DROPOUT if dropout else None
    pj = jmlp.init_mlp_params(jax.random.PRNGKey(0), audit.FEATURES, (8,), 1)
    jloss = lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, "regression")
    jplan = jfed.make_fl_plan(
        num_silos=padded.num_silos, num_batches=padded.num_batches,
        batch_size=padded.batch_size, opt=jadamw(audit.LR),
        batch_loss=jfed._make_batch_loss(jloss, True, 0.0),
        rounds=audit.ROUNDS, local_epochs=audit.EPOCHS,
        aggregator=aggregator, masked=True)
    jpadded = jfed.pad_silo_data(audit.tenant(), audit.BATCH)
    gp, losses = jplan(pj, *jfed._plan_args(jpadded, 3, audit.ROUNDS,
                                            availability=av))
    key = jax.random.PRNGKey(3)
    sched = np.stack([np.asarray(jfed.round_perms(
        key, r, padded.num_silos, audit.EPOCHS, padded.n_slots))
        for r in range(audit.ROUNDS)])
    tp = weights.mlp_params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    plan = audit.make_plan(padded, audit.batch_loss(), aggregator, "cpu")
    low = tfed.lower_fl_plan(plan, tp, padded, rounds=audit.ROUNDS,
                             schedule=sched, availability=av)
    got = low.run(*low.args)
    want = np.concatenate([tfed._flat(weights.mlp_params_from_numpy(
        jax.tree.map(np.asarray, gp), "cpu")), np.asarray(losses, np.float64)])
    gap = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    print(f"parity-gap lowered plan vs reference {aggregator} "
          f"dropout={dropout}: {gap:.2e} (bar {BAR:.0e})")
    assert gap <= BAR


def test_closure_baked_control_is_caught(report):
    control = report["closure_control"]
    assert "does not move when its argument 1" in control["behaviour"]
    assert len(control["structure"]) == 1
    assert control["structure"][0].endswith(":baked_X>")


def test_buffer_resident_control_is_caught(report):
    assert report["buffer_control"]["structure"] == ["RetainingPlan._bufs.X"]


def test_warm_run_builds_nothing(report):
    assert report["warm_recompiles"] == 0
    assert report["ok"] is True


def test_cli_prints_each_check_and_exit_status(report, monkeypatch, capsys):
    monkeypatch.setattr(audit, "run", lambda device, min_elems, ranks: report)
    assert audit.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(l.startswith("AUDIT_OK ") for l in out) == len(audit.FLAVORS) \
        + len(audit.SHARDED_FLAVORS)
    assert sum(l.startswith("AUDIT_OK sharded/") for l in out) == 3
    assert sum(l.startswith("POSITIVE_CONTROL caught ") for l in out) == 2
    assert "WARM_RECOMPILES 0" in out
    assert not any(l.startswith("SKIPPED ") for l in out)
    missed = dict(report, buffer_control={"structure": []})
    missed["ok"] = audit.ok(missed)
    monkeypatch.setattr(audit, "run", lambda device, min_elems, ranks: missed)
    assert audit.main(["--device", "cpu"]) == 1
    assert "POSITIVE_CONTROL MISSED buffer_resident" in capsys.readouterr().out


def test_lower_fl_plan_refuses_another_layout():
    padded = tfed.pad_silo_data(audit.tenant(), audit.BATCH)
    other = tfed.pad_silo_data(audit.tenant(), audit.BATCH, min_batches=8)
    plan = audit.make_plan(padded, audit.batch_loss(), "fedavg", "cpu")
    tp = tmlp.init_mlp_params(torch.Generator().manual_seed(0),
                              audit.FEATURES, (8,), 1, device="cpu")
    with pytest.raises(ValueError, match="not the plan's"):
        tfed.lower_fl_plan(plan, tp, other, rounds=1)


# --------------------------------------------------------------------------
# find_baked_constants
# --------------------------------------------------------------------------

def _holder(t):
    def fn(x):
        return x + t
    return SimpleNamespace(fn=fn, bufs=SimpleNamespace(X=t), rows=[t])


def test_find_baked_constants_flags_closures_and_buffers():
    data = torch.randn(32, 32, generator=torch.Generator().manual_seed(0))
    found = find_baked_constants(_holder(data), min_elems=512)
    # one tensor, reached three ways, reported once
    assert len(found) == 1 and found[0]["shape"] == (32, 32)
    assert found[0]["elements"] == 1024
    paths = {f["path"] for f in find_baked_constants(
        SimpleNamespace(a=_holder(data.clone()).fn,
                        b=SimpleNamespace(X=data.numpy().copy())),
        min_elems=512)}
    assert paths == {"SimpleNamespace.a.<fn:t>", "SimpleNamespace.b.X"}


@pytest.mark.parametrize("splat", [
    torch.zeros(64, 64), torch.full((64, 64), 3.5),
    torch.full((64, 64), float("nan")), torch.zeros(64, 64, dtype=torch.long),
    np.ones((64, 64))], ids=["zeros", "fill", "nan", "int", "ndarray"])
def test_find_baked_constants_passes_splats(splat):
    assert find_baked_constants(_holder(splat), min_elems=512) == []


def test_find_baked_constants_threshold():
    small = torch.arange(100.0)
    assert find_baked_constants(_holder(small), min_elems=512) == []
    assert len(find_baked_constants(_holder(small), min_elems=100)) == 1


def test_assert_no_baked_data_names_what_an_idle_plan_holds():
    padded = tfed.pad_silo_data(audit.tenant(), audit.BATCH)
    plan = audit.make_plan(padded, audit.batch_loss(), "fedavg", "cpu",
                           cls=audit.RetainingPlan)
    tp = tmlp.init_mlp_params(torch.Generator().manual_seed(0),
                              audit.FEATURES, (8,), 1, device="cpu")
    low = tfed.lower_fl_plan(plan, tp, padded, rounds=1)
    with pytest.raises(BakedDataError, match=r"RetainingPlan\._bufs\.X"):
        assert_no_baked_data(low, min_elems=512)


def test_zero_buffers_clears_every_leaf():
    """Mixed dtypes, nesting and None leaves: every tensor ends all zeros,
    in place (a captured graph keeps reading the same storage)."""
    gen = torch.Generator().manual_seed(0)
    tree = {"p": [torch.randn(4, 3, generator=gen), None],
            "x": torch.randn(8, generator=gen),
            "idx": torch.arange(5), "h": torch.ones(2, dtype=torch.float64)}
    ptrs = [t.data_ptr() for t in tree_leaves(tree) if t is not None]
    zero_buffers(tree)
    leaves = [t for t in tree_leaves(tree) if t is not None]
    assert [t.data_ptr() for t in leaves] == ptrs
    assert all(not t.any() for t in leaves) and tree["p"][1] is None


def test_plan_cache_lists_its_plans():
    cache = tfed.PlanCache()
    kw = dict(opt=tadamw(1e-2), rounds=1, local_epochs=1, batch_size=8,
              engine="scan", cache=cache, device="cpu",
              loss_id=("mlp", "regression"), opt_id=("adamw", 1e-2))
    tp = tmlp.init_mlp_params(torch.Generator().manual_seed(0),
                              audit.FEATURES, (8,), 1, device="cpu")
    loss = lambda p, x, y: tmlp.mlp_per_example_loss(p, x, y, "regression")
    tfed.run_federated(loss, tp, audit.tenant(0), **kw)
    tfed.run_federated(loss, tp, audit.tenant(1), **kw)
    assert len(cache.plans()) == 1
    assert isinstance(cache.plans()[0], tfed.FLPlan)
    assert find_baked_constants(cache.plans()[0], min_elems=512) == []


# --------------------------------------------------------------------------
# on the card: the repair (idle plans hold only splats) and its guard
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: plans fill static buffers only "
                    "where they capture CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fl_kw(dev, cache):
    return dict(opt=tadamw(audit.LR), rounds=audit.ROUNDS,
                local_epochs=audit.EPOCHS, batch_size=audit.BATCH,
                engine="scan", cache=cache, device=dev, seed=3,
                loss_id=("mlp", "regression"), opt_id=("adamw", audit.LR))


def _fl_loss(p, x, y):
    return tmlp.mlp_per_example_loss(p, x, y, "regression")


@pytest.mark.cuda
def test_idle_cached_plans_hold_only_splats_on_cuda(cuda_device):
    tp = tmlp.init_mlp_params(torch.Generator().manual_seed(0),
                              audit.FEATURES, (8,), 1, device=cuda_device)
    res = tfed.run_federated(_fl_loss, tp, audit.tenant(),
                             **_fl_kw(cuda_device, True))
    assert res.cache_stats["captures"] >= 1
    b = serve_bench.build(fast=True, device=cuda_device)
    serve_bench.serve_sweeps(b)
    plans = tfed.default_plan_cache().plans() + b.srv.cache.plans()
    assert any(isinstance(p, tfed.FLPlan) and p.captures for p in plans)
    assert any(not isinstance(p, tfed.FLPlan) and p.captures for p in plans)
    for plan in plans:
        assert find_baked_constants(plan, min_elems=512) == [], plan


@pytest.mark.cuda
def test_audit_on_cuda(cuda_device):
    rep = audit.run(cuda_device)
    assert rep["ok"] is True
    for row in rep["flavors"]:
        # a sharded round is two graphs, one each side of the collective
        two = row["flavor"].startswith("sharded/")
        assert (row["plans"], row["captures"]) == (1, 1 + two), row
        assert row["max_rel_err_vs_eager"] <= 1e-5, row


@pytest.mark.cuda
def test_a_reused_fl_plan_gives_a_its_own_answer_on_cuda(cuda_device):
    """Tenant A, then tenant B on the same cached plan, then A again: A's
    second result is bitwise its first."""
    cache = tfed.PlanCache()
    tp = tmlp.init_mlp_params(torch.Generator().manual_seed(0),
                              audit.FEATURES, (8,), 1, device=cuda_device)
    runs = [tfed.run_federated(_fl_loss, tp, audit.tenant(s),
                               **_fl_kw(cuda_device, cache))
            for s in (0, 1, 0)]
    assert [r.cache_stats["hit"] for r in runs] == [False, True, True]
    assert cache.stats()["captures"] == 1
    a1, b, a2 = runs
    assert [h["loss"] for h in a1.history] == [h["loss"] for h in a2.history]
    for x, y in zip(tree_leaves(a1.params), tree_leaves(a2.params)):
        assert torch.equal(x, y)
    assert [h["loss"] for h in a1.history] != [h["loss"] for h in b.history]


@pytest.mark.cuda
def test_a_reused_serve_plan_gives_a_its_own_answer_on_cuda(cuda_device):
    b = serve_bench.build(fast=True, device=cuda_device)
    x = np.random.default_rng(5).standard_normal((16, serve_bench.M_RAW))
    outs = [b.srv.serve([CollabRequest(rid=k, group=g, user=u, x=x)])[k]
            for k, (g, u) in enumerate([(0, 1), (1, 2), (0, 1)])]
    assert b.srv.cache.stats()["captures"] == 1
    assert np.array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], outs[1])
