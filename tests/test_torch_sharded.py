"""Step 4 across DC-server processes (``run_federated(mesh=...)``,
``repro_torch.launch.mesh``) against the reference's sharded tier
(``tests/test_fed_sharded.py``), on CPU ranks.

Each group of ranks (``run_ranks(device="cpu")``: spawned processes, one
thread each, gloo) runs many cases through ``launch.fed_ranks``; this
process holds the oracle. A sharded run must match the reference's
UNSHARDED engine (its own sharded == unsharded claim, <= 1e-5 relative,
holds under jax 0.9.0) and the port's unsharded scan engine, both <= 1e-5
relative, and every rank must return bitwise the same params. Torch
cannot reproduce jax.random, so the ranks take the reference's init
params and its minibatch schedule at the sharded run's padded layout
(the reference folds each silo's GLOBAL id into its stream, so the first
d rows are the unsharded draw). The census counts operands of the round
boundary's combined collectives per hierarchy level; it must not grow
with local epochs. The card's tests, JAX-free, are in
``tests/test_torch_sharded_cuda.py``.
"""
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import federated as jfed  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.analysis import collective_census  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.launch import fed_ranks, mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

BAR = 1e-5                 # the reference's sharded == unsharded bar
ROBUST = ("median", "trimmed_mean", "krum")
LEAVES = 4                 # the 4 -> 8 -> 1 MLP
KW = dict(rounds=3, local_epochs=2, batch_size=16, seed=7)
SCALE5 = [1.0, -3.0, 1.0, 1.0, 1.0]


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _gap(what: str, value: float, bar: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _linear_silos(sizes, m=4, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, 1))
    out = []
    for k, n in enumerate(sizes):
        r = np.random.default_rng(seed * 97 + k + 1)
        X = r.standard_normal((n, m))
        out.append((X, X @ w + 0.01 * r.standard_normal((n, 1))))
    return out


def _jparams(seed):
    return jmlp.init_mlp_params(jax.random.PRNGKey(seed), 4, (8,), 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.detach().numpy()
                     if isinstance(t, torch.Tensor) else t, tree))]


def _max_rel_diff(a, b) -> float:
    """The reference test's measure: max |a - b| / max |a| over leaves."""
    return max(float(np.max(np.abs(x - y)) / (np.max(np.abs(x)) + 1e-12))
               for x, y in zip(_leaves(a), _leaves(b)))


def _loss_gap(ha, hb) -> float:
    assert len(ha) == len(hb)
    return max(abs(a["loss"] - b["loss"]) / max(1.0, abs(a["loss"]))
               for a, b in zip(ha, hb))


def _jloss(p, x, y):
    return jmlp.mlp_per_example_loss(p, x, y, "regression")


def _tloss(p, x, y):
    return tmlp.mlp_per_example_loss(p, x, y, "regression")


def _ref_schedule(silos, shards, agg, rounds, epochs, batch, seed):
    """The reference's round_perms at the sharded run's padded layout."""
    if agg == "fedsgd":
        return None
    d = -(-len(silos) // shards) * shards
    padded = jfed.pad_silo_data(silos, batch, min_silos=d)
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jfed.round_perms(
        key, r, d, epochs, padded.n_slots)) for r in range(rounds)])


def _jopt(opt):
    return jadamw(opt[1]) if opt[0] == "adamw" else jsgd(opt[1],
                                                         momentum=opt[2])


def _oracles(silos, jp, kw, sched):
    """(reference unsharded, port unsharded) on the same init and schedule;
    the port's at its own unsharded layout, the schedule's first d rows."""
    kw = dict(kw)
    opt = kw.pop("opt")
    kw.pop("eval", None)
    ev = kw.pop("eval_fn", None)
    ref = jfed.run_federated(_jloss, jp, silos, opt=_jopt(opt),
                             engine="scan", eval_fn=ev and ev[0], **kw)
    port = tfed.run_federated(
        _tloss, weights.mlp_params_from_numpy(_np(jp), "cpu"), silos,
        opt=fed_ranks.make_opt(*opt), engine="scan", device="cpu",
        eval_fn=ev and ev[1],
        schedule=None if sched is None else sched[:, :len(silos)], **kw)
    return ref, port


def _case(silos, jp, shards, **kw):
    """A run's kwargs for the ranks (the reference's schedule injected)."""
    kw.setdefault("opt", ("adamw", 1e-2))
    sched = _ref_schedule(silos, shards, kw.get("aggregator", "fedavg"),
                          kw["rounds"], kw["local_epochs"], kw["batch_size"],
                          kw["seed"])
    return dict(kw, schedule=sched), sched


def _check_run(what, silos, jp, kw, sched, per_rank, i):
    """The sharded run i against both oracles; every rank bitwise alike."""
    got = [r["runs"][i] for r in per_rank]
    for g in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(
            _leaves(got[0]["params"]), _leaves(g["params"]))), what
        assert g["history"] == got[0]["history"], what
    base = {k: v for k, v in kw.items() if k != "schedule"}
    ref, port = _oracles(silos, jp, base, sched)
    _gap(f"sharded vs reference {what}",
         _max_rel_diff(ref.params, got[0]["params"]), BAR)
    _gap(f"sharded vs port unsharded {what}",
         _max_rel_diff(port.params, got[0]["params"]), BAR)
    _gap(f"sharded losses vs reference {what}",
         _loss_gap(ref.history, got[0]["history"]), BAR)
    return ref, got[0]


# --------------------------------------------------------------------------
# the groups of ranks, one spawn each (module-scoped)
# --------------------------------------------------------------------------

D3 = _linear_silos([20, 13, 17], seed=3)
D3_EVAL = _linear_silos([20, 13, 17], seed=5)
D2 = _linear_silos([18, 25], seed=9)
D5 = _linear_silos([12, 20, 9, 15, 11], seed=0)
WEIGHTED = ("fedavg", "fedprox", "fedsgd")


def _weighted_runs(shards):
    runs = []
    for agg in WEIGHTED:
        kw, _ = _case(D3, _jparams(1), shards, aggregator=agg,
                      fedprox_mu=0.1 if agg == "fedprox" else 0.0, **KW)
        runs.append(kw)
    return runs


def _spawn(world, jobs):
    return tmesh.run_ranks(fed_ranks.serial, world, args=(jobs,),
                           device="cpu", timeout=300)


@pytest.fixture(scope="module")
def two_ranks():
    """2 x 1 ("data", "model"): the weighted aggregators at d 3, streamed
    eval, optimizer state carried, and the plan cache's mesh key."""
    m = {"model": 1}
    ev, _ = _case(D3_EVAL, _jparams(2), 2, eval="w0", eval_chunk=2, **KW)
    carry, _ = _case(D2, _jparams(3), 2, opt=("sgd", 1e-2, 0.9),
                     reset_opt_per_round=False, **KW)
    cache = tfed.PlanCache()
    cached = dict(KW, opt=("adamw", 1e-2), cache=cache,
                  loss_id=("mlp", "regression"), opt_id=("adamw", 1e-2))
    jobs = [("fit", dict(mesh=m, silos=D3, params=_np(_jparams(1)),
                         runs=_weighted_runs(2))),
            ("fit", dict(mesh=m, silos=D3_EVAL, params=_np(_jparams(2)),
                         runs=[ev])),
            ("fit", dict(mesh=m, silos=D2, params=_np(_jparams(3)),
                         runs=[carry])),
            ("fit", dict(mesh=m, silos=D3, params=_np(_jparams(1)),
                         runs=[cached, cached, dict(cached, unsharded=True),
                               dict(cached, unsharded=True)]))]
    return _spawn(2, jobs), {"eval": ev, "carry": carry}


@pytest.fixture(scope="module")
def three_ranks():
    """3 x 1: the weighted aggregators at d 3 (one silo a shard), and what
    a rank sees of its mesh, with make_host_mesh's validation at 3."""
    m = {"model": 1}
    jobs = [("fit", dict(mesh=m, silos=D3, params=_np(_jparams(1)),
                         runs=_weighted_runs(3))),
            ("describe_mesh", dict(mesh=m, silos=D3, params=_np(_jparams(0)),
                                   host_meshes=[(1, None), (2, None),
                                                (2, 2), (4, None)]))]
    return _spawn(3, jobs)


def _d5_runs(shards):
    runs = []
    for agg in WEIGHTED + ROBUST:
        extra = dict(dropout_rate=0.25, silo_scale=SCALE5) \
            if agg in ROBUST else {}
        kw, _ = _case(D5, _jparams(0), shards, aggregator=agg, rounds=2,
                      local_epochs=2, batch_size=8, seed=3,
                      fedprox_mu=0.1 if agg == "fedprox" else 0.0, **extra)
        runs.append(kw)
    return runs


@pytest.fixture(scope="module")
def four_ranks():
    """4 x 1: d 5 over 4 shards with all six aggregators (the robust ones
    under dropout with a scaled silo), and the census of lowered plans at
    E 1 and E 3 (fedavg) and E 2 (each robust aggregator), audited."""
    m = {"model": 1}
    cases = [("fedavg", 1), ("fedavg", 3)] + [(a, 2) for a in ROBUST]
    jobs = [("fit", dict(mesh=m, silos=D5, params=_np(_jparams(0)),
                         runs=_d5_runs(4))),
            ("lowered", dict(mesh=m, silos=D5, params=_np(_jparams(0)),
                             task="regression", batch=8, cases=cases))]
    return _spawn(4, jobs)


POD_MESH = {"shape": (2, 2, 1), "names": ("pod", "data", "model")}


@pytest.fixture(scope="module")
def pod_ranks():
    """(2, 2, 1) ("pod", "data", "model"): the silo dim over ("pod",
    "data") jointly, 4 shards, two-level aggregation."""
    fedavg, _ = _case(D3, _jparams(1), 4, opt=("adamw", 1e-2), **KW)
    cached = dict(fedavg, cache=tfed.PlanCache(),
                  loss_id=("mlp", "regression"), opt_id=("adamw", 1e-2))
    jobs = [("fit", dict(mesh=POD_MESH, silos=D3, params=_np(_jparams(1)),
                         runs=[fedavg])),
            ("fit", dict(mesh=POD_MESH, silos=D5, params=_np(_jparams(0)),
                         runs=_d5_runs(4)[3:4])),
            ("describe_mesh", dict(mesh=POD_MESH, silos=D3,
                                   params=_np(_jparams(0)))),
            ("lowered", dict(mesh=POD_MESH, silos=D5, params=_np(_jparams(0)),
                             task="regression", batch=8,
                             cases=[("fedavg", 1), ("median", 2)])),
            ("fit", dict(mesh=POD_MESH, silos=D3, params=_np(_jparams(1)),
                         runs=[cached, dict(cached, fresh_mesh=True)]))]
    return _spawn(4, jobs)


@pytest.fixture(scope="module")
def replica_ranks():
    """2 x 2 ("data", "model"): model replicas of each silo shard."""
    runs = _d5_runs(2)
    jobs = [("fit", dict(mesh={"model": 2}, silos=D5, params=_np(_jparams(0)),
                         runs=[runs[0], runs[3]]))]
    return _spawn(4, jobs), [runs[0], runs[3]]


# --------------------------------------------------------------------------
# sharded == unsharded
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("aggregator", WEIGHTED)
def test_sharded_matches_unsharded_all_aggregators(
        two_ranks, three_ranks, world, aggregator):
    """Ragged d 3 on 2 ranks (padded to 4 with an exact no-op empty silo)
    and on 3 (one silo a shard): the reference's and the port's unsharded
    engines, <= 1e-5; a weighted round's census is leaves + 1 operands."""
    per_rank = [r[0] for r in (two_ranks[0] if world == 2 else three_ranks)]
    i = WEIGHTED.index(aggregator)
    kw = _weighted_runs(world)[i]
    _, got = _check_run(f"{aggregator} d3 on {world} ranks", D3, _jparams(1),
                        kw, kw["schedule"], per_rank, i)
    assert got["collectives"]["census"] == {"all-reduce": LEAVES + 1}
    assert got["collectives"]["shards"] == world
    # the round's collective records, as launch.roofline reads them: one
    # all-reduce over the data axis's one group of every rank
    recs = got["collectives"]["records"]
    wire = got["collectives"]["wire_bytes_per_round"]
    assert [(r["kind"], r["groups"]) for r in recs] == [
        ("all-reduce", [list(range(world))])]
    assert roofline.collective_bytes(recs) == {"all-reduce": wire,
                                               "total": wire}
    assert roofline.cross_block_bytes(recs, block=1) == wire
    assert roofline.cross_block_bytes(recs, block=world) == 0


def test_sharded_streamed_eval_matches_unsharded(two_ranks):
    """mesh= composes with eval_fn: each chunk's params reach eval_fn on
    every rank, and the per-round probe matches the reference's."""
    per_rank = [r[1] for r in two_ranks[0]]
    kw = two_ranks[1]["eval"]
    got = per_rank[0]["runs"][0]
    assert len(got["history"]) == KW["rounds"]
    ev = (lambda p: {"w0": float(np.mean(np.abs(
              jax.tree_util.tree_leaves(p)[0])))},
          fed_ranks._first_leaf_mean_abs)
    base = dict(kw, eval_fn=ev)
    base.pop("schedule")
    ref, port = _oracles(D3_EVAL, _jparams(2), base, kw["schedule"])
    for a, b, c in zip(ref.history, port.history, got["history"]):
        _gap("sharded streamed eval w0 vs reference", abs(a["w0"] - c["w0"]),
             BAR)
        assert abs(b["w0"] - c["w0"]) <= BAR
    assert all(r["runs"][0]["history"] == got["history"] for r in per_rank)


def test_sharded_carries_opt_state_across_rounds(two_ranks):
    """reset_opt_per_round=False with momentum SGD: each shard keeps its
    own silos' optimizer state across rounds."""
    per_rank = [r[2] for r in two_ranks[0]]
    kw = two_ranks[1]["carry"]
    _check_run("sgd momentum carried state", D2, _jparams(3), kw,
               kw["schedule"], per_rank, 0)


def test_ragged_d5_over_4_shards_all_aggregators(four_ranks):
    """d 5 over 4 shards (padded to 8): all six aggregators, the robust
    ones under dropout with a scaled silo, against both oracles."""
    per_rank = [r[0] for r in four_ranks]
    for i, kw in enumerate(_d5_runs(4)):
        agg = kw["aggregator"]
        _, got = _check_run(f"{agg} d5 on 4 ranks", D5, _jparams(0), kw,
                            kw["schedule"], per_rank, i)
        census = got["collectives"]["census"]
        assert census == ({"all-reduce": 1, "all-gather": LEAVES + 1}
                          if agg in ROBUST else {"all-reduce": LEAVES + 1})


def test_hierarchical_pod_data_mesh_matches_unsharded(pod_ranks):
    """(2, 2, 1) pod/data/model: the silo dim spans ("pod", "data")
    jointly (4 shards), aggregation is two-level (intra-pod first), and the
    results match the unsharded engines; the gathered stack comes out in
    global silo order (median under dropout with a scaled silo)."""
    facts = pod_ranks[0][2]
    assert facts["default_silo_axes"] == ("pod", "data")
    assert facts["num_silo_shards"] == 4 and facts["silo_axis_name"] == "pod"
    fedavg, _ = _case(D3, _jparams(1), 4, opt=("adamw", 1e-2), **KW)
    _, got = _check_run("fedavg d3 on the pod/data mesh", D3, _jparams(1),
                        fedavg, fedavg["schedule"],
                        [r[0] for r in pod_ranks], 0)
    assert got["collectives"]["census"] == {"all-reduce": 2 * (LEAVES + 1)}
    assert got["collectives"]["levels"] == ["data", "pod"]
    median = _d5_runs(4)[3]
    _check_run("median d5 on the pod/data mesh", D5, _jparams(0), median,
               median["schedule"], [r[1] for r in pod_ranks], 0)
    coords = [r[0]["coords"] for r in pod_ranks]
    assert coords == [{"pod": p, "data": d, "model": 0}
                      for p in (0, 1) for d in (0, 1)]


def test_model_axis_replicas_agree_bitwise(replica_ranks):
    """A 2 x 2 ("data", "model") mesh: the silo axis is "data" (2 shards);
    the two ranks of each shard are replicas, and all four ranks return
    bitwise the same params, matching the unsharded engines."""
    per_rank, runs = replica_ranks
    per_rank = [r[0] for r in per_rank]
    for i, kw in enumerate(runs):
        _, got = _check_run(f"{kw['aggregator']} d5 on a 2x2 mesh", D5,
                            _jparams(0), kw, kw["schedule"], per_rank, i)
        assert got["collectives"]["shards"] == 2
    assert [r["coords"] for r in per_rank] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]


# --------------------------------------------------------------------------
# the mesh, its validation and the plan cache
# --------------------------------------------------------------------------

def test_mesh_requires_scan_engine(three_ranks):
    facts = three_ranks[0][1]
    assert "scan" in facts["host_engine"]


def test_num_silo_shards_validates_axes(three_ranks):
    facts = three_ranks[0][1]
    assert facts["num_silo_shards"] == facts["shape"][0] == 3
    assert facts["default_silo_axes"] == ("data",)
    assert facts["axis_names"] == ("data", "model")
    assert facts["num_silos"] == 3
    assert "nope" in facts["bad_axes"]
    assert all(r[1] == facts for r in three_ranks)


def test_make_host_mesh_validation_names_rank_count(three_ranks):
    """The reference's cases at 6 (by the shape rule alone), and
    make_host_mesh itself at 3 ranks: an impossible shape raises at once,
    naming the rank count."""
    assert tmesh.host_mesh_shape(6, model=2) == (3, 2)
    assert tmesh.host_mesh_shape(6, model=4) == (1, 4)
    with pytest.raises(ValueError, match=r"needs 8 ranks, but only 6"):
        tmesh.host_mesh_shape(6, model=4, data=2)
    with pytest.raises(ValueError, match="only 6"):
        tmesh.host_mesh_shape(6, model=7)
    shapes = three_ranks[0][1]["host_meshes"]
    assert shapes[:2] == [(3, 1), (1, 2)]
    assert "needs 4 ranks, but only 3" in shapes[2]
    assert "model=4" in shapes[3] and "only 3" in shapes[3]
    with pytest.raises(RuntimeError, match="run_ranks"):
        tmesh.make_host_mesh()               # no group in this process


def test_plan_cache_key_carries_the_mesh(two_ranks):
    """Two sharded runs on one mesh share a plan (a hit); an unsharded run
    of the same layout never takes the sharded plan (a miss), then hits
    its own; the sharded and unsharded runs agree within the bar."""
    runs = two_ranks[0][0][3]["runs"]
    assert [r["cache_stats"]["hit"] for r in runs] == [False, True, False,
                                                       True]
    assert runs[-1]["cache_stats"]["plans"] == 2
    assert runs[0]["collectives"]["census"] == {"all-reduce": LEAVES + 1}
    assert runs[2]["collectives"] is None
    _gap("cached sharded vs cached unsharded",
         _max_rel_diff(runs[2]["params"], runs[0]["params"]), BAR)


def test_cached_sharded_plan_runs_on_a_new_mesh(pod_ranks):
    """A plan cached on a mesh whose sub-groups were since destroyed
    serves a run on a new mesh of the same signature (a hit) over the new
    mesh's groups, bitwise as the uncached run."""
    for r in pod_ranks:
        first, again = r[4]["runs"]
        assert (first["cache_stats"]["hit"], again["cache_stats"]["hit"]) \
            == (False, True)
        for run in (first, again):
            assert all(np.array_equal(a, b) for a, b in zip(
                _leaves(r[0]["runs"][0]["params"]), _leaves(run["params"])))
            assert run["collectives"]["census"] == {
                "all-reduce": 2 * (LEAVES + 1)}


# --------------------------------------------------------------------------
# the census and idle plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(5),
                         ids=["fedavg-E1", "fedavg-E3", "median", "trimmed_mean",
                              "krum"])
def test_collective_census_structure(four_ranks, case):
    """One level (4 x 1): a weighted round is leaves + 1 all-reduce
    operands at E 1 and at E 3 (a collective in the local phase would grow
    with E); a robust round gathers leaves + 1 operands (the params and
    the availability mask) and reduces only the loss."""
    rows = [r[1][case] for r in four_ranks]
    row = rows[0]
    assert all(r["census"] == row["census"] for r in rows)
    if row["aggregator"] == "fedavg":
        assert row["census"] == {"all-reduce": row["leaves"] + 1}
    else:
        assert row["census"] == {"all-reduce": 1,
                                 "all-gather": row["leaves"] + 1}


def test_two_level_census_on_pod_data_mesh(pod_ranks):
    rows = pod_ranks[0][3]
    assert rows[0]["census"] == {"all-reduce": 2 * (LEAVES + 1)}
    assert rows[1]["census"] == {"all-reduce": 2,
                                 "all-gather": 2 * (LEAVES + 1)}


def test_idle_sharded_plans_hold_only_splats(four_ranks, pod_ranks):
    """Every lowered sharded plan passed assert_no_baked_data on every rank
    (its run answers from its arguments and is held to its eager rounds),
    and once idle holds no non-splat array: its staging and gather
    buffers are zeroed with the rest."""
    for per_rank in (four_ranks, pod_ranks):
        for r in per_rank:
            rows = r[1] if per_rank is four_ranks else r[3]
            assert all(row["idle"] == [] for row in rows)


def test_unsharded_plan_census_is_empty():
    """The counterpart of the reference's unsharded census: {}."""
    silos = _linear_silos([20, 13], seed=1)
    padded = tfed.pad_silo_data(silos, 8)
    plan = tfed.make_fl_plan(
        num_silos=padded.num_silos, num_batches=padded.num_batches,
        batch_size=padded.batch_size, opt=tadamw(1e-2),
        batch_loss=tfed._make_batch_loss(_tloss, True, 0.0), local_epochs=1,
        aggregator="median", device="cpu")
    p = tmlp.init_mlp_params(torch.Generator().manual_seed(0), 4, (8,), 1,
                             device="cpu")
    low = tfed.lower_fl_plan(plan, p, padded, rounds=1)
    assert collective_census(low) == {} and plan.comm is None


def test_round_perms_silo_ids_are_rows_of_the_global_draw():
    """A shard's rows of the port's own schedule are the unsharded draw's,
    bit for bit, whatever the global count the draw runs over."""
    full = tfed.round_perms(5, 2, 8, 3, 24)
    assert np.array_equal(tfed.round_perms(5, 2, 8, 3, 24, silo_ids=[4, 5]),
                          full[4:6])
    assert np.array_equal(tfed.round_perms(5, 2, 6, 3, 24), full[:6])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _children():
    """Live child processes of this process (by /proc)."""
    me, out = os.getpid(), set()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(pid))
    return out


def test_launcher_ends_every_rank_when_one_raises():
    """Rank 1 raises while ranks 0 and 2 wait in an all-reduce that needs
    it: the call returns well inside its timeout with rank 1's traceback,
    and no rank is left behind."""
    before = _children()
    t0 = time.monotonic()
    with pytest.raises(tmesh.RankError) as err:
        tmesh.run_ranks(tmesh.launcher_selfcheck, 3, args=(1,),
                        device="cpu", timeout=120)
    assert time.monotonic() - t0 < 60
    assert err.value.rank == 1
    assert "rank 1 fails before the collective" in str(err.value)
    assert "launcher_selfcheck" in err.value.detail
    assert _children() <= before
    assert tmesh.run_ranks("repro_torch.launch.mesh:launcher_selfcheck", 3,
                           device="cpu") == [3, 3, 3]


def test_launcher_times_out_and_ends_every_rank():
    """Rank 1 hangs while rank 0 waits for it in an all-reduce: at the
    timeout every rank is ended and the error names both as running."""
    before = _children()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2"):
        tmesh.run_ranks(tmesh.launcher_selfcheck, 2, kwargs={"hang_rank": 1},
                        device="cpu", timeout=10)
    assert time.monotonic() - t0 < 40
    assert _children() <= before


def test_launcher_refuses_what_a_rank_cannot_import():
    with pytest.raises(ValueError, match="module-level"):
        tmesh.run_ranks(lambda: 0, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.run_ranks(tmesh.launcher_selfcheck, 2)
