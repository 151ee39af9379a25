"""The scripts that carry the reference's bars, on the port, against the
reference's (``benchmarks/serve_bench.py``, ``benchmarks/fed_bench.py``,
``experiments/robust_ablation.py`` and ``examples/`` at the repository
root), on the CPU, with the reference's ``jax.random`` draws injected.

Bars: the collaboration setup bit for bit (host NumPy float64); served
rows 2e-5 × max(1, |out|) (tests/test_serve_collab.py:50); onboarding
against a recompute 1e-5 (the script's own); the ablation's final and
honest losses 1e-4 relative (the reference's host == scan bar), the same
best aggregator; fed_bench's host and scan params 1e-5 relative to
max(1, |x|); the federated LLM loss history 1e-4 relative. Every gap
prints as a ``parity-gap`` line under ``pytest -s``. The ``cuda`` tests
audit the captured serve steps and hold fed_bench's fast rows on the card.
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core import protocol as jprotocol  # noqa: E402
from repro.data.tokens import silo_batches as jsilo_batches  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve_collab import ServeCollab as JServeCollab  # noqa: E402
from repro_torch.analysis import (BakedDataError, CompileCounter,  # noqa: E402
                                  assert_no_baked_data, collective_census)
from repro_torch.benchmarks import fed_bench, serve_bench  # noqa: E402
from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.federated import PlanCache, run_federated  # noqa: E402
from repro_torch.examples import (end_to_end_driver,  # noqa: E402
                                  feddcl_llm_pretrain, serve_batched)
from repro_torch.experiments import robust_ablation  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve_collab import ServeCollab  # noqa: E402
from repro_torch.serve_collab.server import LoweredStep  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_TOL = 2e-5
ONBOARD_TOL = 1e-5
LOSS_TOL = 1e-4
PARAM_TOL = 1e-5
# what the sharded legs' errors name: the ROADMAP item, by name
SHARDING_QUEUE = "Queue 1, multi-process silo sharding"


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and one BLAS thread for NumPy: the
    arrays here are small, and beside the suite's other parallel workers a
    pool of threads only stalls on its barriers (the serve_bench setup's
    SVDs and QRs took ~3 min this way instead of ~6 s)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:                # no BLAS pool to cap
        threadpool_limits = contextlib.nullcontext
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _reference():
    """The reference's scripts, imported from the repository root."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import serve_bench as jsb
    from experiments import robust_ablation as jra
    return jsb, jra


def _gap(what: str, value: float, bar: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _param_gap(port, ref) -> float:
    return max(float(np.max(np.abs(x - y))) / max(1.0, float(np.abs(y).max()))
               for x, y in zip(tree_leaves(params_to_numpy(port)),
                               jax.tree_util.tree_leaves(_np_tree(ref))))


def _ref_schedule(seed: int, num_silos: int, epochs: int, n_slots: int):
    key = jax.random.PRNGKey(seed)
    return lambda r: np.asarray(jfed.round_perms(key, r, num_silos, epochs,
                                                 n_slots))


# --------------------------------------------------------------------------
# serve_bench
# --------------------------------------------------------------------------

def test_serve_bench_fast_holds_to_the_reference():
    """The fast layout: the reference's setup bit for bit, the warm sweep's
    served rows against the reference server's on the same stream, a cold
    sweep that builds every bucket's plan and a warm one that builds
    nothing, every group's step audited, onboarding against a recompute."""
    jsb, _ = _reference()
    lay = serve_bench.layout(True)
    Xs, Ys = jsb._make_data(np.random.default_rng(0), lay["d"], lay["c"],
                            lay["n_ij"])
    jsetup = jprotocol.run_protocol(Xs, Ys, m_tilde=jsb.M_TILDE,
                                    anchor_r=lay["anchor_r"], seed=0,
                                    onboard=True)
    jparams = jmlp.init_mlp_params(jax.random.PRNGKey(0), jsetup.m_hat,
                                   (32,), 1)
    b = serve_bench.build(True, init_params=_np_tree(jparams), device="cpu")
    assert np.array_equal(b.setup.anchor, jsetup.anchor)
    assert np.array_equal(b.setup.Z, jsetup.Z)
    for i in range(jsetup.num_groups):
        assert np.array_equal(b.setup.collab_X[i], jsetup.collab_X[i])
        for j in range(jsetup.num_users(i)):
            assert np.array_equal(b.setup.Gs[i][j], jsetup.Gs[i][j])

    serve = serve_bench.serve_sweeps(b)
    assert serve["plans_cold"] == serve["cache"]["misses"] > 0
    assert serve["compiles_cold"] == serve["plans_cold"]
    assert serve["captures_cold"] == 0            # the CPU captures nothing
    assert serve["compiles_warm"] == 0

    jsrv = JServeCollab.from_setup(jsetup, jparams,
                                   max_batch=serve_bench.MAX_BATCH)
    rng = np.random.default_rng(1)
    for _ in range(lay["n_req"]):
        g, u = int(rng.integers(0, lay["d"])), int(rng.integers(0, lay["c"]))
        jsrv.submit(rng.standard_normal(
            (int(rng.integers(1, lay["max_rows"] + 1)), serve_bench.M_RAW)),
            g, u)
    jout = jsrv.serve()
    got, want = sorted(b.out_warm.items()), sorted(jout.items())
    assert len(got) == len(want) == lay["n_req"]
    _gap("serve_bench served rows", max(
        float(np.abs(y - np.asarray(w)).max()) / max(1.0, float(np.abs(w).max()))
        for (_, y), (_, w) in zip(got, want)), SERVE_TOL)

    serve_bench.audit(b)
    ob = serve_bench.onboard(b)
    _gap("serve_bench onboarding vs recompute", ob["agreement_max_rel"],
         ONBOARD_TOL)
    print(f"serve_bench onboarding speedup (CPU, not a bar here): "
          f"{ob['speedup']}x")


# --------------------------------------------------------------------------
# analysis: CompileCounter, assert_no_baked_data, lower_step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_server():
    rng = np.random.default_rng(3)
    Xs = [[rng.standard_normal((30, 7)) for _ in range(c)] for c in (2, 3)]
    Ys = [[rng.standard_normal((30, 1)) for _ in range(c)] for c in (2, 3)]
    setup = protocol.run_protocol(Xs, Ys, m_tilde=4, anchor_r=64, seed=0,
                                  device="cpu")
    params = mlp.init_mlp_params(torch.Generator().manual_seed(0),
                                 setup.m_hat, (8,), 1, device="cpu")
    return ServeCollab.from_setup(setup, params, max_batch=8,
                                  cache=PlanCache(), device="cpu")


def test_compile_counter_counts_builds_not_hits():
    """Plans built count, cache hits do not; counters nest and freeze when
    their block ends."""
    silos = [(np.random.default_rng(i).standard_normal((20, 3)),
              np.random.default_rng(i + 9).standard_normal((20, 1)))
             for i in range(2)]
    params = mlp.init_mlp_params(torch.Generator().manual_seed(0), 3, (4,),
                                 1, device="cpu")
    cache = PlanCache()
    kw = dict(opt=adamw(1e-2), rounds=2, local_epochs=1, batch_size=8,
              engine="scan", cache=cache, loss_id=("mse",),
              opt_id=("adamw", 1e-2), device="cpu")
    loss = robust_ablation.loss
    with CompileCounter() as outer:
        with CompileCounter() as cold:
            run_federated(loss, params, silos, **kw)
        with CompileCounter() as warm:
            run_federated(loss, params, silos, **kw)
        assert outer.count == 1                    # read live inside
    with CompileCounter() as other_shape:
        run_federated(loss, params, silos + silos[:1] * 3, **kw)
    with CompileCounter() as uncached:
        run_federated(loss, params, silos, **{**kw, "cache": None})
    assert uncached.plans == 1                     # a plan outside the cache
    assert (cold.plans, cold.captures, cold.count) == (1, 0, 1)
    assert warm.count == 0 and outer.count == 1
    assert other_shape.count == 1
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 1


def test_lower_step_builds_through_the_plan_cache(small_server):
    srv = small_server
    with CompileCounter() as first:
        step = srv.lower_step(1, 8)
    with CompileCounter() as again:
        step2 = srv.lower_step(1, 8)
    assert isinstance(step, LoweredStep) and step2.plan is step.plan
    assert step.plan is srv._step_fn(srv.tables[1].t_pad, 8,
                                     srv.tables[1].in_dim,
                                     srv.tables[1].out_dim)
    assert (first.plans, again.plans) == (1, 0)
    params, M, mu, x, tix = step.args
    assert M is srv.tables[1].M and tix.tolist() == [0, 1, 2, 0, 1, 2, 0, 1]
    np.testing.assert_array_equal(step.run(*step.args),
                                  step.eager(*step.args))
    assert_no_baked_data(step)
    assert torch.equal(M, srv.tables[1].M)        # the check used copies


def test_assert_no_baked_data_catches_a_step_holding_a_table(small_server):
    """A step that closed over a table (here: the group's M) answers from
    it, not from the table it is given, and fails the check; so does one
    that holds every argument it was built with."""
    srv = small_server
    step = srv.lower_step(0, 8)
    held_M = step.args[1].clone()

    def closes_over_M(plan, params, M, mu, x, tix):
        return srv._dispatch(plan, params, held_M, mu, x, tix)

    with pytest.raises(BakedDataError, match="answers from data it holds"):
        assert_no_baked_data(LoweredStep(step.plan, closes_over_M, step.args))
    first = step.run(*step.args)
    with pytest.raises(BakedDataError):
        assert_no_baked_data(LoweredStep(step.plan, lambda *a: first,
                                         step.args))
    assert issubclass(BakedDataError, AssertionError)


# --------------------------------------------------------------------------
# robust_ablation
# --------------------------------------------------------------------------

def test_robust_ablation_cells_hold_to_the_reference():
    """The four aggregators under one gradient-scaling silo and one dropout
    cell, each rebuilt on the reference's side from its own make_silos,
    scenarios and run_federated arguments; then the port's engine check
    on the reference's schedules."""
    _, jra = _reference()
    sizes, rounds, epochs = robust_ablation.layout(True)
    jparams = jmlp.init_mlp_params(jax.random.PRNGKey(4), 4, (8,), 1)
    pj = _np_tree(jparams)
    silos = jra.make_silos(sizes, seed=9)
    n_slots = jfed.pad_silo_data(silos, 16).n_slots
    d = len(sizes)
    grid_sched = _ref_schedule(robust_ablation.GRID_SEED, d, epochs, n_slots)
    jloss = lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, "regression")
    attacks = dict(jra.scenarios(d))

    def reference_row(scenario, agg, dropout_rate):
        attack = attacks[scenario]
        data, scale = jpriv.apply_attack(silos, attack)
        res = jfed.run_federated(
            jloss, jparams, data, opt=jadamw(1e-2), rounds=rounds,
            local_epochs=epochs, batch_size=16, aggregator=agg,
            seed=robust_ablation.GRID_SEED, engine="scan",
            silo_scale=scale, dropout_rate=dropout_rate,
            trim_frac=jra.TRIM_FRAC, krum_f=jra.KRUM_F)
        bad = set(attack.corrupted)
        Xh = jnp.asarray(np.concatenate(
            [x for i, (x, _) in enumerate(silos) if i not in bad]), jnp.float32)
        Yh = jnp.asarray(np.concatenate(
            [y for i, (_, y) in enumerate(silos) if i not in bad]), jnp.float32)
        return {"final_loss": res.history[-1]["loss"],
                "honest_loss": float(jnp.mean(jloss(res.params, Xh, Yh)))}

    assert (robust_ablation.TRIM_FRAC, robust_ablation.KRUM_F) == (
        jra.TRIM_FRAC, jra.KRUM_F)
    assert jra.run_grid.__kwdefaults__["seed"] == robust_ablation.GRID_SEED
    cells = [("grad_scale_x1", a, 0.0) for a in robust_ablation.AGGREGATORS]
    cells.append(("grad_scale_x2", "trimmed_mean", 0.3))
    rows = [robust_ablation.run_cell(sizes, rounds, epochs, scen, agg,
                                     dropout_rate=rate, init_params=pj,
                                     schedule=grid_sched, device="cpu")
            for scen, agg, rate in cells]
    assert [(r["scenario"], r["aggregator"], r["dropout_rate"])
            for r in rows] == cells
    want = {}
    for r in rows:
        w = reference_row(r["scenario"], r["aggregator"], r["dropout_rate"])
        want[r["aggregator"]] = w
        for k in ("final_loss", "honest_loss"):
            _gap(f"robust_ablation {r['scenario']} {r['aggregator']} "
                 f"dropout={r['dropout_rate']} {k}", _rel(r[k], w[k]),
                 LOSS_TOL)
    best = robust_ablation.best_robust(rows[:4], "grad_scale_x1")["aggregator"]
    assert best == min(robust_ablation.AGGREGATORS[1:],
                       key=lambda a: want[a]["honest_loss"])

    engines = robust_ablation.check_engine_agreement(
        sizes, max(rounds // 2, 2), epochs, init_params=pj,
        schedules={a: _ref_schedule(robust_ablation.ENGINE_SEED, d, epochs,
                                    n_slots)
                   for a in robust_ablation.AGGREGATORS[1:]},
        device="cpu")
    assert set(engines) == {"median", "trimmed_mean", "krum"}
    for agg, diff in engines.items():
        _gap(f"robust_ablation host == scan {agg}", diff, 1e-4)


def test_robust_ablation_cli_accepts_and_writes_only_its_out_dir(
        tmp_path, monkeypatch):
    """The fast grid end to end on the port's own draws: the acceptance
    asserts and the engine check hold, and only --out-dir is written."""
    monkeypatch.chdir(tmp_path)
    out = robust_ablation.main(["--fast", "--skip-sharded", "--device", "cpu",
                                "--out-dir", "out"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "BENCH_fed_robust.json"]
    assert len(out["grid"]) == len(out["dropout_grid"]) == 16
    assert set(out["acceptance"]) == {"grad_scale_x1", "grad_scale_x2",
                                      "label_flip_x1"}
    assert out["sharded_agreement_maxdiff"] is None


def test_sharded_legs_raise_before_any_work(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=SHARDING_QUEUE):
        robust_ablation.main(["--fast", "--device", "cpu", "--out-dir", "o"])
    with pytest.raises(NotImplementedError, match=SHARDING_QUEUE):
        robust_ablation.check_sharded_agreement((4, 4), 2, 1)
    for flag in ("--sharded", "--sharded-worker"):
        with pytest.raises(NotImplementedError, match=SHARDING_QUEUE):
            fed_bench.main([flag, "--device", "cpu", "--out-dir", "o"])
    with pytest.raises(NotImplementedError, match=SHARDING_QUEUE):
        collective_census("")
    assert list(tmp_path.iterdir()) == []


# --------------------------------------------------------------------------
# fed_bench
# --------------------------------------------------------------------------

def test_fed_bench_case_holds_to_the_reference():
    """bench_case(2, 5) with the reference's init and schedule: its host
    and scan params against the reference's host and scan engines."""
    d, rounds = 2, 5
    silos = fed_bench._make_silos(d)
    jparams = jmlp.init_mlp_params(jax.random.PRNGKey(0), fed_bench.M_FEAT,
                                   (32,), 1)
    n_slots = jfed.pad_silo_data(silos, fed_bench.BATCH).n_slots
    out = {}
    row = fed_bench.bench_case(
        d, rounds, warm_iters=1, init_params=_np_tree(jparams),
        schedule=_ref_schedule(0, d, fed_bench.LOCAL_EPOCHS, n_slots),
        device="cpu", results=out)
    jloss = lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, "regression")
    kw = dict(opt=jadamw(1e-3), rounds=rounds,
              local_epochs=fed_bench.LOCAL_EPOCHS,
              batch_size=fed_bench.BATCH, seed=0)
    for engine in ("host", "scan"):
        ref = jfed.run_federated(jloss, jparams, silos, engine=engine, **kw)
        _gap(f"fed_bench d=2 rounds=5 {engine} params",
             _param_gap(out[engine].params, ref.params), PARAM_TOL)
    _gap("fed_bench d=2 rounds=5 rel_param_diff", row["rel_param_diff"], 1e-4)
    assert row["host_step_dispatches"] == d * rounds * 4 * 3
    assert set(row) >= {"t_host_dispatch_s", "t_host_total_s",
                        "t_scan_cold_s", "t_scan_warm_s", "speedup_warm",
                        "speedup_cold", "final_loss_host", "final_loss_scan"}


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------

SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256)


def test_end_to_end_driver_matches_the_reference_loop():
    """The example at a narrow width against the reference's own loop
    (make_federated_local_step vmapped and jitted, fedavg sync every H
    steps) from the same init: every step's silo-meaned loss."""
    steps, batch, seq, silos, h = 6, 4, 16, 2, 2
    cfg_t = end_to_end_driver.llama_100m().with_overrides(**SMALL)
    cfg_j = jget_arch("llama3.2-1b").with_overrides(
        name="llama-100m", **SMALL)
    tc = JTrainConfig(model=cfg_j, shape=JInputShape(
        "e2e", seq_len=seq, global_batch=batch, kind="train"),
        learning_rate=1e-3, warmup_steps=20, total_steps=steps,
        param_dtype="float32", compute_dtype="float32", remat=False,
        federated=JFederatedConfig(num_silos=silos, local_steps=h))
    params = jbb.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    vstep, opt = jsteps.make_federated_local_step(cfg_j, tc)
    vstep, sync = jax.jit(vstep), jax.jit(jsteps.make_fedavg_sync_step(tc))
    sp = jfed.silo_replicate(params, silos)
    so = jax.vmap(opt.init)(sp)
    want = []
    for step in range(steps):
        nb = jsilo_batches(cfg_j.vocab_size, seq, batch // silos, silos, step,
                           non_iid=True)
        sp, so, m = vstep(sp, so, {k: jnp.asarray(v) for k, v in nb.items()})
        if (step + 1) % h == 0:
            sp, so = sync(sp, so)
        want.append(float(jnp.mean(m["loss"])))
    got = end_to_end_driver.run(cfg_t, steps=steps, batch=batch, seq=seq,
                                silos=silos, local_steps=h,
                                init_params=_np_tree(params), log_every=1,
                                device="cpu")
    assert [r["step"] for r in got] == list(range(steps))
    _gap("end_to_end_driver losses",
         max(_rel(g["loss"], w) for g, w in zip(got, want)), LOSS_TOL)


def test_feddcl_llm_pretrain_runs_and_writes_only_its_out_dir(tmp_path,
                                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    hist = feddcl_llm_pretrain.main(["--steps", "8", "--device", "cpu",
                                     "--out-dir", "out"])
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "feddcl_llm_pretrain.json"]


def test_serve_batched_serves_every_request():
    outs = serve_batched.main(["--device", "cpu", "--requests", "3",
                               "--max-new", "4"])
    assert set(outs.status.values()) == {"done"}
    assert all(len(v) == 4 for v in outs.values())


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serve steps are captured and "
                    "fed_bench's scan rounds replayed only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_serve_bench_captured_steps_on_cuda(cuda_device):
    """Every bucket of the cold sweep is one plan and one capture, the warm
    sweep neither; every group's captured step answers from the tables it
    is given."""
    b = serve_bench.build(True, device=cuda_device)
    serve = serve_bench.serve_sweeps(b)
    assert serve["captures_cold"] == serve["plans_cold"] > 0
    assert serve["compiles_warm"] == 0
    with CompileCounter() as audit:
        serve_bench.audit(b)
    assert audit.count == 0                         # the buckets are warm
    step = b.srv.lower_step(0, serve_bench.MAX_BATCH)
    assert step.plan.captures == 1
    held_M = step.args[1].clone()
    with pytest.raises(BakedDataError):
        assert_no_baked_data(LoweredStep(
            step.plan, lambda plan, p, M, mu, x, tix: b.srv._dispatch(
                plan, p, held_M, mu, x, tix), step.args))


@pytest.mark.cuda
def test_fed_bench_fast_rows_on_cuda(cuda_device):
    for d, rounds in ((2, 5), (8, 5)):
        row = fed_bench.bench_case(d, rounds, device=cuda_device)
        print(f"fed_bench cuda d={d} rounds={rounds}: {row}")
        _gap(f"fed_bench cuda d={d} rounds={rounds} rel_param_diff",
             row["rel_param_diff"], 1e-4)
