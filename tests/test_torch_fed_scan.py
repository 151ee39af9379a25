"""Step 4's scan engine (repro_torch.core.federated, engine="scan"): the
vmapped round held against the port's host engine and the reference's
scan engine, its streamed eval, its mask rules, and on a card its captured
CUDA graph.

Tolerances are the reference's own: a whole federated run compounds fp32
rounding over every step -> 1e-4 (relative to max(1, |x|)) on params and
per-round losses, the reference's host==scan bar (CHANGES.md, PR 2); mask
rules and repeat runs of one computation are bitwise. Torch cannot
reproduce jax.random, so runs against the reference share its init params
and its minibatch schedule (repro.core.federated.round_perms) at the
padded layout both packages build.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import federated as jfed  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import adamw as tadamw, sgd as tsgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

BAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _gap(what: str, value: float, bar: float) -> None:
    """Assert a parity gap against its bar and print it (pytest -s shows
    the measured gaps)."""
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _np(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return weights.mlp_params_to_numpy(tree)
    return jax.tree.map(np.asarray, tree)


def _param_gap(a, b) -> float:
    """Largest leaf gap, relative to max(1, |b|)."""
    return max(float(np.max(np.abs(x - y))) / max(1.0, float(np.abs(y).max()))
               for x, y in zip(jax.tree_util.tree_leaves(_np(a)),
                               jax.tree_util.tree_leaves(_np(b))))


def _loss_gap(ra, rb) -> float:
    assert len(ra.history) == len(rb.history)
    return max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
               for a, b in zip(ra.history, rb.history))


def _silos(sizes, m=4, seed=0, task="regression", classes=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, 1))
    out = []
    for k, n in enumerate(sizes):
        r = np.random.default_rng(seed * 97 + k + 1)
        X = r.standard_normal((n, m))
        if task == "regression":
            out.append((X, X @ w + 0.01 * r.standard_normal((n, 1))))
        else:
            out.append((X, r.integers(0, classes, size=n).astype(np.int64)))
    return out


def _jparams(m=4, out=1, seed=0):
    return jmlp.init_mlp_params(jax.random.PRNGKey(seed), m, (8,), out)


def _tparams(m=4, out=1, seed=0):
    return weights.mlp_params_from_numpy(_np(_jparams(m, out, seed)), "cpu")


def _tloss(task="regression"):
    return lambda p, x, y: tmlp.mlp_per_example_loss(p, x, y, task)


def _jloss(task="regression"):
    return lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, task)


def _port_schedule(padded, rounds, epochs, seed=0):
    return np.stack([tfed.round_perms(seed, r, padded.num_silos, epochs,
                                      padded.n_slots) for r in range(rounds)])


def _ref_schedule(padded, rounds, epochs, seed):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jfed.round_perms(
        key, r, padded.num_silos, epochs, padded.n_slots))
        for r in range(rounds)])


# --------------------------------------------------------------------------
# port scan == port host on one injected schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("aggregator", ["fedavg", "fedprox", "fedsgd"])
@pytest.mark.parametrize("sizes", [(32, 32), (40, 28, 52)],
                         ids=["equal", "ragged"])
def test_scan_matches_host_on_one_schedule(aggregator, sizes):
    silos = _silos(list(sizes), seed=3)
    kw = dict(opt=tadamw(1e-2), rounds=3, local_epochs=2, batch_size=16,
              aggregator=aggregator, device="cpu",
              fedprox_mu=0.1 if aggregator == "fedprox" else 0.0)
    padded = tfed.padded_layout(silos, batch_size=16, aggregator=aggregator)
    sched = _port_schedule(padded, 3, 2, seed=5)
    p = _tparams(seed=1)
    host = tfed.run_federated(_tloss(), p, silos, engine="host",
                              schedule=sched, **kw)
    scan = tfed.run_federated(_tloss(), p, silos, engine="scan",
                              schedule=sched, **kw)
    _gap(f"scan vs host params {aggregator} {sizes}",
         _param_gap(scan.params, host.params), BAR)
    _gap(f"scan vs host losses {aggregator} {sizes}", _loss_gap(scan, host),
         BAR)
    assert [h["round"] for h in scan.history] == [0, 1, 2]
    assert scan.cache_stats is None
    # the caller's params are copied, never written
    assert _param_gap(p, _tparams(seed=1)) == 0.0


@pytest.mark.parametrize("case", ["adamw_carried", "sgd_momentum"])
def test_scan_carries_and_vmaps_optimizer_state(case):
    """reset_opt_per_round=False carries each silo's AdamW state across
    rounds; sgd with momentum vmaps its state through the round."""
    silos = _silos([24, 30], seed=9)
    opt, reset = ((tadamw(1e-2), False) if case == "adamw_carried"
                  else (tsgd(1e-2, momentum=0.9), True))
    kw = dict(opt=opt, rounds=3, local_epochs=2, batch_size=8, seed=1,
              reset_opt_per_round=reset, device="cpu")
    p = _tparams(seed=3)
    host = tfed.run_federated(_tloss(), p, silos, engine="host", **kw)
    scan = tfed.run_federated(_tloss(), p, silos, engine="scan", **kw)
    _gap(f"scan vs host params {case}", _param_gap(scan.params, host.params),
         BAR)
    _gap(f"scan vs host losses {case}", _loss_gap(scan, host), BAR)


# --------------------------------------------------------------------------
# port scan == the reference's scan engine on its round_perms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(aggregator="fedavg", sizes=(40, 28, 52), task="regression"),
    dict(aggregator="fedsgd", sizes=(10, 40), task="regression"),
    dict(aggregator="fedavg", sizes=(45, 30), task="classification",
         reset_opt_per_round=False)],
    ids=["fedavg-ragged", "fedsgd", "classification-carried"])
def test_scan_matches_reference_scan(case):
    case = dict(case)
    sizes, task = case.pop("sizes"), case.pop("task")
    out = 4 if task == "classification" else 1
    silos = _silos(list(sizes), m=5, seed=2, task=task, classes=4)
    kw = dict(rounds=3, local_epochs=2, batch_size=16, seed=7, **case)
    pj = _jparams(m=5, out=out, seed=1)
    rj = jfed.run_federated(_jloss(task), pj, silos, opt=jadamw(1e-2),
                            engine="scan", **kw)
    padded = jfed.pad_silo_data(
        silos, None if case["aggregator"] == "fedsgd" else 16)
    rt = tfed.run_federated(
        _tloss(task), weights.mlp_params_from_numpy(_np(pj), "cpu"), silos,
        opt=tadamw(1e-2), engine="scan", device="cpu",
        schedule=_ref_schedule(padded, 3, 2, seed=7), **kw)
    name = "-".join(str(v) for v in (case["aggregator"], sizes, task))
    _gap(f"scan vs reference scan params {name}",
         _param_gap(rt.params, rj.params), BAR)
    _gap(f"scan vs reference scan losses {name}", _loss_gap(rt, rj), BAR)


def test_scan_runner_reuses_its_plan():
    """make_scan_runner binds one tenant: calling it twice reuses its plan
    and gives bitwise the same run, which is run_federated's."""
    silos = _silos([40, 28, 52], seed=3)
    padded = tfed.padded_layout(silos, batch_size=16)
    sched = _port_schedule(padded, 3, 2, seed=5)
    run = tfed.make_scan_runner(
        tfed._make_batch_loss(_tloss(), True, 0.0), padded, opt=tadamw(1e-2),
        rounds=3, local_epochs=2, schedule=sched, device="cpu")
    p = _tparams(seed=1)
    (pa, la), (pb, lb) = run(p), run(p)
    ref = tfed.run_federated(_tloss(), p, silos, opt=tadamw(1e-2), rounds=3,
                             local_epochs=2, batch_size=16, engine="scan",
                             schedule=sched, device="cpu")
    assert la == lb == [h["loss"] for h in ref.history]
    for a, b, c in zip(tree_leaves(pa), tree_leaves(pb),
                       tree_leaves(ref.params)):
        assert torch.equal(a, b) and torch.equal(a, c)


# --------------------------------------------------------------------------
# streamed eval
# --------------------------------------------------------------------------

@pytest.mark.parametrize("eval_chunk", [1, 3, 8])
def test_streamed_eval_history_matches_plain_run(eval_chunk):
    """With eval_fn the rounds run in chunks of eval_chunk (5 rounds: 3 + 2
    is a ragged last chunk); the losses equal those of the run without
    eval_fn bitwise, and eval_fn sees each round's params, which agree with
    the host engine's per-round params."""
    silos = _silos([40, 28, 52], seed=3)
    seen = []

    def ev(p):
        seen.append(p)
        return {"w0": float(tree_leaves(p)[0].reshape(-1)[0])}

    kw = dict(opt=tadamw(1e-2), rounds=5, local_epochs=2, batch_size=16,
              seed=7, device="cpu")
    p = _tparams(seed=1)
    plain = tfed.run_federated(_tloss(), p, silos, engine="scan", **kw)
    streamed = tfed.run_federated(_tloss(), p, silos, engine="scan",
                                  eval_fn=ev, eval_chunk=eval_chunk, **kw)
    host = tfed.run_federated(_tloss(), p, silos, engine="host",
                              eval_fn=lambda q: {"w0": float(
                                  tree_leaves(q)[0].reshape(-1)[0])}, **kw)
    assert [h["loss"] for h in streamed.history] == \
        [h["loss"] for h in plain.history]
    assert [h["round"] for h in streamed.history] == list(range(5))
    for a, b in zip(tree_leaves(streamed.params), tree_leaves(plain.params)):
        assert torch.equal(a, b)
    for s, h in zip(streamed.history, host.history):
        assert abs(s["w0"] - h["w0"]) <= BAR
    # the trees eval_fn kept are copies: the last one is the final params
    assert len(seen) == 5
    for a, b in zip(tree_leaves(seen[-1]), tree_leaves(plain.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# mask rules: all-padding batches, padding fill, sample-weighted loss
# --------------------------------------------------------------------------

def test_all_padding_batch_is_exact_noop_in_the_silo_step():
    """In the silo-stacked step a silo whose batch holds ZERO real samples
    keeps its params AND optimizer state bitwise, beside a silo that
    trains; each silo's step is the single-silo step's."""
    p = _tparams(seed=7)
    opt = tadamw(1e-2)
    vstep = tfed._make_silo_step(tfed._make_batch_loss(_tloss(), True, 0.0),
                                 opt, masked=True)
    sp = tfed.silo_replicate(p, 2)
    so = tfed._stacked_opt_init(opt, p, 2)
    x = torch.ones((2, 8, 4))
    y = torch.zeros((2, 8, 1))
    sp1, so1, _ = vstep(sp, so, x, y, torch.ones((2, 8)), p)   # warm state
    x[0] = 1e3                                     # garbage in the padding
    w = torch.stack([torch.zeros(8), torch.ones(8)])
    sp2, so2, loss = vstep(sp1, so1, x, y, w, p)
    assert float(loss[0]) == 0.0
    for a, b in zip(tree_leaves(sp1) + tree_leaves(so1),
                    tree_leaves(sp2) + tree_leaves(so2)):
        assert torch.equal(a[0], b[0])
    assert not torch.equal(sp1["layers"][0]["w"][1], sp2["layers"][0]["w"][1])
    assert so2["step"].tolist() == [1, 2]
    one = tfed._make_sgd_step(tfed._make_batch_loss(_tloss(), True, 0.0),
                              opt, masked=True)
    q1, o1, _ = one(tree_map(lambda a: a[1], sp1), tree_map(lambda a: a[1],
                                                            so1),
                    x[1], y[1], w[1], p)
    for a, b in zip(tree_leaves(q1) + tree_leaves(o1),
                    tree_leaves(sp2) + tree_leaves(so2)):
        assert torch.allclose(a, b[1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fill", [123.0, -999.0])
def test_padding_fill_never_leaks_into_training(fill):
    silos = _silos([13, 29], seed=1329)
    kw = dict(opt=tadamw(1e-2), rounds=2, local_epochs=2, batch_size=16,
              seed=2, engine="scan", device="cpu")
    p = _tparams(seed=5)
    clean = tfed.run_federated(_tloss(), p, silos, pad_fill=0.0, **kw)
    dirty = tfed.run_federated(_tloss(), p, silos, pad_fill=fill, **kw)
    for a, b in zip(tree_leaves(clean.params), tree_leaves(dirty.params)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in clean.history] == \
        [h["loss"] for h in dirty.history]


def test_round_loss_is_sample_weighted_over_silos():
    """The round loss is the sample-weighted mean over silos of each silo's
    final-epoch masked mean loss, recomputed here step by step."""
    silos = _silos([32, 64], seed=11)
    p = _tparams(seed=4)
    opt = tadamw(1e-3)
    padded = tfed.padded_layout(silos, batch_size=16)
    sched = _port_schedule(padded, 1, 1, seed=0)
    res = tfed.run_federated(_tloss(), p, silos, opt=opt, rounds=1,
                             local_epochs=1, batch_size=16, engine="scan",
                             schedule=sched, device="cpu")
    step = tfed._make_sgd_step(tfed._make_batch_loss(_tloss(), True, 0.0),
                               opt)
    num = den = 0.0
    for i in range(2):
        q, o = p, opt.init(p)
        s_num = s_den = 0.0
        for b in sched[0, i, 0].reshape(-1, 16):
            x, y, w = (torch.as_tensor(padded.X[i][b]),
                       torch.as_tensor(padded.Y[i][b]).float(),
                       torch.as_tensor(padded.w[i][b]))
            q, o, loss = step(q, o, x, y, w, p)
            s_num += float(loss) * float(w.sum())
            s_den += float(w.sum())
        num += padded.sizes[i] * (s_num / s_den)
        den += padded.sizes[i]
    assert abs(res.history[0]["loss"] - num / den) < 1e-5


# --------------------------------------------------------------------------
# the one-call API with its defaults (scan engine, plan cache)
# --------------------------------------------------------------------------

def _groups(n_ij, seed, m=6):
    r = np.random.default_rng(seed)
    w = r.standard_normal((m, 1))
    Xs = [[r.standard_normal((n_ij + 3 * j, m)) for j in range(2)]
          for _ in range(3)]
    Ys = [[x @ w + 0.01 * r.standard_normal((x.shape[0], 1)) for x in g]
          for g in Xs]
    return Xs, Ys


def test_feddcl_fit_defaults_match_reference():
    """FedDCL.fit with the defaults (engine="scan", cache=True) in both
    packages, the reference's init params and its schedule at the BUCKETED
    layout (3 groups -> 4 silos) injected: params, losses and the score
    within 1e-4; cache_stats present."""
    from repro.api import FedDCL as JFedDCL
    from repro_torch.api import FedDCL as TFedDCL
    Xs, Ys = _groups(20, 0)
    kw = dict(m_tilde=4, hidden=(8,), anchor_r=64, rounds=3, local_epochs=2,
              batch_size=8, seed=0)
    p0 = jmlp.init_mlp_params(jax.random.PRNGKey(0), 4, (8,), 1)
    jm = JFedDCL(**kw)
    jsetup, jres = jm.fit(Xs, Ys, init_params=p0)
    layout = tfed.padded_layout(jsetup.fed_silos(), batch_size=8,
                                cache=tfed.PlanCache())
    assert layout.num_silos == 4
    tm = TFedDCL(**kw, device="cpu")
    assert (tm.engine, tm.cache) == ("scan", True)
    _, tres = tm.fit(Xs, Ys, init_params=_np(p0),
                     schedule=_ref_schedule(layout, 3, 2, seed=0))
    _gap("FedDCL.fit defaults params", _param_gap(tres.params, jres.params),
         BAR)
    _gap("FedDCL.fit defaults losses", _loss_gap(tres, jres), BAR)
    sj, st = jm.score(Xs[0][0], Ys[0][0]), tm.score(Xs[0][0], Ys[0][0])
    _gap("FedDCL.fit defaults score", abs(st - sj) / max(1.0, abs(sj)), BAR)
    assert set(tres.cache_stats) >= {"hit", "hits", "misses", "evictions",
                                     "plans", "captures", "replays"}
    assert tres.cache_stats["captures"] == 0          # nothing captured on CPU


# --------------------------------------------------------------------------
# on the card: one captured graph a plan, replayed once a round
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan engine captures its round "
                    "in a CUDA graph only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_plan(dev, silos, rounds, **kw):
    padded = tfed.padded_layout(silos, batch_size=16)
    opt = tadamw(1e-2)
    plan = tfed.make_fl_plan(
        num_silos=padded.num_silos, num_batches=padded.num_batches,
        batch_size=16, opt=opt,
        batch_loss=tfed._make_batch_loss(_tloss(), True, 0.0),
        local_epochs=2, device=dev, **kw)
    sched = _port_schedule(padded, rounds, 2, seed=3)
    args = tfed._plan_args(padded, tfed._to_device(padded, dev), rounds,
                           aggregator=kw.get("aggregator", "fedavg"),
                           schedule=lambda r: sched[r], device=dev)
    return plan, args


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["fedavg", "median", "krum"])
def test_captured_round_equals_eager_round_on_cuda(cuda_device, aggregator):
    """One replay of the captured round gives bitwise the params and loss
    of the same round run eagerly on the card."""
    silos = _silos([40, 28, 52], seed=3)
    plan, args = _cuda_plan(cuda_device, silos, 1, aggregator=aggregator)
    p = weights.mlp_params_from_numpy(_np(_jparams(seed=1)), cuda_device)
    X, Y, w, wr, scale, perms = args
    carry, loss, gp = plan.round_step(plan.carry_init(p), perms[0], X, Y, w,
                                      wr[0], scale)
    res = plan.run(p, args, rounds=1)
    assert (plan.captures, plan.replays) == (1, 1)
    for a, b in zip(tree_leaves(res.params), tree_leaves(gp)):
        assert torch.equal(a, b)
    assert res.history[0]["loss"] == float(loss)


@pytest.mark.cuda
def test_warm_cache_hit_captures_nothing_on_cuda(cuda_device):
    cache = tfed.PlanCache()
    kw = dict(opt=tadamw(1e-2), rounds=3, local_epochs=2, batch_size=16,
              engine="scan", cache=cache, device=cuda_device,
              loss_id=("mlp", "regression"), opt_id=("adamw", 1e-2))
    p = weights.mlp_params_from_numpy(_np(_jparams(seed=1)), cuda_device)
    cold = tfed.run_federated(_tloss(), p, _silos([40, 28, 52], seed=3), **kw)
    assert cold.cache_stats["captures"] == 1
    assert cold.cache_stats["replays"] == 3
    warm = tfed.run_federated(_tloss(), p, _silos([36, 30, 50], seed=4), **kw)
    assert warm.cache_stats["hit"] is True
    assert warm.cache_stats["captures"] == 1         # nothing new captured
    assert warm.cache_stats["replays"] == 6
    # the warm tenant trains as a fresh plan would
    fresh = tfed.run_federated(_tloss(), p, _silos([36, 30, 50], seed=4),
                               **{**kw, "cache": tfed.PlanCache()})
    for a, b in zip(tree_leaves(warm.params), tree_leaves(fresh.params)):
        assert torch.equal(a, b)
    assert warm.timings["capture_s"] == 0.0 < cold.timings["capture_s"]


@pytest.mark.cuda
def test_eval_fn_sees_copies_on_cuda(cuda_device):
    """The trees eval_fn receives are copies: later replays, which rewrite
    the plan's buffers, leave them as they were; each matches the same
    round run on the CPU."""
    silos = _silos([40, 28, 52], seed=3)
    kw = dict(opt=tadamw(1e-2), rounds=4, local_epochs=2, batch_size=16,
              seed=3, engine="scan", eval_chunk=2)
    seen = {"cuda": [], "cpu": []}
    for dev in ("cuda", "cpu"):
        p = weights.mlp_params_from_numpy(_np(_jparams(seed=1)), dev)
        tfed.run_federated(_tloss(), p, silos, device=dev,
                           eval_fn=lambda q, d=dev: seen[d].append(q) or {},
                           **kw)
    assert len(seen["cuda"]) == 4
    for a, b in zip(seen["cuda"], seen["cpu"]):
        _gap("eval params cuda vs cpu", _param_gap(a, b), BAR)
    assert _param_gap(seen["cuda"][0], seen["cuda"][-1]) > 0


@pytest.mark.cuda
def test_captured_plans_release_their_memory_on_cuda(cuda_device):
    """Plans captured one after another and dropped leave no device memory
    allocated behind them (each shares the one capture stream, so no
    stream's cuBLAS workspace is left per plan)."""
    silos = _silos([40, 28, 52], seed=3)
    p = weights.mlp_params_from_numpy(_np(_jparams(seed=1)), cuda_device)
    kw = dict(opt=tadamw(1e-2), rounds=2, local_epochs=2, batch_size=16,
              engine="scan", device=cuda_device)
    tfed.run_federated(_tloss(), p, silos, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for extra in (dict(aggregator="median"), dict(reset_opt_per_round=False),
                  dict(aggregator="fedsgd")):
        tfed.run_federated(_tloss(), p, silos, **kw, **extra)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.cuda
def test_adamw_step_captures_in_a_graph_on_cuda(cuda_device):
    """One AdamW update captured in a CUDA graph: the optimizer builds no
    tensor from a Python number on the host, and the replay equals the
    eager update bitwise."""
    opt = tadamw(1e-2)
    p = weights.mlp_params_from_numpy(_np(_jparams(seed=2)), cuda_device)
    g = tree_map(lambda a: torch.randn_like(a), p)
    state = opt.init(p)
    want_u, want_s = opt.update(g, state, p)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        opt.update(g, state, p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_u, got_s = opt.update(g, state, p)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves((got_u, got_s)), tree_leaves((want_u, want_s))):
        assert torch.equal(a, b)
