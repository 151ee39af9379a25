"""Collaboration serving: repro_torch.serve_collab against
repro.serve_collab on the same setup, params and request stream, and the
reference's own invariants (tests/test_serve_collab.py), one port test for
each: bucketed dispatch correctness, statuses, plan sharing, the warm path
that builds nothing, no tenant data held by a step, and live onboarding.

The setups come from each package's host collaboration solve, which the
port runs bit for bit; the reference's MLP params are carried over with
``weights.mlp_params_from_numpy``. Where the reference counts XLA
compiles, the port counts PlanCache misses and captures (0 on the CPU,
where a step runs eagerly). Bar: atol 2e-5, the reference's
(tests/test_serve_collab.py:50); the measured gaps print under
``pytest -s``. The ``cuda`` tests hold the captured steps (one CUDA graph
a shape bucket) to the eager step and to every table they must read.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import protocol as jprotocol  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.serve_collab import ServeCollab as JServeCollab  # noqa: E402
from repro_torch.api import FedDCL  # noqa: E402
from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.federated import PlanCache  # noqa: E402
from repro_torch.launch import serve_collab as serve_collab_cli  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.serve_collab import (CollabRequest, ServeCollab,  # noqa: E402
                                      serve_step)
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.weights import (mlp_params_from_numpy,  # noqa: E402
                                 mlp_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


M_RAW = 7
ATOL = 2e-5
COUNTS = [2, 3, 4]


def _gap(what: str, value: float, bar: float = ATOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _data():
    rng = np.random.default_rng(3)
    Xs = [[rng.standard_normal((35, M_RAW)) for _ in range(c)]
          for c in COUNTS]
    Ys = [[rng.standard_normal((35, 1)) for _ in range(c)] for c in COUNTS]
    return Xs, Ys


def _setup(pkg=protocol, **kw):
    Xs, Ys = _data()
    return pkg.run_protocol(Xs, Ys, m_tilde=4, anchor_r=120, seed=0,
                            onboard=True, **kw)


def _jparams(m_hat):
    return jmlp.init_mlp_params(jax.random.PRNGKey(0), m_hat, (16,), 1)


@pytest.fixture(scope="module")
def fitted():
    """(port setup, port params on the CPU, reference params)."""
    setup = _setup(device="cpu")
    pj = _jparams(setup.m_hat)
    return setup, mlp_params_from_numpy(jax.tree.map(np.asarray, pj), "cpu"), pj


def _srv(setup, params, **kw):
    return ServeCollab.from_setup(setup, params, device="cpu", **kw)


def _direct(setup, params, i, j, x):
    """The finalized per-user model, no batching or padding."""
    h = np.asarray(setup.user_transform(i, j)(x), np.float32)
    with torch.no_grad():
        return mlp.mlp_forward(params, torch.as_tensor(
            h, device=params["layers"][0]["w"].device)).cpu().numpy()


def _stream(srv, setup, seed, n, max_rows=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = int(rng.integers(0, setup.num_groups))
        u = int(rng.integers(0, setup.num_users(g)))
        x = rng.standard_normal((int(rng.integers(1, max_rows)), M_RAW))
        out.append((srv.submit(x, g, u), g, u, x))
    return out


def test_mixed_tenant_batches_match_direct_path(fitted):
    setup, params, _ = fitted
    srv = _srv(setup, params, max_batch=16)
    checks = _stream(srv, setup, 1, 15)
    out = srv.serve()
    assert set(out.status.values()) == {"done"}
    gap = max(np.abs(out[req.rid] - _direct(setup, params, g, u, x)).max()
              for req, g, u, x in checks)
    _gap("served vs direct path", gap)


def test_matches_reference_server(fitted):
    """The same request stream through the reference's ServeCollab and the
    port's, each on its own package's setup (equal bit for bit on the host
    path) and the same params, then both onboard the same user live."""
    setup, params, pj = fitted
    jsetup = _setup(jprotocol)
    tsetup = _setup(device="cpu")
    for a, b in zip(tsetup.collab_X, jsetup.collab_X):
        assert np.array_equal(a, b)
    js = JServeCollab.from_setup(jsetup, pj, max_batch=16)
    ts = _srv(tsetup, params, max_batch=16)
    jreq, treq = _stream(js, jsetup, 11, 20), _stream(ts, tsetup, 11, 20)
    jout, tout = js.serve(), ts.serve()
    assert tout.status == jout.status
    assert ts.stats()["buckets"] == js.stats()["buckets"]
    _gap("port vs reference server",
         max(np.abs(tout[r.rid] - jout[r.rid]).max() for r, *_ in treq))
    rng = np.random.default_rng(12)
    Xn, Yn = rng.standard_normal((30, M_RAW)), rng.standard_normal((30, 1))
    assert ts.onboard_user(1, Xn, Yn) == js.onboard_user(1, Xn, Yn) == 3
    x = rng.standard_normal((9, M_RAW))
    rj, rt = js.submit(x, 1, 3), ts.submit(x, 1, 3)
    _gap("port vs reference, onboarded tenant",
         np.abs(ts.serve()[rt.rid] - js.serve()[rj.rid]).max())
    assert len(jreq) == len(treq)


def test_oversize_request_chunks_across_steps(fitted):
    setup, params, _ = fitted
    srv = _srv(setup, params, max_batch=8)
    x = np.random.default_rng(2).standard_normal((30, M_RAW))
    req = srv.submit(x, 1, 0)                      # 30 rows through batch 8
    out = srv.serve()
    assert out.status[req.rid] == "done"
    assert out[req.rid].shape[0] == 30
    np.testing.assert_allclose(out[req.rid], _direct(setup, params, 1, 0, x),
                               rtol=0, atol=ATOL)
    assert srv.steps >= 4                          # genuinely chunked


def test_status_distinguishes_cutoff_requests(fitted):
    setup, params, _ = fitted
    srv = _srv(setup, params, max_batch=4)
    rng = np.random.default_rng(3)
    r0 = srv.submit(rng.standard_normal((3, M_RAW)), 0, 0)
    r1 = srv.submit(rng.standard_normal((20, M_RAW)), 0, 1)
    r2 = srv.submit(rng.standard_normal((5, M_RAW)), 1, 0)
    out = srv.serve(max_steps=2)
    assert out.status[r0.rid] == "done"
    assert out.status[r1.rid] == "truncated"
    assert 0 < out[r1.rid].shape[0] < 20           # partial rows, flagged
    assert out.status[r2.rid] == "pending" and out[r2.rid].size == 0
    out2 = srv.serve()                             # the rest drains
    assert out2.status[r1.rid] == "done" and out2.status[r2.rid] == "done"


def test_same_shape_groups_share_one_plan(fitted):
    """The plan key carries only SHAPES: groups with equal (T_pad, B_pad)
    hit one plan; tenant identity lives in runtime arguments."""
    setup, params, _ = fitted
    cache = PlanCache(max_plans=8)
    srv = _srv(setup, params, max_batch=8, cache=cache)
    rng = np.random.default_rng(4)
    # groups 1 (3 users) and 2 (4 users) both pad to T=4: same bucket
    srv.submit(rng.standard_normal((8, M_RAW)), 1, 0)
    srv.serve()
    misses = cache.stats()["misses"]
    x = rng.standard_normal((8, M_RAW))
    req = srv.submit(x, 2, 3)
    out = srv.serve()
    assert cache.stats()["misses"] == misses == 1  # one shared plan
    assert cache.stats()["captures"] == 0          # the CPU captures nothing
    assert set(out.status.values()) == {"done"}
    np.testing.assert_allclose(out[req.rid], _direct(setup, params, 2, 3, x),
                               rtol=0, atol=ATOL)


def test_warm_mixed_traffic_builds_nothing(fitted):
    """Steady-state serving across >=3 groups with heterogeneous request
    widths adds no plan (no miss) and no capture."""
    setup, params, _ = fitted
    cache = PlanCache()
    srv = _srv(setup, params, max_batch=16, cache=cache)

    def sweep():
        # the same stream both passes: tail-batch pow2 buckets depend on
        # the traffic, so the warm pass replays the cold pass's pattern
        _stream(srv, setup, 5, 25, max_rows=20)
        return srv.serve()

    sweep()                                        # cold: builds the buckets
    cold = cache.stats()
    out = sweep()                                  # warm: must build nothing
    warm = cache.stats()
    assert cold["misses"] > 1 and warm["misses"] == cold["misses"]
    assert warm["captures"] == cold["captures"] == 0
    assert warm["hits"] > cold["hits"]
    assert set(out.status.values()) == {"done"}


def test_no_tenant_data_held_by_step(fitted):
    """The reference audits the lowered step for baked constants; the port
    has no lowering (lower_step raises, naming ROADMAP.md) and holds the
    same property by behaviour: a table overwritten in place between two
    steps of one plan is read as it is now."""
    setup, params, _ = fitted
    srv = _srv(setup, params, max_batch=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 7"):
        srv.lower_step(0, 16)
    x = np.random.default_rng(9).standard_normal((5, M_RAW))
    first = srv.serve([CollabRequest(rid=0, group=2, user=1, x=x)])[0]
    tbl = srv.tables[2]
    tbl.M[1] = tbl.M[0] * 2.0
    tbl.mu[1] = tbl.mu[0]
    second = srv.serve([CollabRequest(rid=1, group=2, user=1, x=x)])[1]
    with torch.no_grad():
        want = serve_step(params, tbl.M, tbl.mu,
                          torch.as_tensor(x, dtype=torch.float32),
                          torch.ones(5, dtype=torch.long)).numpy()
    assert np.abs(first - second).max() > 1e-3
    np.testing.assert_allclose(second, want, rtol=0, atol=ATOL)


def test_live_onboarding_serves_new_tenant(fitted):
    _, params, _ = fitted
    setup = _setup(device="cpu")                  # onboarding mutates it
    srv = _srv(setup, params, max_batch=16)
    rng = np.random.default_rng(6)
    j = srv.onboard_user(0, rng.standard_normal((30, M_RAW)),
                         rng.standard_normal((30, 1)))
    assert (j, srv.tables[0].count, srv.tables[0].t_pad) == (2, 3, 4)
    x = rng.standard_normal((6, M_RAW))
    req = srv.submit(x, 0, j)
    out = srv.serve()
    np.testing.assert_allclose(out[req.rid],
                               _direct(srv.setup, params, 0, j, x),
                               rtol=0, atol=ATOL)
    i = srv.onboard_silo([rng.standard_normal((25, M_RAW)) for _ in range(2)],
                         [rng.standard_normal((25, 1)) for _ in range(2)])
    x2 = rng.standard_normal((4, M_RAW))
    r2 = srv.submit(x2, i, 1)
    out2 = srv.serve()
    np.testing.assert_allclose(out2[r2.rid],
                               _direct(srv.setup, params, i, 1, x2),
                               rtol=0, atol=ATOL)
    # every older tenant keeps serving through the refreshed tables
    x3 = rng.standard_normal((3, M_RAW))
    r3 = srv.submit(x3, 2, 3)
    np.testing.assert_allclose(srv.serve()[r3.rid],
                               _direct(srv.setup, params, 2, 3, x3),
                               rtol=0, atol=ATOL)


def test_submit_validates_tenant(fitted):
    setup, params, _ = fitted
    srv = _srv(setup, params)
    with pytest.raises(ValueError, match="unknown group"):
        srv.submit(np.zeros((2, M_RAW)), 99, 0)
    with pytest.raises(ValueError, match="unknown user"):
        srv.submit(np.zeros((2, M_RAW)), 0, 99)


def test_single_row_promotes(fitted):
    setup, params, _ = fitted
    srv = _srv(setup, params)
    x = np.random.default_rng(7).standard_normal(M_RAW)   # (m,) request
    req = srv.submit(x, 0, 0)
    out = srv.serve()
    assert out[req.rid].shape[0] == 1
    np.testing.assert_allclose(
        out[req.rid], _direct(setup, params, 0, 0, x[None, :]),
        rtol=0, atol=ATOL)


def test_explicit_requests_and_rids(fitted):
    setup, params, _ = fitted
    srv = _srv(setup, params)
    rng = np.random.default_rng(8)
    reqs = [CollabRequest(rid=100 + k, group=0, user=0,
                          x=rng.standard_normal((3, M_RAW)))
            for k in range(3)]
    out = srv.serve(reqs)
    assert sorted(out) == [100, 101, 102]
    assert all(s == "done" for s in out.status.values())
    st = srv.stats()
    assert st["requests_done"] == 3 and st["rows_served"] == 9
    assert 0 < st["p50_latency_s"] <= st["p99_latency_s"]
    assert st["buckets"] == {"g0/T2/B16": 1}


def test_feddcl_serve_matches_reference_server():
    """FedDCL.serve() on a fitted port estimator: its outputs equal the
    reference's ServeCollab on the reference's setup for the same data and
    the port's trained params, and its own direct path."""
    Xs, Ys = _data()
    kw = dict(m_tilde=4, hidden=(16,), rounds=2, anchor_r=120,
              svd_backend="host", seed=0)
    model = FedDCL(**kw, device="cpu")
    model.fit(Xs, Ys)
    srv = model.serve(max_batch=16)
    assert isinstance(srv, ServeCollab) and srv.device.type == "cpu"
    assert srv.setup is model.setup_
    jsetup = jprotocol.run_protocol(Xs, Ys, m_tilde=4, anchor_r=120, seed=0,
                                    onboard=True)
    js = JServeCollab.from_setup(
        jsetup, mlp_params_to_numpy(model.params_), max_batch=16)
    treq, jreq = _stream(srv, model.setup_, 13, 12), _stream(js, jsetup, 13, 12)
    tout, jout = srv.serve(), js.serve()
    _gap("FedDCL.serve vs reference server",
         max(np.abs(tout[r.rid] - jout[r.rid]).max() for r, *_ in treq))
    _gap("FedDCL.serve vs direct path",
         max(np.abs(tout[r.rid] - _direct(model.setup_, model.params_, g, u,
                                          x)).max() for r, g, u, x in treq))
    assert len(jreq) == len(treq)
    unfitted = FedDCL(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        unfitted.serve()


def test_serve_collab_cli_on_cpu(capsys):
    serve_collab_cli.main(["--device", "cpu", "--onboard", "--requests", "16"])
    out = capsys.readouterr().out
    assert "served 16/16 requests" in out and "device=cpu" in out
    assert "onboarded user 2 into group 0" in out
    assert "served 8 requests through the new tenant" in out
    assert "'captures': 0" in out


# --------------------------------------------------------------------------
# on the card: one captured graph a shape bucket
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: ServeCollab captures its steps in "
                    "CUDA graphs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def cuda_fitted(cuda_device, fitted):
    setup, _, pj = fitted
    return setup, mlp_params_from_numpy(jax.tree.map(np.asarray, pj),
                                        cuda_device), cuda_device


@pytest.mark.cuda
def test_captured_step_equals_eager_step_on_cuda(cuda_fitted):
    setup, params, dev = cuda_fitted
    cache = PlanCache()
    srv = ServeCollab.from_setup(setup, params, max_batch=16, cache=cache,
                                 device=dev)
    checks = _stream(srv, setup, 1, 15)
    out = srv.serve()
    st = cache.stats()
    assert st["captures"] == st["misses"] > 0
    assert st["replays"] == srv.steps
    tables = srv.tables
    for req, g, u, x in checks:
        tix = torch.full((req.rows,), u, dtype=torch.long, device=dev)
        with torch.no_grad():
            eager = serve_step(params, tables[g].M, tables[g].mu,
                               torch.as_tensor(x, dtype=torch.float32,
                                               device=dev), tix)
        np.testing.assert_allclose(out[req.rid], eager.cpu().numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[req.rid],
                                   _direct(setup, params, g, u, x),
                                   rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_groups_sharing_one_graph_get_their_own_tables_on_cuda(cuda_fitted):
    """Groups 1 and 2 pad to T=4 and share one captured graph; so do two
    servers with params of one signature: each gets its own answer."""
    setup, params, dev = cuda_fitted
    cache = PlanCache()
    srv = ServeCollab.from_setup(setup, params, max_batch=8, cache=cache,
                                 device=dev)
    other = tree_map(lambda a: a * 0.5, params)
    srv2 = ServeCollab.from_setup(setup, other, max_batch=8, cache=cache,
                                  device=dev)
    x = np.random.default_rng(4).standard_normal((8, M_RAW))
    outs = []
    for s, g in ((srv, 1), (srv, 2), (srv2, 2), (srv, 1)):
        outs.append((s.serve([CollabRequest(rid=len(outs), group=g, user=0,
                                            x=x)])[len(outs)], s, g))
    assert cache.stats()["captures"] == 1 and cache.stats()["replays"] == 4
    for y, s, g in outs:
        np.testing.assert_allclose(y, _direct(setup, s.params, g, 0, x),
                                   rtol=0, atol=ATOL)
    assert np.abs(outs[0][0] - outs[1][0]).max() > 1e-3
    assert np.abs(outs[1][0] - outs[2][0]).max() > 1e-3


@pytest.mark.cuda
def test_rebuilt_tables_are_served_on_cuda(cuda_device, fitted):
    """Onboarding rebuilds every table as a new tensor at the same T_pad:
    the captured graph of that bucket serves the new maps (no stale
    pointer, no baked data), with no new capture."""
    _, _, pj = fitted
    setup = _setup(device="cpu")
    params = mlp_params_from_numpy(jax.tree.map(np.asarray, pj), cuda_device)
    cache = PlanCache()
    srv = ServeCollab.from_setup(setup, params, max_batch=8, cache=cache,
                                 device=cuda_device)
    x = np.random.default_rng(5).standard_normal((8, M_RAW))
    before = srv.serve([CollabRequest(rid=0, group=2, user=1, x=x)])[0]
    old_M = srv.tables[2].M
    rng = np.random.default_rng(6)
    srv.onboard_user(1, rng.standard_normal((30, M_RAW)),
                     rng.standard_normal((30, 1)))     # group 1: 3 -> 4, T=4
    assert srv.tables[2].M is not old_M and srv.tables[2].t_pad == 4
    captures = cache.stats()["captures"]
    after = srv.serve([CollabRequest(rid=1, group=2, user=1, x=x)])[1]
    assert cache.stats()["captures"] == captures == 1
    assert np.abs(after - before).max() > 1e-6      # Z moved: new maps
    np.testing.assert_allclose(after, _direct(srv.setup, params, 2, 1, x),
                               rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_warm_mixed_traffic_captures_nothing_on_cuda(cuda_fitted):
    setup, params, dev = cuda_fitted
    cache = PlanCache()
    srv = ServeCollab.from_setup(setup, params, max_batch=16, cache=cache,
                                 device=dev)
    _stream(srv, setup, 5, 25, max_rows=20)
    srv.serve()
    cold = cache.stats()
    _stream(srv, setup, 5, 25, max_rows=20)
    out = srv.serve()
    warm = cache.stats()
    assert cold["captures"] == cold["misses"] > 1
    assert warm["captures"] == cold["captures"]
    assert warm["misses"] == cold["misses"]
    assert warm["replays"] == srv.steps
    assert set(out.status.values()) == {"done"}


@pytest.mark.cuda
def test_feddcl_serve_runs_captured_on_cuda(cuda_device):
    Xs, Ys = _data()
    model = FedDCL(m_tilde=4, hidden=(16,), rounds=2, anchor_r=120,
                   svd_backend="device", seed=0, device=cuda_device)
    model.fit(Xs, Ys)
    srv = model.serve(max_batch=16, cache=PlanCache())
    checks = _stream(srv, model.setup_, 3, 10)
    out = srv.serve()
    assert srv.stats()["cache"]["captures"] > 0
    for req, g, u, x in checks:
        np.testing.assert_allclose(
            out[req.rid], _direct(model.setup_, model.params_, g, u, x),
            rtol=0, atol=ATOL)
