"""Algorithm 1, steps 1–3 + 12: repro_torch.core.protocol.run_protocol
against repro.core.protocol.run_protocol on the same partitions.

Host: NumPy float64 in both packages -> np.array_equal on Z, every G and
every collaboration representation. Device (fp32, here on the CPU): 1e-4
relative to the reference's device run and 1e-3 to host (the reference's
own bar). Onboarding equals a from-scratch recompute to 1e-8 on host and
1e-5 on device, the bars of the reference's tests/test_onboard.py.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import protocol as jp  # noqa: E402
from repro.data.partition import split_iid  # noqa: E402
from repro.data.tabular import make_dataset, train_test_split  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


DEV = dict(device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float) -> None:
    """Assert a parity gap against its bar and print it (pytest -s shows
    the measured gaps; ROADMAP.md Queue 3 records them)."""
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


@pytest.fixture(scope="module")
def partitions():
    ds = make_dataset("battery_small", n=900, seed=0)
    (Xtr, Ytr), _ = train_test_split(ds, 400, 400, seed=0)
    return Xtr, Ytr


LAYOUTS = [(2, [2, 2]), (3, [1, 2, 1])]
KW = dict(m_tilde=4, anchor_r=600, seed=0)


@pytest.mark.parametrize("d,c", LAYOUTS)
def test_run_protocol_host_bit_for_bit(partitions, d, c):
    Xs, Ys = split_iid(*partitions, d=d, c=c, n_ij=60, seed=0)
    st = tp.run_protocol(Xs, Ys, svd_backend="host", **KW)
    sj = jp.run_protocol(Xs, Ys, svd_backend="host", **KW)
    assert np.array_equal(st.anchor, sj.anchor)
    assert np.array_equal(st.Z, sj.Z)
    for gt, gj in zip(st.Gs, sj.Gs):
        assert len(gt) == len(gj)
        for a, b in zip(gt, gj):
            assert np.array_equal(a, b)
    for a, b in zip(st.collab_X, sj.collab_X):
        assert np.array_equal(a, b)
    for a, b in zip(st.collab_Y, sj.collab_Y):
        assert np.array_equal(a, b)
    for rt, rj in zip(st.mappings, sj.mappings):
        for ft, fj in zip(rt, rj):
            assert np.array_equal(ft.W, fj.W) and np.array_equal(ft.mu, fj.mu)


@pytest.mark.parametrize("d,c", LAYOUTS)
def test_run_protocol_device_matches_reference_and_host(partitions, d, c):
    Xs, Ys = split_iid(*partitions, d=d, c=c, n_ij=60, seed=0)
    st = tp.run_protocol(Xs, Ys, svd_backend="device", **KW, **DEV)
    sj = jp.run_protocol(Xs, Ys, svd_backend="device", **KW)
    sh = jp.run_protocol(Xs, Ys, svd_backend="host", **KW)
    _gap(f"protocol device Z vs reference device {c}", _rel(st.Z, sj.Z), 1e-4)
    _gap(f"protocol device Z vs host {c}", _rel(st.Z, sh.Z), 1e-3)
    pairs_G = [(a, b, h) for gt, gj, gh in zip(st.Gs, sj.Gs, sh.Gs)
               for a, b, h in zip(gt, gj, gh)]
    pairs_X = list(zip(st.collab_X, sj.collab_X, sh.collab_X))
    for a, b, _ in pairs_G + pairs_X:
        assert a.shape == b.shape
    _gap(f"protocol device G, X vs reference device {c}",
         max(_rel(a, b) for a, b, _ in pairs_G + pairs_X), 1e-4)
    _gap(f"protocol device G, X vs host {c}",
         max(_rel(a, h) for a, _, h in pairs_G + pairs_X), 1e-3)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_comm_log_identical_and_two_communications_per_user(partitions,
                                                            backend):
    Xs, Ys = split_iid(*partitions, d=2, c=[2, 2], n_ij=60, seed=0)
    extra = DEV if backend == "device" else {}
    st = tp.run_protocol(Xs, Ys, svd_backend=backend, **KW, **extra)
    sj = jp.run_protocol(Xs, Ys, svd_backend=backend, **KW)
    h = lambda Z: np.asarray(Z)[:, :1]
    tp.finalize_user_models(st, h, h_params_bytes=1234)
    jp.finalize_user_models(sj, h, h_params_bytes=1234)
    ev_t = [(e.src, e.dst, e.payload, e.nbytes) for e in st.comm.events]
    ev_j = [(e.src, e.dst, e.payload, e.nbytes) for e in sj.comm.events]
    assert ev_t == ev_j
    trips = st.comm.user_round_trips()
    assert len(trips) == 4 and all(v == 2 for v in trips.values())
    assert st.comm.total_bytes() == sj.comm.total_bytes()


def _mkdata(rng, counts, m, lo=20, hi=45):
    Xs = [[rng.standard_normal((int(rng.integers(lo, hi)), m))
           for _ in range(c)] for c in counts]
    Ys = [[rng.standard_normal((x.shape[0], 1)) for x in row] for row in Xs]
    return Xs, Ys


def _scaled(a, b) -> float:
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def _assert_setups_match(inc, ref, tol, what):
    """Incremental setup vs from-scratch recompute: Z, every G, every X̂."""
    assert inc.num_groups == ref.num_groups
    errs = [_scaled(inc.Z, ref.Z)]
    for i in range(ref.num_groups):
        assert inc.num_users(i) == ref.num_users(i)
        errs += [_scaled(a, b) for a, b in zip(inc.Gs[i], ref.Gs[i])]
        assert inc.collab_X[i].shape == ref.collab_X[i].shape
        errs.append(_scaled(inc.collab_X[i], ref.collab_X[i]))
        np.testing.assert_array_equal(inc.collab_Y[i], ref.collab_Y[i])
    _gap(what, max(errs), tol)


BACKENDS = [("host", 1e-8), ("device", 1e-5)]


@pytest.mark.parametrize("backend,tol", BACKENDS)
def test_onboard_user_matches_full_recompute(backend, tol):
    rng = np.random.default_rng(5)
    m = 7
    Xs, Ys = _mkdata(rng, [2, 3], m)
    Xn, Yn = rng.standard_normal((33, m)), rng.standard_normal((33, 1))
    kw = dict(m_tilde=4, anchor_r=120, seed=3, svd_backend=backend)
    if backend == "device":
        kw.update(DEV)
    setup = tp.run_protocol(Xs, Ys, onboard=True, **kw)
    n_events = len(setup.comm.events)
    j = setup.onboard_user(1, Xn, Yn)
    assert j == 3
    uploads = [e for e in setup.comm.events[n_events:]
               if e.src.startswith("user")]
    assert [e.src for e in uploads] == ["user(1,3)"]
    Xs2 = [list(r) for r in Xs]
    Ys2 = [list(r) for r in Ys]
    Xs2[1].append(Xn)
    Ys2[1].append(Yn)
    ref = tp.run_protocol(Xs2, Ys2, anchor=setup.anchor, **kw)
    _assert_setups_match(setup, ref, tol, f"onboard_user vs recompute {backend}")


@pytest.mark.parametrize("backend,tol", BACKENDS)
def test_onboard_silo_then_user_matches_full_recompute(backend, tol):
    rng = np.random.default_rng(11)
    m = 6
    Xs, Ys = _mkdata(rng, [2, 2], m)
    Xn = [rng.standard_normal((int(rng.integers(25, 40)), m)) for _ in range(3)]
    Yn = [rng.standard_normal((x.shape[0], 1)) for x in Xn]
    kw = dict(m_tilde=4, anchor_r=100, seed=0, svd_backend=backend)
    if backend == "device":
        kw.update(DEV)
    setup = tp.run_protocol(Xs, Ys, onboard=True, **kw)
    assert setup.onboard_silo(Xn, Yn) == 2
    x, y = rng.standard_normal((28, m)), rng.standard_normal((28, 1))
    setup.onboard_user(2, x, y)                  # onto the onboarded silo
    ref = tp.run_protocol(list(Xs) + [Xn + [x]], list(Ys) + [Yn + [y]],
                          anchor=setup.anchor, **kw)
    _assert_setups_match(setup, ref, tol,
                         f"onboard_silo+user vs recompute {backend}")


def test_onboard_requires_state():
    rng = np.random.default_rng(0)
    Xs, Ys = _mkdata(rng, [2], 5)
    setup = tp.run_protocol(Xs, Ys, m_tilde=3, anchor_r=60, seed=0)
    with pytest.raises(RuntimeError, match="onboard=True"):
        setup.onboard_user(0, Xs[0][0], Ys[0][0])
