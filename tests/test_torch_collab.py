"""Step 3, the collaboration solve: repro_torch.core.collab against
repro.core.collab on the same NumPy inputs.

Tolerances: the host backend is NumPy float64 in both packages, so it must
agree BIT FOR BIT. The device backend (fp32, here on the CPU) must agree
with the reference's device path to 1e-5 relative on single ops and 1e-4
relative on bases and G's, which carry the reference's fp32 eigenvector
noise (the port takes the eigh of the same fp32 Gram in float64); against
host it keeps the reference's own bar, 1e-3.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import collab as jc  # noqa: E402
from repro_torch.core import collab as tc  # noqa: E402
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


def _groups(rng, widths, r=300):
    return [[rng.standard_normal((r, w)) for w in row] for row in widths]


def test_pad_helpers_and_fix_signs_are_identical():
    rng = np.random.default_rng(0)
    mats = [rng.standard_normal((20, w)) for w in (3, 7, 5)]
    for a, b in zip(tc.pad_ragged(mats), jc.pad_ragged(mats)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    mats2 = [rng.standard_normal((n, w)) for n, w in ((4, 3), (9, 2))]
    assert np.array_equal(tc.pad_ragged2d(mats2), jc.pad_ragged2d(mats2))
    U, s, V = rng.standard_normal((10, 4)), rng.random(4), rng.standard_normal((6, 4))
    for a, b in zip(tc._fix_signs(U, s, V), jc._fix_signs(U, s, V)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("widths", [[[4, 4], [4, 4]], [[3, 5], [6], [2, 2, 2]]])
def test_host_backend_bit_for_bit(widths):
    rng = np.random.default_rng(1)
    groups = _groups(rng, widths)
    m_hat = 4
    seeds = [31 * i for i in range(len(groups))]
    bt = tc.intra_group_bases(groups, m_hat, seeds=seeds, backend="host")
    bj = jc.intra_group_bases(groups, m_hat, seeds=seeds, backend="host")
    for a, b in zip(bt, bj):
        assert np.array_equal(a.B, b.B)
    zt = tc.central_target(bt, m_hat, 57, backend="host").Z
    zj = jc.central_target(bj, m_hat, 57, backend="host").Z
    assert np.array_equal(zt, zj)
    flat = [a for row in groups for a in row]
    for a, b in zip(tc.solve_G_all(flat, zt, backend="host"),
                    jc.solve_G_all(flat, zj, backend="host")):
        assert np.array_equal(a, b)
    hb_t, hb_j = tc.HostBackend(), jc.HostBackend()
    A = np.concatenate(groups[0], axis=1)
    assert np.array_equal(hb_t.gram(A), hb_j.gram(A))
    for a, b in zip(hb_t.topk_svd_from_gram(A, hb_t.gram(A), 3),
                    hb_j.topk_svd_from_gram(A, hb_j.gram(A), 3)):
        assert np.array_equal(a, b)


def test_device_ops_match_reference_device():
    """Single device ops: gram, blocked update, solve, apply — 1e-5."""
    rng = np.random.default_rng(2)
    be_t, be_j = tc.DeviceBackend(**DEV), jc.DeviceBackend()
    A_old, A_new = rng.standard_normal((250, 9)), rng.standard_normal((250, 4))
    g_t, g_j = be_t.gram(A_old), be_j.gram(A_old)
    assert _rel(g_t, g_j) <= 1e-5
    assert _rel(be_t.gram_update_blocked(g_t, A_old, A_new),
                be_j.gram_update_blocked(g_j, A_old, A_new)) <= 1e-5
    anchors = [rng.standard_normal((300, w)) for w in (5, 9, 3)]
    Z = rng.standard_normal((300, 4))
    for a, b in zip(tc.solve_G_all(anchors, Z, backend=be_t),
                    jc.solve_G_all(anchors, Z, backend="device")):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5
    shapes = [(30, 6, 3), (17, 8, 5), (44, 4, 4)]
    Xs = [rng.standard_normal((n, mt)) for n, mt, _ in shapes]
    Gs = [rng.standard_normal((mt, mh)) for _, mt, mh in shapes]
    for a, b, h in zip(tc.apply_G_all(Xs, Gs, backend=be_t),
                       jc.apply_G_all(Xs, Gs, backend="device"),
                       jc.apply_G_all(Xs, Gs, backend="host")):
        assert a.shape == b.shape == h.shape and _rel(a, b) <= 1e-5
    fac_t, fac_j = be_t.factor_G_many(anchors), be_j.factor_G_many(anchors)
    for a, b in zip(be_t.solve_G_factors(fac_t, Z),
                    be_j.solve_G_factors(fac_j, Z)):
        assert _rel(a, b) <= 1e-5
    new = rng.standard_normal((300, 7))
    fac_t2 = be_t.factor_G_append(fac_t, new)
    fac_j2 = be_j.factor_G_append(fac_j, new)
    assert fac_t2["widths"] == fac_j2["widths"] == [5, 9, 3, 7]
    for a, b in zip(be_t.solve_G_factors(fac_t2, Z),
                    be_j.solve_G_factors(fac_j2, Z)):
        assert _rel(a, b) <= 1e-5
    assert be_t.factor_G_append(fac_t, rng.standard_normal((300, 12))) is None


@pytest.mark.parametrize("widths", [[[4, 4], [4, 4]], [[3, 5], [6], [2, 2, 2]]])
def test_device_bases_and_G_match_reference_and_host(widths):
    rng = np.random.default_rng(3)
    groups = _groups(rng, widths)
    m_hat = 4
    seeds = [31 * i for i in range(len(groups))]
    be_t = tc.DeviceBackend(**DEV)
    bt = tc.intra_group_bases(groups, m_hat, seeds=seeds, backend=be_t)
    bj = jc.intra_group_bases(groups, m_hat, seeds=seeds, backend="device")
    bh = jc.intra_group_bases(groups, m_hat, seeds=seeds, backend="host")
    assert [a.B.shape for a in bt] == [b.B.shape for b in bj]
    _gap(f"device bases vs reference device {widths}",
         max(_rel(a.B, b.B) for a, b in zip(bt, bj)), 1e-4)
    _gap(f"device bases vs host {widths}",
         max(_rel(a.B, h.B) for a, h in zip(bt, bh)), 1e-3)
    zt = tc.central_target(bt, m_hat, 57, backend=be_t).Z
    zj = jc.central_target(bj, m_hat, 57, backend="device").Z
    zh = jc.central_target(bh, m_hat, 57, backend="host").Z
    _gap(f"device Z vs reference device {widths}", _rel(zt, zj), 1e-4)
    _gap(f"device Z vs host {widths}", _rel(zt, zh), 1e-3)
    flat = [a for row in groups for a in row]
    gt = tc.solve_G_all(flat, zt, backend=be_t)
    gj = jc.solve_G_all(flat, zj, backend="device")
    gh = jc.solve_G_all(flat, zh, backend="host")
    _gap(f"device G vs reference device {widths}",
         max(_rel(a, b) for a, b in zip(gt, gj)), 1e-4)
    _gap(f"device G vs host {widths}",
         max(_rel(a, h) for a, h in zip(gt, gh)), 1e-3)
    A = np.concatenate(groups[0], axis=1)
    svd_t = be_t.topk_svd_from_gram(A, be_t.gram(A), m_hat)
    svd_j = jc.DeviceBackend().topk_svd_from_gram(A, jc.DeviceBackend().gram(A),
                                                  m_hat)
    for a, b in zip(svd_t, svd_j):
        assert _rel(a, b) <= 1e-4


def test_collinear_anchor_raises_floating_point_error():
    """An exactly degenerate real column makes the triangular factor
    singular at ridge=0; the non-finite G must surface as the diagnostic,
    from a fresh solve and from cached factors alike."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((200, 6))
    A[:, 3] = 0.0
    Z = rng.standard_normal((200, 4))
    anchors = [A, rng.standard_normal((200, 5))]
    be = tc.DeviceBackend(**DEV)
    with pytest.raises(FloatingPointError, match=r"users \[0\]"):
        be.solve_G_many(anchors, Z)
    with pytest.raises(FloatingPointError, match="cached factors"):
        be.solve_G_factors(be.factor_G_many(anchors), Z)
    with pytest.raises(FloatingPointError):       # the reference agrees
        jc.DeviceBackend().solve_G_many(anchors, Z)
    G = tc.DeviceBackend(ridge=1e-3, **DEV).solve_G_many(anchors, Z)
    assert all(np.all(np.isfinite(g)) for g in G)


def test_topk_svd_many_ragged_widths_match_host_clamp():
    """Per-matrix k clamp: a narrow group must not truncate wider groups'
    bases on the device backend (mirrors the reference's regression)."""
    rng = np.random.default_rng(8)
    groups = [[rng.standard_normal((200, 8))],
              [rng.standard_normal((200, 16)), rng.standard_normal((200, 16))]]
    be_t = tc.DeviceBackend(**DEV)
    for m_hat in (4, 16):
        host = jc.intra_group_bases(groups, m_hat, seeds=[0, 1], backend="host")
        dev = tc.intra_group_bases(groups, m_hat, seeds=[0, 1], backend=be_t)
        assert [b.B.shape for b in host] == [b.B.shape for b in dev]
        for bh, bd in zip(host, dev):
            assert _rel(bd.B, bh.B) <= 1e-3


def test_get_backend_names():
    assert tc.get_backend("host").name == "host"
    assert tc.get_backend("device", device="cpu").name == "device"
    be = tc.DeviceBackend(**DEV)
    assert tc.get_backend(be) is be
    with pytest.raises(ValueError, match="unknown collab backend"):
        tc.get_backend("tpu")
