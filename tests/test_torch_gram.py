"""Gram reduction and its ops: the port (repro_torch.kernels.gram) against
the JAX reference (repro.kernels.gram), same NumPy inputs made from a seed.

On the CPU the port's `gram_batched` runs its plain version; the reference
runs its Pallas kernel in interpret mode, as its own tests do. Tolerance:
1e-5 relative (Frobenius) throughout — both sides are fp32 on the CPU and
differ only in summation order. The kernel itself is held against the
plain version on the card by `test_gram_kernel_matches_plain_on_cuda`.

The kernel's launch shape (`kernel.plan`: upper-triangle tiles, r split
over a cluster) and its 3xTF32 arithmetic (`kernel.gram_3xtf32`, the
operand split and products in plain torch) are checked here on the CPU:
the emulation within the kernel's 1e-5 bar of the fp32 Gram, and, routed
through the collaboration solve, onboarding within its 1e-5 bar at the
mnist layout that chip_smoke.py runs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ops as tops
from repro_torch.kernels.gram import ref as tref
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


TOL = 1e-5


@pytest.fixture(scope="module")
def jref():
    """The reference's ops module (skips where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.gram import ops as jops
    return jnp, jops


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float) -> None:
    """Assert a parity gap against its bar and print it (pytest -s shows
    the measured gaps; ROADMAP.md Queue 3 records them)."""
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _t(x):
    return torch.as_tensor(np.array(x))


def _align_signs(V, V_ref):
    """Eigenvector columns are unique up to sign: align V to V_ref."""
    s = np.sign(np.sum(V * V_ref, axis=-2, keepdims=True))
    return np.where(s == 0, 1.0, s)


def _spectrum_stack(rng, B, r, m):
    """(B, r, m) with well-separated singular values, so eigenvectors are
    determined to fp32 precision (not only up to a rotation)."""
    out = []
    for _ in range(B):
        Q1, _ = np.linalg.qr(rng.standard_normal((r, m)))
        Q2, _ = np.linalg.qr(rng.standard_normal((m, m)))
        s = np.linspace(10.0, 1.0, m)
        out.append((Q1 * s) @ Q2.T)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("B,r,m", [(2, 100, 32), (3, 300, 48), (5, 513, 129),
                                   (7, 129, 65)])
def test_plain_gram_batched_matches_pallas_interpret(jref, B, r, m):
    jnp, jops = jref
    rng = np.random.default_rng(1)
    a = rng.standard_normal((B, r, m)).astype(np.float32)
    g_jax = np.asarray(jops.gram_batched(jnp.asarray(a), backend="interpret"))
    g_pt = tops.gram_batched(_t(a)).numpy()
    assert g_pt.shape == (B, m, m) and g_pt.dtype == np.float32
    _gap(f"gram plain vs pallas-interpret {(B, r, m)}", _rel(g_pt, g_jax), TOL)


def test_gram_single_and_ref_backend(jref):
    jnp, jops = jref
    rng = np.random.default_rng(2)
    a = rng.standard_normal((200, 40)).astype(np.float32)
    g_jax = np.asarray(jops.gram(jnp.asarray(a), backend="ref"))
    assert _rel(tops.gram(_t(a)).numpy(), g_jax) <= TOL
    assert _rel(tops.gram(_t(a), backend="ref").numpy(), g_jax) <= TOL
    assert _rel(tref.gram_reference(_t(a)).numpy(), g_jax) <= TOL
    with pytest.raises(ValueError, match="unknown gram backend"):
        tops.gram(_t(a), backend="pallas")


def test_gram_batched_casts_other_floats():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 50, 12))
    g = tops.gram_batched(_t(a))                     # float64 in
    assert g.dtype == torch.float32
    assert _rel(g.numpy(), np.einsum("brm,brn->bmn", a, a)) <= TOL


def test_kernel_wrapper_refuses_cpu_tensor():
    """The CUDA wrapper never falls back: a CPU tensor is an error there
    (ops.gram_batched is what sends CPU tensors to the plain version)."""
    before = gram_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        gram_kernel.gram_batched_cuda(torch.zeros(1, 4, 4))
    assert gram_kernel.launches == before


@pytest.mark.parametrize("B,r,m,k", [(1, 300, 16, 6), (4, 400, 24, 6)])
def test_gram_eigh_topk_batched_matches_reference(jref, B, r, m, k):
    jnp, jops = jref
    rng = np.random.default_rng(4)
    a = _spectrum_stack(rng, B, r, m)
    Uj, sj, Vj = (np.asarray(x) for x in
                  jops.gram_eigh_topk_batched(jnp.asarray(a), k, backend="ref"))
    U, s, V = (x.numpy() for x in tops.gram_eigh_topk_batched(_t(a), k))
    assert U.shape == Uj.shape and s.shape == sj.shape and V.shape == Vj.shape
    flip = _align_signs(V, Vj)
    _gap(f"gram_eigh_topk_batched {(B, r, m, k)} U,s,V",
         max(_rel(s, sj), _rel(V * flip, Vj), _rel(U * flip, Uj)), TOL)
    U1, s1, V1 = (x.numpy() for x in tops.gram_eigh_topk(_t(a[0]), k))
    assert _rel(s1, sj[0]) <= TOL


def test_eigh_topk_recover_and_gram_append_blocked(jref):
    jnp, jops = jref
    rng = np.random.default_rng(5)
    a_old = rng.standard_normal((2, 150, 10)).astype(np.float32)
    a_new = rng.standard_normal((2, 150, 4)).astype(np.float32)
    g_old = np.einsum("brm,brn->bmn", a_old, a_old).astype(np.float32)
    gj = np.asarray(jops.gram_append_blocked(
        jnp.asarray(g_old), jnp.asarray(a_old), jnp.asarray(a_new)))
    gt = tops.gram_append_blocked(_t(g_old), _t(a_old), _t(a_new)).numpy()
    assert gt.shape == (2, 14, 14)
    assert _rel(gt, gj) <= TOL
    a_full = _spectrum_stack(rng, 2, 150, 14)
    g_full = np.einsum("brm,brn->bmn", a_full, a_full).astype(np.float32)
    Uj, sj, Vj = (np.asarray(x) for x in jops.eigh_topk_recover_batched(
        jnp.asarray(g_full), jnp.asarray(a_full), 5))
    U, s, V = (x.numpy() for x in tops.eigh_topk_recover_batched(
        _t(g_full), _t(a_full), 5))
    flip = _align_signs(V, Vj)
    assert _rel(s, sj) <= TOL and _rel(V * flip, Vj) <= TOL
    assert _rel(U * flip, Uj) <= TOL


def test_apply_G_batched_matches_reference(jref):
    jnp, jops = jref
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 40, 9)).astype(np.float32)
    g = rng.standard_normal((3, 9, 5)).astype(np.float32)
    out_j = np.asarray(jops.apply_G_batched(jnp.asarray(x), jnp.asarray(g)))
    assert _rel(tops.apply_G_batched(_t(x), _t(g)).numpy(), out_j) <= TOL


@pytest.mark.parametrize("ridge", [0.0, 1e-3])
@pytest.mark.parametrize("widths", [[6], [6, 3, 5, 2], [1, 12, 4, 7]])
def test_solve_G_batched_matches_reference(jref, widths, ridge):
    jnp, jops = jref
    from repro.core import collab as jcollab
    rng = np.random.default_rng(7)
    r, m_hat = 250, 4
    Z = rng.standard_normal((r, m_hat)).astype(np.float32)
    mats = [rng.standard_normal((r, w)).astype(np.float32) for w in widths]
    padded, mask = jcollab.pad_ragged(mats)
    Gj = np.asarray(jops.solve_G_batched(jnp.asarray(padded), jnp.asarray(Z),
                                         jnp.asarray(mask), ridge=ridge))
    Gt = tops.solve_G_batched(_t(padded), _t(Z), _t(mask),
                              ridge=ridge).numpy()
    assert Gt.shape == Gj.shape
    _gap(f"solve_G_batched widths={widths} ridge={ridge}", _rel(Gt, Gj), TOL)
    for b, w in enumerate(widths):
        assert np.all(Gt[b, w:] == 0.0), "padded rows must be exactly zero"


def test_solve_G_factors_and_per_batch_targets(jref):
    jnp, jops = jref
    rng = np.random.default_rng(8)
    A = rng.standard_normal((3, 100, 8)).astype(np.float32)
    Z = rng.standard_normal((3, 100, 4)).astype(np.float32)
    qj, rj = (np.asarray(x) for x in jops.solve_G_factor_batched(jnp.asarray(A)))
    qt, rt = (x.numpy() for x in tops.solve_G_factor_batched(_t(A)))
    assert qt.shape == qj.shape == (3, 108, 8) and rt.shape == rj.shape
    assert _rel(rt, rj) <= TOL and _rel(qt, qj) <= TOL
    # the apply half on the reference's own factors, per-batch targets
    Gj = np.asarray(jops.solve_G_from_factors(jnp.asarray(qj), jnp.asarray(rj),
                                              jnp.asarray(Z)))
    Gt = tops.solve_G_from_factors(_t(qj), _t(rj), _t(Z)).numpy()
    assert _rel(Gt, Gj) <= TOL
    Gb = tops.solve_G_batched(_t(A), _t(Z)).numpy()
    assert _rel(Gb, np.asarray(jops.solve_G_batched(jnp.asarray(A),
                                                    jnp.asarray(Z)))) <= TOL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Gram kernel runs only on the card")
    return torch.device("cuda")


# the fit's three shapes (groups, central, maintained group Grams), as
# chip_smoke.py's MAIN_SHAPES
MAIN_SHAPES = [(5, 2000, 200), (1, 2000, 250), (1, 2000, 200)]
PLAN_SHAPES = MAIN_SHAPES + [(3, 1037, 77), (2, 17, 1), (2, 0, 33),
                             (1, 40, 200), (1, 130, 250), (7, 129, 65),
                             (16, 8192, 1024)]


@pytest.mark.parametrize("B,r,m", PLAN_SHAPES)
def test_plan_tiles_cover_upper_triangle_once(B, r, m):
    """The kernel's tile decode visits every (i, j) with i <= j of the
    output exactly once, and nothing below the diagonal."""
    p = gram_kernel.plan(B, r, m)
    assert p.nt * gram_kernel.TILE >= m > (p.nt - 1) * gram_kernel.TILE
    hits = np.zeros((p.nt * gram_kernel.TILE,) * 2, np.int64)
    for t in range(p.tiles):
        bi, bj = gram_kernel.triangle_tile(t, p.nt)
        assert 0 <= bi <= bj < p.nt
        i0, j0 = bi * gram_kernel.TILE, bj * gram_kernel.TILE
        block = hits[i0:i0 + gram_kernel.TILE, j0:j0 + gram_kernel.TILE]
        block += (np.triu(np.ones_like(block)) if bi == bj
                  else np.ones_like(block))
    assert np.array_equal(hits, np.triu(np.ones_like(hits)))


@pytest.mark.parametrize("B,r,m", PLAN_SHAPES)
def test_plan_slices_partition_r(B, r, m):
    """The r slices of a tile's blocks tile [0, r) in order, none empty
    unless r is, each a whole number of panels but the last."""
    p = gram_kernel.plan(B, r, m)
    sl = gram_kernel.slices(r, p.split)
    assert len(sl) == p.split
    assert sl[0][0] == 0 and sl[-1][1] == r
    for (_, stop), (start, _) in zip(sl, sl[1:]):
        assert stop == start
    for start, stop in sl:
        assert start % gram_kernel.BK == 0
        assert stop > start or r == 0
        assert stop == r or stop % gram_kernel.BK == 0
    assert p.blocks == p.split * p.tiles * B


@pytest.mark.parametrize("B,r,m", PLAN_SHAPES)
def test_plan_cluster_size(B, r, m):
    """The split is the cluster size: at most 8 blocks, the portable limit
    (no non-portable attribute is set)."""
    p = gram_kernel.plan(B, r, m)
    assert 1 <= p.split <= gram_kernel.MAX_SPLIT == 8
    assert m % p.vec == 0 and p.vec in (1, 2, 4)


@pytest.mark.parametrize("B,r,m", MAIN_SHAPES)
def test_plan_fills_the_card_on_main_path(B, r, m):
    """The groups' Gram runs at least one block per SM of an H100. The B=1
    calls have 10 triangle tiles, so the 8-block cluster caps them at 80
    blocks of 8 warps: clusters of 10-16 ran slower on the card."""
    p = gram_kernel.plan(B, r, m)
    if B == 1:
        assert p.split == gram_kernel.MAX_SPLIT and p.blocks == 80, p
    else:
        assert p.blocks >= gram_kernel.H100_SMS, p


def test_plan_limits():
    """Where r is too short to split (r = 0, 17, 40 rows: one 64-row panel
    at most) or the tiles fill the card alone, one slice."""
    assert gram_kernel.plan(2, 0, 33).split == 1
    assert gram_kernel.plan(2, 17, 1).split == 1
    assert gram_kernel.plan(1, 40, 200).split == 1
    assert gram_kernel.plan(16, 8192, 1024).split == 1
    assert gram_kernel.plan(1, 100_000, 8).split == gram_kernel.MAX_SPLIT
    assert gram_kernel.plan(5, 2000, 200).split == 4


def test_tf32_round_is_cvt_rna():
    """To nearest TF32 (10 mantissa bits), ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4,
                      -(1 + ulp / 2), 3.1415926, 0.0, -0.0, 1e-30],
                     dtype=torch.float32)
    got = gram_kernel.tf32_round(x)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.140625,
                         0.0, -0.0, 1e-30], dtype=torch.float32)
    assert torch.equal(got[:-1], want[:-1])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(got[-1]) / 1e-30 - 1) <= 2.0 ** -11


@pytest.mark.parametrize("B,r,m", MAIN_SHAPES)
def test_3xtf32_emulation_within_gram_tol(B, r, m):
    """The kernel's arithmetic against the fp32 plain Gram at the fit's
    shapes: within GRAM_TOL (1e-5), exactly symmetric; TF32 alone is not."""
    rng = np.random.default_rng(9)
    a = _t(rng.standard_normal((B, r, m)).astype(np.float32))
    g = gram_kernel.gram_3xtf32(a)
    g_ref = tref.gram_batched_reference(a)
    assert torch.equal(g, g.transpose(1, 2))
    _gap(f"gram 3xtf32 emulation vs plain {(B, r, m)}", _rel(g, g_ref), TOL)
    hi = gram_kernel.tf32_round(a)
    assert _rel(hi.transpose(1, 2) @ hi, g_ref) > TOL


def test_3xtf32_emulation_keeps_onboarding_within_bar(monkeypatch):
    """chip_smoke.py's onboarding check on the CPU with every Gram of the
    collaboration solve computed in the kernel's arithmetic: a new user
    onboarded into group 0 (maintained Gram + torch.bmm cross blocks)
    against the from-scratch recompute, 1e-5 max error scaled by max(1,
    |ref|), the bar of the reference's tests/test_onboard.py."""
    from repro_torch.core import protocol as tp
    from repro_torch.data.partition import split_iid
    from repro_torch.data.tabular import make_dataset, train_test_split
    monkeypatch.setattr(tops, "gram_batched",
                        lambda a, backend="auto": gram_kernel.gram_3xtf32(a))
    d, c, n_ij, m_tilde, anchor_r = 5, 4, 100, 50, 2000
    ds = make_dataset("mnist", n=d * c * n_ij + 1000 + 200, seed=0)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, d * c * n_ij, 1000,
                                              seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d, [c] * d, n_ij, seed=0)
    kw = dict(m_tilde=m_tilde, anchor_r=anchor_r, seed=0,
              svd_backend="device", device="cpu")
    setup = tp.run_protocol(Xs, Ys, onboard=True, **kw)
    Xn, Yn = Xte[:n_ij], Yte[:n_ij]
    setup.onboard_user(0, Xn, Yn)
    Xs2 = [list(r) for r in Xs]
    Ys2 = [list(r) for r in Ys]
    Xs2[0].append(Xn)
    Ys2[0].append(Yn)
    ref = tp.run_protocol(Xs2, Ys2, anchor=setup.anchor, **kw)

    def scaled(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        return float(np.abs(x - y).max() / max(1.0, np.abs(y).max()))

    err = max([scaled(setup.Z, ref.Z)]
              + [scaled(x, y) for gi, gr in zip(setup.Gs, ref.Gs)
                 for x, y in zip(gi, gr)]
              + [scaled(x, y) for x, y in zip(setup.collab_X, ref.collab_X)])
    _gap("onboarding vs recompute, 3xtf32 emulation, mnist layout", err, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,r,m", [(5, 2000, 200), (1, 2000, 250),
                                   (3, 1037, 77), (2, 17, 1),
                                   (1, 2000, 200), (2, 8192, 1024),
                                   (2, 0, 33), (1, 40, 200), (1, 130, 250)])
def test_gram_kernel_matches_plain_on_cuda(cuda_device, B, r, m):
    """The hand-written kernel against its plain version on the same CUDA
    inputs, ragged edges, r = 0 and r shorter than one slice included;
    1e-5 relative (3xTF32 against fp32 FFMA)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((B, r, m), generator=gen, device=cuda_device)
    before = gram_kernel.launches
    g = tops.gram_batched(a)
    torch.cuda.synchronize()
    assert gram_kernel.launches == before + 1
    g_ref = tops.gram_batched(a, backend="ref")
    rel = float(torch.linalg.norm(g - g_ref)
                / torch.linalg.norm(g_ref).clamp_min(1e-30))
    assert rel <= TOL, rel
    assert torch.isfinite(g).all()
    if r == 0:
        assert torch.equal(g, torch.zeros_like(g))
    assert torch.equal(g, g.transpose(1, 2)), "tiles (I,J),(J,I) must agree"


@pytest.mark.cuda
@pytest.mark.parametrize("B,r,m", [(5, 2000, 200), (1, 2000, 250),
                                   (3, 1037, 77), (16, 8192, 1024)])
def test_gram_kernel_is_repeatable_on_cuda(cuda_device, B, r, m):
    """Two calls on the same input agree bit for bit: the split's partial
    tiles are summed in a fixed order, with no atomics."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn((B, r, m), generator=gen, device=cuda_device)
    g1 = tops.gram_batched(a)
    g2 = tops.gram_batched(a)
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,m", [(1, 200), (2, 200), (1, 250)])
def test_gram_kernel_unaligned_view_on_cuda(cuda_device, offset, m):
    """A view that starts off 16 bytes takes narrower copies (8 or 4 bytes
    per cp.async) and gives the same Gram."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    flat = torch.randn((offset + 2000 * m,), generator=gen,
                       device=cuda_device)
    a = flat[offset:].view(1, 2000, m)
    assert a.data_ptr() % 16 != 0
    g = tops.gram_batched(a)
    g_ref = tops.gram_batched(a, backend="ref")
    rel = float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref))
    assert rel <= TOL, rel
    assert torch.equal(g, tops.gram_batched(a.clone()))
