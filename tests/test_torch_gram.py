"""Gram reduction and its ops: the port (repro_torch.kernels.gram) against
the JAX reference (repro.kernels.gram), same NumPy inputs made from a seed.

On the CPU the port's `gram_batched` runs its plain version; the reference
runs its Pallas kernel in interpret mode, as its own tests do. Tolerance:
1e-5 relative (Frobenius) throughout — both sides are fp32 on the CPU and
differ only in summation order. The kernel itself is held against the
plain version on the card by `test_gram_kernel_matches_plain_on_cuda`.
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,r,m", [(5, 2000, 200), (1, 2000, 250),
                                   (3, 1037, 77), (2, 17, 1)])
def test_gram_kernel_matches_plain_on_cuda(cuda_device, B, r, m):
    """The hand-written kernel against its plain version on the same CUDA
    inputs, ragged edges included; 1e-5 relative (fp32 FFMA on both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((B, r, m), generator=gen, device=cuda_device)
    before = gram_kernel.launches
    g = tops.gram_batched(a)
    torch.cuda.synchronize()
    assert gram_kernel.launches == before + 1
    g_ref = tops.gram_batched(a, backend="ref")
    rel = float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref))
    assert rel <= TOL, rel
    assert torch.equal(g, g.transpose(1, 2)), "tiles (I,J),(J,I) must agree"
