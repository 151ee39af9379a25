"""The helpers the paper's experiments call, against the reference:
``collab.topk_svd`` / ``intra_group_basis`` / ``alignment_residual`` (NumPy
float64 on the host: bit for bit), ``mlp.mlp_loss`` (1e-6 relative on the
same injected params) and ``mlp.for_config`` (the same shapes for every
Table 3 network)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs.feddcl_mlp import PAPER_MLPS as JPAPER_MLPS  # noqa: E402
from repro.core import collab as jcollab  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.configs.feddcl_mlp import PAPER_MLPS  # noqa: E402
from repro_torch.core import collab  # noqa: E402
from repro_torch.core.mappings import LinearMap  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.weights import mlp_params_from_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _gap(what: str, value: float, bar: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


@pytest.mark.parametrize("shape,k", [((300, 20), 5), ((50, 80), 12),
                                     ((400, 6), 9)])
def test_topk_svd_host_bit_for_bit(shape, k):
    A = np.random.default_rng(0).standard_normal(shape)
    for a, b in zip(collab.topk_svd(A, k), jcollab.topk_svd(A, k)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_topk_svd_device_backend_matches_host():
    """The "device" backend (here on the CPU: the Gram kernel's plain
    version, float64 eigh) against the host SVD at the reference's
    device-vs-host bar."""
    A = np.random.default_rng(1).standard_normal((500, 24))
    U, s, V = collab.topk_svd(A, 8, backend="device", device="cpu")
    Uh, sh, Vh = collab.topk_svd(A, 8)
    _gap("topk_svd device vs host, s", float(np.max(np.abs(s - sh) / sh)),
         1e-3)
    rec, rec_h = (U * s) @ V.T, (Uh * sh) @ Vh.T
    _gap("topk_svd device vs host, rank-8 product",
         float(np.linalg.norm(rec - rec_h) / np.linalg.norm(rec_h)), 1e-3)


@pytest.mark.parametrize("widths,m_hat,seed", [((4, 5, 6), 6, 3),
                                               ((8, 8), 8, 11),
                                               ((3,), 2, 0)])
def test_intra_group_basis_bit_for_bit(widths, m_hat, seed):
    rng = np.random.default_rng(seed)
    anchors = [rng.standard_normal((200, w)) for w in widths]
    got = collab.intra_group_basis(anchors, m_hat, seed)
    want = jcollab.intra_group_basis(anchors, m_hat, seed)
    assert np.array_equal(got.B, want.B)
    # the single-group form is one group of the batched one
    assert np.array_equal(
        got.B, collab.intra_group_bases([anchors], m_hat, [seed])[0].B)


def test_alignment_residual_bit_for_bit():
    rng = np.random.default_rng(2)
    A, Z = rng.standard_normal((300, 7)), rng.standard_normal((300, 5))
    G = collab.solve_G(A, Z)
    assert collab.alignment_residual(A, G, Z) == \
        jcollab.alignment_residual(A, G, Z)
    assert collab.alignment_residual(A, np.zeros((7, 5)), np.zeros((300, 5))) \
        == jcollab.alignment_residual(A, np.zeros((7, 5)), np.zeros((300, 5)))


@pytest.mark.parametrize("d,c,m,mt_frac,seed", [(2, 1, 6, 0.5, 0),
                                                (3, 2, 11, 0.7, 17),
                                                (4, 3, 16, 0.3, 9_999)])
def test_theorem1_exact_alignment_on_the_port(d, c, m, mt_frac, seed):
    """tests/test_collab.py's Theorem-1 check on the port's API: linear maps
    of one range give residual 0 and X̂ = X F for one global F; each
    residual equals the reference's on the same inputs."""
    rng = np.random.default_rng(seed)
    m_tilde = max(2, int(m * mt_frac))
    n_ij = 12
    X = rng.standard_normal((n_ij * d * c, m))
    F_base = rng.standard_normal((m, m_tilde))
    Es = [[rng.standard_normal((m_tilde, m_tilde)) + np.eye(m_tilde) * m_tilde
           for _ in range(c)] for _ in range(d)]
    anchors = rng.standard_normal((2000, m))
    Xs = [[X[(i * c + j) * n_ij:(i * c + j + 1) * n_ij] for j in range(c)]
          for i in range(d)]
    maps = [[LinearMap(mu=np.zeros(m), W=F_base @ Es[i][j]) for j in range(c)]
            for i in range(d)]
    inter_A = [[f(anchors) for f in row] for row in maps]
    bases = [collab.intra_group_basis(inter_A[i], m_tilde, seed + i)
             for i in range(d)]
    target = collab.central_target(bases, m_tilde, seed + 99)
    jbases = [jcollab.intra_group_basis(inter_A[i], m_tilde, seed + i)
              for i in range(d)]
    jtarget = jcollab.central_target(jbases, m_tilde, seed + 99)
    assert np.array_equal(target.Z, jtarget.Z)
    Gs, res = [], []
    for i in range(d):
        for j in range(c):
            G = collab.solve_G(inter_A[i][j], target.Z)
            Gs.append((i, j, G))
            r = collab.alignment_residual(inter_A[i][j], G, target.Z)
            assert r == jcollab.alignment_residual(inter_A[i][j], G,
                                                   jtarget.Z)
            res.append(r)
    _gap(f"Theorem-1 residual d{d} c{c} m{m}", max(res), 1e-6)
    F = maps[0][0].W @ Gs[0][2]
    for i, j, G in Gs:
        np.testing.assert_allclose(maps[i][j](Xs[i][j]) @ G, Xs[i][j] @ F,
                                   atol=1e-6 * X.shape[0], rtol=1e-5)


@pytest.mark.parametrize("dataset", ["battery_small", "human_activity"])
@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_mlp_loss_matches_reference(dataset, l2):
    cfg = JPAPER_MLPS[dataset]
    p = jmlp.for_config(jax.random.PRNGKey(3), cfg, reduced=False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, cfg.in_dim)).astype(np.float32)
    if cfg.task == "regression":
        y = rng.standard_normal((64, cfg.out_dim)).astype(np.float32)
    else:
        y = rng.integers(0, cfg.out_dim, size=64)
    want = float(jmlp.mlp_loss(p, x, y, cfg.task, l2=l2))
    tp = mlp_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    yt = torch.as_tensor(y) if cfg.task != "regression" else torch.tensor(y)
    got = float(mlp.mlp_loss(tp, torch.tensor(x), yt, cfg.task, l2=l2))
    _gap(f"mlp_loss {dataset} l2={l2}", abs(got - want) / abs(want), 1e-6)
    if l2:
        assert got > float(mlp.mlp_loss(tp, torch.tensor(x), yt, cfg.task))


@pytest.mark.parametrize("reduced", [False, True])
def test_for_config_shapes_match_reference(reduced):
    assert sorted(PAPER_MLPS) == sorted(JPAPER_MLPS)
    gen = torch.Generator().manual_seed(0)
    for name, cfg in PAPER_MLPS.items():
        got = mlp.for_config(gen, cfg, reduced=reduced, device="cpu")
        want = jmlp.for_config(jax.random.PRNGKey(0), JPAPER_MLPS[name],
                               reduced=reduced)
        assert [(tuple(l["w"].shape), tuple(l["b"].shape))
                for l in got["layers"]] == \
            [(tuple(l["w"].shape), tuple(l["b"].shape))
             for l in want["layers"]], name
        assert all(l["w"].dtype == torch.float32 for l in got["layers"])
    # the same generator state gives the same draw
    a = mlp.for_config(torch.Generator().manual_seed(5), PAPER_MLPS["eicu"],
                       reduced=True, device="cpu")
    b = mlp.for_config(torch.Generator().manual_seed(5), PAPER_MLPS["eicu"],
                       reduced=True, device="cpu")
    assert all(torch.equal(x["w"], y["w"])
               for x, y in zip(a["layers"], b["layers"]))
