"""Host substrate of the port (configs, datasets, partitions, anchors,
private maps): NumPy float64 in both packages, so every array must be
np.array_equal to the reference's for the same seeds."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs.feddcl_mlp import PAPER_MLPS as J_MLPS  # noqa: E402
from repro.core import anchor as janchor, mappings as jmap  # noqa: E402
from repro.data import partition as jpart, tabular as jtab  # noqa: E402
from repro_torch.configs.feddcl_mlp import PAPER_MLPS as T_MLPS  # noqa: E402
from repro_torch.core import anchor as tanchor, mappings as tmap  # noqa: E402
from repro_torch.data import partition as tpart, tabular as ttab  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def test_configs_equal():
    assert list(T_MLPS) == list(J_MLPS)
    for name in J_MLPS:
        t, j = T_MLPS[name], J_MLPS[name]
        assert (t.name, t.in_dim, t.hidden, t.out_dim, t.task, t.reduced_dim) \
            == (j.name, j.in_dim, j.hidden, j.out_dim, j.task, j.reduced_dim)


@pytest.mark.parametrize("name", sorted(J_MLPS))
@pytest.mark.parametrize("seed", [0, 3])
def test_datasets_and_splits_equal(name, seed):
    dt = ttab.make_dataset(name, n=300, seed=seed)
    dj = jtab.make_dataset(name, n=300, seed=seed)
    assert dt.task == dj.task and dt.name == dj.name
    assert np.array_equal(dt.X, dj.X) and np.array_equal(dt.Y, dj.Y)
    assert dt.Y.dtype == dj.Y.dtype
    (a, b), (c, d) = ttab.train_test_split(dt, 120, 100, seed=seed)
    (e, f), (g, h) = jtab.train_test_split(dj, 120, 100, seed=seed)
    for x, y in ((a, e), (b, f), (c, g), (d, h)):
        assert np.array_equal(x, y)


def _same_nested(u, v):
    assert len(u) == len(v)
    for ru, rv in zip(u, v):
        assert len(ru) == len(rv)
        for x, y in zip(ru, rv):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 5])
def test_partitions_equal(seed):
    ds = jtab.make_dataset("human_activity", n=800, seed=0)
    for tx, jx in (
            (tpart.split_iid(ds.X, ds.Y, 3, [2, 1, 3], 40, seed=seed),
             jpart.split_iid(ds.X, ds.Y, 3, [2, 1, 3], 40, seed=seed)),
            (tpart.split_dirichlet(ds.X, ds.Y, 2, [2, 2], 50, alpha=0.3,
                                   seed=seed),
             jpart.split_dirichlet(ds.X, ds.Y, 2, [2, 2], 50, alpha=0.3,
                                   seed=seed))):
        _same_nested(tx[0], jx[0])
        _same_nested(tx[1], jx[1])


@pytest.mark.parametrize("kind", ["uniform", "lowrank", "smote"])
@pytest.mark.parametrize("seed", [0, 7])
def test_anchors_equal(kind, seed):
    X = jtab.make_dataset("credit_rating", n=200, seed=1).X
    kw = dict(feat_min=X.min(0), feat_max=X.max(0), public_sample=X[::4])
    assert np.array_equal(tanchor.make_anchor(kind, seed, 150, **kw),
                          janchor.make_anchor(kind, seed, 150, **kw))


@pytest.mark.parametrize("kind", ["pca_rot", "pca", "randproj"])
@pytest.mark.parametrize("seed", [0, 11])
def test_mappings_equal(kind, seed):
    X = jtab.make_dataset("mnist", n=120, seed=seed).X
    ft = tmap.fit_mapping(kind, X, 50, seed=seed)
    fj = jmap.fit_mapping(kind, X, 50, seed=seed)
    assert np.array_equal(ft.W, fj.W) and np.array_equal(ft.mu, fj.mu)
    assert np.array_equal(ft(X[:30]), fj(X[:30]))
    assert ft.out_dim == fj.out_dim == 50
