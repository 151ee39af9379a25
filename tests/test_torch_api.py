"""The one-call API: repro_torch.api.FedDCL against repro.api.FedDCL on the
paper's layouts, with the reference's init params and minibatch schedule
injected (torch cannot reproduce jax.random).

Tolerance: the collaboration solve runs on host (bit for bit), so the only
gap is the fp32 federated phase -> 1e-4, the reference's host==scan bar,
on the test metric and on every round's loss.
"""
from functools import partial

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.api import FedDCL as JFedDCL  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.data.partition import split_iid  # noqa: E402
from repro.data.tabular import make_dataset, train_test_split  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.api import FedDCL as TFedDCL  # noqa: E402
from repro_torch.weights import mlp_params_to_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _gap(what: str, value: float, bar: float) -> None:
    """Assert a parity gap against its bar and print it (pytest -s shows
    the measured gaps; ROADMAP.md Queue 3 records them)."""
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


CASES = {
    # the quickstart: paper Exp I, battery_small, d=2, c=[2,2], n_ij=100
    "quickstart": dict(name="battery_small", n=1500, n_train=400, n_test=1000,
                       c=[2, 2], n_ij=100, m_tilde=4, hidden=(20,), out=1,
                       task="regression", rounds=20, anchor_r=2000),
    # the mnist head 50-500-100-10 at a small layout
    "mnist_head": dict(name="mnist", n=700, n_train=240, n_test=200,
                       c=[2, 2], n_ij=60, m_tilde=50, hidden=(500, 100),
                       out=10, task="classification", rounds=1, anchor_r=500),
}


def _schedule(setup, seed, epochs, batch_size=32):
    """The reference's jax.random minibatch schedule for these silos."""
    n_slots = jfed.pad_silo_data(setup.fed_silos(), batch_size).n_slots
    key = jax.random.PRNGKey(seed)
    d = setup.num_groups
    return lambda rnd: np.asarray(jfed.round_perms(key, rnd, d, epochs, n_slots))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_predict_score_match_reference(case):
    cfg = CASES[case]
    ds = make_dataset(cfg["name"], n=cfg["n"], seed=0)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, cfg["n_train"], cfg["n_test"],
                                              seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d=2, c=cfg["c"], n_ij=cfg["n_ij"], seed=0)
    kw = dict(m_tilde=cfg["m_tilde"], hidden=cfg["hidden"], task=cfg["task"],
              rounds=cfg["rounds"], anchor_r=cfg["anchor_r"],
              svd_backend="host", engine="host", seed=0)
    p0 = jmlp.init_mlp_params(jax.random.PRNGKey(0), cfg["m_tilde"],
                              cfg["hidden"], cfg["out"])
    jm = JFedDCL(**kw)
    jsetup, jres = jm.fit(Xs, Ys, init_params=p0)
    tm = TFedDCL(**kw, device="cpu")
    tsetup, tres = tm.fit(Xs, Ys, init_params=jax.tree.map(np.asarray, p0),
                          schedule=_schedule(jsetup, 0, tm.local_epochs))
    for a, b in zip(tsetup.collab_X, jsetup.collab_X):
        assert np.array_equal(a, b)
    _gap(f"fit losses {case}",
         max(abs(h["loss"] - t["loss"]) / max(1.0, abs(h["loss"]))
             for h, t in zip(jres.history, tres.history)), 1e-4)
    pj = jax.tree.map(np.asarray, jres.params)
    pt = mlp_params_to_numpy(tres.params)
    _gap(f"fit params {case}",
         max(float(np.max(np.abs(a - b))) / max(1.0, float(np.abs(b).max()))
             for a, b in zip(jax.tree_util.tree_leaves(pt),
                             jax.tree_util.tree_leaves(pj))), 1e-4)
    sj, st = jm.score(Xte, Yte), tm.score(Xte, Yte)
    _gap(f"score {case}", abs(st - sj) / max(1.0, abs(sj)), 1e-4)
    assert np.array_equal(tm.transform(Xte[:7], 1, 0), jm.transform(Xte[:7], 1, 0))
    if cfg["task"] == "classification":
        agree = np.mean(tm.predict(Xte) == jm.predict(Xte))
        assert agree >= 0.99
    else:
        assert np.max(np.abs(tm.predict(Xte) - jm.predict(Xte))) <= 1e-4
    # the paper's headline property, through the port's own comm log
    from repro_torch.core import protocol as tp
    h = partial(np.asarray)
    tp.finalize_user_models(tsetup, h)
    trips = tsetup.comm.user_round_trips()
    assert len(trips) == sum(cfg["c"]) and all(v == 2 for v in trips.values())


def test_partial_fit_onboards_and_refits():
    ds = make_dataset("battery_small", n=800, seed=0)
    (Xtr, Ytr), _ = train_test_split(ds, 500, 100, seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d=2, c=[2, 2], n_ij=100, seed=0)
    model = TFedDCL(m_tilde=4, hidden=(8,), rounds=1, local_epochs=1,
                    anchor_r=300, device="cpu")
    model.fit(Xs, Ys)
    assert model.partial_fit(Xtr[400:450], Ytr[400:450], group=1,
                             refit_rounds=1) == (1, 2)
    assert model.setup_.num_users(1) == 3
    assert model.partial_fit([Xtr[450:500]], [Ytr[450:500]]) == (2, 0)
    assert model.setup_.num_groups == 3
    with pytest.raises(RuntimeError, match="fit"):
        TFedDCL(m_tilde=4, device="cpu").partial_fit(Xtr[:5], Ytr[:5], group=0)


def exp2_mnist_accuracy(seeds) -> dict:
    """Test accuracy at the layout chip_smoke.py fits on the card (mnist
    stand-in, d=5 x c=4 x n_ij=100, r=2000, 50-500-100-10, 20 rounds x 4
    epochs, batch 32; data drawn with seed 0), on the CPU: the reference
    (`engine="host"`, host solve) and the port with their own draws at each
    seed (anchor, maps, init, schedule), and the port at seed 0 with the
    reference's init and schedule injected."""
    ds = make_dataset("mnist", n=3200, seed=0)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, 2000, 1000, seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d=5, c=[4] * 5, n_ij=100, seed=0)
    out = {"reference": {}, "port": {}}
    for s in seeds:
        kw = dict(m_tilde=50, hidden=(500, 100), task="classification",
                  rounds=20, anchor_r=2000, svd_backend="host",
                  engine="host", seed=s)
        jm = JFedDCL(**kw)
        jsetup, _ = jm.fit(Xs, Ys)
        out["reference"][s] = jm.score(Xte, Yte)
        tm = TFedDCL(**kw, device="cpu")
        tm.fit(Xs, Ys)
        out["port"][s] = tm.score(Xte, Yte)
        if s == 0:
            p0 = jmlp.init_mlp_params(jax.random.PRNGKey(0), 50, (500, 100), 10)
            tm.fit(Xs, Ys, init_params=jax.tree.map(np.asarray, p0),
                   schedule=_schedule(jsetup, 0, tm.local_epochs))
            out["port_with_reference_draws"] = tm.score(Xte, Yte)
        print(s, out, flush=True)
    return out


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_api.py [SEED ...]
    import json
    import sys
    seeds = [int(a) for a in sys.argv[1:]] or [0, 1, 2, 3, 4]
    print(json.dumps(exp2_mnist_accuracy(seeds)))
