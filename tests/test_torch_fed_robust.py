"""The hostile-world round boundary of the port (robust aggregators, silo
dropout, per-silo delta scaling) and the modules built on the engine
(core/baselines.py, core/privacy.py), against the JAX reference on the
same NumPy inputs.

Tolerances: the masked statistics are one fp32 sort / sum each -> 1e-6
(Krum's index exactly); host NumPy code (the dropout schedule, the round
weights, the privacy metrics, the attack constructors, the DC set-up) is bit
for bit or float64-close; whole federated runs -> 1e-4 relative to
max(1, |x|), the reference's engine-agreement bar.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import mappings as jmap  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import mappings as tmap  # noqa: E402
from repro_torch.core import privacy as tpriv  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

BAR = 1e-4
STAT_BAR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _gap(what: str, value: float, bar: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _np(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return weights.mlp_params_to_numpy(tree)
    return jax.tree.map(np.asarray, tree)


def _param_gap(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) / max(1.0, float(np.abs(y).max()))
               for x, y in zip(jax.tree_util.tree_leaves(_np(a)),
                               jax.tree_util.tree_leaves(_np(b))))


def _loss_gap(ra, rb) -> float:
    assert len(ra.history) == len(rb.history)
    return max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
               for a, b in zip(ra.history, rb.history))


def _silos(sizes, m=4, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, 1))
    out = []
    for k, n in enumerate(sizes):
        r = np.random.default_rng(seed * 97 + k + 1)
        X = r.standard_normal((n, m))
        out.append((X, X @ w + 0.01 * r.standard_normal((n, 1))))
    return out


def _jparams(m=4, seed=0):
    return jmlp.init_mlp_params(jax.random.PRNGKey(seed), m, (8,), 1)


MASKS = {"all": [1, 1, 1, 1, 1, 1], "one-out": [1, 1, 0, 1, 1, 1],
         "two-left": [0, 1, 0, 0, 1, 0], "one-left": [0, 0, 0, 1, 0, 0]}


def _stat_inputs(mask_name, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((6, 3, 2)).astype(np.float32)
    v[4] *= 40.0                                       # one outlier silo
    return v, np.asarray(MASKS[mask_name], np.float32)


# --------------------------------------------------------------------------
# masked statistics against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_masked_median_and_trimmed_mean_match_reference(mask_name):
    v, mask = _stat_inputs(mask_name)
    got = tfed.masked_median(torch.as_tensor(v), torch.as_tensor(mask))
    want = np.asarray(jfed.masked_median(jnp.asarray(v), jnp.asarray(mask)))
    _gap(f"masked_median {mask_name}", float(np.abs(got.numpy() - want).max()),
         STAT_BAR)
    for frac in (0.0, 0.2, 0.34, 0.5):
        got = tfed.masked_trimmed_mean(torch.as_tensor(v),
                                       torch.as_tensor(mask), frac)
        want = np.asarray(jfed.masked_trimmed_mean(
            jnp.asarray(v), jnp.asarray(mask), frac))
        _gap(f"masked_trimmed_mean {mask_name} {frac}",
             float(np.abs(got.numpy() - want).max()), STAT_BAR)


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("krum_f", [0, 1, 2])
def test_krum_select_matches_reference(mask_name, krum_f):
    rng = np.random.default_rng(3)
    flat = rng.standard_normal((6, 11)).astype(np.float32)
    flat[2] += 25.0                                    # far from the rest
    mask = np.asarray(MASKS[mask_name], np.float32)
    got = tfed.krum_select(torch.as_tensor(flat), torch.as_tensor(mask),
                           krum_f)
    want = jfed.krum_select(jnp.asarray(flat), jnp.asarray(mask), krum_f)
    assert int(got) == int(want)
    assert mask[int(got)] > 0


@pytest.mark.parametrize("aggregator", list(tfed.ROBUST_AGGREGATORS))
def test_robust_aggregate_and_sync_match_reference(aggregator):
    rng = np.random.default_rng(4)
    tree = {"layers": [{"w": rng.standard_normal((5, 4, 3)).astype(np.float32),
                        "b": rng.standard_normal((5, 3)).astype(np.float32)}]}
    tree["layers"][0]["w"][1] += 30.0
    mask = np.asarray([1, 1, 1, 0, 1], np.float32)
    kw = dict(trim_frac=0.25, krum_f=1)
    t_tree = weights.params_from_numpy(tree, "cpu")
    got = tfed.robust_aggregate(t_tree, torch.as_tensor(mask), aggregator,
                                **kw)
    want = jfed.robust_aggregate(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(mask), aggregator, **kw)
    _gap(f"robust_aggregate {aggregator}", _param_gap(got, want), STAT_BAR)
    got = tfed.robust_sync(t_tree, aggregator, torch.as_tensor(mask), **kw)
    want = jfed.robust_sync(jax.tree.map(jnp.asarray, tree), aggregator,
                            jnp.asarray(mask), **kw)
    assert tree_leaves(got)[0].shape == (5, 4, 3)
    _gap(f"robust_sync {aggregator}", _param_gap(got, want), STAT_BAR)
    with pytest.raises(ValueError, match="robust aggregator"):
        tfed.robust_aggregate(t_tree, torch.as_tensor(mask), "fedfoo")


def test_fedavg_sync_and_silo_primitives_match_reference():
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    wts = np.asarray([1.0, 2.0, 0.0, 5.0], np.float32)
    t_tree = weights.params_from_numpy(tree, "cpu")
    j_tree = jax.tree.map(jnp.asarray, tree)
    for w in (None, wts):
        got = tfed.fedavg_sync(t_tree, None if w is None else torch.as_tensor(w))
        want = jfed.fedavg_sync(j_tree, None if w is None else jnp.asarray(w))
        _gap("fedavg_sync", _param_gap(got, want), STAT_BAR)
    assert _param_gap(tfed.robust_sync(t_tree, "fedavg"),
                      jfed.robust_sync(j_tree, "fedavg")) <= STAT_BAR
    avg = tfed.fedavg_average([{"w": t_tree["w"][i]} for i in range(4)], wts)
    want = jfed.fedavg_average([{"w": j_tree["w"][i]} for i in range(4)], wts)
    _gap("fedavg_average", _param_gap(avg, want), STAT_BAR)
    rep = tfed.silo_replicate({"w": t_tree["w"][0]}, 3)
    assert rep["w"].shape == (3, 3, 2) and torch.equal(rep["w"][2],
                                                       t_tree["w"][0])
    # H local steps in order, vmapped over silos
    step = tfed.silo_vmap_step(lambda p, o, b: (p + b, o + 1, (p * b).sum()))
    sp, so, ms = tfed.scan_local_steps(
        step, t_tree["w"], torch.zeros(4), torch.ones((3, 4, 3, 2)))
    assert torch.allclose(sp, t_tree["w"] + 3)
    assert torch.equal(so, torch.full((4,), 3.0))
    assert ms.shape == (3, 4)


def test_apply_silo_scale_is_exact_noop_at_one():
    rng = np.random.default_rng(6)
    sp = {"w": torch.as_tensor(rng.standard_normal((3, 4, 2)).astype(np.float32))}
    ref = {"w": torch.as_tensor(rng.standard_normal((4, 2)).astype(np.float32))}
    same = tfed.apply_silo_scale(sp, ref, torch.ones(3))
    assert torch.equal(same["w"], sp["w"])
    scale = np.asarray([1.0, -5.0, 0.5], np.float32)
    got = tfed.apply_silo_scale(sp, ref, torch.as_tensor(scale))
    want = jfed.apply_silo_scale({"w": jnp.asarray(sp["w"].numpy())},
                                 {"w": jnp.asarray(ref["w"].numpy())},
                                 jnp.asarray(scale))
    _gap("apply_silo_scale", _param_gap(got, want), STAT_BAR)
    assert torch.equal(got["w"][0], sp["w"][0])


# --------------------------------------------------------------------------
# host NumPy: the dropout schedule and the per-round weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(0, 0.3), (11, 0.9), (5, 0.0)])
def test_dropout_schedule_bit_for_bit(seed, rate):
    for sizes in (None, np.array([40, 0, 28, 52, 0])):
        n = 5
        a = tfed.make_dropout_schedule(seed, 12, n, rate, sizes=sizes)
        b = jfed.make_dropout_schedule(seed, 12, n, rate, sizes=sizes)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.all(a.sum(1) >= 1)
        if sizes is not None:
            assert not a[:, sizes == 0].any()
    with pytest.raises(ValueError, match="real silo"):
        tfed.make_dropout_schedule(0, 2, 2, 0.5, sizes=np.zeros(2))


def test_round_weights_with_availability_bit_for_bit():
    sizes = np.array([40, 28, 52, 0], np.int64)
    av = tfed.make_dropout_schedule(3, 6, 4, 0.5, sizes=sizes)
    assert np.array_equal(tfed._round_weights(sizes, av, 6),
                          jfed._round_weights(sizes, av, 6))
    full = tfed._round_weights(sizes, None, 2)
    assert np.array_equal(full[0], tfed._norm_weights(sizes))
    with pytest.raises(ValueError, match="zero available sample mass"):
        tfed._round_weights(sizes, np.array([[0, 0, 0, 1]], np.float32), 1)


# --------------------------------------------------------------------------
# both engines against the reference's host engine: all six aggregators,
# with dropout and one scaled silo
# --------------------------------------------------------------------------

@pytest.mark.parametrize("aggregator", list(tfed.AGGREGATORS))
def test_engines_match_reference_host_under_dropout_and_scaling(aggregator):
    silos = _silos([40, 28, 52, 33], seed=3)
    kw = dict(rounds=3, local_epochs=2, batch_size=16, aggregator=aggregator,
              seed=7, trim_frac=0.25, krum_f=1, dropout_rate=0.3,
              silo_scale=[1.0, -5.0, 1.0, 1.0],
              fedprox_mu=0.1 if aggregator == "fedprox" else 0.0)
    pj = _jparams(seed=1)
    rj = jfed.run_federated(
        lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, "regression"),
        pj, silos, opt=jadamw(1e-2), engine="host", **kw)
    padded = jfed.pad_silo_data(
        silos, None if aggregator == "fedsgd" else 16)
    key = jax.random.PRNGKey(7)
    sched = lambda r: np.asarray(jfed.round_perms(key, r, 4, 2, padded.n_slots))
    tloss = lambda p, x, y: tmlp.mlp_per_example_loss(p, x, y, "regression")
    for engine in ("host", "scan"):
        rt = tfed.run_federated(
            tloss, weights.mlp_params_from_numpy(_np(pj), "cpu"), silos,
            opt=tadamw(1e-2), engine=engine, schedule=sched, device="cpu",
            **kw)
        _gap(f"{engine} vs reference host params {aggregator}",
             _param_gap(rt.params, rj.params), BAR)
        _gap(f"{engine} vs reference host losses {aggregator}",
             _loss_gap(rt, rj), BAR)


def test_silo_scale_ones_is_bitwise_noop_and_options_checked():
    silos = _silos([32, 32, 32], seed=6)
    p = weights.mlp_params_from_numpy(_np(_jparams(seed=3)), "cpu")
    loss = lambda q, x, y: tmlp.mlp_per_example_loss(q, x, y, "regression")
    kw = dict(opt=tadamw(1e-2), rounds=2, local_epochs=1, batch_size=16,
              aggregator="median", engine="scan", device="cpu")
    plain = tfed.run_federated(loss, p, silos, **kw)
    ones = tfed.run_federated(loss, p, silos, silo_scale=[1.0] * 3, **kw)
    for a, b in zip(tree_leaves(plain.params), tree_leaves(ones.params)):
        assert torch.equal(a, b)
    av = np.ones((2, 3), np.float32)
    with pytest.raises(ValueError, match="not both"):
        tfed.run_federated(loss, p, silos, availability=av, dropout_rate=0.1,
                           **kw)
    with pytest.raises(ValueError, match="availability must be"):
        tfed.run_federated(loss, p, silos, availability=av[:1], **kw)
    with pytest.raises(ValueError, match="silo_scale has"):
        tfed.run_federated(loss, p, silos, silo_scale=[1.0] * 4, **kw)
    # an explicit availability matrix equals the same dropout schedule
    sched = tfed.make_dropout_schedule(0, 2, 3, 0.5)
    a = tfed.run_federated(loss, p, silos, availability=sched, seed=0, **kw)
    b = tfed.run_federated(loss, p, silos, dropout_rate=0.5, seed=0, **kw)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_grad_scale_attack_breaks_fedavg_not_median():
    """The attack harness end to end on the port: one silo submitting
    −5× its delta wrecks FedAvg, and the median boundary shrugs it off (the
    reference's bound: robust ≤ 0.5× fedavg, and near the clean run)."""
    silos = _silos([48] * 5, seed=9)
    p = weights.mlp_params_from_numpy(_np(_jparams(seed=4)), "cpu")
    loss = lambda q, x, y: tmlp.mlp_per_example_loss(q, x, y, "regression")
    kw = dict(opt=tadamw(1e-2), rounds=8, local_epochs=2, batch_size=16,
              seed=17, engine="scan", device="cpu")
    _, scale = tpriv.apply_attack(
        silos, tpriv.SiloAttack(corrupted=(2,), kind="grad_scale"))
    bad = tfed.run_federated(loss, p, silos, aggregator="fedavg",
                             silo_scale=scale, **kw).history[-1]["loss"]
    good = tfed.run_federated(loss, p, silos, aggregator="median",
                              silo_scale=scale, **kw).history[-1]["loss"]
    clean = tfed.run_federated(loss, p, silos, aggregator="fedavg",
                               **kw).history[-1]["loss"]
    assert good <= 0.5 * bad
    assert good <= 2.0 * clean + 0.1


# --------------------------------------------------------------------------
# baselines and privacy: the port's own copies
# --------------------------------------------------------------------------

def test_sgd_train_matches_reference():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((50, 4))
    Y = X @ rng.standard_normal((4, 1))
    pj = _jparams(seed=2)
    ev_j = lambda q: {"m": float(jmlp.mlp_metric(q, jnp.asarray(X, jnp.float32),
                                                 jnp.asarray(Y), "regression"))}
    kw = dict(epochs=3, batch_size=16, seed=4)
    pjo, hj = jbase.sgd_train(
        lambda q, x, y: jmlp.mlp_per_example_loss(q, x, y, "regression"),
        pj, X, Y, opt=jadamw(1e-2), eval_fn=ev_j, **kw)
    key = jax.random.PRNGKey(4)
    sched = lambda r: np.asarray(jfed.round_perms(key, r, 1, 1, 64))
    Xt = torch.as_tensor(X, dtype=torch.float32)
    Yt = torch.as_tensor(Y, dtype=torch.float32)
    ev_t = lambda q: {"m": tmlp.mlp_metric(q, Xt, Yt, "regression")}
    for engine in ("host", "scan"):
        pto, ht = tbase.sgd_train(
            lambda q, x, y: tmlp.mlp_per_example_loss(q, x, y, "regression"),
            weights.mlp_params_from_numpy(_np(pj), "cpu"), X, Y,
            opt=tadamw(1e-2), eval_fn=ev_t, engine=engine, schedule=sched,
            device="cpu", **kw)
        _gap(f"sgd_train {engine} params", _param_gap(pto, pjo), BAR)
        assert [h["epoch"] for h in ht] == [h["epoch"] for h in hj] == [0, 1, 2]
        for a, b in zip(ht, hj):
            assert abs(a["loss"] - b["loss"]) <= BAR * max(1.0, abs(b["loss"]))
            assert abs(a["m"] - b["m"]) <= BAR * max(1.0, abs(b["m"]))


def test_dc_setup_matches_reference():
    rng = np.random.default_rng(9)
    Xs = [rng.standard_normal((30 + 5 * u, 7)) for u in range(3)]
    kw = dict(m_tilde=3, anchor_r=40, seed=2)
    mt, gt, xt = tbase.dc_setup(Xs, **kw)
    mj, gj, xj = jbase.dc_setup(Xs, **kw)
    for a, b in zip(mt, mj):
        assert np.array_equal(a.W, b.W) and np.array_equal(a.mu, b.mu)
    for a, b in zip(gt + xt, gj + xj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_privacy_metrics_and_attacks_match_reference():
    rng = np.random.default_rng(10)
    X = rng.standard_normal((60, 8)) @ rng.standard_normal((8, 8))
    ft = tmap.fit_mapping("pca_rot", X, 3, seed=1)
    fj = jmap.fit_mapping("pca_rot", X, 3, seed=1)
    assert tpriv.evaluate(X, ft, seed=2) == jpriv.evaluate(X, fj, seed=2)
    silos = _silos([6, 5, 7], seed=1)
    cls = [(x, np.arange(len(x)) % 3) for x, _ in silos]
    for data, attack in (
            (silos, dict(corrupted=(1,), kind="grad_scale", scale=-3.0)),
            (silos, dict(corrupted=(0, 2), kind="label_flip")),
            (cls, dict(corrupted=(1,), kind="label_flip", num_classes=3)),
            (silos, dict(corrupted=(), kind="grad_scale")),
            (silos, dict())):
        dt, st = tpriv.apply_attack(data, tpriv.SiloAttack(**attack))
        dj, sj = jpriv.apply_attack(data, jpriv.SiloAttack(**attack))
        assert (st is None) == (sj is None)
        if st is not None:
            assert np.array_equal(st, sj) and st.dtype == sj.dtype
        for (a, b), (c, e) in zip(dt, dj):
            assert np.array_equal(a, c) and np.array_equal(b, e)
            assert b.dtype == e.dtype
    assert np.array_equal(tpriv.grad_scale_vector(4, [0, 3], -2.0),
                          jpriv.grad_scale_vector(4, [0, 3], -2.0))
    with pytest.raises(ValueError, match="out of range"):
        tpriv.grad_scale_vector(2, [2])
    with pytest.raises(ValueError, match="attack kind"):
        tpriv.SiloAttack(kind="what")
