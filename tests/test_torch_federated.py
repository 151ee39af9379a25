"""Step 4, the federated engine: repro_torch's MLP, optimizers and host
engine against the JAX reference on the same NumPy inputs.

Tolerances: the padded layout and the FedAvg weights are NumPy in both
packages -> bit for bit. One MLP forward / loss and one optimizer step are
fp32 in both -> 1e-6. A whole federated run compounds fp32 rounding over
every step -> 1e-4 relative on params and losses, the reference's own
host==scan bar. Torch cannot reproduce jax.random, so the runs share the
reference's init params (through repro_torch.weights) and its minibatch
schedule (repro.core.federated.round_perms).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import federated as jfed  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import adamw as tadamw, sgd as tsgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _max_rel_diff(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))) /
                     (np.max(np.abs(np.asarray(y))) + 1e-12))
               for x, y in zip(la, lb))


def _gap(what: str, value: float, bar: float) -> None:
    """Assert a parity gap against its bar and print it (pytest -s shows
    the measured gaps; ROADMAP.md Queue 3 records them)."""
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _loss_gap(rj, rt) -> float:
    """Largest per-round loss gap, relative to max(1, |loss|)."""
    return max(abs(h["loss"] - t["loss"]) / max(1.0, abs(h["loss"]))
               for h, t in zip(rj.history, rt.history))


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


@pytest.mark.parametrize("batch_size", [16, None])
def test_padded_layout_and_weights_bit_for_bit(batch_size):
    silos = _silos([40, 28, 52])
    pt = tfed.pad_silo_data(silos, batch_size, fill=3.5, min_silos=4)
    pj = jfed.pad_silo_data(silos, batch_size, fill=3.5, min_silos=4)
    for f in ("X", "Y", "w", "sizes"):
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pt.n_slots, pt.batch_size, pt.num_batches, pt.has_padding) == \
        (pj.n_slots, pj.batch_size, pj.num_batches, pj.has_padding)
    sizes = np.array([40, 28, 52, 0], np.int64)
    assert np.array_equal(tfed._norm_weights(sizes), jfed._norm_weights(sizes))
    av = np.array([[1, 1, 0, 0], [0, 1, 1, 0]], np.float32)
    for a in (None, av):
        assert np.array_equal(tfed._round_weights(sizes, a, 2),
                              jfed._round_weights(sizes, a, 2))
    assert tfed._DEN_EPS == jfed._DEN_EPS


def test_weights_round_trip_exact():
    rng = np.random.default_rng(3)
    dims = [50, 500, 100, 10]                   # the mnist head
    p = {"layers": [{"w": rng.standard_normal((a, b)).astype(np.float32),
                     "b": rng.standard_normal(b).astype(np.float32)}
                    for a, b in zip(dims[:-1], dims[1:])]}
    back = weights.mlp_params_to_numpy(weights.mlp_params_from_numpy(p, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("task,out", [("regression", 2), ("classification", 10)])
def test_mlp_forward_and_per_example_loss(task, out):
    rng = np.random.default_rng(4)
    pj = jmlp.init_mlp_params(jax.random.PRNGKey(0), 50, (64, 32), out)
    pt = weights.mlp_params_from_numpy(_np_tree(pj), "cpu")
    x = rng.standard_normal((37, 50)).astype(np.float32)
    y = (rng.standard_normal((37, out)).astype(np.float32)
         if task == "regression" else rng.integers(0, out, size=37))
    fj = np.asarray(jmlp.mlp_forward(pj, jnp.asarray(x)))
    ft = tmlp.mlp_forward(pt, torch.as_tensor(x)).numpy()
    assert np.max(np.abs(ft - fj)) <= 1e-6 * max(1.0, np.abs(fj).max())
    yt = torch.as_tensor(y)
    lj = np.asarray(jmlp.mlp_per_example_loss(pj, jnp.asarray(x),
                                              jnp.asarray(y), task))
    lt = tmlp.mlp_per_example_loss(pt, torch.as_tensor(x), yt, task).numpy()
    assert lt.shape == (37,)
    assert np.max(np.abs(lt - lj)) <= 1e-6 * max(1.0, np.abs(lj).max())
    mj = jmlp.mlp_metric(pj, jnp.asarray(x), jnp.asarray(y), task)
    mt = tmlp.mlp_metric(pt, torch.as_tensor(x), yt, task)
    assert abs(mt - mj) <= 1e-6 * max(1.0, abs(mj))


@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_optimizer_steps_match(name):
    """Five steps from the same params and grads; each step ≤1e-6."""
    make_j, make_t = {
        "adamw": (lambda: jadamw(1e-2), lambda: tadamw(1e-2)),
        "sgd": (lambda: jsgd(1e-2), lambda: tsgd(1e-2)),
        "sgd_momentum": (lambda: jsgd(1e-2, momentum=0.9),
                         lambda: tsgd(1e-2, momentum=0.9)),
    }[name]
    rng = np.random.default_rng(5)
    pj = _np_tree(jmlp.init_mlp_params(jax.random.PRNGKey(1), 6, (8,), 2))
    pt = weights.mlp_params_from_numpy(pj, "cpu")
    oj, ot = make_j(), make_t()
    sj, st = oj.init(pj), ot.init(pt)
    from repro.optim import apply_updates as japply
    from repro_torch.optim import apply_updates as tapply
    for _ in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pj)
        uj, sj = oj.update(g, sj, pj)
        ut, st = ot.update(weights.mlp_params_from_numpy(g, "cpu"), st, pt)
        pj = _np_tree(japply(pj, uj))
        pt = tapply(pt, ut)
        assert _max_rel_diff(weights.mlp_params_to_numpy(pt), pj) <= 1e-6
    assert int(st["step"]) == int(sj["step"]) == 5


def test_clip_by_global_norm_and_schedules_match():
    from repro.optim import (clip_by_global_norm as jclip, constant as jconst,
                             cosine_with_warmup as jcos)
    from repro_torch.optim import (clip_by_global_norm as tclip,
                                   constant as tconst,
                                   cosine_with_warmup as tcos)
    pj = _np_tree(jmlp.init_mlp_params(jax.random.PRNGKey(2), 6, (8,), 2))
    for max_norm in (0.5, 1e3):                  # clipping, and a no-op
        gj, nj = jclip(pj, max_norm)
        gt, nt = tclip(weights.mlp_params_from_numpy(pj, "cpu"), max_norm)
        assert abs(float(nt) - float(nj)) <= 1e-6 * float(nj)
        assert _max_rel_diff(weights.mlp_params_to_numpy(gt), _np_tree(gj)) <= 1e-6
    js, ts = jcos(1e-2, 10, 100), tcos(1e-2, 10, 100)
    for step in (0, 5, 10, 50, 100, 150):
        assert abs(float(ts(torch.tensor(step))) - float(js(jnp.asarray(step)))) \
            <= 1e-9
    assert float(tconst(3e-4)(7)) == float(jconst(3e-4)(7))


def _run_both(silos, task, out, **kw):
    """The same federated run through both packages' host engines."""
    m = silos[0][0].shape[1]
    pj = jmlp.init_mlp_params(jax.random.PRNGKey(1), m, (8,), out)
    padded = jfed.pad_silo_data(
        silos, None if kw["aggregator"] == "fedsgd" else kw["batch_size"])
    key = jax.random.PRNGKey(kw["seed"])
    sched = lambda rnd: np.asarray(jfed.round_perms(
        key, rnd, len(silos), kw["local_epochs"], padded.n_slots))
    jloss = lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, task)
    tloss = lambda p, x, y: tmlp.mlp_per_example_loss(p, x, y, task)
    rj = jfed.run_federated(jloss, pj, silos, opt=jadamw(1e-2), engine="host",
                            **kw)
    rt = tfed.run_federated(tloss, weights.mlp_params_from_numpy(
        _np_tree(pj), "cpu"), silos, opt=tadamw(1e-2), schedule=sched,
        device="cpu", **kw)
    return rj, rt


@pytest.mark.parametrize("aggregator", ["fedavg", "fedprox", "fedsgd"])
@pytest.mark.parametrize("sizes", [(32, 32), (40, 28, 52)],
                         ids=["equal", "ragged"])
def test_host_engine_matches_reference(aggregator, sizes):
    kw = dict(rounds=4, local_epochs=2, batch_size=16, aggregator=aggregator,
              fedprox_mu=0.1 if aggregator == "fedprox" else 0.0, seed=7)
    rj, rt = _run_both(_silos(list(sizes), seed=3), "regression", 1, **kw)
    _gap(f"host engine params {aggregator} {sizes}",
         _max_rel_diff(weights.mlp_params_to_numpy(rt.params), rj.params), 1e-4)
    assert len(rt.history) == len(rj.history) == 4
    assert [h["round"] for h in rt.history] == [h["round"] for h in rj.history]
    _gap(f"host engine losses {aggregator} {sizes}", _loss_gap(rj, rt), 1e-4)


def test_host_engine_classification_and_eval_matches_reference():
    kw = dict(rounds=3, local_epochs=2, batch_size=16, aggregator="fedavg",
              seed=0, reset_opt_per_round=False)
    silos = _silos([45, 30], m=5, seed=2, task="classification", classes=4)
    rj, rt = _run_both(silos, "classification", 4, **kw)
    _gap("host engine params classification",
         _max_rel_diff(weights.mlp_params_to_numpy(rt.params), rj.params), 1e-4)
    _gap("host engine losses classification", _loss_gap(rj, rt), 1e-4)


def test_port_schedule_and_unported_options():
    silos = _silos([20, 12])
    gen = torch.Generator().manual_seed(0)
    p = tmlp.init_mlp_params(gen, 4, (8,), 1, device="cpu")
    loss = lambda p, x, y: tmlp.mlp_per_example_loss(p, x, y, "regression")
    kw = dict(opt=tadamw(1e-2), rounds=2, local_epochs=2, batch_size=8,
              device="cpu")
    a = tfed.run_federated(loss, p, silos, seed=1, **kw)
    b = tfed.run_federated(loss, p, silos, seed=1, **kw)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)             # own schedule: seeded, repeatable
    perms = tfed.round_perms(1, 0, 2, 2, 24)
    assert perms.shape == (2, 2, 24)
    assert all(sorted(r) == list(range(24)) for r in perms.reshape(-1, 24))
    with pytest.raises(ValueError, match="schedule must be"):
        tfed.run_federated(loss, p, silos, schedule=np.zeros((1, 2, 2, 24)),
                           **kw)
    # mesh= (tests/test_torch_sharded.py runs it on ranks) needs the scan
    # engine, as the reference's does, and a mesh of ranks
    with pytest.raises(ValueError, match="scan"):
        tfed.run_federated(loss, p, silos, mesh=object(), **kw)
    with pytest.raises(TypeError, match="HostMesh"):
        tfed.run_federated(loss, p, silos, mesh=object(), engine="scan",
                           **kw)
