"""The scan engine's plan cache (repro_torch.core.federated.PlanCache), as
tests/test_plan_cache.py holds the reference's: warm hits agree with cold
runs bitwise, the counters record exactly the plans built, distinct
configs never alias, eviction is LRU, chunk plans are rounds-agnostic, and
a cached run agrees with the reference's cached run on the bucketed layout
within the reference's engine bar (1e-4, relative to max(1, |x|)). On the
CPU no graph is captured, so `captures` and `replays` stay 0.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import federated as jfed  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core.federated import PlanCache, bucket_pow2  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

M = 6          # raw feature dim of the toy tenants


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _silos(d, n, seed=0):
    r = np.random.default_rng(seed)
    wt = r.standard_normal((M, 1))
    out = []
    for i in range(d):
        X = r.standard_normal((n + 3 * i, M))            # ragged on purpose
        out.append((X, X @ wt + 0.01 * r.standard_normal((n + 3 * i, 1))))
    return out


def _jparams(seed=0):
    return jmlp.init_mlp_params(jax.random.PRNGKey(seed), M, (8,), 1)


def _params(seed=0):
    return weights.mlp_params_from_numpy(
        jax.tree.map(np.asarray, _jparams(seed)), "cpu")


def _loss(p, x, y):
    return tmlp.mlp_per_example_loss(p, x, y, "regression")


KW = dict(rounds=2, local_epochs=1, batch_size=8, engine="scan",
          loss_id=("mlp_per_example_loss", "regression"),
          opt_id=("adamw", 1e-2), device="cpu")


def _run(silos, cache, **over):
    kw = {**KW, **over}
    return tfed.run_federated(_loss, _params(), silos, opt=adamw(1e-2),
                              cache=cache, **kw)


def _flat(result):
    return torch.cat([l.reshape(-1) for l in tree_leaves(result.params)])


# ---------------------------------------------------------------------------
# correctness: warm == cold, cached scan == the reference's cached scan
# ---------------------------------------------------------------------------

def test_warm_hit_agrees_with_cold_run():
    cache = PlanCache()
    first = _run(_silos(3, 20, seed=0), cache)
    assert first.cache_stats["hit"] is False
    tenant = _silos(3, 22, seed=1)           # new tenant, same shape bucket
    warm = _run(tenant, cache)
    assert warm.cache_stats["hit"] is True
    cold = _run(tenant, PlanCache())         # fresh cache: a new plan
    assert cold.cache_stats["hit"] is False
    assert torch.equal(_flat(warm), _flat(cold))
    assert [h["loss"] for h in warm.history] == \
        [h["loss"] for h in cold.history]


def test_cached_scan_matches_reference_cached_scan_on_bucketed_layout():
    """Both packages' cached scan engines on the same bucketed layout (3
    silos -> 4, 4 batches of 8), the reference's round_perms at that layout
    injected into the port."""
    silos = _silos(3, 20, seed=0)
    rj = jfed.run_federated(
        lambda p, x, y: jmlp.mlp_per_example_loss(p, x, y, "regression"),
        _jparams(), silos, opt=jadamw(1e-2), cache=jfed.PlanCache(),
        **{k: v for k, v in KW.items() if k != "device"})
    bs = KW["batch_size"]
    n_max = max(x.shape[0] for x, _ in silos)
    padded = tfed.padded_layout(silos, batch_size=bs, cache=PlanCache())
    assert (padded.num_silos, padded.n_slots) == \
        (bucket_pow2(3), bs * bucket_pow2(-(-n_max // bs)))
    key = jax.random.PRNGKey(0)
    sched = np.stack([np.asarray(jfed.round_perms(
        key, r, padded.num_silos, 1, padded.n_slots)) for r in range(2)])
    rt = _run(silos, PlanCache(), schedule=sched)
    gap = max(float(np.max(np.abs(a - np.asarray(b))))
              / max(1.0, float(np.abs(np.asarray(b)).max()))
              for a, b in zip(tree_leaves(weights.mlp_params_to_numpy(
                  rt.params)), jax.tree_util.tree_leaves(rj.params)))
    print(f"parity-gap cached scan vs reference cached scan: {gap:.2e} "
          "(bar 1e-04)")
    assert gap <= 1e-4
    for a, b in zip(rt.history, rj.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * max(1.0, abs(b["loss"]))


def test_cached_scan_matches_host_on_bucketed_layout():
    silos = _silos(3, 20, seed=0)
    res = _run(silos, PlanCache())
    padded = tfed.padded_layout(silos, batch_size=8, cache=PlanCache())
    # the host engine on the same bucketed layout and the schedule the
    # cached run drew (the port's own, from seed 0)
    data = tfed._to_device(padded, torch.device("cpu"))
    host = tfed._run_host(
        tfed._make_batch_loss(_loss, True, 0.0), _params(), padded, data,
        opt=adamw(1e-2), rounds=2, local_epochs=1, aggregator="fedavg",
        schedule=lambda r: tfed.round_perms(0, r, 4, 1, 32), eval_fn=None,
        per_example=True, reset_opt=True, masked=True,
        device=torch.device("cpu"))
    np.testing.assert_allclose(_flat(res).numpy(), _flat(host).numpy(),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# counters, bucket sharing, aliasing, eviction
# ---------------------------------------------------------------------------

def test_counters_and_bucket_sharing():
    cache = PlanCache()
    r1 = _run(_silos(3, 20, seed=0), cache)      # d=3 -> silo bucket 4
    r2 = _run(_silos(4, 18, seed=1), cache)      # d=4 -> same bucket, hits
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0,
                             "plans": 1, "captures": 0, "replays": 0}
    assert r1.cache_stats["hit"] is False and r2.cache_stats["hit"] is True


def test_distinct_configs_never_alias():
    cache = PlanCache()
    silos = _silos(3, 20, seed=0)
    base = _run(silos, cache)
    prox = _run(silos, cache, aggregator="fedprox", fedprox_mu=0.1)
    carry = _run(silos, cache, reset_opt_per_round=False)
    med = _run(silos, cache, aggregator="median")
    trim = _run(silos, cache, aggregator="trimmed_mean", trim_frac=0.3)
    s = cache.stats()
    assert s["misses"] == 5 and s["hits"] == 0 and s["plans"] == 5
    again = _run(silos, cache)                   # base config now hits
    assert again.cache_stats["hit"] is True
    assert torch.equal(_flat(again), _flat(base))
    # the configs genuinely train differently: aliasing would silently
    # collapse them onto one plan
    for other in (prox, carry, med, trim):
        assert not torch.allclose(_flat(base), _flat(other))


def test_lru_eviction():
    cache = PlanCache(max_plans=1)
    _run(_silos(2, 10, seed=0), cache)           # bucket (2 silos, 2 batches)
    _run(_silos(3, 20, seed=1), cache)           # bucket (4, 4) -> evicts
    assert cache.stats()["evictions"] == 1 and len(cache) == 1
    r = _run(_silos(2, 10, seed=0), cache)       # evicted -> rebuilds
    assert r.cache_stats["hit"] is False


def test_chunk_mode_plan_is_rounds_agnostic():
    """With eval_fn the cached plan's key has no rounds: a rounds=3 and a
    rounds=5 run share ONE plan, and the shared plan trains the same
    prefix round for round."""
    cache = PlanCache()
    silos = _silos(3, 20, seed=0)
    ev = lambda p: {"w0": float(tree_leaves(p)[0].reshape(-1)[0])}
    r3 = _run(silos, cache, rounds=3, eval_fn=ev)
    r5 = _run(silos, cache, rounds=5, eval_fn=ev)
    assert r3.cache_stats["hit"] is False
    assert r5.cache_stats["hit"] is True
    assert cache.stats()["plans"] == 1
    assert len(r3.history) == 3 and len(r5.history) == 5
    for a, b in zip(r3.history, r5.history):
        assert a == b


def test_cache_requires_scan_engine():
    with pytest.raises(ValueError, match="engine='scan'"):
        _run(_silos(2, 10), PlanCache(), engine="host")


def test_default_cache_helpers():
    tfed.clear_plan_cache()
    assert tfed.plan_cache_stats()["plans"] == 0
    res = _run(_silos(2, 10, seed=3), True)
    assert res.cache_stats["misses"] == 1
    assert tfed.plan_cache_stats() == tfed.default_plan_cache().stats()
    tfed.clear_plan_cache()
    assert tfed.plan_cache_stats()["misses"] == 0


def test_plan_is_not_reentrant():
    """An eval_fn that trains on the same cached plan while it runs is
    refused."""
    cache = PlanCache()
    silos = _silos(2, 10, seed=0)

    def ev(p):
        _run(silos, cache, eval_fn=lambda q: {})
        return {}

    with pytest.raises(RuntimeError, match="already running"):
        _run(silos, cache, eval_fn=ev)
    _run(silos, cache, eval_fn=lambda q: {})    # the plan is free again


# ---------------------------------------------------------------------------
# sample counts stay integral (float32 counts corrupt above 2^24)
# ---------------------------------------------------------------------------

def test_sample_counts_stay_integral():
    padded = tfed.pad_silo_data(_silos(3, 20), 8, min_silos=4)
    assert np.issubdtype(padded.sizes.dtype, np.integer)
    assert padded.sizes.tolist() == [20, 23, 26, 0]   # bucket silo: size 0
    big = np.array([2 ** 24 + 1, 2 ** 24], np.int64)
    assert np.float32(big[0]) == np.float32(big[1])    # the hazard
    w = tfed._norm_weights(big)
    assert w.dtype == np.float32
    assert abs(float(w.sum()) - 1.0) < 1e-6
    np.testing.assert_allclose(tfed._norm_weights(np.array([1, 3])),
                               [0.25, 0.75], rtol=0)
    assert np.array_equal(tfed._norm_weights(big), jfed._norm_weights(big))
