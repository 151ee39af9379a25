"""BatchedServer: repro_torch.launch.serve against repro.launch.serve with
the same weights (carried over with ``weights.lm_params_from_numpy``).

Greedy decoding must give the reference's tokens and statuses exactly: 8
requests on 4 slots, an empty prompt, slot reuse across the queue, a ring
cache shorter than the longest sequence, and a `max_steps` cut. With
temperature > 0 the port draws from a host generator seeded by (seed,
request id, tokens emitted so far), so its output must not depend on the
slot count or the admission order. The slot-table invariants of the
reference's tests/test_serve.py hold as well.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED as JREDUCED  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch.configs import REDUCED as TREDUCED  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


OVERRIDES = {"llama3.2-1b": dict(num_kv_heads=2),
             "gemma2-2b": dict(sliding_window=8)}


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def model(request):
    arch = request.param
    jc = JREDUCED[arch].with_overrides(**OVERRIDES[arch])
    tc = TREDUCED[arch].with_overrides(**OVERRIDES[arch])
    pj = jbb.init_params(jc, jax.random.PRNGKey(1), jnp.float32)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return jc, tc, pj, pt


def _prompts(seed=0, n=8, vocab=512):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=rng.integers(4, 12))
               for _ in range(n)]
    prompts[3] = np.array([], np.int64)          # an empty prompt
    return prompts


def _requests(mod, prompts, order=None):
    order = range(len(prompts)) if order is None else order
    return [mod.Request(rid=i, prompt=prompts[i], max_new=3 + 7 * (i % 2))
            for i in order]


@pytest.mark.parametrize("max_steps", [10_000, 6])
def test_greedy_matches_reference(model, max_steps):
    jc, tc, pj, pt = model
    prompts = _prompts()
    kw = dict(slots=4, cache_len=16)     # 16 < 11 prompt + 10 new: ring wraps
    js = jserve.BatchedServer(jc, pj, **kw)
    ts = tserve.BatchedServer(tc, pt, device="cpu", **kw)
    out_j = js.serve(_requests(jserve, prompts), max_steps=max_steps)
    out_t = ts.serve(_requests(tserve, prompts), max_steps=max_steps)
    assert dict(out_t) == dict(out_j)
    assert out_t.status == out_j.status
    want = {"done"} if max_steps > 100 else {"done", "truncated", "pending"}
    assert set(out_t.status.values()) == want, out_t.status
    assert np.array_equal(ts.pos, np.asarray(js.pos))
    assert np.array_equal(ts.cur_tok, np.asarray(js.cur_tok))


def test_sampling_independent_of_slots_and_order(model):
    _, tc, _, pt = model
    prompts = _prompts(seed=3)
    runs = []
    for slots, order in [(4, None), (2, None), (3, [5, 2, 7, 0, 1, 6, 3, 4])]:
        server = tserve.BatchedServer(tc, pt, slots=slots, cache_len=32,
                                      temperature=0.8, seed=11, device="cpu")
        out = server.serve(_requests(tserve, prompts, order=order))
        assert set(out.status.values()) == {"done"}
        runs.append(dict(out))
    assert runs[0] == runs[1] == runs[2]
    other = tserve.BatchedServer(tc, pt, slots=4, cache_len=32,
                                 temperature=0.8, seed=12, device="cpu")
    assert dict(other.serve(_requests(tserve, prompts))) != runs[0]


TINY = dataclasses.replace(TREDUCED["llama3.2-1b"], num_layers=1, d_model=64,
                           num_heads=2, num_kv_heads=2, head_dim=32,
                           d_ff=128, vocab_size=64)


@pytest.fixture(scope="module")
def tiny_params():
    gen = torch.Generator().manual_seed(0)
    return tbb.init_params(TINY, gen, torch.float32, device="cpu")


def test_idle_slots_hold_position_and_released_slot_resets(tiny_params):
    server = tserve.BatchedServer(TINY, tiny_params, slots=3, cache_len=32,
                                  device="cpu")
    outs = server.serve([tserve.Request(rid=0, prompt=np.array([1, 2, 3]),
                                        max_new=6)])
    assert len(outs[0]) == 6 and outs.status == {0: "done"}
    assert list(server.pos) == [0, 0, 0]
    assert int(server.cur_tok[0, 0]) == 0
    assert server.active == [None, None, None]


def test_slot_reuse_and_empty_prompt(tiny_params):
    server = tserve.BatchedServer(TINY, tiny_params, slots=2, cache_len=32,
                                  device="cpu")
    reqs = [tserve.Request(rid=i, prompt=np.arange(i % 3), max_new=3)
            for i in range(5)]
    outs = server.serve(reqs)
    assert all(len(outs[i]) == 3 for i in range(5))
    assert all(0 <= t < TINY.vocab_size for v in outs.values() for t in v)


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "device=cpu" in out
