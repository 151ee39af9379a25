"""rwkv6 serving: repro_torch's ssm prefill, decode and BatchedServer
against repro's, with the reference's weights carried over
(``weights.lm_params_from_numpy``) and the same token ids from a seed.

Config: ``REDUCED["rwkv6-3b"]`` (2 layers, d 256, 8 heads of 32, vocab
512). Both sides run fp32. Prefill takes the chunked plain WKV6 form in
both packages (the kernel returns no final state). Bar: 1e-4 relative
(Frobenius) on logits and on each state leaf; the measured gaps print
under ``pytest -s``.

The server differs from the reference on purpose in one place: admission
zeroes an ssm slot's state, where the reference decodes a new prompt from
the state the slot's last request left. So the reference is the oracle
only while every request gets a fresh slot; the freed-slot test holds the
port to a fresh server instead.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REDUCED as JREDUCED  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import REDUCED as TREDUCED  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


ARCH = "rwkv6-3b"
TOL = 1e-4
B, S = 2, 24
STATE = ("wkv", "x_prev_att", "x_prev_ffn")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float = TOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    jc, tc = JREDUCED[ARCH], TREDUCED[ARCH]
    assert tc.family == "ssm" and tc.num_layers == 2
    pj = jbb.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return jc, tc, pj, pt


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_rwkv6_decode_step_matches_reference(model):
    jc, tc, pj, pt = model
    rng = np.random.default_rng(1)
    H, hd, d = tc.num_heads, tc.ssm.head_dim, tc.d_model
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    state = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    xpa, xpf = (rng.standard_normal((B, d)).astype(np.float32)
                for _ in range(2))
    lj = _layer(pj["layers"], 1)
    want = jlayers.rwkv6_decode_step(
        lj["tm"], lj["cm"], jnp.asarray(x), jc, state=jnp.asarray(state),
        x_prev_att=jnp.asarray(xpa), x_prev_ffn=jnp.asarray(xpf),
        norm_att=lj["ln_att"], norm_ffn=lj["ln_ffn"])
    lt = tbb._layers(pt["layers"])[1]
    got = tlayers.rwkv6_decode_step(
        lt["tm"], lt["cm"], torch.as_tensor(x), tc,
        state=torch.as_tensor(state), x_prev_att=torch.as_tensor(xpa),
        x_prev_ffn=torch.as_tensor(xpf), norm_att=lt["ln_att"],
        norm_ffn=lt["ln_ffn"])
    for name, g, w in zip(("out", "state", "x_prev_att", "x_prev_ffn"),
                          got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _gap(f"rwkv6_decode_step {name}", _rel(g, w))


def test_prefill_logits_and_state_match_reference(model):
    jc, tc, pj, pt = model
    tok = _tokens(0)
    lj, sj, nj = jbb.prefill(pj, jnp.asarray(tok), jc, cache_len=S,
                             compute_dtype=jnp.float32)
    lt, st, nt = tbb.prefill(pt, torch.as_tensor(tok), tc, cache_len=S,
                             compute_dtype=torch.float32)
    assert sorted(st) == sorted(STATE) == sorted(sj)
    _gap("rwkv6 prefill logits", _rel(lt, lj))
    for k in STATE:
        assert st[k].dtype == torch.float32 and tuple(st[k].shape) == \
            sj[k].shape
        _gap(f"rwkv6 prefill state {k}", _rel(st[k], sj[k]))
    assert np.array_equal(nt.numpy(), np.asarray(nj))


def test_prefill_runs_no_kernel_whatever_use_kernels_says(model, monkeypatch):
    """Prefill needs the final state, which the WKV6 kernel does not
    return: both settings take the chunked plain form, as the reference."""
    _, tc, _, pt = model
    calls = []
    monkeypatch.setattr(tlayers.rwkv_ops, "wkv6",
                        lambda *a, **k: calls.append(1))
    tok = torch.as_tensor(_tokens(4))
    outs = [tbb.prefill(pt, tok, tc, cache_len=S, use_kernels=u,
                        compute_dtype=torch.float32)[0] for u in (True, False)]
    assert not calls
    assert torch.equal(outs[0], outs[1])


def test_decode_steps_from_empty_state_match_reference(model):
    jc, tc, pj, pt = model
    tok = _tokens(1, s=6)
    sj = jbb.init_decode_state(jc, B, 8)
    st = tbb.init_decode_state(tc, B, 8, device="cpu")
    gaps = {k: 0.0 for k in ("logits",) + STATE}
    for t in range(tok.shape[1]):
        pos = np.full((B,), t, np.int32)
        lj, sj = jbb.decode_step(pj, sj, jnp.asarray(tok[:, t:t + 1]),
                                 jnp.asarray(pos), jc,
                                 compute_dtype=jnp.float32)
        lt, st2 = tbb.decode_step(pt, st, torch.as_tensor(tok[:, t:t + 1]),
                                  torch.as_tensor(pos), tc,
                                  compute_dtype=torch.float32)
        assert st2 is st                    # updated in place
        gaps["logits"] = max(gaps["logits"], _rel(lt, lj))
        for k in STATE:
            gaps[k] = max(gaps[k], _rel(st[k], sj[k]))
    for k, v in gaps.items():
        _gap(f"rwkv6 6 decode steps from empty, {k}", v)


def test_prefill_then_decode_equals_forward(model):
    """Prefill of S−1 tokens then one decode gives forward's last logits
    (reference tests/test_models_smoke.py:62), in both packages."""
    jc, tc, pj, pt = model
    tok = _tokens(2)
    full, _, _ = tbb.forward(pt, torch.as_tensor(tok), tc,
                             compute_dtype=torch.float32)
    pl, st, nxt = tbb.prefill(pt, torch.as_tensor(tok[:, :S - 1]), tc,
                              cache_len=S, compute_dtype=torch.float32)
    _gap("rwkv6 prefill(S-1) vs forward[-2]", _rel(pl[:, 0], full[:, -2]))
    dl, _ = tbb.decode_step(pt, st, torch.as_tensor(tok[:, S - 1:]), nxt, tc,
                            compute_dtype=torch.float32)
    _gap("rwkv6 prefill(S-1)+decode vs forward[-1]",
         _rel(dl[:, 0], full[:, -1]))
    _, sj, nj = jbb.prefill(pj, jnp.asarray(tok[:, :S - 1]), jc, cache_len=S,
                            compute_dtype=jnp.float32)
    jl, _ = jbb.decode_step(pj, sj, jnp.asarray(tok[:, S - 1:]), nj, jc,
                            compute_dtype=jnp.float32)
    _gap("rwkv6 prefill(S-1)+decode vs reference", _rel(dl, jl))


def test_steps_pass_the_ssm_state_through(model):
    """make_prefill_step and make_serve_step need no ssm argument: the
    prefill step returns the state, the serve step takes NumPy and
    advances that state in place."""
    _, tc, _, pt = model
    tok = _tokens(3)
    prefill = tsteps.make_prefill_step(tc, cache_len=S, device="cpu",
                                       compute_dtype=torch.float32)
    serve = tsteps.make_serve_step(tc, device="cpu",
                                   compute_dtype=torch.float32)
    _, state, nxt = prefill(pt, {"tokens": tok[:, :S - 1]})
    before = {k: v.clone() for k, v in state.items()}
    logits, out = serve(pt, state, tok[:, S - 1:], nxt.numpy())
    assert out is state and tuple(logits.shape) == (B, 1, tc.vocab_size)
    assert all(not torch.equal(before[k], state[k]) for k in STATE)
    want, _ = tbb.decode_step(pt, before, torch.as_tensor(tok[:, S - 1:]),
                              nxt, tc, compute_dtype=torch.float32)
    assert torch.equal(logits, want)


def _prompts(seed=0, n=5, vocab=512):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=rng.integers(3, 9))
               for _ in range(n)]
    prompts[2] = np.array([], np.int64)           # an empty prompt
    return prompts


def _requests(mod, prompts, order=None, max_new=6):
    order = range(len(prompts)) if order is None else order
    return [mod.Request(rid=i, prompt=prompts[i], max_new=max_new - (i % 2))
            for i in order]


def test_greedy_server_matches_reference_in_fresh_slots(model):
    """Every request gets a slot no request used before (slots ≥ requests),
    where the reference's server is right: the same tokens and statuses."""
    jc, tc, pj, pt = model
    prompts = _prompts()
    js = jserve.BatchedServer(jc, pj, slots=len(prompts), cache_len=16)
    ts = tserve.BatchedServer(tc, pt, slots=len(prompts), cache_len=16,
                              device="cpu")
    out_j = js.serve(_requests(jserve, prompts))
    out_t = ts.serve(_requests(tserve, prompts))
    assert dict(out_t) == dict(out_j)
    assert out_t.status == out_j.status == {i: "done"
                                            for i in range(len(prompts))}
    assert np.array_equal(ts.pos, np.asarray(js.pos))


def test_freed_slot_serves_as_a_fresh_server(model):
    """A request admitted into a slot another request left gives the same
    tokens as in a fresh server: admission zeroes the slot's ssm state
    (the reference's server decodes it from the leftover state)."""
    jc, tc, pj, pt = model
    prompts = _prompts(seed=1)
    reused = tserve.BatchedServer(tc, pt, slots=1, cache_len=16, device="cpu")
    out = reused.serve(_requests(tserve, prompts))       # one slot, in turn
    assert set(out.status.values()) == {"done"}
    for i, p in enumerate(prompts):
        fresh = tserve.BatchedServer(tc, pt, slots=1, cache_len=16,
                                     device="cpu")
        alone = fresh.serve([tserve.Request(rid=i, prompt=p,
                                            max_new=6 - (i % 2))])
        assert out[i] == alone[i], i
    # the reference's server, on the same queue, carries the last request's
    # recurrence into the next one
    ref = jserve.BatchedServer(jc, pj, slots=1, cache_len=16).serve(
        _requests(jserve, prompts))
    assert ref[0] == out[0] and any(ref[i] != out[i] for i in range(1, 5))


def test_sampling_independent_of_slots_and_order(model):
    """With per-request sampling streams and zeroed slots, what an ssm
    request samples depends neither on the slot count nor on the order of
    admission."""
    _, tc, _, pt = model
    prompts = _prompts(seed=3, n=6)
    runs = []
    for slots, order in [(3, None), (2, None), (4, [5, 2, 0, 1, 4, 3])]:
        server = tserve.BatchedServer(tc, pt, slots=slots, cache_len=16,
                                      temperature=0.8, seed=11, device="cpu")
        out = server.serve(_requests(tserve, prompts, order=order))
        assert set(out.status.values()) == {"done"}
        runs.append(dict(out))
    assert runs[0] == runs[1] == runs[2]


def test_serve_cli_rwkv6_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                 "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "device=cpu" in out
