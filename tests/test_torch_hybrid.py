"""The hybrid family: repro_torch's Mamba2 layers (the causal conv, the
chunked SSD scan, full-sequence and single-token decode), the hybrid
backbone, the steps and the server against the JAX reference's, with the
reference's weights carried over (``weights.lm_params_from_numpy``) and
inputs made from a seed with NumPy.

Configs: ``REDUCED["zamba2-1.2b"]`` (3 Mamba2 blocks at period 2: one
round, the shared block, one trailing block; d 256, 16 SSD heads of 32,
state 16, chunk 16) and the same config at ``num_layers=4`` (two rounds,
two shared applications, no trailing block). S = 40 is not a multiple of
the chunk, so the last chunk is padded. Both sides run fp32; the port runs
its kernel path (on the CPU, the flash kernel's plain version), the
reference ``use_pallas=False`` (its kernel-path forward raises under remat,
ROADMAP Queue 3). Bar: 1e-4 relative (Frobenius; the largest leaf of a
tree), as the other LM tests. The measured gaps print under ``pytest -s``
as ``parity-gap`` lines.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.federated import silo_replicate as jsilo_replicate  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import FederatedConfig, TrainConfig  # noqa: E402
from repro_torch.core.federated import silo_replicate  # noqa: E402
from repro_torch.data.tokens import TokenStream, silo_batches  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
ZAMBA = "zamba2-1.2b"
B, S = 2, 40
F32J = dict(compute_dtype=jnp.float32)
F32T = dict(compute_dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and one BLAS thread for NumPy: the
    tensors here are small, and beside the suite's other parallel workers
    a pool of threads only stalls on its barriers."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:                # no BLAS pool to cap
        threadpool_limits = contextlib.nullcontext
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


CONFIGS = {"tail": 3, "rounds2": 4}      # num_layers of each test config
_PARAMS = {}


def _configs(name):
    """(reference cfg, port cfg): one round and a trailing block ("tail"),
    or two rounds and none ("rounds2")."""
    n = CONFIGS[name]
    return tuple(reg[ZAMBA].with_overrides(num_layers=n)
                 for reg in (jconfigs.REDUCED, tconfigs.REDUCED))


def _params(name):
    """The reference's params of a config (jitted init), as NumPy."""
    if name not in _PARAMS:
        jc, _ = _configs(name)
        pj = jax.jit(lambda k: jbb.init_params(jc, k, jnp.float32))(
            jax.random.PRNGKey(0))
        _PARAMS[name] = jax.tree.map(np.asarray, pj)
    return _PARAMS[name]


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    jc, tc = _configs(request.param)
    p_np = _params(request.param)
    return (request.param, jc, tc, jax.tree.map(jnp.asarray, p_np),
            lm_params_from_numpy(p_np, device="cpu"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float = TOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _tree_gap(what, port_tree, ref_tree) -> None:
    """Largest per-leaf relative gap, leaves matched by key path."""
    port_np = lm_params_to_numpy(port_tree)
    paths = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, ref_tree))
    assert len(paths) == len(tree_leaves(port_np))
    worst = 0.0
    for path, want in paths:
        got = _leaf(port_np, path)
        assert got.shape == want.shape, path
        worst = max(worst, _rel(got, want))
    _gap(what, worst)


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(seed, b, s):
    toks = _tokens(seed, b, s + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# --------------------------------------------------------------------------
# the layers: conv, SSD, the Mamba2 block, its decode step
# --------------------------------------------------------------------------

def _block0(name="tail"):
    """(reference cfg, port cfg, reference Mamba2 params of block 0, the
    port's)."""
    jc, tc = _configs(name)
    p = jax.tree.map(lambda a: a[0], _params(name)["layers"]["mamba"])
    return jc, tc, jax.tree.map(jnp.asarray, p), lm_params_from_numpy(
        p, device="cpu")


def test_causal_conv1d_matches_reference():
    x, w, b = _x(1, (2, 37, 24)), _x(2, (4, 24)), _x(3, (24,))
    want = jlayers._causal_conv1d(*(jnp.asarray(a) for a in (x, w, b)))
    got = tlayers._causal_conv1d(*(torch.as_tensor(a) for a in (x, w, b)))
    _gap("_causal_conv1d", _rel(got.numpy(), want), 1e-6)


def _ssd_inputs(seed, b, s, h, p, n, dt_scale=1.0, a_max=16.0):
    """x, dt = softplus(N(0, 1)·dt_scale + U[-4, -2]) (Mamba2's dt_bias
    init), A = -linspace(1, a_max), B, C."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) * dt_scale
                         + rng.uniform(-4.0, -2.0, h)))
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            dt.astype(np.float32),
            -np.linspace(1.0, a_max, h).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(40, 16), (48, 16), (7, 16)])
def test_ssd_chunked_output_and_state(s, chunk):
    """A padded last chunk (40), whole chunks (48) and one short chunk (7):
    the output and the final state."""
    args = _ssd_inputs(s, 2, s, 4, 8, 6)
    yj, sj = jlayers.ssd_chunked(*(jnp.asarray(a) for a in args),
                                 chunk=chunk, return_state=True)
    yt, st = tlayers.ssd_chunked(*(torch.as_tensor(a) for a in args),
                                 chunk=chunk, return_state=True)
    assert yt.dtype == torch.float32 and tuple(st.shape) == (2, 4, 6, 8)
    _gap(f"ssd_chunked y S={s}", _rel(yt.numpy(), yj), 1e-5)
    _gap(f"ssd_chunked final state S={s}", _rel(st.numpy(), sj), 1e-5)


def test_mamba2_forward_output_and_state():
    jc, tc, pj, pt = _block0()
    x = _x(4, (B, S, tc.d_model))
    oj, (cj, sj) = jlayers.mamba2_forward(pj, jnp.asarray(x), jc,
                                          return_state=True)
    ot, (ct, st) = tlayers.mamba2_forward(pt, torch.as_tensor(x), tc,
                                          return_state=True)
    assert ct.dtype == st.dtype == torch.float32
    _gap("mamba2_forward output", _rel(ot.numpy(), oj))
    _gap("mamba2_forward conv window", _rel(ct.numpy(), cj))
    _gap("mamba2_forward ssm state", _rel(st.numpy(), sj))


def test_mamba2_decode_chain_matches_forward_and_reference():
    """S single-token steps from a zero state: each step's output against
    the forward's at that position and the reference's step, and the last
    states against the forward's."""
    jc, tc, pj, pt = _block0()
    x = _x(5, (B, S, tc.d_model))
    fwd, (cw, sw) = tlayers.mamba2_forward(pt, torch.as_tensor(x), tc,
                                           return_state=True)
    cache = tlayers.init_mamba2_cache(tc, B, 1, "cpu")
    conv_t, ssm_t = cache["conv"][0], cache["ssm"][0]
    conv_j, ssm_j = jnp.asarray(conv_t.numpy()), jnp.asarray(ssm_t.numpy())
    outs, ref_outs = [], []
    for t in range(S):
        xt = x[:, t:t + 1]
        o, conv_t, ssm_t = tlayers.mamba2_decode_step(
            pt, torch.as_tensor(xt), tc, conv_state=conv_t, ssm_state=ssm_t)
        oj, conv_j, ssm_j = jlayers.mamba2_decode_step(
            pj, jnp.asarray(xt), jc, conv_state=conv_j, ssm_state=ssm_j)
        outs.append(o.numpy())
        ref_outs.append(np.asarray(oj))
    outs, ref_outs = np.concatenate(outs, 1), np.concatenate(ref_outs, 1)
    _gap("mamba2 decode chain vs forward", _rel(outs, fwd.numpy()))
    _gap("mamba2 decode chain vs the reference's steps", _rel(outs, ref_outs))
    _gap("mamba2 decode conv window vs forward's", _rel(conv_t.numpy(),
                                                        cw.numpy()))
    _gap("mamba2 decode ssm state vs forward's", _rel(ssm_t.numpy(),
                                                      sw.numpy()))
    _gap("mamba2 decode ssm state vs the reference's", _rel(ssm_t.numpy(),
                                                            ssm_j))


# --------------------------------------------------------------------------
# the model: weights, counts, forward, loss, gradients, train steps
# --------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def test_weights_round_trip(model):
    """The hybrid tree carries over as it is, with no transposes: the
    stacked Mamba2 blocks (w_in (L, d, 2·inner + 2N + H), conv_w (L, K, C),
    A_log / D / dt_bias fp32), ``tail_layers`` where there are trailing
    blocks, and one unstacked ``shared_block``."""
    name, _, tc, pj, pt = model
    back = lm_params_to_numpy(pt)
    paths = jax.tree_util.tree_leaves_with_path(pj)
    assert len(paths) == len(tree_leaves(back))
    for path, a in paths:
        assert np.array_equal(np.asarray(a), _leaf(back, path)), path
    rounds = tc.num_layers // tc.hybrid_period
    trailing = tc.num_layers - rounds * tc.hybrid_period
    assert ("tail_layers" in pt) == bool(trailing)
    s, d = tc.ssm, tc.d_model
    inner = s.expand * d
    H, N = inner // s.head_dim, s.state_dim
    m = pt["layers"]["mamba"]
    assert {k: tuple(m[k].shape) for k in ("w_in", "conv_w", "A_log")} == {
        "w_in": (rounds * tc.hybrid_period, d, 2 * inner + 2 * N + H),
        "conv_w": (rounds * tc.hybrid_period, s.conv_dim, inner + 2 * N),
        "A_log": (rounds * tc.hybrid_period, H)}
    assert tuple(pt["shared_block"]["attn"]["wq"].shape) == (
        d, tc.num_heads, tc.head_dim)
    assert set(pt) == set(pj)
    # the port's own init draws the same tree; bf16 params keep the SSD's
    # A_log, D and dt_bias fp32
    shapes = lambda tree: sorted((k, tuple(t.shape)) for k, t in
                                 zip(_paths(tree), tree_leaves(tree)))
    own = tbb.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert shapes(own) == shapes(pt)
    own16 = tbb.init_params(tc, torch.Generator().manual_seed(0),
                            torch.bfloat16, device="cpu")
    assert {k: own16["layers"]["mamba"][k].dtype
            for k in ("A_log", "D", "dt_bias", "w_in")} == {
        "A_log": torch.float32, "D": torch.float32,
        "dt_bias": torch.float32, "w_in": torch.bfloat16}


@pytest.mark.parametrize("registry", ["ARCHS", "REDUCED"])
def test_param_counts_equal_reference(registry):
    for embed in (True, False):
        tc = getattr(tconfigs, registry)[ZAMBA]
        jc = getattr(jconfigs, registry)[ZAMBA]
        assert (tbb.count_params_analytic(tc, include_embed=embed)
                == jbb.count_params_analytic(jc, include_embed=embed))
    assert tc.param_count() == jc.param_count()
    if registry == "ARCHS":
        assert tc.param_count() == 1_170_473_856
        assert tbb.count_params_analytic(tc, include_embed=False) == (
            1_039_401_856)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits(model, use_kernels):
    """The port's kernel path and plain path against the reference's plain
    forward (its kernel-path forward raises under remat)."""
    name, jc, tc, pj, pt = model
    toks = _tokens(0)
    lj, hj, auxj = jbb.forward(pj, jnp.asarray(toks), jc, use_pallas=False,
                               **F32J)
    with torch.no_grad():
        lt, ht, auxt = tbb.forward(pt, torch.as_tensor(toks), tc,
                                   use_kernels=use_kernels, **F32T)
    assert float(auxt["moe_aux"]) == float(auxj["moe_aux"]) == 0.0
    _gap(f"{name} forward logits (kernels={use_kernels})",
         _rel(lt.numpy(), lj))
    _gap(f"{name} forward hidden", _rel(ht.numpy(), hj))


def test_loss_fn_matches_reference(model):
    name, jc, tc, pj, pt = model
    batch = _batch(6, B, S)
    batch["labels"][0, :3] = -1                      # ignored positions
    _, mj = jbb.loss_fn(pj, jax.tree.map(jnp.asarray, batch), jc,
                        use_pallas=False, **F32J)
    with torch.no_grad():
        _, mt = tbb.loss_fn(pt, {k: torch.tensor(v) for k, v in
                                 batch.items()}, tc, **F32T)
    assert set(mt) == set(mj) == {"ce", "loss"}
    for k in sorted(mt):
        _gap(f"{name} loss_fn {k}", _rel(float(mt[k]), float(mj[k])))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_gradients_match_jax_grad(model, remat):
    """Every leaf's gradient, the shared block's (the sum over its
    applications) included, under per-round remat and without."""
    name, jc, tc, pj, pt = model
    batch = _batch(7, B, S)
    gj = jax.grad(lambda p: jbb.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jc, use_pallas=False,
        remat=remat, **F32J)[0])(pj)
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(pt)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), pt)
    loss, _ = tbb.loss_fn(live, {k: torch.tensor(v)
                                 for k, v in batch.items()},
                          tc, use_kernels=False, remat=remat, **F32T)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gt = tree_map(lambda _: next(it), pt)
    _tree_gap(f"{name} loss gradients remat={remat}", gt, gj)
    _gap(f"{name} shared block gradient (wq)",
         _rel(gt["shared_block"]["attn"]["wq"].numpy(),
              gj["shared_block"]["attn"]["wq"]))


def _train_configs(name, federated=None):
    jc, tc = _configs(name)
    shape_kw = dict(seq_len=S, global_batch=B, kind="train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              compute_dtype="float32", remat=True)
    fed = {} if federated is None else {"federated": federated}
    jt = JTrainConfig(model=jc, shape=jconfigs.InputShape("t", **shape_kw),
                      **{k: JFederatedConfig(**v) for k, v in fed.items()},
                      **kw)
    tt = TrainConfig(model=tc, shape=tconfigs.InputShape("t", **shape_kw),
                     **{k: FederatedConfig(**v) for k, v in fed.items()},
                     **kw)
    return jt, tt


def test_three_train_steps_match_reference(model):
    """Three AdamW steps of both packages from the same params and
    batches: each step's metrics, and the params after three."""
    name, jc, tc, pj, pt = model
    jt, tt = _train_configs(name)
    jstep, jopt = jsteps.make_train_step(jc, jt)
    jstep = jax.jit(jstep)
    tstep, topt = tsteps.make_train_step(tc, tt, use_kernels=False,
                                         device="cpu")
    pj_, oj = pj, jopt.init(pj)
    pt_ = lm_params_from_numpy(lm_params_to_numpy(pt), device="cpu")
    ot = topt.init(pt_)
    stream = TokenStream(tc.vocab_size, S, B, seed=7)
    for step in range(3):
        b = stream.batch(step)
        pj_, oj, mj = jstep(pj_, oj, jax.tree.map(jnp.asarray, b))
        pt_, ot, mt = tstep(pt_, ot, b)
        assert set(mt) == set(mj)
        for k in sorted(mt):
            _gap(f"{name} train step {step} {k}",
                 _rel(float(mt[k]), float(mj[k])))
    assert int(ot["step"]) == 3
    _tree_gap(f"{name} params after 3 train steps", pt_, pj_)


# --------------------------------------------------------------------------
# serving: prefill, decode, BatchedServer
# --------------------------------------------------------------------------

def _state_gap(what, st, sj) -> None:
    """Every leaf of the decode state: the Mamba2 conv windows and SSM
    states and the shared KV cache within the bar, ``pos`` equal."""
    paths = jax.tree_util.tree_leaves_with_path(sj)
    assert len(paths) == len(tree_leaves(st))
    for path, want in paths:
        got = _leaf(st, path)
        key = "/".join(p.key for p in path)
        assert tuple(got.shape) == want.shape, key
        if key.endswith("pos"):
            assert np.array_equal(got.numpy(), np.asarray(want)), key
        else:
            _gap(f"{what} {key}", _rel(got.numpy(), want))


@pytest.mark.parametrize("cache_len", [64, 16])     # > S and < S (ring)
def test_prefill_logits_and_state(model, cache_len):
    name, jc, tc, pj, pt = model
    toks = _tokens(1, s=S - 1)
    lj, sj, nj = jbb.prefill(pj, jnp.asarray(toks), jc, cache_len=cache_len,
                             cache_dtype=jnp.float32, **F32J)
    lt, st, nt = tbb.prefill(pt, torch.as_tensor(toks), tc,
                             cache_len=cache_len, cache_dtype=torch.float32,
                             **F32T)
    assert lt.shape == (B, 1, tc.vocab_size)
    want = {"mamba", "shared_cache"} | ({"mamba_tail"} if name == "tail"
                                        else set())
    assert set(st) == set(sj) == want
    rounds = tc.num_layers // tc.hybrid_period
    assert st["shared_cache"]["k"].shape[0] == rounds
    _gap(f"{name} prefill last logits (C={cache_len})", _rel(lt.numpy(), lj))
    _state_gap(f"{name} prefill (C={cache_len})", st, sj)
    assert np.array_equal(nt.numpy(), np.asarray(nj))
    # the state tree is init_decode_state's
    fresh = tbb.init_decode_state(tc, B, cache_len, torch.float32,
                                  device="cpu")
    assert (sorted((k, tuple(t.shape)) for k, t in
                   zip(_paths(fresh), tree_leaves(fresh)))
            == sorted((k, tuple(t.shape)) for k, t in
                      zip(_paths(st), tree_leaves(st))))


def test_decode_steps_after_prefill(model):
    """prefill(S - 1) (the last chunk padded), then 8 decode steps (a ring
    shorter than the sequence); the reference's greedy token feeds both.
    The first step's logits also against the forward's last position."""
    name, jc, tc, pj, pt = model
    toks = _tokens(2)
    kw = dict(cache_len=44)
    _, sj, nj = jbb.prefill(pj, jnp.asarray(toks[:, :-1]), jc,
                            cache_dtype=jnp.float32, **kw, **F32J)
    _, st, nt = tbb.prefill(pt, torch.as_tensor(toks[:, :-1]), tc,
                            cache_dtype=torch.float32, **kw, **F32T)
    with torch.no_grad():
        full, _, _ = tbb.forward(pt, torch.as_tensor(toks), tc, **F32T)
    tok, cur, worst = toks[:, -1:], np.array(nj), 0.0
    for i in range(8):
        dj, sj = jbb.decode_step(pj, sj, jnp.asarray(tok), jnp.asarray(cur),
                                 jc, **F32J)
        dt, st = tbb.decode_step(pt, st, torch.as_tensor(tok),
                                 torch.as_tensor(cur), tc, **F32T)
        if i == 0:
            _gap(f"{name} prefill(S-1)+decode vs forward's last",
                 _rel(dt.numpy(), full[:, -1:].numpy()))
        worst = max(worst, _rel(dt.numpy(), dj))
        tok = np.asarray(jnp.argmax(dj[:, 0], -1), np.int32)[:, None]
        cur = cur + 1
    _gap(f"{name} 8 decode steps, worst logits", worst)
    _state_gap(f"{name} after 8 decode steps", st, sj)


def _prompts(seed=0, n=5, vocab=512):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=rng.integers(3, 9))
               for _ in range(n)]
    prompts[2] = np.array([], np.int64)           # an empty prompt
    return prompts


def _requests(mod, prompts, max_new=6):
    return [mod.Request(rid=i, prompt=p, max_new=max_new - (i % 2))
            for i, p in enumerate(prompts)]


def test_batched_server_greedy_matches_reference(model):
    """Every request in a slot no request used before (slots = requests),
    where the reference's server is right: the same tokens and statuses."""
    name, jc, tc, pj, pt = model
    prompts = _prompts()
    kw = dict(slots=len(prompts), cache_len=16)
    out_j = jserve.BatchedServer(jc, pj, **kw).serve(
        _requests(jserve, prompts))
    ts = tserve.BatchedServer(tc, pt, device="cpu", **kw)
    out_t = ts.serve(_requests(tserve, prompts))
    assert dict(out_t) == dict(out_j)
    assert out_t.status == out_j.status == {i: "done"
                                            for i in range(len(prompts))}


def test_freed_slot_serves_as_a_fresh_server(model):
    """A request admitted into a slot another request left gives the same
    tokens as in a fresh server: admission zeroes the slot's Mamba2 states
    (``mamba``, ``mamba_tail``) and leaves the shared KV cache, whose
    position mask hides the stale keys. The reference's server decodes
    from the leftover Mamba2 state."""
    name, jc, tc, pj, pt = model
    prompts = _prompts(seed=1)
    reused = tserve.BatchedServer(tc, pt, slots=1, cache_len=16, device="cpu")
    out = reused.serve(_requests(tserve, prompts))       # one slot, in turn
    assert set(out.status.values()) == {"done"}
    # the shared cache was not zeroed: its pos keeps the last request's
    # positions and -1 past them
    assert int(reused.state["shared_cache"]["pos"].max()) > 0
    assert int(reused.state["shared_cache"]["pos"].min()) == -1
    for i, p in enumerate(prompts):
        fresh = tserve.BatchedServer(tc, pt, slots=1, cache_len=16,
                                     device="cpu")
        alone = fresh.serve([tserve.Request(rid=i, prompt=p,
                                            max_new=6 - (i % 2))])
        assert out[i] == alone[i], i
    ref = jserve.BatchedServer(jc, pj, slots=1, cache_len=16).serve(
        _requests(jserve, prompts))
    assert ref[0] == out[0] and any(ref[i] != out[i] for i in range(1, 5))


def test_serve_steps_and_cli_on_cpu(capsys):
    """The prefill step returns the hybrid state, the serve step advances
    it in place from NumPy inputs; the serve CLI runs the reduced zamba2."""
    _, tc = _configs("tail")
    pt = lm_params_from_numpy(_params("tail"), device="cpu")
    tok = _tokens(3)
    prefill = tsteps.make_prefill_step(tc, cache_len=S, device="cpu", **F32T)
    serve = tsteps.make_serve_step(tc, device="cpu", **F32T)
    _, state, nxt = prefill(pt, {"tokens": tok[:, :S - 1]})
    before = tree_map(torch.clone, state)
    logits, out = serve(pt, state, tok[:, S - 1:], nxt.numpy())
    assert out is state and tuple(logits.shape) == (B, 1, tc.vocab_size)
    for part in ("mamba", "mamba_tail"):
        for k in ("conv", "ssm"):
            assert not torch.equal(before[part][k], state[part][k])
    want, _ = tbb.decode_step(pt, before, torch.as_tensor(tok[:, S - 1:]),
                              nxt, tc, **F32T)
    assert torch.equal(logits, want)
    tserve.main(["--arch", ZAMBA, "--device", "cpu", "--requests", "3",
                 "--max-new", "4"])
    printed = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in printed and "device=cpu" in printed


# --------------------------------------------------------------------------
# FedDCL's federated round
# --------------------------------------------------------------------------

D, H = 2, 2


def test_federated_round_matches_reference():
    """One fedavg round, d = 2 silos x H = 2 local steps, against the
    reference's jitted make_federated_round_step: the (H, d) metrics and
    the params (the shared block an unstacked leaf of each silo's tree);
    the silos equal after the sync."""
    name = "tail"
    jt, tt = _train_configs(name, federated=dict(num_silos=D, local_steps=H))
    jround, jopt = jsteps.make_federated_round_step(jt.model, jt)
    tround, topt = tsteps.make_federated_round_step(
        tt.model, tt, use_kernels=False, device="cpu")
    p_np = _params(name)
    spj = jsilo_replicate(jax.tree.map(jnp.asarray, p_np), D)
    soj = jax.vmap(jopt.init)(spj)
    sp = tree_map(lambda a: a.contiguous(),
                  silo_replicate(lm_params_from_numpy(p_np, device="cpu"), D))
    so = tsteps.silo_opt_init(topt, sp)
    assert tuple(sp["shared_block"]["attn"]["wq"].shape[:1]) == (D,)
    bs = [silo_batches(512, S, B, D, h, seed=1) for h in range(H)]
    bs = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    spj, soj, mj = jax.jit(jround)(spj, soj, jax.tree.map(jnp.asarray, bs))
    sp, so, mt = tround(sp, so, bs)
    assert set(mt) == set(mj)
    for k in sorted(mt):
        assert tuple(mt[k].shape) == (H, D)
        _gap(f"{name} round {k}", _rel(mt[k].numpy(), mj[k]))
    _tree_gap(f"{name} round params", sp, spj)
    assert all(torch.equal(a[1], a[0]) for a in tree_leaves(sp))


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

def test_train_cli_zamba2_loss_falls():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ZAMBA,
         "--reduced", "--device", "cpu", "--steps", "20"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step")]
    print(f"zamba2 train CLI losses: {losses}")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
