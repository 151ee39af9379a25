"""DeepSeek's multi-head latent attention: repro_torch's ``mla_attention``
(the expanded form of forward and prefill), ``init_mla_cache`` and
``mla_decode`` (the absorbed-weight decode against the latent cache)
against the JAX reference's, with the reference's weights carried over
(``weights``) and inputs made from a seed with NumPy; then the model-level
pieces only MLA has: the latent caches of prefill and
``init_decode_state``, the absorbed decode held to the expanded forward,
and three train steps, each also from the reference's own state.

Config: ``REDUCED["deepseek-v3-671b"]`` (MLA ranks q 64 / kv 32, nope /
rope / v 32 / 16 / 32, 4 heads; one dense layer, one MoE layer, the MTP
head). Its forward, loss with MTP, gradients, prefill, decode, server
and federated round against the reference's are
``tests/test_torch_moe.py``'s ``deepseek-mla`` case. Both sides run fp32.
Bar: 1e-5 relative (Frobenius) for one layer, 1e-4 for the model. The
measured gaps print under ``pytest -s`` as ``parity-gap`` lines.
"""
import contextlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402

ARCH = "deepseek-v3-671b"
LAYER_TOL, TOL = 1e-5, 1e-4
B, S = 2, 24
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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float = LAYER_TOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params (NumPy), port params)."""
    jc, tc = jconfigs.REDUCED[ARCH], tconfigs.REDUCED[ARCH]
    pj = jax.jit(lambda k: jbb.init_params(jc, k, jnp.float32))(
        jax.random.PRNGKey(0))
    p_np = jax.tree.map(np.asarray, pj)
    return jc, tc, p_np, lm_params_from_numpy(p_np, device="cpu")


def _layer(model, scales=True):
    """Layer 0's MLA params of the main stack, both sides, with non-unit
    q / kv norm scales (the init's ones would hide a missing norm)."""
    jc, tc, p_np, _ = model
    p = jax.tree.map(lambda a: np.array(a[0]), p_np["layers"]["attn"])
    if scales:
        rng = np.random.default_rng(3)
        for k in ("q_norm", "kv_norm"):
            n = p[k]["scale"].shape[0]
            p[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, p), lm_params_from_numpy(
        p, device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("is_local,window", [(False, 4096), (True, 8)])
def test_mla_attention_matches_reference(model, is_local, window):
    """The expanded form (each head's nope key from the latent, the one
    rope key broadcast and concatenated, scale 1/sqrt(nope + rope)) and
    the latent entries it returns for the cache; causal, and with a
    window shorter than the sequence."""
    jc, tc, pj, pt = _layer(model)
    jc, tc = (c.with_overrides(sliding_window=window) for c in (jc, tc))
    x, pos = _x(1, (B, S, tc.d_model)), _positions(B, S)
    oj, (cj, rj) = jlayers.mla_attention(pj, jnp.asarray(x), jc,
                                         positions=jnp.asarray(pos),
                                         is_local=is_local, return_kv=True)
    ot, (ct, rt) = tlayers.mla_attention(pt, torch.as_tensor(x), tc,
                                         positions=torch.as_tensor(pos),
                                         is_local=is_local, return_kv=True)
    m = tc.mla
    assert ct.shape == (B, S, m.kv_lora_rank)
    assert rt.shape == (B, S, m.qk_rope_head_dim)
    _gap(f"mla_attention output (local={is_local})", _rel(ot.numpy(), oj))
    _gap("mla_attention latent ckv", _rel(ct.numpy(), cj))
    _gap("mla_attention rope'd k_rope", _rel(rt.numpy(), rj))
    alone = tlayers.mla_attention(pt, torch.as_tensor(x), tc,
                                  positions=torch.as_tensor(pos),
                                  is_local=is_local)
    assert torch.equal(alone, ot)


def test_init_mla_cache_matches_reference(model):
    jc, tc, _, _ = model
    want = jlayers.init_mla_cache(jc, 3, 10, 2, jnp.bfloat16)
    got = tlayers.init_mla_cache(tc, 3, 10, 2, torch.bfloat16, "cpu")
    assert list(got) == ["ckv", "krope", "pos"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
        assert np.array_equal(got[k].float().numpy(),
                              np.asarray(want[k], np.float32)), k


@pytest.mark.parametrize("is_local", [False, True])
def test_mla_decode_chain_matches_reference(model, is_local):
    """12 single-token steps into a 10-slot ring (it wraps), the first
    slots prefilled from mla_attention's entries: each step's output
    against the reference's, and the caches, written in place, against
    the reference's updated copies."""
    jc, tc, pj, pt = _layer(model)
    jc, tc = (c.with_overrides(sliding_window=6) for c in (jc, tc))
    C, P0, steps = 10, 4, 12
    xs = _x(2, (B, P0 + steps, tc.d_model))
    _, (ckv, krope) = tlayers.mla_attention(
        pt, torch.as_tensor(xs[:, :P0]), tc,
        positions=torch.as_tensor(_positions(B, P0)), return_kv=True)
    cache = tlayers.init_mla_cache(tc, B, C, 1, torch.float32, "cpu")
    cache["ckv"][0, :, :P0] = ckv
    cache["krope"][0, :, :P0] = krope
    cache["pos"][0, :, :P0] = torch.arange(P0, dtype=torch.int32)
    c_t = {k: v[0] for k, v in cache.items()}
    c_j = {k: jnp.asarray(v.numpy()) for k, v in c_t.items()}
    worst = 0.0
    for t in range(steps):
        cur = np.full((B,), P0 + t, np.int32)
        xt = xs[:, P0 + t:P0 + t + 1]
        oj, (c_j["ckv"], c_j["krope"], c_j["pos"]) = jlayers.mla_decode(
            pj, jnp.asarray(xt), jc, cache_ckv=c_j["ckv"],
            cache_krope=c_j["krope"], cache_pos=c_j["pos"],
            cur_pos=jnp.asarray(cur), is_local=is_local)
        ot = tlayers.mla_decode(
            pt, torch.as_tensor(xt), tc, cache_ckv=c_t["ckv"],
            cache_krope=c_t["krope"], cache_pos=c_t["pos"],
            cur_pos=torch.as_tensor(cur), is_local=is_local)
        assert ot.shape == (B, 1, tc.d_model)
        worst = max(worst, _rel(ot.numpy(), oj))
    _gap(f"mla_decode, {steps} steps (local={is_local}), worst", worst)
    assert np.array_equal(c_t["pos"].numpy(), np.asarray(c_j["pos"]))
    assert int(c_t["pos"].min()) == P0 + steps - C      # wrapped
    for k in ("ckv", "krope"):
        _gap(f"mla_decode cache {k} in place", _rel(c_t[k].numpy(), c_j[k]))


def test_absorbed_decode_equals_expanded_attention(model):
    """The absorbed decode of the last token against the expanded form's
    last position over the whole sequence, in the port alone: the same
    function (the weights absorbed into the query and the output)."""
    _, tc, _, pt = _layer(model)
    x, pos = _x(4, (B, S, tc.d_model)), _positions(B, S)
    full, (ckv, krope) = tlayers.mla_attention(
        pt, torch.as_tensor(x), tc, positions=torch.as_tensor(pos),
        return_kv=True)
    cache = {"ckv": ckv[:, :-1].clone(), "krope": krope[:, :-1].clone(),
             "pos": torch.as_tensor(pos[:, :-1])}
    cache = {k: torch.cat([v, torch.zeros_like(v[:, :1])], 1)
             for k, v in cache.items()}
    out = tlayers.mla_decode(
        pt, torch.as_tensor(x[:, -1:]), tc, cache_ckv=cache["ckv"],
        cache_krope=cache["krope"], cache_pos=cache["pos"],
        cur_pos=torch.full((B,), S - 1, dtype=torch.int32))
    _gap("absorbed decode vs expanded attention, last position",
         _rel(out.numpy(), full[:, -1:].numpy()))
    _gap("the latent the decode wrote vs the expanded form's",
         _rel(cache["ckv"][:, -1].numpy(), ckv[:, -1].numpy()))


# --------------------------------------------------------------------------
# the model: latent caches and the absorbed decode through a ring
# --------------------------------------------------------------------------

def test_decode_state_is_latent(model):
    """init_decode_state and prefill give the same latent tree for the
    dense layer (``dense_cache``) and the MoE layer (``cache``): r_kv +
    rope numbers a position, not 2 x H x hd; the reference's tree."""
    jc, tc, p_np, pt = model
    m = tc.mla
    fresh = tbb.init_decode_state(tc, B, 16, torch.float32, device="cpu")
    want = jbb.init_decode_state(jc, B, 16, jnp.float32)
    assert set(fresh) == set(want) == {"dense_cache", "cache"}
    for part in fresh:
        assert {k: tuple(v.shape) for k, v in fresh[part].items()} == {
            k: v.shape for k, v in want[part].items()}
        assert fresh[part]["ckv"].shape[-1] == m.kv_lora_rank
        assert fresh[part]["krope"].shape[-1] == m.qk_rope_head_dim
    toks = np.random.default_rng(0).integers(0, 512, (B, 8)).astype(np.int32)
    _, st, _ = tbb.prefill(pt, torch.as_tensor(toks), tc, cache_len=16,
                           cache_dtype=torch.float32, **F32T)
    assert {p: {k: tuple(v.shape) for k, v in st[p].items()} for p in st} \
        == {p: {k: tuple(v.shape) for k, v in fresh[p].items()}
            for p in fresh}


def test_prefill_then_absorbed_decode_matches_forward(model):
    """prefill(S - 6), then 6 absorbed decode steps feeding the true next
    tokens: every step's logits against the expanded forward's at that
    position over the whole sequence, and against the reference's
    prefill + decode (the ring's wrap is the layer test's)."""
    jc, tc, p_np, pt = model
    pj = jax.tree.map(jnp.asarray, p_np)
    toks = np.random.default_rng(1).integers(0, 512, (B, S)).astype(np.int32)
    n0, C = S - 6, S
    with torch.no_grad():
        full, _, _ = tbb.forward(pt, torch.as_tensor(toks), tc, **F32T)
    _, st, nt = tbb.prefill(pt, torch.as_tensor(toks[:, :n0]), tc,
                            cache_len=C, cache_dtype=torch.float32, **F32T)
    _, sj, nj = jbb.prefill(pj, jnp.asarray(toks[:, :n0]), jc, cache_len=C,
                            cache_dtype=jnp.float32, **F32J)
    jdecode = jax.jit(lambda p, s, t, c: jbb.decode_step(p, s, t, c, jc,
                                                          **F32J))
    fwd_gap = ref_gap = 0.0
    cur = nt
    for i in range(n0, S):
        tok = toks[:, i:i + 1]
        dt, st = tbb.decode_step(pt, st, torch.as_tensor(tok), cur, tc,
                                 **F32T)
        dj, sj = jdecode(pj, sj, jnp.asarray(tok), jnp.asarray(nj))
        fwd_gap = max(fwd_gap, _rel(dt[:, 0].numpy(), full[:, i].numpy()))
        ref_gap = max(ref_gap, _rel(dt.numpy(), dj))
        cur, nj = cur + 1, nj + 1
    _gap("prefill + absorbed decode vs expanded forward, worst", fwd_gap,
         TOL)
    _gap("prefill + absorbed decode vs the reference's, worst", ref_gap,
         TOL)
    for part in st:
        for k in ("ckv", "krope"):
            _gap(f"latent {part} {k} after decode",
                 _rel(st[part][k].numpy(), sj[part][k]), TOL)
        assert np.array_equal(st[part]["pos"].numpy(),
                              np.asarray(sj[part]["pos"]))


# --------------------------------------------------------------------------
# three train steps
# --------------------------------------------------------------------------

ADAM_B1 = 0.9                    # both packages' adamw default
G_NOISE = 1e-7                   # 10 x adamw's eps (1e-8)


def _leaf_gaps(port_tree, ref_tree):
    """{key path: (port array, reference array)}, leaves matched by path."""
    port_np = lm_params_to_numpy(port_tree)
    out = {}
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, ref_tree)):
        got = port_np
        for key in path:
            got = got[key.key]
        assert got.shape == want.shape, path
        out[jax.tree_util.keystr(path)] = (got, want)
    assert len(out) == len(tree_leaves(port_np))
    return out


def _tree_gap(what, port_tree, ref_tree, bar=TOL) -> None:
    _gap(what, max(_rel(a, b) for a, b in
                   _leaf_gaps(port_tree, ref_tree).values()), bar)


def test_three_train_steps_match_reference(model):
    """Three AdamW steps (MTP on) of both packages from the same params
    and batches, as tests/test_torch_train.py holds rwkv6's. Running free,
    each step's metrics hold 1e-4, and AdamW's moments and the params
    after step 1. Each step is also run from the reference's own state
    (params and moments copied in): there the moments and the params hold
    1e-4 at every step. The free-running params after three steps part
    by more (1.4e-4 in the embedding at one torch thread), and only where
    the test shows the cause: in elements whose gradient, in some step,
    was below G_NOISE, near AdamW's eps, where the update
    -lr m̂ / (sqrt(v̂) + eps) moves with the gradient's rounding."""
    jc, tc, p_np, _ = model
    shape_kw = dict(seq_len=32, global_batch=B, kind="train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              compute_dtype="float32", remat=True)
    jt = JTrainConfig(model=jc, shape=jconfigs.InputShape("t", **shape_kw),
                      **kw)
    tt = TrainConfig(model=tc, shape=tconfigs.InputShape("t", **shape_kw),
                     **kw)
    jstep, jopt = jsteps.make_train_step(jc, jt)
    jstep = jax.jit(jstep)
    tstep, topt = tsteps.make_train_step(tc, tt, device="cpu")
    pj = jax.tree.map(jnp.asarray, p_np)
    pj_, oj = pj, jopt.init(pj)
    pt_ = lm_params_from_numpy(p_np, device="cpu")
    ot = topt.init(pt_)
    to_port = lambda tree: lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), device="cpu")
    stream = TokenStream(tc.vocab_size, 32, B, seed=7)
    small, m_prev = {}, None
    for step in range(3):
        b = stream.batch(step)
        pf = to_port(pj_)
        of = {"step": torch.tensor(int(oj["step"]), dtype=torch.int32),
              "m": to_port(oj["m"]), "v": to_port(oj["v"])}
        pj_, oj, mj = jstep(pj_, oj, jax.tree.map(jnp.asarray, b))
        pt_, ot, mt = tstep(pt_, ot, b)
        assert set(mt) == set(mj) == {"ce", "moe_aux", "mtp", "loss",
                                      "grad_norm"}
        for k in sorted(mt):
            _gap(f"deepseek-mla train step {step} {k}",
                 _rel(float(mt[k]), float(mj[k])), TOL)
        # the reference's clipped gradient of this step, from its moments
        m = {k: v for k, (_, v) in _leaf_gaps(ot["m"], oj["m"]).items()}
        for k, mk in m.items():
            g = np.abs(mk - (0.0 if m_prev is None else ADAM_B1 * m_prev[k]))
            small[k] = small.get(k, False) | (g / (1 - ADAM_B1) < G_NOISE)
        m_prev = m
        if step == 0:
            for k in ("m", "v"):
                _tree_gap(f"adamw {k} after step 1", ot[k], oj[k])
            _tree_gap("params after step 1", pt_, pj_)
            first = max(float(np.abs(b_ - a).max()) for a, b_ in
                        _leaf_gaps(to_port(pj), pj_).values())
        pf, of, _ = tstep(pf, of, b)
        for k in ("m", "v"):
            _tree_gap(f"adamw {k} after step {step + 1} from the "
                      f"reference's state", of[k], oj[k])
        _tree_gap(f"params after step {step + 1} from the reference's "
                  f"state", pf, pj_)
    assert int(ot["step"]) == 3
    worst, parted = 0.0, 0
    for k, (got, want) in _leaf_gaps(pt_, pj_).items():
        worst = max(worst, _rel(got, want))
        far = np.abs(got - want) > 0.01 * first
        parted += int(far.sum())
        assert np.all(small[k][far]), k
    print(f"free-running params after 3 train steps: {worst:.2e}; "
          f"{parted} elements parted by > 1% of the first update, each "
          f"with a gradient below {G_NOISE} in some step")
