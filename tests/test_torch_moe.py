"""The moe family: repro_torch's MoE layers, backbone, steps and server
against the JAX reference's, with the reference's weights carried over
(``weights.lm_params_from_numpy``) and token ids made from a seed.

Configs: ``REDUCED["granite-moe-1b-a400m"]`` with 2 kv heads (GQA 2:1),
once with ``impl="dense"`` (every token through every expert, as REDUCED
pins) and once with ``impl="gspmd"`` (the capacity dispatch of the full
config, which drops tokens); and the deepseek-style config
``REDUCED["deepseek-v3-671b"]`` without MLA at head dim 64 (sigmoid
router with its selection bias, a shared expert, one leading dense layer,
the MTP head), and the same config with its MLA attention as REDUCED has
it (``deepseek-mla``: head dim 32, ranks q 64 / kv 32, nope / rope / v
32 / 16 / 32; the MTP block's attention MLA too, the decode state latent).
Both sides run fp32; the port runs its kernel path (on the CPU, the flash
kernel's plain version; MLA takes ``sdpa`` on both), the reference
``use_pallas=False``.
Bar: 1e-4 relative (Frobenius, the largest leaf), as the other LM tests;
the router's gates and probabilities 1e-6 absolute. The measured gaps
print under ``pytest -s`` as ``parity-gap`` lines.

With gspmd the capacity comes from each call's own token count, so a
decode step's logits depend on its batch-mates and depart from the
forward's: the port must show the reference's departure, not remove it.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from collections import defaultdict
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
from repro_torch.models import moe_ep as tmoe_ep  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
ROUTER_TOL = 1e-6
# what the expert-parallel error names: the ROADMAP item, by name
SHARDING_QUEUE = "Queue 1, multi-process silo sharding"
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v3-671b"
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


def _with_impl(cfg, impl, **moe_kw):
    return cfg.with_overrides(
        moe=dataclasses.replace(cfg.moe, impl=impl, **moe_kw))


def _configs(name):
    """(reference cfg, port cfg) of one of the four test configs."""
    out = []
    for reg in (jconfigs.REDUCED, tconfigs.REDUCED):
        if name == "deepseek":
            out.append(reg[DEEPSEEK].with_overrides(mla=None, head_dim=64))
        elif name == "deepseek-mla":
            out.append(reg[DEEPSEEK])
        else:
            impl = name.split("-")[1]
            out.append(_with_impl(
                reg[GRANITE].with_overrides(num_kv_heads=2), impl))
    return tuple(out)


CONFIGS = ["granite-dense", "granite-gspmd", "deepseek", "deepseek-mla"]
_PARAMS = {}


def _params(name):
    """The reference's params of a config (jitted init), as NumPy."""
    if name not in _PARAMS:
        jc, _ = _configs(name)
        pj = jax.jit(lambda k: jbb.init_params(jc, k, jnp.float32))(
            jax.random.PRNGKey(0))
        _PARAMS[name] = jax.tree.map(np.asarray, pj)
    return _PARAMS[name]


@pytest.fixture(scope="module", params=CONFIGS)
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


def _tree_gap(what, port_tree, ref_tree) -> None:
    """Largest per-leaf relative gap, leaves matched by key path."""
    port_np = lm_params_to_numpy(port_tree)
    paths = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, ref_tree))
    assert len(paths) == len(tree_leaves(port_np))
    worst = 0.0
    for path, want in paths:
        got = port_np
        for key in path:
            got = got[key.key]
        assert got.shape == want.shape, path
        worst = max(worst, _rel(got, want))
    _gap(what, worst)


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(seed, b, s):
    toks = _tokens(seed, b, s + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --------------------------------------------------------------------------
# the layer: router, aux loss, dispatch
# --------------------------------------------------------------------------

def _layer0(name):
    """(reference cfg, port cfg, reference moe params of layer 0, port's)
    with a random selection bias where the router has one (the init's is
    zero, which would not show that it moves the selection only)."""
    jc, tc = _configs(name)
    p = jax.tree.map(lambda a: a[0], _params(name)["layers"]["moe"])
    if "router_bias" in p:
        p["router_bias"] = (0.05 * np.random.default_rng(9).standard_normal(
            p["router_bias"].shape)).astype(np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, p), lm_params_from_numpy(
        p, device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["granite-dense", "deepseek"])
def test_router_probs_match_reference(name):
    """softmax (granite) and sigmoid with a selection bias (deepseek):
    the chosen experts equal, in the same order; gates and probabilities
    within 1e-6."""
    jc, tc, pj, pt = _layer0(name)
    x = _x(1, (64, tc.d_model))
    gj, ij, prj = jlayers._router_probs(pj, jnp.asarray(x), jc.moe)
    gt, it, prt = tlayers._router_probs(pt, torch.as_tensor(x), tc.moe)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    gate_gap = float(np.abs(gt.numpy() - np.asarray(gj)).max())
    prob_gap = float(np.abs(prt.numpy() - np.asarray(prj)).max())
    _gap(f"{tc.moe.router} router gates (max abs)", gate_gap, ROUTER_TOL)
    _gap(f"{tc.moe.router} router probs (max abs)", prob_gap, ROUTER_TOL)
    if tc.moe.router == "sigmoid":
        # the bias moved the selection, and the gates carry the scaling
        plain = np.argsort(-np.asarray(prj), axis=-1)[:, :tc.moe.top_k]
        assert not np.array_equal(np.sort(plain), np.sort(it.numpy()))
        np.testing.assert_allclose(gt.sum(-1).numpy(),
                                   tc.moe.routed_scaling, rtol=1e-5)


@pytest.mark.parametrize("name", ["granite-dense", "deepseek"])
def test_moe_aux_loss_matches_reference(name):
    jc, tc, pj, _ = _layer0(name)
    x = _x(2, (96, tc.d_model))
    _, idx, probs = jlayers._router_probs(pj, jnp.asarray(x), jc.moe)
    want = float(jlayers.moe_aux_loss(probs, idx, jc.moe))
    got = float(tlayers.moe_aux_loss(torch.tensor(np.asarray(probs)),
                                     torch.tensor(np.asarray(idx)), tc.moe))
    _gap(f"{tc.moe.router} moe_aux_loss", _rel(got, want))


def _kept_pairs(idx: np.ndarray, cap: int):
    """The Switch rule written out: each expert keeps the first `cap`
    (token, slot) pairs that chose it, in token-then-slot order."""
    taken, kept = defaultdict(int), {}
    for t in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            if taken[e] < cap:
                kept[(t, j)] = taken[e]
                taken[e] += 1
    return kept


@pytest.mark.parametrize("name", ["granite-dense", "deepseek"])
def test_gspmd_dispatch_drops_tokens_as_reference(name):
    """capacity_factor 0.5: a quarter or more of the (token, slot) pairs
    overflow. The pairs the port keeps, and their places in the expert
    queues, are the Switch rule's on the reference's routing; the output
    (shared expert included for deepseek) matches the reference's."""
    jc, tc, pj, pt = _layer0(name)
    jc, tc = (_with_impl(c, "gspmd", capacity_factor=0.5) for c in (jc, tc))
    x = _x(3, (2, 40, tc.d_model))
    oj, aj = jlayers.apply_moe_gspmd(pj, jnp.asarray(x), jc)
    ot, at = tlayers.apply_moe_gspmd(pt, torch.as_tensor(x), tc)
    T, k, E = 80, tc.moe.top_k, tc.moe.num_experts
    cap = max(int(0.5 * T * k / E), 1)
    _, idx, _ = jlayers._router_probs(pj, jnp.asarray(x.reshape(T, -1)),
                                      jc.moe)
    idx = np.asarray(idx)
    flat_e, slot, keep = tlayers.moe_dispatch(torch.as_tensor(idx), cap, E)
    got = {(i // k, i % k): int(slot[i]) for i in range(T * k) if keep[i]}
    want = _kept_pairs(idx, cap)
    assert got == want
    assert np.array_equal(flat_e.numpy(), idx.reshape(-1))
    assert (slot[~keep] == cap).all()
    dropped = T * k - len(want)
    print(f"gspmd {name}: cap {cap}, {dropped} of {T * k} pairs dropped")
    assert dropped >= T * k // 4
    _gap(f"{name} apply_moe_gspmd output, tokens dropped", _rel(ot.numpy(),
                                                                oj))
    _gap(f"{name} apply_moe_gspmd aux", _rel(float(at), float(aj)))


def test_gspmd_without_drops_equals_dense():
    """With room for every pair (capacity_factor E/k), the capacity
    dispatch computes the dense path's function."""
    _, tc, _, pt = _layer0("deepseek")
    E, k = tc.moe.num_experts, tc.moe.top_k
    x = torch.as_tensor(_x(4, (2, 16, tc.d_model)))
    od, ad = tlayers.apply_moe_dense(pt, x, _with_impl(tc, "dense"))
    og, ag = tlayers.apply_moe_gspmd(
        pt, x, _with_impl(tc, "gspmd", capacity_factor=E / k))
    _gap("gspmd at full capacity vs dense", _rel(og.numpy(), od.numpy()),
         1e-6)
    assert float(ag) == float(ad)


def test_moe_ep_takes_gspmd_alone_and_raises_in_a_group(monkeypatch):
    """One process: the reference's fallback (the gspmd path). A process
    in a group of ranks would need the all_to_all: it raises."""
    _, tc, _, pt = _layer0("granite-dense")
    x = torch.as_tensor(_x(5, (1, 12, tc.d_model)))
    ep, gs = _with_impl(tc, "ep"), _with_impl(tc, "gspmd")
    o_ep, a_ep = tlayers.apply_moe(pt, x, ep)
    o_gs, a_gs = tlayers.apply_moe(pt, x, gs)
    assert torch.equal(o_ep, o_gs) and torch.equal(a_ep, a_gs)
    monkeypatch.setattr(tmoe_ep.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmoe_ep.dist, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match=SHARDING_QUEUE):
        tlayers.apply_moe(pt, x, ep)


# --------------------------------------------------------------------------
# the model: weights, forward, loss, gradients, train steps
# --------------------------------------------------------------------------

def test_weights_round_trip(model):
    """The moe tree carries over as it is, with no transposes: router
    (L, d, E), w_gate / w_up (L, E, d, f), w_down (L, E, f, d)."""
    name, _, tc, pj, pt = model
    back = lm_params_to_numpy(pt)
    paths = jax.tree_util.tree_leaves_with_path(pj)
    assert len(paths) == len(tree_leaves(back))
    for path, a in paths:
        b = back
        for p in path:
            b = b[p.key]
        assert np.array_equal(np.asarray(a), b), path
    L = tc.num_layers - tc.first_k_dense
    d, E, f = tc.d_model, tc.moe.num_experts, tc.moe.d_ff_expert
    moe = pt["layers"]["moe"]
    assert {k: tuple(moe[k].shape) for k in
            ("router", "w_gate", "w_up", "w_down")} == {
        "router": (L, d, E), "w_gate": (L, E, d, f), "w_up": (L, E, d, f),
        "w_down": (L, E, f, d)}
    assert set(pt) == set(pj)
    # the port's own init draws the same tree
    own = tbb.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: sorted((k, tuple(t.shape), t.dtype) for k, t in
                                 zip(_paths(tree), tree_leaves(tree)))
    assert shapes(own) == shapes(pt)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits_and_aux(model, use_kernels):
    name, jc, tc, pj, pt = model
    toks = _tokens(0)
    lj, hj, auxj = jbb.forward(pj, jnp.asarray(toks), jc, use_pallas=False,
                               **F32J)
    with torch.no_grad():
        lt, ht, auxt = tbb.forward(pt, torch.as_tensor(toks), tc,
                                   use_kernels=use_kernels, **F32T)
    assert set(auxt) == {"moe_aux", "loss_mask"} and auxt["loss_mask"].all()
    _gap(f"{name} forward logits (kernels={use_kernels})",
         _rel(lt.numpy(), lj))
    _gap(f"{name} forward hidden", _rel(ht.numpy(), hj))
    _gap(f"{name} forward moe_aux", _rel(float(auxt["moe_aux"]),
                                         float(auxj["moe_aux"])))


@pytest.mark.parametrize("name,s", [(c, 32) for c in CONFIGS]
                         + [("deepseek", 1024)])
def test_loss_fn_metrics_match_reference(name, s):
    """ce, moe_aux, mtp (deepseek) and loss; at S = 1024 the CE head runs
    chunked and the MTP head trims its 1023 positions to 512."""
    jc, tc = _configs(name)
    p_np = _params(name)
    batch = _batch(6, 1 if s > 100 else B, s)
    batch["labels"][0, :3] = -1                      # ignored positions
    _, mj = jbb.loss_fn(jax.tree.map(jnp.asarray, p_np),
                        jax.tree.map(jnp.asarray, batch), jc,
                        use_pallas=False, **F32J)
    with torch.no_grad():
        _, mt = tbb.loss_fn(lm_params_from_numpy(p_np, device="cpu"),
                            {k: torch.tensor(v) for k, v in batch.items()},
                            tc, **F32T)
    assert set(mt) == set(mj)
    want = {"ce", "moe_aux", "loss"} | ({"mtp"} if tc.mtp_depth else set())
    assert set(mt) == want
    for k in sorted(mt):
        _gap(f"{name} loss_fn {k} S={s}", _rel(float(mt[k]), float(mj[k])))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_gradients_match_jax_grad(model, remat):
    name, jc, tc, pj, pt = model
    batch = _batch(7, B, 32)
    gj = jax.grad(lambda p: jbb.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jc, use_pallas=False,
        remat=remat, **F32J)[0])(pj)
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(pt)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), pt)
    loss, _ = tbb.loss_fn(live, {k: torch.tensor(v)
                                 for k, v in batch.items()},
                          tc, remat=remat, **F32T)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    _tree_gap(f"{name} loss gradients remat={remat}",
              tree_map(lambda _: next(it), pt), gj)


def _train_configs(name, remat=True, federated=None):
    jc, tc = _configs(name)
    shape_kw = dict(seq_len=32, global_batch=B, kind="train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              compute_dtype="float32", remat=remat)
    jt = JTrainConfig(model=jc, shape=jconfigs.InputShape("t", **shape_kw),
                      **({} if federated is None else
                         {"federated": JFederatedConfig(**federated)}), **kw)
    tt = TrainConfig(model=tc, shape=tconfigs.InputShape("t", **shape_kw),
                     **({} if federated is None else
                        {"federated": FederatedConfig(**federated)}), **kw)
    return jt, tt


@pytest.mark.parametrize("name", CONFIGS[:3])
def test_three_train_steps_match_reference(name):
    """Three AdamW steps of both packages from the same params and
    batches: each step's metrics, and the params after three. deepseek
    with MLA has its own train-step test (tests/test_torch_mla.py): its
    free-running params part by more than the bar in elements whose
    gradient is near AdamW's eps."""
    jc, tc = _configs(name)
    p_np = _params(name)
    pj, pt = (jax.tree.map(jnp.asarray, p_np),
              lm_params_from_numpy(p_np, device="cpu"))
    jt, tt = _train_configs(name)
    jstep, jopt = jsteps.make_train_step(jc, jt)
    jstep = jax.jit(jstep)
    tstep, topt = tsteps.make_train_step(tc, tt, device="cpu")
    pj_, oj = pj, jopt.init(pj)
    pt_ = lm_params_from_numpy(lm_params_to_numpy(pt), device="cpu")
    ot = topt.init(pt_)
    stream = TokenStream(tc.vocab_size, 32, B, seed=7)
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

def _entries(cfg):
    """A cache's per-position leaves: K and V, or MLA's latent."""
    return ("ckv", "krope") if cfg.mla is not None else ("k", "v")


@pytest.mark.parametrize("cache_len", [64, 16])     # > S and < S (ring)
def test_prefill_logits_and_caches(model, cache_len):
    name, jc, tc, pj, pt = model
    toks = _tokens(1)
    lj, sj, nj = jbb.prefill(pj, jnp.asarray(toks), jc, cache_len=cache_len,
                             cache_dtype=jnp.float32, **F32J)
    lt, st, nt = tbb.prefill(pt, torch.as_tensor(toks), tc,
                             cache_len=cache_len, cache_dtype=torch.float32,
                             **F32T)
    assert lt.shape == (B, 1, tc.vocab_size)
    assert set(st) == set(sj) == ({"dense_cache", "cache"}
                                  if tc.first_k_dense else {"cache"})
    _gap(f"{name} prefill last logits (C={cache_len})", _rel(lt.numpy(), lj))
    for part in st:
        assert set(st[part]) == set(sj[part]) == {*_entries(tc), "pos"}
        for k in _entries(tc):
            assert st[part][k].shape == sj[part][k].shape
            _gap(f"{name} prefill {part} {k} (C={cache_len})",
                 _rel(st[part][k].numpy(), sj[part][k]))
        assert np.array_equal(st[part]["pos"].numpy(),
                              np.asarray(sj[part]["pos"]))
    assert np.array_equal(nt.numpy(), np.asarray(nj))


def test_decode_steps_after_prefill(model):
    """8 cached decode steps from a prefilled state (a ring shorter than
    the sequence); the reference's greedy token feeds both."""
    name, jc, tc, pj, pt = model
    toks = _tokens(2)
    kw = dict(cache_len=28)
    _, sj, _ = jbb.prefill(pj, jnp.asarray(toks), jc,
                           cache_dtype=jnp.float32, **kw, **F32J)
    _, st, _ = tbb.prefill(pt, torch.as_tensor(toks), tc,
                           cache_dtype=torch.float32, **kw, **F32T)
    tok, cur, worst = toks[:, -1:], np.full((B,), S, np.int32), 0.0
    for _ in range(8):
        dj, sj = jbb.decode_step(pj, sj, jnp.asarray(tok), jnp.asarray(cur),
                                 jc, **F32J)
        dt, st = tbb.decode_step(pt, st, torch.as_tensor(tok),
                                 torch.as_tensor(cur), tc, **F32T)
        worst = max(worst, _rel(dt.numpy(), dj))
        tok = np.asarray(jnp.argmax(dj[:, 0], -1), np.int32)[:, None]
        cur = cur + 1
    _gap(f"{name} 8 decode steps, worst logits", worst)
    for part in st:
        for k in _entries(tc):
            _gap(f"{name} decode {part} {k}",
                 _rel(st[part][k].numpy(), sj[part][k]))


def test_decode_departs_from_forward_as_reference(model):
    """prefill(P) then decode(t) against forward(P + t)'s last position.
    With every expert computing every token (dense) the two are one
    function; with gspmd the decode step's capacity comes from its B
    tokens (cap = max(int(1.25·B·k/E), 1)), so it drops pairs the
    forward keeps and departs from it. The port departs by the
    reference's amount. B = 4: the step's 4 x 2 pairs share cap = 2
    places on each of 4 experts."""
    name, jc, tc, pj, pt = model
    toks = _tokens(4, b=4, s=S + 1)
    gaps = {}
    for side, (bbm, cfg, p, arr, kw) in {
            "ref": (jbb, jc, pj, jnp.asarray,
                    dict(cache_dtype=jnp.float32, **F32J)),
            "port": (tbb, tc, pt, torch.as_tensor,
                     dict(cache_dtype=torch.float32, **F32T))}.items():
        full = bbm.forward(p, arr(toks), cfg, **({"use_pallas": False}
                                                 if side == "ref" else {}),
                           compute_dtype=kw["compute_dtype"])[0][:, -1:]
        _, st, nxt = bbm.prefill(p, arr(toks[:, :S]), cfg, cache_len=32,
                                 **kw)
        step, _ = bbm.decode_step(p, st, arr(toks[:, S:]), nxt, cfg,
                                  compute_dtype=kw["compute_dtype"])
        gaps[side] = (np.asarray(step, np.float64),
                      np.asarray(full, np.float64))
    dep = {s: float(np.abs(a - b).max()) for s, (a, b) in gaps.items()}
    print(f"{name} decode vs forward, max abs: port {dep['port']:.3e}, "
          f"reference {dep['ref']:.3e}")
    if name == "granite-gspmd":
        assert dep["ref"] > 0.05 and dep["port"] > 0.05
    else:
        _gap(f"{name} prefill(P)+decode(t) vs forward(P+t)",
             _rel(*gaps["port"]))
    _gap(f"{name} decode logits vs the reference's", _rel(
        gaps["port"][0], gaps["ref"][0]))
    assert abs(dep["port"] - dep["ref"]) <= TOL * max(
        1.0, float(np.abs(gaps["ref"][1]).max()))


def test_batched_server_greedy_matches_reference(model):
    """8 requests on 4 slots (an empty prompt, slot reuse, a ring shorter
    than the longest sequence): the reference's greedy tokens and
    statuses. With gspmd a request's tokens depend on its batch-mates'
    slots, so only the reference's own tokens are the bar."""
    name, jc, tc, pj, pt = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=rng.integers(4, 12))
               for _ in range(8)]
    prompts[3] = np.array([], np.int64)
    kw = dict(slots=4, cache_len=16)
    js = jserve.BatchedServer(jc, pj, **kw)
    ts = tserve.BatchedServer(tc, pt, device="cpu", **kw)
    mk = lambda mod: [mod.Request(rid=i, prompt=p, max_new=3 + 7 * (i % 2))
                      for i, p in enumerate(prompts)]
    out_j, out_t = js.serve(mk(jserve)), ts.serve(mk(tserve))
    assert dict(out_t) == dict(out_j)
    assert out_t.status == out_j.status
    assert set(out_t.status.values()) == {"done"}
    assert np.array_equal(ts.pos, np.asarray(js.pos))


# --------------------------------------------------------------------------
# FedDCL's federated round
# --------------------------------------------------------------------------

D, H = 2, 2


@pytest.mark.parametrize("name", ["granite-gspmd", "deepseek",
                                  "deepseek-mla"])
def test_federated_round_matches_reference(name):
    """One fedavg round, d = 2 silos x H = 2 local steps, against the
    reference's jitted make_federated_round_step: the (H, d) metrics and
    the params; the silos equal after the sync."""
    fed = dict(num_silos=D, local_steps=H)
    jt, tt = _train_configs(name, federated=fed)
    jround, jopt = jsteps.make_federated_round_step(jt.model, jt)
    tround, topt = tsteps.make_federated_round_step(tt.model, tt,
                                                    device="cpu")
    p_np = _params(name)
    spj = jsilo_replicate(jax.tree.map(jnp.asarray, p_np), D)
    soj = jax.vmap(jopt.init)(spj)
    sp = tree_map(lambda a: a.contiguous(),
                  silo_replicate(lm_params_from_numpy(p_np, device="cpu"), D))
    so = tsteps.silo_opt_init(topt, sp)
    bs = [silo_batches(512, 32, B, D, h, seed=1) for h in range(H)]
    bs = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    spj, soj, mj = jax.jit(jround)(spj, soj, jax.tree.map(jnp.asarray, bs))
    sp, so, mt = tround(sp, so, bs)
    assert set(mt) == set(mj) and "moe_aux" in mt
    for k in sorted(mt):
        assert tuple(mt[k].shape) == (H, D)
        _gap(f"{name} round {k}", _rel(mt[k].numpy(), mj[k]))
    _tree_gap(f"{name} round params", sp, spj)
    assert all(torch.equal(a[1], a[0]) for a in tree_leaves(sp))


# --------------------------------------------------------------------------
# parameter counts and the train CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("registry", ["ARCHS", "REDUCED"])
def test_param_counts_equal_reference(registry):
    """Every moe arch, MLA's params included (its init is ported), with
    and without the embedding, all and active only."""
    moe = [n for n, c in getattr(tconfigs, registry).items()
           if c.family == "moe"]
    assert {GRANITE, DEEPSEEK} <= set(moe)
    for n in moe:
        tc, jc = getattr(tconfigs, registry)[n], getattr(jconfigs,
                                                         registry)[n]
        for active in (False, True):
            for embed in (True, False):
                assert (tbb.count_params_analytic(tc, active, embed)
                        == jbb.count_params_analytic(jc, active, embed)), (
                    n, active, embed)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    if registry == "ARCHS":
        g = tconfigs.ARCHS[GRANITE]
        assert (g.param_count(), g.active_param_count()) == (
            1_334_628_352, 428_658_688)


def test_train_cli_granite_loss_falls():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", GRANITE,
         "--reduced", "--device", "cpu", "--steps", "20"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step")]
    print(f"granite train CLI losses: {losses}")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
