"""The modality-prefix families: repro_torch's ``models.modality``, the
prefix in the backbone (``embed_inputs``, forward, loss, prefill, decode),
chameleon's qk-norm, the steps with ``prefix_embeds`` in the batch,
``BatchedServer`` and ``train()`` against the JAX reference's, with the
reference's weights and prefixes carried over (``weights``; torch cannot
reproduce ``jax.random``) and token ids made from a seed with NumPy.

Configs: ``REDUCED["musicgen-large"]`` (audio: 2 layers, d 256, MHA 4/4
heads of 64, prefix 8) and ``REDUCED["chameleon-34b"]`` with 2 kv heads
(vlm: GQA 2:1, qk-norm, prefix 8). Both sides run fp32; the port runs its
kernel path (on the CPU, the flash kernel's plain version) unless a test
says otherwise, the reference ``use_pallas=False``. Bar: 1e-4 relative
(Frobenius; the largest leaf of a tree), 1e-6 for the prefix itself and
the embedding, 1e-5 for one attention layer. The measured gaps print
under ``pytest -s`` as ``parity-gap`` lines.
"""
import contextlib

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
from repro.models import modality as jmodality  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import FederatedConfig, TrainConfig  # noqa: E402
from repro_torch.core.federated import silo_replicate  # noqa: E402
from repro_torch.data.tokens import TokenStream, silo_batches  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import modality as tmodality  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402

TOL = 1e-4
ARCH = {"musicgen": "musicgen-large", "chameleon": "chameleon-34b"}
OVERRIDES = {"musicgen": {}, "chameleon": dict(num_kv_heads=2)}
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


def _configs(name):
    """(reference cfg, port cfg) of one of the two test configs."""
    return tuple(reg[ARCH[name]].with_overrides(**OVERRIDES[name])
                 for reg in (jconfigs.REDUCED, tconfigs.REDUCED))


_PARAMS = {}


def _params(name):
    """The reference's params of a config (jitted init), as NumPy."""
    if name not in _PARAMS:
        jc, _ = _configs(name)
        pj = jax.jit(lambda k: jbb.init_params(jc, k, jnp.float32))(
            jax.random.PRNGKey(0))
        _PARAMS[name] = jax.tree.map(np.asarray, pj)
    return _PARAMS[name]


@pytest.fixture(scope="module", params=list(ARCH))
def model(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    jc, tc = _configs(request.param)
    p_np = _params(request.param)
    return (request.param, jc, tc, jax.tree.map(jnp.asarray, p_np),
            lm_params_from_numpy(p_np, device="cpu"))


def _prefix(jc, seed, *lead):
    """The reference's synthetic_prefix of prod(lead) rows, reshaped to
    lead + (P, d), as NumPy."""
    n = int(np.prod(lead))
    pe = jmodality.synthetic_prefix(jax.random.PRNGKey(seed), jc, n)
    return np.asarray(pe).reshape(lead + pe.shape[1:])


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


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(seed, jc, b=B, s=S):
    toks = _tokens(seed, b, s + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "prefix_embeds": _prefix(jc, seed, b)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# models.modality
# --------------------------------------------------------------------------

def test_smooth_prefix_matches_reference():
    """The reference's own normal draw through the port's smoothing (the
    EMA over the prefix axis, each row over its population std) against
    the reference's synthetic_prefix; the port's own draw: the shape, dtype
    and unit rows, the same from the same generator seed."""
    jc, tc = _configs("musicgen")
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, (3, jc.prefix_len, jc.d_model),
                              jnp.float32)
    want = jmodality.synthetic_prefix(key, jc, 3)
    got = tmodality.smooth_prefix(torch.tensor(np.asarray(noise)))
    assert got.dtype == torch.float32
    _gap("smooth_prefix on the reference's draw", _rel(got.numpy(), want),
         1e-6)
    assert tmodality.prefix_spec(tc, 5) == (
        torch.Size((5, tc.prefix_len, tc.d_model)), torch.bfloat16)
    draw = lambda: tmodality.synthetic_prefix(
        torch.Generator().manual_seed(1), tc, 4, torch.bfloat16,
        device="cpu")
    pe = draw()
    assert pe.shape == (4, tc.prefix_len, tc.d_model)
    assert pe.dtype == torch.bfloat16 and torch.equal(pe, draw())
    std = pe.float().std(dim=-1, unbiased=False)
    assert torch.allclose(std, torch.ones_like(std), atol=1e-2)
    with pytest.raises(ValueError, match="no modality prefix"):
        tmodality.synthetic_prefix(None, tconfigs.REDUCED["llama3.2-1b"], 1,
                                   device="cpu")


def test_embed_inputs_with_prefix(model):
    """The prefix normed by ``ln_prefix`` in front of the tokens: positions
    0..P+S-1 and a mask False over the prefix, exactly; x within 1e-6. A
    prefix family without a prefix raises."""
    name, jc, tc, pj, pt = model
    toks = _tokens(0)
    pe = _prefix(jc, 0, B)
    pt = dict(pt)
    pt["ln_prefix"] = {"scale": torch.linspace(0.5, 1.5, tc.d_model)}
    pj = dict(pj)
    pj["ln_prefix"] = {"scale": jnp.asarray(pt["ln_prefix"]["scale"].numpy())}
    xj, posj, mj = jbb.embed_inputs(pj, jnp.asarray(toks), jc,
                                    prefix_embeds=jnp.asarray(pe))
    xt, post, mt = tbb.embed_inputs(pt, torch.as_tensor(toks), tc,
                                    prefix_embeds=torch.as_tensor(pe))
    P = tc.prefix_len
    assert xt.shape == (B, P + S, tc.d_model)
    assert np.array_equal(post.numpy(), np.asarray(posj))
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert not mt[:, :P].any() and mt[:, P:].all()
    _gap(f"{name} embed_inputs x", _rel(xt.numpy(), xj), 1e-6)
    with pytest.raises(ValueError, match="requires prefix_embeds"):
        tbb.embed_inputs(pt, torch.as_tensor(toks), tc)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_qk_norm_attention_matches_reference(use_kernels):
    """chameleon's qk-norm (RMSNorm of each head's q and k before RoPE) in
    one attention layer, with non-unit norm scales, on the kernel path and
    on the plain path, against the reference's multi_head_attention; the
    rope'd keys it returns for the cache too."""
    jc, tc = _configs("chameleon")
    assert tc.qk_norm and tc.num_heads // tc.num_kv_heads == 2
    p = jax.tree.map(lambda a: a[0], _params("chameleon")["layers"]["attn"])
    rng = np.random.default_rng(5)
    for k in ("q_norm", "k_norm"):
        p[k]["scale"] = rng.uniform(0.5, 1.5, tc.head_dim).astype(np.float32)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    oj, (kj, vj) = jlayers.multi_head_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc,
        positions=jnp.asarray(pos), return_kv=True)
    ot, (kt, vt) = tlayers.multi_head_attention(
        lm_params_from_numpy(p, device="cpu"), torch.as_tensor(x), tc,
        positions=torch.as_tensor(pos), use_kernels=use_kernels,
        return_kv=True)
    _gap(f"qk-norm attention output (kernels={use_kernels})",
         _rel(ot.numpy(), oj), 1e-5)
    _gap("qk-norm attention rope'd keys", _rel(kt.numpy(), kj), 1e-5)
    _gap("qk-norm attention values", _rel(vt.numpy(), vj), 1e-5)


# --------------------------------------------------------------------------
# the model: weights, counts, forward, loss, gradients, train steps
# --------------------------------------------------------------------------

def test_weights_round_trip_and_counts(model):
    """The tree carries ``ln_prefix`` (d,) beside the dense stack, with no
    transposes; the port's own init draws the same tree; both registries'
    parameter counts equal the reference's."""
    name, jc, tc, pj, pt = model
    back = lm_params_to_numpy(pt)
    paths = jax.tree_util.tree_leaves_with_path(pj)
    assert len(paths) == len(tree_leaves(back))
    for path, a in paths:
        assert np.array_equal(np.asarray(a), _leaf(back, path)), path
    assert tuple(pt["ln_prefix"]["scale"].shape) == (tc.d_model,)
    own = tbb.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: sorted((k, tuple(t.shape)) for k, t in
                                 zip(_paths(tree), tree_leaves(tree)))
    assert shapes(own) == shapes(pt)
    for reg in ("ARCHS", "REDUCED"):
        t, j = (getattr(r, reg)[ARCH[name]] for r in (tconfigs, jconfigs))
        for embed in (True, False):
            assert (tbb.count_params_analytic(t, include_embed=embed)
                    == jbb.count_params_analytic(j, include_embed=embed))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits(model, use_kernels):
    """(B, P + S) logits: the port's kernel path and plain path against the
    reference's plain forward."""
    name, jc, tc, pj, pt = model
    toks, pe = _tokens(0), _prefix(jc, 1, B)
    lj, hj, auxj = jbb.forward(pj, jnp.asarray(toks), jc,
                               prefix_embeds=jnp.asarray(pe),
                               use_pallas=False, **F32J)
    with torch.no_grad():
        lt, ht, auxt = tbb.forward(pt, torch.as_tensor(toks), tc,
                                   prefix_embeds=torch.as_tensor(pe),
                                   use_kernels=use_kernels, **F32T)
    assert lt.shape == (B, tc.prefix_len + S, tc.vocab_size)
    assert np.array_equal(auxt["loss_mask"].numpy(),
                          np.asarray(auxj["loss_mask"]))
    _gap(f"{name} forward logits (kernels={use_kernels})",
         _rel(lt.numpy(), lj))
    _gap(f"{name} forward hidden", _rel(ht.numpy(), hj))


def test_loss_fn_matches_reference(model):
    """The loss over the token positions only (hidden sliced at P), with
    ignored labels."""
    name, jc, tc, pj, pt = model
    batch = _batch(6, jc)
    batch["labels"][0, :3] = -1
    _, mj = jbb.loss_fn(pj, _j(batch), jc, use_pallas=False, **F32J)
    with torch.no_grad():
        _, mt = tbb.loss_fn(pt, _t(batch), tc, **F32T)
    assert set(mt) == set(mj) == {"ce", "loss"}
    for k in sorted(mt):
        _gap(f"{name} loss_fn {k}", _rel(float(mt[k]), float(mj[k])))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_gradients_match_jax_grad(model, remat):
    """Every leaf's gradient, ``ln_prefix``'s and the qk-norm scales'
    included."""
    name, jc, tc, pj, pt = model
    batch = _batch(7, jc)
    gj = jax.jit(jax.grad(lambda p, b: jbb.loss_fn(
        p, b, jc, use_pallas=False, remat=remat, **F32J)[0]))(pj, _j(batch))
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(pt)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), pt)
    loss, _ = tbb.loss_fn(live, _t(batch), tc, use_kernels=False,
                          remat=remat, **F32T)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gt = tree_map(lambda _: next(it), pt)
    _tree_gap(f"{name} loss gradients remat={remat}", gt, gj)
    _gap(f"{name} ln_prefix gradient",
         _rel(gt["ln_prefix"]["scale"].numpy(), gj["ln_prefix"]["scale"]))


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


def test_three_train_steps_match_reference():
    """Three AdamW steps of make_train_step on musicgen with
    ``prefix_embeds`` in the batch (NumPy, the reference's draws): each
    step's metrics and the params after three. A step that dropped the
    prefix would fail."""
    name = "musicgen"
    jc, tc = _configs(name)
    p_np = _params(name)
    pj, pt = jax.tree.map(jnp.asarray, p_np), p_np
    jt, tt = _train_configs(name)
    jstep, jopt = jsteps.make_train_step(jc, jt)
    jstep = jax.jit(jstep)
    tstep, topt = tsteps.make_train_step(tc, tt, use_kernels=False,
                                         device="cpu")
    pj_, oj = pj, jopt.init(pj)
    pt_ = lm_params_from_numpy(pt, device="cpu")
    ot = topt.init(pt_)
    stream = TokenStream(tc.vocab_size, S, B, seed=7)
    for step in range(3):
        b = dict(stream.batch(step), prefix_embeds=_prefix(jc, 20 + step, B))
        pj_, oj, mj = jstep(pj_, oj, _j(b))
        pt_, ot, mt = tstep(pt_, ot, b)
        assert set(mt) == set(mj)
        for k in sorted(mt):
            _gap(f"{name} train step {step} {k}",
                 _rel(float(mt[k]), float(mj[k])))
    _tree_gap(f"{name} params after 3 train steps", pt_, pj_)


D, H = 2, 2


def test_federated_round_matches_reference():
    """One fedavg round, d = 2 silos x H = 2 local steps, with the prefix
    (H, d, b, P, d) in the batches, sliced per silo like the tokens: the
    (H, d) metrics and the params; the silos equal after the sync."""
    name = "musicgen"
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
    bs = [silo_batches(512, S, B, D, h, seed=1) for h in range(H)]
    bs = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    bs["prefix_embeds"] = _prefix(jt.model, 9, H, D, B)
    spj, soj, mj = jax.jit(jround)(spj, soj, _j(bs))
    sp, so, mt = tround(sp, so, bs)
    assert set(mt) == set(mj)
    for k in sorted(mt):
        assert tuple(mt[k].shape) == (H, D)
        _gap(f"{name} round {k}", _rel(mt[k].numpy(), mj[k]))
    _tree_gap(f"{name} round params", sp, spj)
    assert all(torch.equal(a[1], a[0]) for a in tree_leaves(sp))


# --------------------------------------------------------------------------
# serving: prefill, decode, BatchedServer
# --------------------------------------------------------------------------

def _state_gap(what, st, sj) -> None:
    for part in st:
        for k in ("k", "v"):
            assert st[part][k].shape == sj[part][k].shape
            _gap(f"{what} {part} {k}", _rel(st[part][k].numpy(),
                                           sj[part][k]))
        assert np.array_equal(st[part]["pos"].numpy(),
                              np.asarray(sj[part]["pos"]))


@pytest.mark.parametrize("name,cache_len", [("musicgen", 16),  # a ring
                                            ("chameleon", 64)])  # > P + S
def test_prefill_logits_and_cache(name, cache_len):
    """The cache holds the prefix's entries (a ring of 16 keeps the last
    16 of P + S = 32 positions); the next position is P + S."""
    jc, tc = _configs(name)
    p_np = _params(name)
    pj, pt = (jax.tree.map(jnp.asarray, p_np),
              lm_params_from_numpy(p_np, device="cpu"))
    toks, pe = _tokens(1), _prefix(jc, 2, B)
    lj, sj, nj = jbb.prefill(pj, jnp.asarray(toks), jc, cache_len=cache_len,
                             prefix_embeds=jnp.asarray(pe),
                             cache_dtype=jnp.float32, **F32J)
    lt, st, nt = tbb.prefill(pt, torch.as_tensor(toks), tc,
                             cache_len=cache_len,
                             prefix_embeds=torch.as_tensor(pe),
                             cache_dtype=torch.float32, **F32T)
    assert lt.shape == (B, 1, tc.vocab_size) and set(st) == {"cache"}
    assert nt.tolist() == [tc.prefix_len + S] * B == np.asarray(nj).tolist()
    _gap(f"{name} prefill last logits (C={cache_len})", _rel(lt.numpy(), lj))
    _state_gap(f"{name} prefill (C={cache_len})", st, sj)


def test_decode_steps_after_prefill(model):
    """prefill(S - 1) after the prefix, then 8 decode steps (a ring of
    P + S + 4, so it wraps over the prefix's first slots); the reference's
    greedy token feeds both. The first step's logits also against the
    forward's last position over the prefix and all S tokens."""
    name, jc, tc, pj, pt = model
    toks, pe = _tokens(2), _prefix(jc, 3, B)
    kw = dict(cache_len=tc.prefix_len + S + 4)
    _, sj, nj = jbb.prefill(pj, jnp.asarray(toks[:, :-1]), jc,
                            prefix_embeds=jnp.asarray(pe),
                            cache_dtype=jnp.float32, **kw, **F32J)
    _, st, nt = tbb.prefill(pt, torch.as_tensor(toks[:, :-1]), tc,
                            prefix_embeds=torch.as_tensor(pe),
                            cache_dtype=torch.float32, **kw, **F32T)
    with torch.no_grad():
        full, _, _ = tbb.forward(pt, torch.as_tensor(toks), tc,
                                 prefix_embeds=torch.as_tensor(pe), **F32T)
    jdecode = jax.jit(lambda p, s, t, c: jbb.decode_step(p, s, t, c, jc,
                                                          **F32J))
    tok, cur, worst = toks[:, -1:], np.asarray(nj), 0.0
    for i in range(8):
        dj, sj = jdecode(pj, sj, jnp.asarray(tok), jnp.asarray(cur))
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


def test_batched_server_greedy_matches_reference():
    """8 requests on 4 slots (an empty prompt, slot reuse, a ring shorter
    than the longest sequence) on musicgen: the reference's server serves
    a prefix family from its tokens alone (no request carries a prefix),
    and so does the port: the same greedy tokens and statuses."""
    jc, tc = _configs("musicgen")
    p_np = _params("musicgen")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=rng.integers(4, 12))
               for _ in range(8)]
    prompts[3] = np.array([], np.int64)
    kw = dict(slots=4, cache_len=16)
    mk = lambda mod: [mod.Request(rid=i, prompt=p, max_new=3 + 7 * (i % 2))
                      for i, p in enumerate(prompts)]
    out_j = jserve.BatchedServer(jc, jax.tree.map(jnp.asarray, p_np),
                                 **kw).serve(mk(jserve))
    out_t = tserve.BatchedServer(tc, lm_params_from_numpy(p_np, device="cpu"),
                                 device="cpu", **kw).serve(mk(tserve))
    assert dict(out_t) == dict(out_j)
    assert out_t.status == out_j.status
    assert set(out_t.status.values()) == {"done"}


def test_prefill_step_serve_step_and_cli(capsys):
    """make_prefill_step forwards the batch's ``prefix_embeds`` (NumPy);
    the serve step continues from P + S; the serve CLI runs the reduced
    musicgen and chameleon."""
    jc, tc = _configs("musicgen")
    pt = lm_params_from_numpy(_params("musicgen"), device="cpu")
    toks, pe = _tokens(3), _prefix(jc, 4, B)
    prefill = tsteps.make_prefill_step(tc, cache_len=64, device="cpu",
                                       cache_dtype=torch.float32, **F32T)
    _, state, nxt = prefill(pt, {"tokens": toks[:, :-1], "prefix_embeds": pe})
    assert nxt.tolist() == [tc.prefix_len + S - 1] * B
    serve = tsteps.make_serve_step(tc, device="cpu", **F32T)
    logits, _ = serve(pt, state, toks[:, -1:], nxt.numpy())
    with torch.no_grad():
        full, _, _ = tbb.forward(pt, torch.as_tensor(toks), tc,
                                 prefix_embeds=torch.as_tensor(pe), **F32T)
    _gap("prefill step + serve step vs forward's last",
         _rel(logits.numpy(), full[:, -1:].numpy()))
    with pytest.raises(ValueError, match="requires prefix_embeds"):
        prefill(pt, {"tokens": toks})
    for arch in ARCH.values():
        tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                     "--max-new", "4"])
        printed = capsys.readouterr().out
        assert "served 3 requests, 12 tokens" in printed, arch


# --------------------------------------------------------------------------
# train(): both branches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("silos", [1, 2])
def test_train_musicgen_loss_falls(silos, monkeypatch):
    """train() on the reduced musicgen draws a prefix every step (baseline
    (batch, P, d); federated (H, silos, batch/silos, P, d)), trains on
    plain attention, and its loss is finite and falls."""
    seen = []
    real = tsteps.make_train_step

    def spy(cfg, tc, **kw):
        seen.append(kw["use_kernels"])
        return real(cfg, tc, **kw)

    monkeypatch.setattr(ttrain.steps_lib, "make_train_step", spy)
    monkeypatch.setattr(tsteps, "make_train_step", spy)
    drawn = []
    real_prefix = ttrain.step_prefix

    def spy_prefix(cfg, seed, step, shape, dev):
        drawn.append(tuple(shape))
        return real_prefix(cfg, seed, step, shape, dev)

    monkeypatch.setattr(ttrain, "step_prefix", spy_prefix)
    _, hist = ttrain.train("musicgen-large", steps=16, batch=4, seq=32,
                           lr=3e-3, silos=silos, local_steps=2, log_every=5,
                           device="cpu")
    losses = [r["loss"] for r in hist]
    print(f"musicgen train silos={silos} losses: {losses}")
    assert seen and not any(seen)
    assert drawn == ([(4,)] * 16 if silos == 1 else [(2, 2)] * 16)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    # the draw depends on (seed, step) alone
    cfg = tconfigs.REDUCED["musicgen-large"]
    a = real_prefix(cfg, 0, 3, (2,), torch.device("cpu"))
    assert torch.equal(a, real_prefix(cfg, 0, 3, (2,), torch.device("cpu")))
    assert not torch.equal(a, real_prefix(cfg, 0, 4, (2,),
                                          torch.device("cpu")))
