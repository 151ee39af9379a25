"""The dense LM serving path: repro_torch.models.backbone against
repro.models.backbone with the reference's weights carried over
(``weights.lm_params_from_numpy``), same token ids made from a seed.

Configs: ``REDUCED`` llama3.2-1b with 2 kv heads (GQA 2:1) and gemma2-2b
with a 16-token window, so its alternating local layers mask at these
lengths (softcaps, post-norms and scaled embeddings included). Both sides
run fp32. The port runs its kernel path (``use_kernels=True``: on the CPU,
the flash kernel's plain version); the reference runs ``use_pallas=False``,
its ``sdpa`` path — its Pallas path does not run inside a model (ROADMAP.md
Queue 3). Bar: 1e-4 relative (Frobenius) on logits and caches; the
measured gaps print under ``pytest -s``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


TOL = 1e-4
OVERRIDES = {"llama3.2-1b": dict(num_kv_heads=2),
             "gemma2-2b": dict(sliding_window=16)}
B, S = 2, 40
F32 = dict(compute_dtype=jnp.float32)
TF32 = dict(compute_dtype=torch.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float = TOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def model(request):
    """(arch, reference cfg, port cfg, reference params, port params)."""
    arch = request.param
    jc = jconfigs.REDUCED[arch].with_overrides(**OVERRIDES[arch])
    tc = tconfigs.REDUCED[arch].with_overrides(**OVERRIDES[arch])
    pj = jbb.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return arch, jc, tc, pj, pt


def _tokens(seed, b=B, s=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_weights_round_trip(model):
    _, _, _, pj, pt = model
    back = lm_params_to_numpy(pt)
    leaves_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(leaves_j) == len(jax.tree_util.tree_leaves(back))
    for path, a in leaves_j:
        b = back
        for p in path:
            b = b[p.key]
        assert np.array_equal(np.asarray(a), b), path


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits(model, use_kernels):
    arch, jc, tc, pj, pt = model
    toks = _tokens(0)
    lj, hj, _ = jbb.forward(pj, jnp.asarray(toks), jc, use_pallas=False, **F32)
    lt, ht, aux = tbb.forward(pt, torch.as_tensor(toks), tc,
                              use_kernels=use_kernels, **TF32)
    assert lt.shape == (B, S, tc.vocab_size) and lt.dtype == torch.float32
    assert aux["loss_mask"].all()
    _gap(f"{arch} forward logits (kernels={use_kernels})",
         _rel(lt.numpy(), lj))
    _gap(f"{arch} forward hidden", _rel(ht.numpy(), hj))


@pytest.mark.parametrize("cache_len", [64, 24])     # > S and < S (ring)
def test_prefill_logits_and_caches(model, cache_len):
    arch, jc, tc, pj, pt = model
    toks = _tokens(1)
    lj, sj, nj = jbb.prefill(pj, jnp.asarray(toks), jc, cache_len=cache_len,
                             cache_dtype=jnp.float32, **F32)
    lt, st, nt = tbb.prefill(pt, torch.as_tensor(toks), tc,
                             cache_len=cache_len, cache_dtype=torch.float32,
                             **TF32)
    assert lt.shape == (B, 1, tc.vocab_size)
    _gap(f"{arch} prefill last logits (C={cache_len})", _rel(lt.numpy(), lj))
    for name in ("k", "v"):
        assert st["cache"][name].shape == sj["cache"][name].shape
        _gap(f"{arch} prefill {name} cache (C={cache_len})",
             _rel(st["cache"][name].numpy(), sj["cache"][name]))
    assert np.array_equal(st["cache"]["pos"].numpy(),
                          np.asarray(sj["cache"]["pos"]))
    assert np.array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("cache_len", [64, 24])
def test_decode_steps_after_prefill(model, cache_len):
    """8 cached decode steps from a prefilled state; the reference's greedy
    token feeds both, so the inputs stay identical."""
    arch, jc, tc, pj, pt = model
    toks = _tokens(2)
    _, sj, _ = jbb.prefill(pj, jnp.asarray(toks), jc, cache_len=cache_len,
                           cache_dtype=jnp.float32, **F32)
    _, st, _ = tbb.prefill(pt, torch.as_tensor(toks), tc,
                           cache_len=cache_len, cache_dtype=torch.float32,
                           **TF32)
    tok = toks[:, -1:]
    cur = np.full((B,), S, np.int32)
    worst = 0.0
    for _ in range(8):
        dj, sj = jbb.decode_step(pj, sj, jnp.asarray(tok), jnp.asarray(cur),
                                 jc, **F32)
        dt, st = tbb.decode_step(pt, st, torch.as_tensor(tok),
                                 torch.as_tensor(cur), tc, **TF32)
        worst = max(worst, _rel(dt.numpy(), dj))
        tok = np.asarray(jnp.argmax(dj[:, 0], -1), np.int32)[:, None]
        cur = cur + 1
    _gap(f"{arch} 8 decode steps, worst logits (C={cache_len})", worst)
    for name in ("k", "v"):
        _gap(f"{arch} decode {name} cache (C={cache_len})",
             _rel(st["cache"][name].numpy(), sj["cache"][name]))
    assert np.array_equal(st["cache"]["pos"].numpy(),
                          np.asarray(sj["cache"]["pos"]))


def test_decode_from_empty_state(model):
    """Decode token by token from init_decode_state, as the server does."""
    arch, jc, tc, pj, pt = model
    toks = _tokens(3, s=12)
    sj = jbb.init_decode_state(jc, B, 16, jnp.float32)
    st = tbb.init_decode_state(tc, B, 16, torch.float32, device="cpu")
    worst = 0.0
    for i in range(toks.shape[1]):
        cur = np.full((B,), i, np.int32)
        dj, sj = jbb.decode_step(pj, sj, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.asarray(cur), jc, **F32)
        dt, st = tbb.decode_step(pt, st, torch.as_tensor(toks[:, i:i + 1]),
                                 torch.as_tensor(cur), tc, **TF32)
        worst = max(worst, _rel(dt.numpy(), dj))
    _gap(f"{arch} decode from empty, worst logits", worst)


def test_prefill_then_decode_equals_longer_prefill(model):
    """The port alone: prefill(prompt + t) == prefill(prompt) + decode(t),
    with the kernel path on the prefill side."""
    arch, _, tc, _, pt = model
    toks = torch.as_tensor(_tokens(4, s=S + 1))
    full, _, _ = tbb.prefill(pt, toks, tc, cache_len=64,
                             cache_dtype=torch.float32, **TF32)
    _, st, nxt = tbb.prefill(pt, toks[:, :S], tc, cache_len=64,
                             cache_dtype=torch.float32, **TF32)
    step, _ = tbb.decode_step(pt, st, toks[:, S:], nxt, tc, **TF32)
    _gap(f"{arch} prefill(P+t) vs prefill(P)+decode(t)",
         _rel(step.numpy(), full.numpy()))


def test_sdpa_qchunked_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 32, 2, 16)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)[None]
    kw = dict(is_local=True, window=8, softcap=20.0)
    oj = jlayers.sdpa_qchunked(*(jnp.asarray(a) for a in (q, k, v)),
                               q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                               chunk=8, **kw)
    tp = torch.as_tensor(pos)
    ot = tlayers.sdpa_qchunked(*(torch.as_tensor(a) for a in (q, k, v)),
                               q_pos=tp, k_pos=tp, chunk=8, **kw)
    _gap("sdpa_qchunked", _rel(ot.numpy(), oj))
    whole = tlayers.sdpa_reference(*(torch.as_tensor(a) for a in (q, k, v)),
                                   q_pos=tp, k_pos=tp, **kw)
    assert torch.allclose(ot, whole, atol=1e-6)


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("registry", ["ARCHS", "REDUCED"])
def test_config_registry_equals_reference(registry):
    jreg, treg = getattr(jconfigs, registry), getattr(tconfigs, registry)
    assert list(treg) == list(jreg)
    for name in jreg:
        assert _fields(treg[name]) == _fields(jreg[name]), name
        assert tconfigs.get_arch(name) == tconfigs.ARCHS[name]
    assert ({k: _fields(v) for k, v in tconfigs.INPUT_SHAPES.items()}
            == {k: _fields(v) for k, v in jconfigs.INPUT_SHAPES.items()})
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-5")


def test_param_count_equals_reference_for_dense():
    """Every config of both registries, of every family: the port's count
    (its init on the `meta` device, ``ln_prefix`` and MLA's leaves
    included) equals the reference's, with and without the embedding."""
    for registry in ("ARCHS", "REDUCED"):
        treg, jreg = getattr(tconfigs, registry), getattr(jconfigs, registry)
        assert {c.family for c in treg.values()} == {
            "dense", "ssm", "moe", "hybrid", "audio", "vlm"}
        for name in treg:
            assert treg[name].param_count() == jreg[name].param_count(), name
            assert (tbb.count_params_analytic(treg[name], include_embed=False)
                    == jbb.count_params_analytic(jreg[name],
                                                 include_embed=False)), name
    assert tconfigs.ARCHS["llama3.2-1b"].param_count() == 1_235_814_400
    assert tconfigs.ARCHS["musicgen-large"].param_count() == 3_229_814_784


def test_unported_families_raise():
    """No family raises any more: every ARCHS config, the modality-prefix
    ones (musicgen, audio; chameleon, vlm) and MLA (deepseek) included,
    inits on the `meta` device and has a decode state: K/V caches, MLA's
    latent ones (``ckv`` / ``krope``), rwkv6's recurrence or the hybrid's
    Mamba2 states and shared cache."""
    archs = tconfigs.ARCHS.values()
    assert {c.family for c in archs} == {"dense", "ssm", "moe", "hybrid",
                                         "audio", "vlm"}
    assert any(c.mla is not None for c in archs)
    assert any(c.prefix_frontend for c in archs)
    for cfg in archs:
        params = tbb.init_params(cfg, None, device="meta")
        assert ("ln_prefix" in params) == cfg.prefix_frontend, cfg.name
        state = tbb.init_decode_state(cfg, 1, 8, device="meta")
        assert state, cfg.name
        if cfg.mla is not None:
            assert set(state) == {"dense_cache", "cache"}
            assert set(state["cache"]) == {"ckv", "krope", "pos"}
            assert (state["cache"]["ckv"].shape[-1]
                    == cfg.mla.kv_lora_rank)
        elif cfg.family in ("dense", "audio", "vlm"):
            assert set(state["cache"]) == {"k", "v", "pos"}
