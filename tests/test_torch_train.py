"""The training path: repro_torch's rwkv6 layers, forward, loss_fn,
make_train_step and train CLI against the JAX reference's, with the
reference's weights carried over (``weights.lm_params_from_numpy``) and
batches from both packages' ``TokenStream`` (equal bit for bit).

Configs: ``REDUCED["rwkv6-3b"]`` (2 layers, d 256, 8 heads of 32) and, for
the dense loss, ``REDUCED["llama3.2-1b"]``. Both sides run fp32. The port
runs its kernel path (``use_kernels=True``: on the CPU, the chunked plain
WKV6 form); the reference runs ``use_pallas=False``, whose ``wkv6_chunked``
its own tests hold equal to its Pallas kernel. Bar: 1e-4 relative
(Frobenius) on logits, losses, gradients and parameters; the measured gaps
print under ``pytest -s``.
"""
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
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
ARCH = "rwkv6-3b"


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float = TOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _leaf_gap(what, port_tree, ref_tree) -> None:
    """Largest per-leaf relative gap between a port tree (tensors) and a
    reference tree (jax arrays), leaves matched by key path."""
    ref_np = jax.tree.map(np.asarray, ref_tree)
    port_np = lm_params_to_numpy(port_tree)
    paths = jax.tree_util.tree_leaves_with_path(ref_np)
    assert len(paths) == len(tree_leaves(port_np))
    worst = 0.0
    for path, want in paths:
        got = port_np
        for key in path:
            got = got[key.key]
        assert got.shape == want.shape, path
        worst = max(worst, _rel(got, want))
    _gap(what, worst)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params) for
    REDUCED rwkv6-3b."""
    jc, tc = jconfigs.REDUCED[ARCH], tconfigs.REDUCED[ARCH]
    pj = jbb.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return jc, tc, pj, pt


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch(seed, b, s):
    toks = _tokens(seed, b, s + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, silo=2),
                                dict(seed=3, silo=2, non_iid=True)])
def test_token_stream_bit_for_bit(kw):
    for vocab, seq, batch in ((512, 64, 4), (65536, 100, 2)):
        a = jtokens.TokenStream(vocab, seq, batch, **kw)
        b = ttokens.TokenStream(vocab, seq, batch, **kw)
        for step in (0, 1, 17):
            ba, bb_ = a.batch(step), b.batch(step)
            assert ba.keys() == bb_.keys()
            for key in ba:
                assert ba[key].dtype == bb_[key].dtype
                np.testing.assert_array_equal(ba[key], bb_[key])
    sa = jtokens.silo_batches(512, 32, 2, 3, 5, seed=1, non_iid=True)
    sb = ttokens.silo_batches(512, 32, 2, 3, 5, seed=1, non_iid=True)
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("S", [32, 40])       # whole chunks, and ragged
def test_timemix_matches_reference(model, S):
    jc, tc, pj, pt = model
    x = np.random.default_rng(1).standard_normal((2, S, jc.d_model)).astype(
        np.float32)
    tm_j = _layer0(pj["layers"]["tm"])
    tm_t = lm_params_from_numpy(jax.tree.map(np.asarray, tm_j), device="cpu")
    want, st_j = jlayers.rwkv6_timemix(tm_j, jnp.asarray(x), jc,
                                       use_pallas=False, return_state=True)
    got = tlayers.rwkv6_timemix(tm_t, torch.tensor(x), tc)
    got_s, st_t = tlayers.rwkv6_timemix(tm_t, torch.tensor(x), tc,
                                        return_state=True)
    _gap(f"rwkv6_timemix S={S}", _rel(got.numpy(), want))
    _gap(f"rwkv6_timemix with state S={S}", _rel(got_s.numpy(), want))
    _gap(f"rwkv6_timemix final state S={S}", _rel(st_t.numpy(), st_j))


def test_channelmix_matches_reference(model):
    jc, _, pj, _ = model
    rng = np.random.default_rng(2)
    x, xp = (rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
             for _ in range(2))
    cm_j = _layer0(pj["layers"]["cm"])
    cm_t = lm_params_from_numpy(jax.tree.map(np.asarray, cm_j), device="cpu")
    want = jlayers.rwkv6_channelmix(cm_j, jnp.asarray(x), jnp.asarray(xp))
    got = tlayers.rwkv6_channelmix(cm_t, torch.tensor(x), torch.tensor(xp))
    _gap("rwkv6_channelmix", _rel(got.numpy(), want))


def test_weights_carry_the_rwkv6_tree(model):
    _, _, pj, pt = model
    assert set(pt["layers"]) == {"ln_att", "ln_ffn", "tm", "cm"}
    for leaf in tree_leaves(pt):
        assert leaf.dtype == torch.float32
    back = lm_params_to_numpy(pt)
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, pj)):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, want)


def test_train_configs_equal_reference():
    import dataclasses
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    for name in ("TrainConfig", "FederatedConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jbase, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(tbase, name))]
        assert tf == jf, name
    assert dataclasses.asdict(tbase.FederatedConfig()) == dataclasses.asdict(
        jbase.FederatedConfig())


def test_param_count_equals_reference_for_ssm():
    for reg in ("ARCHS", "REDUCED"):
        tcfg = getattr(tconfigs, reg)[ARCH]
        assert tcfg.param_count() == getattr(jconfigs, reg)[ARCH].param_count()
    assert tconfigs.ARCHS[ARCH].param_count() == 3_154_496_000


# --------------------------------------------------------------------------
# forward and loss
# --------------------------------------------------------------------------

F32J = dict(compute_dtype=jnp.float32)
F32T = dict(compute_dtype=torch.float32)


@pytest.mark.parametrize("B,S", [(2, 32), (1, 1024)])
def test_forward_and_loss_match_reference(model, B, S):
    """S = 1024 runs chunked_xent's chunked branch (S % 512 == 0, S > 512)."""
    jc, tc, pj, pt = model
    batch = _batch(3, B, S)
    lj, _, _ = jbb.forward(pj, jnp.asarray(batch["tokens"]), jc,
                           use_pallas=False, **F32J)
    with torch.no_grad():
        lt, _, _ = tbb.forward(pt, torch.tensor(batch["tokens"]), tc, **F32T)
    _gap(f"rwkv6 forward logits B={B} S={S}", _rel(lt.numpy(), lj))
    loss_j, _ = jbb.loss_fn(pj, jax.tree.map(jnp.asarray, batch), jc,
                            use_pallas=False, **F32J)
    with torch.no_grad():
        loss_t, met = tbb.loss_fn(pt, {k: torch.tensor(v)
                                       for k, v in batch.items()}, tc, **F32T)
    assert set(met) == {"ce", "loss"}
    _gap(f"rwkv6 loss_fn B={B} S={S}", _rel(float(loss_t), float(loss_j)))


@pytest.mark.parametrize("S", [32, 1024])
def test_dense_loss_matches_reference(S):
    jc, tc = jconfigs.REDUCED["llama3.2-1b"], tconfigs.REDUCED["llama3.2-1b"]
    pj = jbb.init_params(jc, jax.random.PRNGKey(1), jnp.float32)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    batch = _batch(4, 1, S)
    batch["labels"][0, :5] = -1                      # ignored positions
    loss_j, _ = jbb.loss_fn(pj, jax.tree.map(jnp.asarray, batch), jc,
                            use_pallas=False, **F32J)
    with torch.no_grad():
        loss_t, _ = tbb.loss_fn(pt, {k: torch.tensor(v)
                                     for k, v in batch.items()}, tc, **F32T)
    _gap(f"dense loss_fn S={S}", _rel(float(loss_t), float(loss_j)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_gradients_match_jax_grad(model, remat):
    jc, tc, pj, pt = model
    batch = _batch(5, 2, 32)
    gj = jax.grad(lambda p: jbb.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jc, use_pallas=False,
        remat=remat, **F32J)[0])(pj)
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(pt)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), pt)
    loss, _ = tbb.loss_fn(live, {k: torch.tensor(v) for k, v in batch.items()},
                          tc, remat=remat, **F32T)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    _leaf_gap(f"rwkv6 loss gradients remat={remat}",
              tree_map(lambda _: next(it), pt), gj)


def test_unported_losses_raise():
    for name in ("granite-moe-1b-a400m", "deepseek-v3-671b", "zamba2-1.2b"):
        cfg = tconfigs.REDUCED[name]
        batch = {k: torch.tensor(v) for k, v in _batch(6, 1, 8).items()}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbb.loss_fn({}, batch, cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbb.prefill({}, torch.zeros((1, 4), dtype=torch.int32), cfg,
                        cache_len=8)
    # rwkv6's serving path is ported: its decode state is the fp32
    # recurrence and token-shift states (tests/test_torch_rwkv6_serve.py)
    cfg = tconfigs.REDUCED[ARCH]
    state = tbb.init_decode_state(cfg, 3, 8, device="cpu")
    L, d, H, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.ssm.head_dim
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "wkv": (L, 3, H, hd, hd), "x_prev_att": (L, 3, d),
        "x_prev_ffn": (L, 3, d)}


# --------------------------------------------------------------------------
# the train step and the CLI
# --------------------------------------------------------------------------

def _train_configs(remat):
    shape_kw = dict(seq_len=32, global_batch=2, kind="train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              compute_dtype="float32", remat=remat)
    jt = JTrainConfig(model=jconfigs.REDUCED[ARCH],
                      shape=jconfigs.InputShape("t", **shape_kw), **kw)
    tt = TrainConfig(model=tconfigs.REDUCED[ARCH],
                     shape=tconfigs.InputShape("t", **shape_kw), **kw)
    return jt, tt


ADAM_B1 = 0.9                    # both packages' adamw default
G_NOISE = 1e-7                   # 10 x adamw's eps (1e-8)


def _state_from_reference(pj, oj):
    """The port's (params, optimizer state) holding the reference's."""
    to_port = lambda tree: lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), device="cpu")
    return to_port(pj), {"step": torch.tensor(int(oj["step"]),
                                              dtype=torch.int32),
                         "m": to_port(oj["m"]), "v": to_port(oj["v"])}


def _leaves_np(tree):
    """{key path: array} of a reference tree (jax arrays) or of a port tree
    taken to NumPy (the same key paths)."""
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("remat", [True, False])
def test_three_train_steps_match_reference(model, remat):
    """Three steps of both packages from the same params and batches.

    Running free, each step's loss and grad_norm and the params after
    three steps hold the 1e-4 bar, and so do AdamW's moments after step 1:
    (1 - b1) g and (1 - b2) g² of each package's gradient. From step 2 on
    the free-running moments part (by ~4e-4 after step 3), and the test
    shows where that starts: step 1's update, -lr m̂ / (sqrt(v̂) + eps),
    is ±lr for any |g| well above eps but moves with g itself where |g| is
    near eps, and there the two packages' gradients differ relatively (a
    few dozen elements, |g| < G_NOISE); only there do the first updates
    differ by more than 1% of lr. Every later step amplifies that gap.
    So each step is also run from the reference's own state (params and
    moments copied in): there m, v and the params hold 1e-4 at every
    step."""
    jc, tc, pj, pt = model
    jt, tt = _train_configs(remat)
    jstep, jopt = jsteps.make_train_step(jc, jt)
    jstep = jax.jit(jstep)
    tstep, topt = tsteps.make_train_step(tc, tt, device="cpu")
    pj_, oj = pj, jopt.init(pj)
    pt_ = lm_params_from_numpy(lm_params_to_numpy(pt), device="cpu")
    ot = topt.init(pt_)
    stream = ttokens.TokenStream(tc.vocab_size, 32, 2, seed=7)
    for step in range(3):
        b = stream.batch(step)
        pf, of = _state_from_reference(pj_, oj)
        pj_, oj, mj = jstep(pj_, oj, jax.tree.map(jnp.asarray, b))
        pt_, ot, mt = tstep(pt_, ot, b)
        assert set(mt) == {"ce", "loss", "grad_norm"}
        _gap(f"train step {step} loss remat={remat}",
             _rel(float(mt["loss"]), float(mj["loss"])))
        _gap(f"train step {step} grad_norm remat={remat}",
             _rel(float(mt["grad_norm"]), float(mj["grad_norm"])))
        if step == 0:
            for k in ("m", "v"):
                _leaf_gap(f"adamw {k} after step 1 remat={remat}", ot[k],
                          oj[k])
            m1, p0 = _leaves_np(oj["m"]), _leaves_np(pj)
            p1, p1_port = _leaves_np(pj_), _leaves_np(lm_params_to_numpy(pt_))
            # the largest first update (|m̂ / (sqrt(v̂) + eps)| < 1)
            lr1 = max(float(np.abs(p1[k] - p0[k]).max()) for k in p0)
            parted = 0
            for k in m1:
                g = np.abs(m1[k]) / (1 - ADAM_B1)      # |clipped gradient|
                far = np.abs(p1_port[k] - p1[k]) > 0.01 * lr1
                parted += int(far.sum())
                assert np.all(g[far] < G_NOISE), (k, g[far].max())
            print(f"parity-gap first updates parted by > 1% of lr "
                  f"remat={remat}: {parted} elements, all |g| < {G_NOISE}")
        pf, of, _ = tstep(pf, of, b)
        for k in ("m", "v"):
            _leaf_gap(f"adamw {k} after step {step + 1} from the "
                      f"reference's state remat={remat}", of[k], oj[k])
        _leaf_gap(f"params after step {step + 1} from the reference's "
                  f"state remat={remat}", pf, pj_)
    assert int(ot["step"]) == 3
    _leaf_gap(f"params after 3 train steps remat={remat}", pt_, pj_)


def test_train_cli_loss_falls():
    # one thread, which torch takes from OMP_NUM_THREADS at start-up: beside
    # the suite's other parallel workers, a subprocess with a thread per core
    # stalls on its barriers and has taken minutes where it needs seconds
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "20"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step")]
    print(f"train CLI losses: {losses}")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0, losses


def test_train_unported_options_raise(monkeypatch):
    """An arch with a prefix front end still raises, federated or not.
    And train() runs a kernel only where it has a gradient: the ssm family
    on the WKV6 kernels, a dense model on plain attention (the flash
    kernel has no backward), in both branches."""
    from repro_torch.launch import train as ttrain
    for kw in (dict(), dict(silos=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.train("musicgen-large", device="cpu", **kw)
    seen = []

    def spy(name):
        real = getattr(ttrain.steps_lib, name)

        def wrapped(cfg, tc, **kw):
            seen.append((cfg.family, name, kw["use_kernels"]))
            return real(cfg, tc, **kw)
        monkeypatch.setattr(ttrain.steps_lib, name, wrapped)

    spy("make_train_step")
    spy("make_federated_round_step")
    for arch in ("llama3.2-1b", ARCH):
        for silos in (1, 2):
            ttrain.train(arch, steps=2, batch=2, seq=16, silos=silos,
                         local_steps=2, device="cpu")
    assert {(family, name) for family, name, _ in seen} == {
        (family, name) for family in ("dense", "ssm")
        for name in ("make_train_step", "make_federated_round_step")}
    assert all(use == (family == "ssm") for family, _, use in seen), seen


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rwkv6_train_step_kernel_path_on_cuda(cuda_device, model):
    """The kernel path's step against the plain path's on the card."""
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    _, tc, _, pt = model
    _, tt = _train_configs(remat=True)
    b = ttokens.TokenStream(tc.vocab_size, 32, 2, seed=8).batch(0)
    out = {}
    for use_kernels in (True, False):
        step, opt = tsteps.make_train_step(tc, tt, use_kernels=use_kernels,
                                           device=cuda_device)
        p = lm_params_from_numpy(lm_params_to_numpy(pt), device=cuda_device)
        before = (wkv_kernel.launches, wkv_kernel.grad_launches)
        p, _, m = step(p, opt.init(p), b)
        # forward: one launch per layer and one per remat re-forward;
        # gradient: one call (two kernels) per layer
        n = tc.num_layers if use_kernels else 0
        assert (wkv_kernel.launches - before[0],
                wkv_kernel.grad_launches - before[1]) == (2 * n, n)
        out[use_kernels] = (float(m["loss"]), lm_params_to_numpy(p))
    assert abs(out[True][0] - out[False][0]) <= TOL * abs(out[False][0])
    for a, b_ in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert _rel(a, b_) <= TOL


@pytest.mark.cuda
def test_dense_train_step_raises_with_flash_kernel_on_cuda(cuda_device):
    cfg = tconfigs.REDUCED["llama3.2-1b"]
    shape = tconfigs.InputShape("t", seq_len=32, global_batch=2, kind="train")
    tt = TrainConfig(model=cfg, shape=shape, compute_dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tbb.init_params(cfg, gen, device=cuda_device)
    b = ttokens.TokenStream(cfg.vocab_size, 32, 2, seed=9).batch(0)
    step, opt = tsteps.make_train_step(cfg, tt, use_kernels=True,
                                       device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, opt.init(params), b)
    step, opt = tsteps.make_train_step(cfg, tt, use_kernels=False,
                                       device=cuda_device)
    before = params["embed"].clone()
    params, _, m = step(params, opt.init(params), b)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(params["embed"], before)


@pytest.mark.cuda
def test_dense_train_cli_runs_on_cuda(cuda_device):
    """train() on a dense arch trains on the card: plain attention, no
    flash launch."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train as ttrain
    before = fa_kernel.launches()
    _, hist = ttrain.train("llama3.2-1b", steps=4, batch=2, seq=64,
                           log_every=1, device=cuda_device)
    assert [r["step"] for r in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert fa_kernel.launches() == before
