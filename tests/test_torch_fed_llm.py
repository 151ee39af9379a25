"""FedDCL's federated LLM training (the launch tier's round steps and the
federated ``train``) against the JAX reference's jitted builders.

Configs: ``REDUCED["rwkv6-3b"]`` (and ``REDUCED["llama3.2-1b"]`` for a
fedavg round), fp32 compute, d = 3 silos with distinct ``silo_batches``
of 2 x 32 tokens (the batch of ``test_three_train_steps_match_reference``),
H = 2 local steps. Both packages start from the
reference's params (``weights.py``); the port runs its kernel path (on the
CPU, the chunked plain WKV6 form), the reference ``use_pallas=False``. Bar:
1e-4 relative (Frobenius, the largest leaf), as
``test_three_train_steps_match_reference``; the gaps print under
``pytest -s``. AdamW's moments are compared after one step and, from the
second step on, each step is run from the reference's own state: run
free, the moments part by ~1e-4 from step 2 on, while params and metrics
hold the bar. tests/test_torch_train.py says why: AdamW's first update
follows g itself where |g| is near eps, and there the two packages'
gradients differ relatively. (At 1 x 32 tokens a silo, four embedding
elements of that kind part by up to 1.4e-3 after two steps, which puts
that leaf's free-running gap at 1.7e-4.)
"""
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs.base import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.federated import silo_replicate as jsilo_replicate  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.configs.base import FederatedConfig, TrainConfig  # noqa: E402
from repro_torch.core.federated import (AGGREGATORS,  # noqa: E402
                                        robust_sync, silo_replicate)
from repro_torch.data.tokens import silo_batches  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from _jax_oracle import oracle_on_cpu  # noqa: E402

TOL = 1e-4
RWKV, LLAMA = "rwkv6-3b", "llama3.2-1b"
D, H, B, S = 3, 2, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU side: its tensors here are
    tiny, and beside the suite's other parallel workers a pool of threads
    only stalls on its barriers, slowing every worker on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float = TOL) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _tree_gap(what, port_tree, ref_tree) -> None:
    """Largest per-leaf relative gap, leaves matched by key path."""
    paths = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, ref_tree))
    assert len(paths) == len(tree_leaves(port_tree))
    worst = 0.0
    for path, want in paths:
        got = port_tree
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape, path
        worst = max(worst, _rel(got.detach().numpy(), want))
    _gap(what, worst)


def _metrics_gap(what, mt, mj) -> None:
    assert set(mt) == set(mj) == {"ce", "loss", "grad_norm"}
    for k in mt:
        assert tuple(mt[k].shape) == mj[k].shape, (k, mt[k].shape)
        _gap(f"{what} {k}", _rel(mt[k].numpy(), mj[k]))


def _configs(arch, aggregator="fedavg", remat=True):
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              compute_dtype="float32", remat=remat)
    shape_kw = dict(seq_len=S, global_batch=B * D, kind="train")
    jt = JTrainConfig(
        model=jconfigs.REDUCED[arch],
        shape=jconfigs.InputShape("t", **shape_kw),
        federated=JFederatedConfig(num_silos=D, local_steps=H,
                                   aggregator=aggregator), **kw)
    tt = TrainConfig(
        model=tconfigs.REDUCED[arch],
        shape=tconfigs.InputShape("t", **shape_kw),
        federated=FederatedConfig(num_silos=D, local_steps=H,
                                  aggregator=aggregator), **kw)
    return jt, tt


_REF = {}


def _ref(name, arch, aggregator="fedavg", remat=True):
    """The reference's jitted builder `name`, built once per process."""
    key = (name, arch, aggregator, remat)
    if key not in _REF:
        jt, _ = _configs(arch, aggregator, remat)
        if name == "sync":
            fn, opt = jsteps.make_fedavg_sync_step(jt), None
        else:
            fn, opt = getattr(jsteps, f"make_federated_{name}_step")(
                jt.model, jt)
        _REF[key] = (jax.jit(fn), opt)
    return _REF[key]


@pytest.fixture(scope="module")
def init_params():
    """The reference's initial params of each arch, as NumPy (jitted: the
    eager init dispatches op by op, ~8 s for rwkv6)."""
    def init(arch):
        cfg = jconfigs.REDUCED[arch]
        return jax.jit(lambda k: jbb.init_params(cfg, k, jnp.float32))(
            jax.random.PRNGKey(0))
    return {arch: jax.tree.map(np.asarray, init(arch))
            for arch in (RWKV, LLAMA)}


def _start(p_np, ropt, topt):
    """Both packages' silo-stacked (params, opt state) from one init."""
    spj = jsilo_replicate(jax.tree.map(jnp.asarray, p_np), D)
    sp = tree_map(lambda a: a.contiguous(),
                  silo_replicate(lm_params_from_numpy(p_np, device="cpu"), D))
    return (spj, jax.vmap(ropt.init)(spj)), (sp, tsteps.silo_opt_init(topt, sp))


def _to_port(spj, soj):
    """The port's stacked state holding the reference's."""
    tp = lambda tree: lm_params_from_numpy(jax.tree.map(np.asarray, tree),
                                           device="cpu")
    so = {k: tp(v) for k, v in soj.items() if k != "step"}
    so["step"] = torch.tensor(np.asarray(soj["step"]), dtype=torch.int32)
    return tp(spj), so


def _batches(arch, n, step0=0):
    """n consecutive per-silo batches, numpy (n, D, B, S)."""
    bs = [silo_batches(jconfigs.REDUCED[arch].vocab_size, S, B, D, step0 + i,
                       seed=1) for i in range(n)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _silos_equal(tree) -> bool:
    return all(torch.equal(a[i], a[0]) for a in tree_leaves(tree)
               for i in range(1, a.shape[0]))


# --------------------------------------------------------------------------
# the local step, the phase, the sync, the round and R rounds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_local_step_matches_reference(init_params, remat):
    jlocal, jopt = _ref("local", RWKV, remat=remat)
    _, tt = _configs(RWKV, remat=remat)
    tlocal, topt = tsteps.make_federated_local_step(tt.model, tt,
                                                    device="cpu")
    (spj, soj), (sp, so) = _start(init_params[RWKV], jopt, topt)
    b = tree_map(lambda a: a[0], _batches(RWKV, 1))
    spj, soj, mj = jlocal(spj, soj, jax.tree.map(jnp.asarray, b))
    sp, so, mt = tlocal(sp, so, b)
    what = f"local step remat={remat}"
    _metrics_gap(what, mt, mj)
    _tree_gap(f"{what} params", sp, spj)
    for k in ("m", "v"):
        _tree_gap(f"{what} adamw {k}", so[k], soj[k])
    assert so["step"].tolist() == np.asarray(soj["step"]).tolist() == [1] * D
    assert not _silos_equal(sp)


def test_silo_step_writes_only_its_slice(init_params):
    """Each silo's step writes its own slice of the stack; a stack of
    silo_replicate's broadcast views (one storage for every silo) is
    refused, since a step on one silo would write them all."""
    _, tt = _configs(RWKV)
    step, opt = tsteps.make_train_step(tt.model, tt, device="cpu")
    local, _ = tsteps.make_federated_local_step(tt.model, tt, device="cpu")
    p = lm_params_from_numpy(init_params[RWKV], device="cpu")
    sp = tree_map(lambda a: a.contiguous(), silo_replicate(p, D))
    so = tsteps.silo_opt_init(opt, sp)
    before = tree_map(torch.clone, sp)
    b = tree_map(lambda a: a[0, 0], _batches(RWKV, 1))
    silo0 = {k: v[0] if k == "step" else tree_map(lambda a: a[0], v)
             for k, v in so.items()}
    step(tree_map(lambda a: a[0], sp), silo0, b)
    for a, a0 in zip(tree_leaves(sp), tree_leaves(before)):
        assert torch.equal(a[1:], a0[1:])
    assert not all(torch.equal(a[0], a0[0])
                   for a, a0 in zip(tree_leaves(sp), tree_leaves(before)))
    shared = silo_replicate(p, D)
    with pytest.raises(ValueError, match="contiguous"):
        local(shared, tsteps.silo_opt_init(opt, sp),
              tree_map(lambda a: a[0], _batches(RWKV, 1)))


@pytest.mark.parametrize("remat", [True, False])
def test_phase_step_matches_reference(init_params, remat):
    """H local steps, no sync: metrics (H, d) and params run free; the
    moments each step from the reference's state."""
    jphase, jopt = _ref("local_phase", RWKV, remat=remat)
    jlocal, _ = _ref("local", RWKV, remat=remat)
    _, tt = _configs(RWKV, remat=remat)
    tphase, topt = tsteps.make_federated_local_phase_step(tt.model, tt,
                                                          device="cpu")
    tlocal, _ = tsteps.make_federated_local_step(tt.model, tt, device="cpu")
    (spj0, soj0), (sp, so) = _start(init_params[RWKV], jopt, topt)
    bs = _batches(RWKV, H)
    spj, soj, mj = jphase(spj0, soj0, jax.tree.map(jnp.asarray, bs))
    sp, so, mt = tphase(sp, so, bs)
    what = f"phase remat={remat}"
    _metrics_gap(what, mt, mj)
    assert tuple(mt["loss"].shape) == (H, D)
    _tree_gap(f"{what} params", sp, spj)
    assert so["step"].tolist() == [H] * D
    assert not _silos_equal(sp)
    sj, oj = spj0, soj0
    for h in range(H):
        b = tree_map(lambda a: a[h], bs)
        pf, of = _to_port(sj, oj)
        sj, oj, _ = jlocal(sj, oj, jax.tree.map(jnp.asarray, b))
        pf, of, _ = tlocal(pf, of, b)
        for k in ("m", "v"):
            _tree_gap(f"{what} adamw {k} after step {h + 1} from the "
                      f"reference's state", of[k], oj[k])
        _tree_gap(f"{what} params after step {h + 1} from the reference's "
                  f"state", pf, sj)
    _tree_gap(f"{what} reference's phase vs its local steps", sp, sj)


def _state_zeroed(so) -> bool:
    return all(not t.any() for t in tree_leaves(so))


def _ref_round(arch, aggregator):
    """The reference's round: its jitted round builder for fedavg; for
    the others its jitted phase and sync builders, which its round step
    composes (one compile of the phase serves every aggregator)."""
    if aggregator == "fedavg":
        return _ref("round", arch)
    jphase, jopt = _ref("local_phase", arch)
    jsync, _ = _ref("sync", arch, aggregator)

    def jround(sp, so, bs):
        sp, so, ms = jphase(sp, so, bs)
        return (*jsync(sp, so), ms)
    return jround, jopt


@pytest.mark.parametrize("arch,aggregator", [
    (RWKV, "fedavg"), (RWKV, "fedsgd"), (RWKV, "median"),
    (RWKV, "trimmed_mean"), (RWKV, "krum"), (LLAMA, "fedavg")])
def test_round_step_matches_reference(init_params, arch, aggregator):
    jround, jopt = _ref_round(arch, aggregator)
    _, tt = _configs(arch, aggregator)
    tround, topt = tsteps.make_federated_round_step(tt.model, tt,
                                                    device="cpu")
    (spj, soj), (sp, so) = _start(init_params[arch], jopt, topt)
    bs = _batches(arch, H)
    spj, soj, mj = jround(spj, soj, jax.tree.map(jnp.asarray, bs))
    sp, so, mt = tround(sp, so, bs)
    what = f"round {arch} {aggregator}"
    _metrics_gap(what, mt, mj)
    _tree_gap(f"{what} params", sp, spj)
    assert _silos_equal(sp)
    # the sync zeroes the optimizer state, step included, or keeps it, as
    # the reference's does
    ref_zeroed = all(not np.asarray(t).any()
                     for t in jax.tree_util.tree_leaves(soj))
    assert _state_zeroed(so) == ref_zeroed == (aggregator != "fedsgd")
    assert so["step"].tolist() == np.asarray(soj["step"]).tolist()


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sync_matches_reference(init_params, aggregator, monkeypatch):
    """The boundary alone, from one pre-sync state of distinct silos, in
    small pieces (so Krum sums its distances over many): the reference's
    sync within 1e-4 (the optimizer state zeroed or kept as there), and the
    port's functional ``robust_sync`` bit for bit."""
    monkeypatch.setattr(tsteps, "OPT_PIECE", 1000)
    jsync, _ = _ref("sync", RWKV, aggregator)
    _, tt = _configs(RWKV, aggregator)
    rng = np.random.default_rng(5)
    noisy = lambda a: (a[None] + 0.01 * rng.standard_normal(
        (D,) + a.shape)).astype(np.float32)
    spj = jax.tree.map(noisy, init_params[RWKV])
    soj = {"step": np.arange(1, D + 1, dtype=np.int32),
           "m": jax.tree.map(lambda a: np.abs(noisy(a)), init_params[RWKV]),
           "v": jax.tree.map(lambda a: np.abs(noisy(a)), init_params[RWKV])}
    sp, so = _to_port(spj, soj)
    want = robust_sync(tree_map(torch.clone, sp), aggregator)
    kept = tree_map(torch.clone, so)
    sp, so = tsteps.make_fedavg_sync_step(tt, device="cpu")(sp, so)
    spj, soj = jsync(jax.tree.map(jnp.asarray, spj),
                     jax.tree.map(jnp.asarray, soj))
    _tree_gap(f"sync {aggregator} params", sp, spj)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(sp), tree_leaves(want)))
    if aggregator in ("fedprox", "fedsgd"):
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(so), tree_leaves(kept)))
        _tree_gap(f"sync {aggregator} kept adamw m", so["m"], soj["m"])
    else:
        assert _state_zeroed(so)
        assert all(not np.asarray(t).any()
                   for t in jax.tree_util.tree_leaves(soj))


def test_multiround_step_matches_reference(init_params):
    """R = 2 rounds in one call: its (R, H) silo-meaned metrics run free
    against the reference's; its params are two of the port's round steps
    bit for bit, and round 2's steps and sync, each run from the
    reference's state, hold the bar against the reference's multiround.
    (Run free, the second round's warm-up restart amplifies the few
    elements parted in the first: ~1.4e-4 on the embedding, 15 of 393,216
    elements.)"""
    R = 2
    jmulti, jopt = _ref("multiround", RWKV)
    jround, _ = _ref("round", RWKV)
    jlocal, _ = _ref("local", RWKV)
    _, tt = _configs(RWKV)
    tmulti, topt = tsteps.make_federated_multiround_step(tt.model, tt,
                                                         device="cpu")
    tround, _ = tsteps.make_federated_round_step(tt.model, tt, device="cpu")
    tlocal, _ = tsteps.make_federated_local_step(tt.model, tt, device="cpu")
    tsync = tsteps.make_fedavg_sync_step(tt, device="cpu")
    (spj0, soj0), (sp, so) = _start(init_params[RWKV], jopt, topt)
    rounds = [_batches(RWKV, H, step0=r * H) for r in range(R)]
    bs = {k: np.stack([b[k] for b in rounds]) for k in rounds[0]}
    spj, soj, mj = jmulti(spj0, soj0, jax.tree.map(jnp.asarray, bs))
    _, (sp2, so2) = _start(init_params[RWKV], jopt, topt)
    sp, so, mt = tmulti(sp, so, bs)
    assert tuple(mt["loss"].shape) == (R, H)
    _metrics_gap(f"multiround R={R}", mt, mj)
    assert _silos_equal(sp) and _state_zeroed(so)
    for b in rounds:
        sp2, so2, _ = tround(sp2, so2, b)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(sp), tree_leaves(sp2)))
    sj, oj, _ = jround(spj0, soj0, jax.tree.map(jnp.asarray, rounds[0]))
    for h in range(H):
        b = tree_map(lambda a: a[h], rounds[1])
        pf, of = _to_port(sj, oj)
        sj, oj, _ = jlocal(sj, oj, jax.tree.map(jnp.asarray, b))
        pf, of, _ = tlocal(pf, of, b)
        _tree_gap(f"multiround round 2 step {h + 1} params from the "
                  f"reference's state", pf, sj)
    pf, _ = tsync(*_to_port(sj, oj))
    _tree_gap(f"multiround R={R} params, round 2's sync from the "
              f"reference's state", pf, spj)


# --------------------------------------------------------------------------
# train(): the federated branch end to end
# --------------------------------------------------------------------------

def test_federated_train_logs_and_checkpoint(tmp_path):
    """Two multiround calls, one single round and one trailing local step
    (steps 11, H 2, R 2): the steps logged as the reference's, finite
    losses, and each package's checkpoint read by both."""
    kw = dict(reduced=True, steps=11, batch=4, seq=32, silos=2,
              local_steps=2, rounds_per_dispatch=2, log_every=1)
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    t0 = time.perf_counter()
    params, hist = ttrain.train(RWKV, checkpoint_path=tpath, device="cpu",
                                **kw)
    print(f"port federated train: {time.perf_counter() - t0:.1f}s")
    _, jhist = jtrain.train(RWKV, checkpoint_path=jpath, **kw)
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] \
        == list(range(11))
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert tstore.load_metadata(tpath) == jstore.load_metadata(jpath) == {
        "arch": tconfigs.REDUCED[RWKV].name, "steps": 11, "reduced": True}
    for a, b in zip(tree_leaves(params),
                    tree_leaves(tstore.load(tpath, params))):
        assert torch.equal(a, b)
    p_np = lm_params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(p_np),
                    jax.tree_util.tree_leaves(jstore.load(tpath, p_np))):
        assert np.array_equal(a, np.asarray(b))
    # the reference's file into the port's tree
    got = tstore.load(jpath, params)
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(t.shape) for t in tree_leaves(params)]


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
def test_rwkv6_federated_round_kernel_path_on_cuda(cuda_device,
                                                   init_params):
    """A round on the card through the WKV6 kernels (d·H·2·layers forward,
    d·H·layers gradient launches) against the plain path's round."""
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    _, tt = _configs(RWKV)
    bs = _batches(RWKV, H)
    out = {}
    for use_kernels in (True, False):
        rnd, opt = tsteps.make_federated_round_step(
            tt.model, tt, use_kernels=use_kernels, device=cuda_device)
        p = lm_params_from_numpy(init_params[RWKV], device=cuda_device)
        sp = tree_map(lambda a: a.contiguous(), silo_replicate(p, D))
        before = (wkv_kernel.launches, wkv_kernel.grad_launches)
        sp, so, m = rnd(sp, tsteps.silo_opt_init(opt, sp), bs)
        n = D * H * tt.model.num_layers if use_kernels else 0
        assert (wkv_kernel.launches - before[0],
                wkv_kernel.grad_launches - before[1]) == (2 * n, n)
        assert _silos_equal(sp) and _state_zeroed(so)
        out[use_kernels] = (m["loss"].cpu().numpy(), lm_params_to_numpy(sp))
    assert _rel(out[True][0], out[False][0]) <= TOL
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert _rel(a, b) <= TOL
