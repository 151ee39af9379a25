"""The sharded LLM program on CPU ranks: the launch tier's steps on DTensor
params laid out by ``param_specs`` over a ("data", "model") = (2, 2) mesh
of 4 gloo ranks (``launch.llm_ranks``, one group for every case), held to
the reference's unsharded steps with the reference's weights and to the
port's unsharded steps; then the per-rank traces of the production-mesh
dry-run on the fake backend.

Bars (relative Frobenius, the largest leaf, as the port's one-card parity
tests): loss and gradients 1e-5; params after three AdamW steps 1e-4 (the
bar of ``test_three_train_steps_match_reference``: AdamW's first update
follows g itself where |g| is near eps); prefill and decode logits 1e-5,
greedy tokens equal. The EP layer (granite, ``moe_impl="ep"`` with the
FSDP gather of its experts over "data") runs at a capacity where nothing
is dropped (capacity_factor = E / top_k), so its output equals the
unsharded gspmd layer's; its aux is the reference's EP aux (each rank's
routed slice's load-balance loss, averaged over the ranks), which no
unsharded gspmd call computes, so aux and the gradients of sum(out · cot)
+ c · aux are held to the port's per-block emulation of the exchange
(``moe_ep.emulate_ep`` on each data block), within 1e-5 over max(1, |x|)
as ``tests/test_torch_moe_ep.py``. granite's gspmd dispatch on DTensors:
loss and gradients 1e-5. The ``feddcl`` local step against the port's
unsharded ``make_federated_local_step``: metrics 1e-5, params after the
step 1e-4. The syncs: fedavg and Krum bit for bit to the port's unsharded
``make_fedavg_sync_step``, the median within 1e-6.
``-s`` prints the ``parity-gap`` lines.
"""
import dataclasses
import json

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
from repro_torch.benchmarks import comm_cost  # noqa: E402
from repro_torch.configs.base import (FederatedConfig,  # noqa: E402
                                      InputShape, TrainConfig)
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.launch import dryrun, llm_ranks, roofline  # noqa: E402
from repro_torch.launch import roofline_table  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import planning_mesh, run_ranks  # noqa: E402
from repro_torch.launch.specs import make_plan  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

LLAMA, GRANITE = "llama3.2-1b", "granite-moe-1b-a400m"
MESH = (2, 2)
B, S, STEPS, DECODE = 4, 32, 3, 4
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
          compute_dtype="float32", remat=True)
EP_B, EP_S, EP_AUX = 4, 16, 0.1
D_SILOS = 2
KRUM_SILOS, KRUM_F = 4, 1


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    yield from oracle_on_cpu()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gap(what: str, value: float, bar: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def _tree_gap(a, b) -> float:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return max(_rel(x, y) for x, y in zip(la, lb))


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _jnp(tree):
    return jax.tree.map(np.asarray, tree)


def _no_drop(cfg):
    mo = cfg.moe
    return cfg.with_overrides(moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))


def _ref_params(arch, seed=0):
    jc = jconfigs.REDUCED[arch]
    return _jnp(jbb.init_params(jc, jax.random.PRNGKey(seed), jnp.float32))


def _batches(n, b=B, s=S):
    stream = TokenStream(512, s, b, seed=7)
    return [stream.batch(i) for i in range(n)]


def _silo_stack(seed=3, d=D_SILOS):
    """A (d, ...) stack of reduced llama params, each silo drawn apart
    (the sync has something to aggregate)."""
    gen = torch.Generator().manual_seed(seed)
    return _np(tree_map(lambda a: torch.stack(
        [a + 0.01 * i * torch.randn(a.shape, generator=gen)
         for i in range(d)]),
        tbb.init_params(tconfigs.REDUCED[LLAMA], gen, torch.float32,
                        device="cpu")))


def _krum_stack():
    """KRUM_SILOS silos of reduced llama params, equal but in the
    embedding, which ``param_specs`` splits over "model": silos 0 and 1
    sit near each other, apart only in the first model rank's block;
    silos 2 and 3, twice as far apart, only in the second's; the two
    pairs far apart everywhere. Summed over the model ranks the
    distances pick silo 0; each model rank's own block alone shows a
    duplicate pair, and the two ranks would pick different silos."""
    from types import SimpleNamespace

    from repro_torch.shardingx.policy import param_specs

    base = _silo_stack(d=1)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty(MESH))
    spec = tuple(param_specs({"embed": torch.empty(
        (KRUM_SILOS,) + base["embed"].shape[1:], device="meta")}, mesh,
        silo_dim=True, silo_axis="data")["embed"])
    dim = spec.index("model") - 1
    e = base["embed"][0]
    rng = np.random.default_rng(5)
    g, h = rng.standard_normal((2,) + e.shape).astype(np.float32)
    lo = np.zeros(e.shape, np.float32)
    np.moveaxis(lo, dim, 0)[:e.shape[dim] // 2] = 1.0
    hi = 1.0 - lo
    stack = tree_map(lambda a: np.repeat(a, KRUM_SILOS, axis=0), base)
    stack["embed"] = np.stack([e + h + 0.1 * g * lo, e + h - 0.1 * g * lo,
                               e - h + 0.2 * g * hi, e - h - 0.2 * g * hi])
    return stack


def _silo_batch():
    """A (D_SILOS, B / D_SILOS, S) batch: each silo its own rows."""
    b = _batches(1)[0]
    return {k: np.stack(np.split(np.asarray(v), D_SILOS)) for k, v in
            b.items()}


def _ep_case():
    cfg = _no_drop(tconfigs.REDUCED[GRANITE])
    gen = torch.Generator().manual_seed(11)
    p = tlayers.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen)
    cot = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen)
    return cfg, _np(p), x.numpy(), cot.numpy()


@pytest.fixture(scope="module")
def ranks():
    """Every case on one group of 4 CPU ranks: the inputs and each rank's
    results (rank 0's; every rank returns the same whole tensors)."""
    _, ep_p, ep_x, ep_cot = _ep_case()
    stack = _silo_stack()
    cases = {
        "train": dict(kind="train", arch=LLAMA, params=_ref_params(LLAMA),
                      batches=_batches(STEPS), tc=TC),
        "serve": dict(kind="serve", arch=LLAMA, params=_ref_params(LLAMA, 1),
                      tokens=_batches(1, s=24)[0]["tokens"],
                      cache_len=24 + DECODE, steps=DECODE),
        "ep_layer": dict(kind="moe_ep", arch=GRANITE, moe_impl="ep",
                         no_drop=True, params=ep_p, x=ep_x, cot=ep_cot,
                         aux_coef=EP_AUX),
        "ep_train": dict(kind="train", arch=GRANITE, moe_impl="ep",
                         no_drop=True, params=_ref_params(GRANITE),
                         batches=_batches(1), tc=TC),
        "granite": dict(kind="grads", arch=GRANITE, remat=False,
                        params=_ref_params(GRANITE), batch=_batches(1)[0]),
        "fed_local": dict(kind="fed_local", arch=LLAMA, params=stack,
                          batch=_silo_batch(), tc=TC),
        "fedavg": dict(kind="sync", arch=LLAMA, aggregator="fedavg",
                       params=stack),
        "median": dict(kind="sync", arch=LLAMA, aggregator="median",
                       params=stack),
        "krum": dict(kind="sync", arch=LLAMA, aggregator="krum",
                     krum_f=KRUM_F, params=_krum_stack()),
    }
    names = list(cases)
    got = run_ranks(llm_ranks.sharded_cases, 4,
                    args=({"mesh": MESH, "cases": [cases[n] for n in names]},),
                    device="cpu", timeout=600)
    for r in got[1:]:
        for a, b in zip(got[0], r):
            assert np.allclose(a.get("loss", 0.0), b.get("loss", 0.0),
                               rtol=0, atol=0)
    for n, r in zip(names, got[0]):
        print(f"sharded case {n}: {r['case_seconds']:.1f} s on rank 0")
    return cases, dict(zip(names, got[0]))


def _train_configs(arch, **over):
    jc = jconfigs.REDUCED[arch].with_overrides(**over)
    tc = tconfigs.REDUCED[arch].with_overrides(**over)
    kw = dict(seq_len=S, global_batch=B, kind="train")
    jt = JTrainConfig(model=jc, shape=jconfigs.InputShape("t", **kw), **TC)
    tt = TrainConfig(model=tc, shape=InputShape("t", **kw), **TC)
    return jc, tc, jt, tt


def test_llama_train_steps_match_reference(ranks):
    cases, res = ranks
    case, got = cases["train"], res["train"]
    jc, tc, jt, tt = _train_configs(LLAMA)
    pj = jax.tree.map(jnp.asarray, case["params"])
    b0 = jax.tree.map(jnp.asarray, case["batches"][0])

    def jloss(p):
        return jbb.loss_fn(p, b0, jc, use_pallas=False,
                           compute_dtype=jnp.float32)[0]

    lj, gj = jax.value_and_grad(jloss)(pj)
    pt = lm_params_from_numpy(case["params"], device="cpu")
    lt, gt = llm_ranks.loss_and_grads(
        pt, {k: torch.as_tensor(v) for k, v in case["batches"][0].items()},
        tc)
    _gap("llama sharded loss vs reference", _rel(got["loss"], float(lj)),
         1e-5)
    _gap("llama sharded loss vs port", _rel(got["loss"], float(lt)), 1e-5)
    _gap("llama sharded gradients vs reference",
         _tree_gap(got["grads"], _jnp(gj)), 1e-5)
    _gap("llama sharded gradients vs port", _tree_gap(got["grads"], _np(gt)),
         1e-5)

    jstep = jax.jit(jsteps.make_train_step(jc, jt)[0])
    oj = jsteps.make_optimizer(jt).init(pj)
    tstep, topt = tsteps.make_train_step(tc, tt, use_kernels=False,
                                         device="cpu")
    ot = topt.init(pt)
    for i, b in enumerate(case["batches"]):
        pj, oj, mj = jstep(pj, oj, jax.tree.map(jnp.asarray, b))
        pt, ot, mt = tstep(pt, ot, b)
        for k in mj:
            _gap(f"llama sharded step {i} {k} vs reference",
                 _rel(got["metrics"][i][k], float(mj[k])), 1e-5)
            _gap(f"llama sharded step {i} {k} vs port",
                 _rel(got["metrics"][i][k], float(mt[k])), 1e-5)
    assert got["step"] == STEPS
    _gap("llama sharded params after 3 steps vs reference",
         _tree_gap(got["params"], _jnp(pj)), 1e-4)
    _gap("llama sharded params after 3 steps vs port",
         _tree_gap(got["params"], _np(pt)), 1e-4)


def test_llama_prefill_and_decode_match_reference(ranks):
    cases, res = ranks
    case, got = cases["serve"], res["serve"]
    jc, tc = jconfigs.REDUCED[LLAMA], tconfigs.REDUCED[LLAMA]
    C = case["cache_len"]
    toks = np.asarray(case["tokens"])
    pj = jax.tree.map(jnp.asarray, case["params"])
    pt = lm_params_from_numpy(case["params"], device="cpu")
    lj, sj, nj = jbb.prefill(pj, jnp.asarray(toks), jc, cache_len=C,
                             compute_dtype=jnp.float32,
                             cache_dtype=jnp.float32)
    lt, st, nt = tbb.prefill(pt, torch.as_tensor(toks), tc, cache_len=C,
                             compute_dtype=torch.float32,
                             cache_dtype=torch.float32, use_kernels=False)
    _gap("llama sharded prefill logits vs reference",
         _rel(got["prefill"], lj), 1e-5)
    _gap("llama sharded prefill logits vs port",
         _rel(got["prefill"], lt.numpy()), 1e-5)
    tok = np.asarray(got["tokens"][0])
    assert np.array_equal(tok, np.asarray(lj)[:, -1].argmax(-1))
    pos = np.asarray(nj)
    for i in range(case["steps"]):
        lj, sj = jbb.decode_step(pj, sj, jnp.asarray(tok[:, None]),
                                 jnp.asarray(pos), jc,
                                 compute_dtype=jnp.float32)
        lt, st = tbb.decode_step(pt, st, torch.as_tensor(tok[:, None]),
                                 torch.as_tensor(pos), tc,
                                 compute_dtype=torch.float32)
        _gap(f"llama sharded decode {i} logits vs reference",
             _rel(got["steps"][i], lj), 1e-5)
        _gap(f"llama sharded decode {i} logits vs port",
             _rel(got["steps"][i], lt.numpy()), 1e-5)
        tok = np.asarray(lj)[:, -1].argmax(-1).astype(np.int32)
        assert np.array_equal(tok, np.asarray(got["tokens"][i + 1])), i
        pos = pos + 1


def _scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def test_granite_ep_layer_with_fsdp_gather(ranks):
    cases, res = ranks
    case, got = cases["ep_layer"], res["ep_layer"]
    cfg, _, x, cot = _ep_case()
    p = {k: torch.as_tensor(v).requires_grad_() for k, v in
         case["params"].items()}
    xt = torch.as_tensor(x).requires_grad_()
    D, M = MESH
    # the unsharded gspmd layer keeps every pair at this capacity
    out_g, _ = tlayers.apply_moe_gspmd(p, xt, cfg)
    jcfg = _no_drop(jconfigs.REDUCED[GRANITE])
    out_j, _ = jlayers.apply_moe_gspmd(
        jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(x), jcfg)
    _gap("granite EP layer out vs reference gspmd",
         _scaled(got["out"], out_j), 1e-5)
    _gap("granite EP layer out vs port gspmd",
         _scaled(got["out"], out_g.detach()), 1e-5)
    # aux and gradients: the per-block emulation of the exchange
    blocks = [moe_ep.emulate_ep(p, xb, cfg, M) for xb in xt.chunk(D)]
    out_e = torch.cat([o for o, _ in blocks])
    aux_e = torch.stack([a for _, a in blocks]).mean()
    loss = torch.sum(out_e * torch.as_tensor(cot)) + EP_AUX * aux_e
    grads = torch.autograd.grad(loss, list(p.values()) + [xt])
    _gap("granite EP layer out vs emulation",
         _scaled(got["out"], out_e.detach()), 1e-5)
    _gap("granite EP layer aux vs emulation",
         _scaled(got["aux"], aux_e.detach()), 1e-5)
    want = dict(zip(list(p) + ["x"], grads))
    for k, g in want.items():
        _gap(f"granite EP layer grad {k} vs emulation",
             _scaled(got["grads"][k], g), 1e-5)
    # the experts' weights came FSDP-split over "data" and were gathered
    assert got["collectives"]["all-gather"] >= 3
    assert got["collectives"]["all-to-all"] >= 2


def test_granite_train_step_under_ep(ranks):
    """A whole granite train step with ``moe_impl="ep"`` across the ranks:
    its cross-entropy equals the unsharded gspmd step's (no pair
    dropped); its aux is the EP aux (per routed slice), so the loss and
    the update differ from gspmd's by the aux term alone."""
    cases, res = ranks
    case, got = cases["ep_train"], res["ep_train"]
    jc = _no_drop(jconfigs.REDUCED[GRANITE])
    tc = _no_drop(tconfigs.REDUCED[GRANITE])
    b0 = case["batches"][0]
    _, mj = jbb.loss_fn(jax.tree.map(jnp.asarray, case["params"]),
                        jax.tree.map(jnp.asarray, b0), jc, use_pallas=False,
                        compute_dtype=jnp.float32)
    _, mt = tbb.loss_fn(lm_params_from_numpy(case["params"], device="cpu"),
                        {k: torch.as_tensor(v) for k, v in b0.items()}, tc,
                        use_kernels=False, compute_dtype=torch.float32)
    m = got["metrics"][0]
    _gap("granite EP train step ce vs reference gspmd",
         _rel(m["ce"], float(mj["ce"])), 1e-5)
    _gap("granite EP train step ce vs port gspmd",
         _rel(m["ce"], float(mt["ce"])), 1e-5)
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert abs(m["loss"] - m["ce"] - 0.01 * m["moe_aux"]) < 1e-5
    assert got["step"] == 1


def test_granite_gspmd_gradients_match_reference(ranks):
    """granite's gspmd dispatch on DTensors: the routing and combine on
    every rank, the experts on the buffer split over "model"."""
    cases, res = ranks
    case, got = cases["granite"], res["granite"]
    jc, tc = jconfigs.REDUCED[GRANITE], tconfigs.REDUCED[GRANITE]
    b = jax.tree.map(jnp.asarray, case["batch"])

    def jloss(p):
        return jbb.loss_fn(p, b, jc, use_pallas=False, remat=False,
                           compute_dtype=jnp.float32)[0]

    lj, gj = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                    case["params"]))
    lt, gt = llm_ranks.loss_and_grads(
        lm_params_from_numpy(case["params"], device="cpu"),
        {k: torch.as_tensor(v) for k, v in case["batch"].items()}, tc,
        remat=False)
    _gap("granite gspmd sharded loss vs reference",
         _rel(got["loss"], float(lj)), 1e-5)
    _gap("granite gspmd sharded loss vs port", _rel(got["loss"], float(lt)),
         1e-5)
    _gap("granite gspmd sharded gradients vs reference",
         _tree_gap(got["grads"], _jnp(gj)), 1e-5)
    _gap("granite gspmd sharded gradients vs port",
         _tree_gap(got["grads"], _np(gt)), 1e-5)


def test_federated_local_step_matches_unsharded(ranks):
    """The ``feddcl`` plan's local step on the (2, 2) mesh (each data row
    one silo, its step on the model sub-mesh) against the port's
    unsharded ``make_federated_local_step`` on the same stack."""
    cases, res = ranks
    case, got = cases["fed_local"], res["fed_local"]
    _, tc, _, _ = _train_configs(LLAMA)
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    d, b, s = batch["tokens"].shape
    tt = TrainConfig(model=tc, shape=InputShape("t", s, d * b, "train"),
                     federated=FederatedConfig(num_silos=d), **TC)
    step, opt = tsteps.make_federated_local_step(tc, tt, use_kernels=False,
                                                 device="cpu")
    sp = tree_map(lambda a: torch.as_tensor(a).clone(), case["params"])
    so = tsteps.silo_opt_init(opt, sp)
    sp, so, m = step(sp, so, batch)
    for k in m:
        _gap(f"federated local step {k} vs port",
             _rel(got["metrics"][k], m[k].numpy()), 1e-5)
    assert np.array_equal(got["step"], so["step"].numpy())
    _gap("federated local step params vs port",
         _tree_gap(got["params"], _np(sp)), 1e-4)


@pytest.mark.parametrize("aggregator", ["fedavg", "median", "krum"])
def test_sync_matches_unsharded(ranks, aggregator):
    """The sharded sync against the unsharded one. Krum's stack
    (``_krum_stack``) has 4 silos, 2 a rank; a leaf split over "model"
    holds only a block on each rank, so its distances must be summed
    over the model ranks for every rank to pick the unsharded sync's
    silo."""
    cases, res = ranks
    case, got = cases[aggregator], res[aggregator]
    d = tree_leaves(case["params"])[0].shape[0]
    tc = tconfigs.REDUCED[LLAMA]
    tt = TrainConfig(model=tc, shape=InputShape("t", S, d, "train"),
                     federated=FederatedConfig(num_silos=d,
                                               aggregator=aggregator,
                                               krum_f=KRUM_F))
    sp = tree_map(lambda a: torch.as_tensor(a).clone(), case["params"])
    so = tsteps.silo_opt_init(tsteps.make_optimizer(tt), sp)
    sp, so = tsteps.make_fedavg_sync_step(tt, device="cpu")(sp, so)
    if aggregator == "krum":
        assert np.array_equal(_np(sp)["embed"][0], case["params"]["embed"][0])
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(_np(sp))):
        if aggregator == "median":
            assert np.abs(a - b).max() <= 1e-6
        else:
            assert np.array_equal(a, b)
    assert got["opt_zero"]


def test_xent_sums_plain_is_the_gather_bitwise():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 7, 50), generator=gen)
    labels = torch.randint(0, 50, (3, 7), generator=gen)
    mask = (torch.rand((3, 7), generator=gen) > 0.3).float()
    tot, cnt = tbb._xent_sums(logits, labels, mask)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    assert torch.equal(tot, torch.sum((logz - gold) * mask))
    assert torch.equal(cnt, torch.sum(mask))


# --------------------------------------------------------------------------
# the per-rank traces on the fake backend
# --------------------------------------------------------------------------

FED_SHAPE = InputShape("train_4k", seq_len=64, global_batch=8, kind="train")
FED_MESH = dict(shape=(4, 2), axis_names=("data", "model"))


def _fed_records(mode: str, rank: int):
    cfg = tconfigs.REDUCED[LLAMA]
    with planning_mesh(rank=rank, **FED_MESH) as mesh:
        tc = TrainConfig(model=cfg, shape=FED_SHAPE,
                         federated=FederatedConfig(num_silos=4,
                                                   local_steps=4))
        plan = make_plan(cfg, FED_SHAPE, mesh, mode=mode, tc=tc,
                         device="cpu")
        return dryrun.trace_sharded(plan, mesh)["collectives"]


def test_no_cross_silo_collectives_in_local_step():
    """The port's twin of the reference's test of the same name: on a
    (4, 2) mesh of the fake backend (4 silos of 2 ranks, REDUCED llama,
    S 64, global batch 8), the FedDCL local step issues no collective
    whose rank group spans two silo rows (blocks of 2 ranks), and the
    sync issues at least one. Ranks 0 and 1 are traced; their records
    are the same, since every rank runs the same program on the same
    block shapes and a record lists every group of its axis."""
    for rank in (0, 1):
        local = _fed_records("feddcl", rank)
        sync = _fed_records("feddcl_sync", rank)
        assert local, "the local step issues the model axis' collectives"
        assert roofline.cross_block_bytes(local, 2) == 0
        assert roofline.cross_block_bytes(sync, 2) > 0
        spans = [r for r in sync if any(len({g // 2 for g in grp}) > 1
                                        for grp in r["groups"])]
        assert spans and all(r["kind"] == "all-gather" for r in spans)
        if rank == 0:
            first = (local, sync)
    assert (local, sync) == first


def _small_dryrun(monkeypatch, tmp_path):
    monkeypatch.setitem(dryrun.PLANNING_MESHES, "2x16x16", FED_MESH)
    monkeypatch.setattr(dryrun, "ARCHS", {
        LLAMA: tconfigs.REDUCED[LLAMA].with_overrides(name=LLAMA)})
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {"train_4k": FED_SHAPE})
    out = str(tmp_path)
    for mode in ("baseline", "feddcl", "feddcl_sync"):
        assert dryrun.main(["--arch", LLAMA, "--shape", "train_4k",
                            "--multi-pod", "--mode", mode, "--tag", "xs",
                            "--device", "cpu", "--out", out]) == 0
    return out


def test_traced_records_give_amortization_and_fed_table_rows(tmp_path,
                                                             monkeypatch):
    """The fed local / sync pair and the baseline of REDUCED llama, traced
    per rank on the fake 8-rank (4, 2) mesh under the multi-pod name:
    ``mesh_amortization`` and ``fed_table`` give rows from them."""
    out = _small_dryrun(monkeypatch, tmp_path)
    rows = comm_cost.mesh_amortization(out)
    assert len(rows) == 1 and rows[0]["mesh"] == "2x16x16"
    assert rows[0]["baseline_coll_bytes_per_step"] > 0
    table = roofline_table.fed_table(out)
    assert table.count("\n") == 2 and "| llama3.2-1b |" in table
    with open(tmp_path /
              "llama3.2-1b__train_4k__2x16x16__feddcl__xs.json") as f:
        rec = json.load(f)
    assert rec["cost_source"] == "traced per rank"
    assert rec["cross_silo_bytes_per_device"] == 0 and rec["silo_block"] == 2
    with open(tmp_path /
              "llama3.2-1b__train_4k__2x16x16__feddcl_sync__xs.json") as f:
        assert json.load(f)["cross_silo_bytes_per_device"] > 0
