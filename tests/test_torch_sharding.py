"""The launch tier's specs (``repro_torch.shardingx``,
``repro_torch.launch.specs``) against the reference's, entry for entry.

``param_specs`` (with and without a silo dim), ``batch_spec``,
``cache_specs``, ``resolve_axis`` under ``silo_context`` and the spec
``constrain`` hands to ``with_sharding_constraint`` are compared at full
width for all 10 architectures on a (4, 2) stand-in mesh and both
production meshes. Every plan the reference's dry-run builds (10 archs ×
4 shapes baseline, plus train_4k ``feddcl`` / ``feddcl_sync``, on both
production meshes) and the ``moe_impl="ep"`` train plans of granite and
deepseek are dumped by one subprocess with 512 host devices; the port's
plans must match every field: name, kind, the MoE impl, argument paths,
shapes and dtypes, in / out specs, ``donate_argnums`` and the per-device
argument bytes (``NamedSharding.shard_shape`` against the port's
``shard_shape``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from _jax_oracle import oracle_on_cpu  # noqa: E402
from _prop import given, settings, st  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.shardingx import constrain as jconstrain  # noqa: E402
from repro.shardingx import policy as jpolicy  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, REDUCED  # noqa: E402
from repro_torch.core.federated import silo_replicate  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import PlanMesh, use_mesh  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.shardingx import constrain, policy  # noqa: E402
from repro_torch.shardingx.policy import P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


class FakeMesh:
    """The reference test's stand-in mesh: axis names and a device array."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _flat(tree, leaf=lambda x: isinstance(x, (P, JP))):
    """{path: leaf} of a port tree (dict keys, list / tuple indices)."""
    out = {}

    def walk(t, path):
        if leaf(t):
            out[path] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[path] = t

    walk(tree, ())
    return out


def _jflat(tree, leaf=lambda x: isinstance(x, JP)):
    """{path: leaf} of a reference tree, keyed as `_flat` keys."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)

    def key(p):
        return p.key if hasattr(p, "key") else p.idx

    return {tuple(key(p) for p in path): v for path, v in pairs}


def _same_specs(got, want) -> None:
    g = {k: tuple(v) for k, v in _flat(got).items()}
    w = {k: tuple(v) for k, v in _jflat(want).items()}
    assert g.keys() == w.keys()
    bad = {k: (g[k], w[k]) for k in g if g[k] != w[k]}
    assert not bad, list(bad.items())[:5]


def _jparams(cfg):
    return jax.eval_shape(lambda: jbb.init_params(cfg, jax.random.PRNGKey(0)))


def _tparams(name):
    return bb.init_params(ARCHS[name], None, torch.float32, device="meta")


def test_spec_type_matches_partition_spec():
    for entries in [(), ("data",), (("data",), None), ((), "model"),
                    (("pod", "data"), None, ["data", "model"])]:
        assert P(*entries) == tuple(JP(*entries))
        assert tuple(P(*entries)) == tuple(JP(*entries))
        assert P(*entries) == P(*entries)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_reference_at_full_width(mesh):
    shape, names = MESHES[mesh]
    fm = FakeMesh(shape, names)
    for name in sorted(ARCHS):
        jshapes, tshapes = _jparams(JARCHS[name]), _tparams(name)
        for kw in (dict(), dict(fsdp=False), dict(moe_fsdp=False)):
            _same_specs(policy.param_specs(tshapes, fm, **kw),
                        jpolicy.param_specs(jshapes, fm, **kw))
        d = dict(zip(names, shape))["pod" if "pod" in names else "data"]
        jsp = jax.eval_shape(lambda p: jax.tree.map(
            lambda a: jnp.broadcast_to(a, (d,) + a.shape), p), jshapes)
        tsp = silo_replicate(tshapes, d)
        for axis in (None,) + tuple(a for a in ("pod", "data")
                                    if a in names):
            _same_specs(
                policy.param_specs(tsp, fm, silo_dim=True, silo_axis=axis),
                jpolicy.param_specs(jsp, fm, silo_dim=True, silo_axis=axis))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_equals_reference(mesh):
    shape, names = MESHES[mesh]
    fm = FakeMesh(shape, names)
    for ndim in (1, 2, 3, 4):
        assert policy.batch_spec(fm, federated=False, ndim=ndim) == tuple(
            jpolicy.batch_spec(fm, federated=False, ndim=ndim))
        for axis in (None, "data", "pod", ("data",), ("pod", "data"),
                     ("data", "model")):
            if axis == "pod" and "pod" not in names:
                continue
            kw = dict(federated=True, silo_axis=axis, ndim=ndim)
            assert policy.batch_spec(fm, **kw) == tuple(
                jpolicy.batch_spec(fm, **kw)), kw


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_equal_reference(mesh):
    shape, names = MESHES[mesh]
    fm = FakeMesh(shape, names)
    for name in sorted(ARCHS):
        for B, cache_len in ((128, 32768), (1, 8192), (6, 100)):
            jst = jax.eval_shape(lambda: jbb.init_decode_state(
                JARCHS[name], B, cache_len, jnp.bfloat16))
            tst = bb.init_decode_state(ARCHS[name], B, cache_len,
                                       device="meta")
            for kw in (dict(), dict(replicate_model=True),
                       dict(model_on_seq=True)):
                _same_specs(specs.cache_specs(tst, fm, **kw),
                            jspecs.cache_specs(jst, fm, **kw))


LOGICAL = ["batch", "model", "data", "pod", None, ("pod", "data"),
           ("data", "model"), ("pod", "model")]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_axis_under_silo_context(mesh):
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    for ctx in (None, "data", "pod"):
        with constrain.silo_context(ctx), jconstrain.silo_context(ctx):
            for logical in LOGICAL:
                assert constrain.resolve_axis(logical, sizes) == \
                    jconstrain.resolve_axis(logical, sizes), (ctx, logical)
    assert constrain._SILO_AXIS == [None]


def _activation_cases(cfg):
    """(shape, logical axes) of the reference model's constrain calls, at
    the architecture's widths: train_4k and long-context batches."""
    d, H, hd, V = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.vocab_size
    out = []
    for B, S in ((256, 4096), (1, 8192), (32, 1)):
        out += [((B, S, H, hd), ("batch", None, "model", None)),
                ((B, H, S, S), ("batch", "model", None, None)),
                ((B, H, hd), ("batch", "model", None)),
                ((B, S, d), ("batch", None, None)),
                ((B, S, V), ("batch", None, "model")),
                ((B * S, d), ("batch", None)),
                ((B, S, 2 * d), ("batch", None, "model"))]
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        out += [((E, 1280, d), ("model", None, None)),
                ((E, 1280, cfg.moe.d_ff_expert), ("model", None, None))]
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_constraint_spec_equals_what_reference_hands_over(mesh, monkeypatch):
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    handed = []
    monkeypatch.setattr(jconstrain, "_mesh_axes", lambda: sizes)
    monkeypatch.setattr(jconstrain.jax.lax, "with_sharding_constraint",
                        lambda x, s: handed.append(s) or x)
    with use_mesh(PlanMesh(shape, names)):
        for name in sorted(ARCHS):
            for ctx in (None, "data", "pod"):
                with constrain.silo_context(ctx), \
                        jconstrain.silo_context(ctx):
                    for shp, logical in _activation_cases(ARCHS[name]):
                        handed.clear()
                        # a shape stand-in: the patched constraint reads
                        # only shape and ndim
                        x = SimpleNamespace(shape=shp, ndim=len(shp))
                        assert jconstrain.constrain(x, *logical) is x
                        want = tuple(handed[0]) if handed else None
                        got = constrain.constraint_spec(shp, *logical)
                        assert (None if got is None else tuple(got)) \
                            == want, (name, ctx, shp, logical)
    # outside a mesh: nothing, as the reference's outside one
    assert constrain.constraint_spec((256, 4096, 32, 64), "batch", None,
                                     "model", None) is None
    x = torch.zeros(2, 4)
    assert constrain.constrain(x, "batch", None) is x


def test_constrain_redistributes_a_dtensor():
    """Under a mesh a DTensor takes the spec's placements (one rank, a
    (1, 1) mesh of the default group); a plain tensor comes back as it
    is."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import mesh as tmesh

    store = dist.HashStore()
    dist.init_process_group("gloo", rank=0, world_size=1, store=store)
    try:
        m = tmesh.make_mesh((1, 1), ("data", "model"))
        with use_mesh(m):
            assert constrain._mesh_axes() == {"data": 1, "model": 1}
            x = torch.arange(8.0).reshape(2, 4)
            # axes of one device resolve to nothing: the input itself
            assert constrain.constrain(x, "batch", "model") is x
            dt = distribute_tensor(x, m.device_mesh,
                                   [Replicate(), Replicate()])
            assert constrain.constrain(dt, "batch", "model") is dt
        assert policy.to_placements(
            {"a": P("data", None), "b": [P(None, ("data", "model"))]},
            m) == {"a": (Shard(0), Replicate()),
                   "b": [(Shard(1), Shard(1))]}
        with pytest.raises(ValueError, match="mesh's order"):
            policy.to_placements(P(("model", "data")), m)
    finally:
        dist.destroy_process_group()


def test_shard_shape():
    fm = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert policy.shard_shape((64, 48, 7), P(("pod", "data"), "model"),
                              fm) == (2, 3, 7)
    assert policy.shard_shape((64,), P(), fm) == (64,)
    with pytest.raises(ValueError, match="not divisible"):
        policy.shard_shape((24, 5), P("data", None), fm)


@settings(max_examples=25, deadline=None)
@given(arch=st.sampled_from(sorted(REDUCED)))
def test_param_specs_always_divisible(arch):
    """The port's twin of the reference's property: no spec it emits
    splits a dim its axes do not divide."""
    shapes = bb.init_params(REDUCED[arch], None, device="meta")
    fm = FakeMesh((4, 2), ("data", "model"))
    sizes = {"data": 4, "model": 2}
    specs_ = policy.param_specs(shapes, fm, fsdp=True)
    leaves = _flat(shapes, leaf=lambda x: isinstance(x, torch.Tensor))
    for path, spec in _flat(specs_).items():
        leaf = leaves[path]
        for dim, entry in zip(leaf.shape, tuple(spec)):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, (
                path, leaf.shape, spec)


# --------------------------------------------------------------------------
# every plan of the reference's dry-run
# --------------------------------------------------------------------------

PLAN_PAIRS = (
    [(a, s, "baseline", None) for a in sorted(ARCHS)
     for s in sorted(INPUT_SHAPES)]
    + [(a, "train_4k", m, None) for a in sorted(ARCHS)
       for m in ("feddcl", "feddcl_sync")]
    + [(a, "train_4k", "baseline", "ep")
       for a in ("granite-moe-1b-a400m", "deepseek-v3-671b")])

_DUMP = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as JP
from repro.configs import ARCHS, INPUT_SHAPES
from repro.configs.base import FederatedConfig, TrainConfig
from repro.launch.mesh import make_production_mesh, num_silos
from repro.launch.specs import make_plan

def key(p):
    return p.key if hasattr(p, "key") else p.idx

def specs(tree):
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, NamedSharding)))
    return [[list(map(key, path)),
             [list(e) if isinstance(e, tuple) else e
              for e in (v.spec if isinstance(v, NamedSharding) else v)]]
            for path, v in pairs]

out = []
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch, shape_name, mode, impl in json.loads(sys.argv[1]):
        shape = INPUT_SHAPES[shape_name]
        opt = "bfloat16" if arch == "deepseek-v3-671b" else "float32"
        tc = TrainConfig(model=ARCHS[arch], shape=shape,
                         param_dtype="bfloat16", compute_dtype="bfloat16",
                         opt_state_dtype=opt,
                         federated=FederatedConfig(
                             num_silos=num_silos(mesh), local_steps=4))
        plan = make_plan(ARCHS[arch], shape, mesh, mode=mode, tc=tc,
                         moe_impl=impl)
        pairs, _ = jax.tree_util.tree_flatten_with_path(plan.args)
        ins = jax.tree_util.tree_leaves(
            plan.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        nbytes = sum(int(np.prod(ns.shard_shape(a.shape))) * a.dtype.itemsize
                     for (_, a), ns in zip(pairs, ins))
        state = []
        if plan.kind == "prefill" and not mp:
            # the prefill step's state, as the reference's plan takes it
            st = jax.eval_shape(plan.step_fn, *plan.args)[1]
            state = [[list(map(key, p)), list(a.shape), str(a.dtype)]
                     for p, a in jax.tree_util.tree_flatten_with_path(st)[0]]
        out.append({
            "pair": [arch, shape_name, mode, impl, mp], "name": plan.name,
            "state": state,
            "kind": plan.kind,
            "impl": plan.cfg.moe.impl if plan.cfg.moe else None,
            "args": [[list(map(key, p)), list(a.shape), str(a.dtype)]
                     for p, a in pairs],
            "in_specs": specs(plan.in_shardings),
            "out_specs": specs(plan.out_shardings),
            "donate": list(plan.donate_argnums), "arg_bytes": nbytes})
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_plans():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DUMP,
                           json.dumps(PLAN_PAIRS)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_plan_record(arch, shape_name, mode, impl, multi_pod):
    shape_, names = MESHES["2x16x16" if multi_pod else "16x16"]
    mesh = PlanMesh(shape_, names)
    shape = INPUT_SHAPES[shape_name]
    tc = dryrun.train_config(arch, ARCHS[arch], shape, mesh)
    plan = specs.make_plan(ARCHS[arch], shape, mesh, mode=mode, tc=tc,
                           moe_impl=impl, device="cpu")
    args = _flat(plan.args, leaf=lambda x: isinstance(x, torch.Tensor))

    def spec_rows(tree):
        return {k: tuple(v) for k, v in _flat(tree).items()}

    return {
        "name": plan.name, "kind": plan.kind,
        "impl": plan.cfg.moe.impl if plan.cfg.moe else None,
        "args": {k: (list(a.shape), str(a.dtype).replace("torch.", ""))
                 for k, a in args.items()},
        "in_specs": spec_rows(plan.in_specs),
        "out_specs": spec_rows(plan.out_specs),
        "donate": list(plan.donate_argnums),
        "arg_bytes": dryrun.arg_bytes_per_rank(plan, mesh)}


def _rows(pairs):
    def entry(e):
        return tuple(e) if isinstance(e, list) else e
    return {tuple(p): tuple(map(entry, s)) for p, s in pairs}


def test_every_plan_equals_reference(reference_plans):
    assert len(reference_plans) == 2 * len(PLAN_PAIRS) == 124
    for ref in reference_plans:
        arch, shape_name, mode, impl, mp = ref["pair"]
        got = _port_plan_record(arch, shape_name, mode, impl, mp)
        what = ref["pair"]
        assert got["name"] == ref["name"], what
        assert (got["kind"], got["impl"], got["donate"]) == (
            ref["kind"], ref["impl"], ref["donate"]), what
        assert got["args"] == {tuple(p): (s, d) for p, s, d in ref["args"]}, \
            what
        assert got["in_specs"] == _rows(ref["in_specs"]), what
        assert got["out_specs"] == _rows(ref["out_specs"]), what
        assert got["arg_bytes"] == ref["arg_bytes"], what
        if ref["state"]:
            # the port's prefill plan takes its state from init_decode_state
            # at the plan's cache length
            shape = INPUT_SHAPES[shape_name]
            cfg = specs.resolve_arch_for_shape(ARCHS[arch], shape)
            st = bb.init_decode_state(cfg, shape.global_batch,
                                      specs.decode_cache_len(cfg, shape),
                                      device="meta")
            assert {k: (list(a.shape), str(a.dtype).replace("torch.", ""))
                    for k, a in _flat(st, leaf=lambda x: isinstance(
                        x, torch.Tensor)).items()} == {
                tuple(p): (sh, d) for p, sh, d in ref["state"]}, what
    assert sum(bool(r["state"]) for r in reference_plans) == 10
