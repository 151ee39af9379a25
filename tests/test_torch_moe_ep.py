"""The expert-parallel MoE exchange (``repro_torch.models.moe_ep``) on CPU
ranks against the reference's ``apply_moe_ep`` under a mesh.

One group of 4 ranks (``run_ranks(device="cpu")``, ``launch.fed_ranks:
moe_ep_layer``) runs the layer on ("data", "model") meshes (1, 2), (1, 4)
and (2, 2) for reduced granite (softmax router) and reduced deepseek
(sigmoid router with a selection bias, routed scaling, a shared expert),
E = 4 in both. One subprocess with 4 host devices runs the reference's
layer under ``with mesh:`` on the same inputs and takes ``jax.grad`` of
sum(out · cot) + c · aux. Each rank's share of that loss is its own S/M
slice of its batch block (the tokens it routes) plus c · aux, so the
ranks' gradients summed are the whole loss's. Output, aux and the summed
gradients (x, router, experts, shared expert) must agree within 1e-5
(absolute, over max(1, |reference|)). The fallbacks (E % M, S % M, no mesh
in context) are the gspmd path bitwise.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.configs import REDUCED as JREDUCED  # noqa: E402
from repro_torch.configs import REDUCED  # noqa: E402
from repro_torch.launch.mesh import PlanMesh, run_ranks, use_mesh  # noqa: E402
from repro_torch.models import layers, moe_ep  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BAR = 1e-5
MESHES = [(1, 2), (1, 4), (2, 2)]
ARCHS = {"granite": "granite-moe-1b-a400m", "deepseek": "deepseek-v3-671b"}
B, S = 2, 16
AUX_COEF = 0.1

_REFERENCE = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_default_matmul_precision", "highest")
from repro.models.moe_ep import apply_moe_ep
with open(sys.argv[1], "rb") as f:
    spec = pickle.load(f)
out = {}
for shape in spec["meshes"]:
    D, M = shape
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
    for case in spec["cases"]:
        cfg = case["cfg"]
        p = jax.tree.map(jnp.asarray, case["params"])
        cot = jnp.asarray(case["cot"])

        def loss(p, x):
            o, a = apply_moe_ep(p, x, cfg)
            return jnp.sum(o * cot) + case["aux_coef"] * a, (o, a)

        with mesh:
            (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(case["x"]))
        out[(tuple(shape), case["name"])] = {
            "out": np.asarray(o), "aux": float(a),
            "grads": {**jax.tree.map(np.asarray, gp), "x": np.asarray(gx)}}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''


def _ep(cfg):
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, impl="ep"))


def _params(cfg, seed):
    """One MoE layer's params, NumPy, with a random selection bias for the
    sigmoid router (the init's zero would not show it moves the
    selection)."""
    rng = np.random.default_rng(seed)
    mo, d = cfg.moe, cfg.d_model
    E, f = mo.num_experts, mo.d_ff_expert

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"router": w(d, E, fan=d), "w_gate": w(E, d, f, fan=d),
         "w_up": w(E, d, f, fan=d), "w_down": w(E, f, d, fan=f)}
    if mo.router == "sigmoid":
        p["router_bias"] = (0.05 * rng.standard_normal(E)).astype(np.float32)
    if mo.num_shared_experts:
        fs = mo.d_ff_shared * mo.num_shared_experts
        p["shared"] = {"w_gate": w(d, fs, fan=d), "w_up": w(d, fs, fan=d),
                       "w_down": w(fs, d, fan=fs)}
    return p


def _cases(reg):
    out = []
    for i, (name, arch) in enumerate(sorted(ARCHS.items())):
        cfg = _ep(reg[arch])
        rng = np.random.default_rng(100 + i)
        out.append({"name": name, "cfg": cfg, "params": _params(cfg, i),
                    "x": rng.standard_normal((B, S, cfg.d_model)).astype(
                        np.float32),
                    "cot": rng.standard_normal((B, S, cfg.d_model)).astype(
                        np.float32),
                    "aux_coef": AUX_COEF})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the reference's), one spawn each."""
    cases = _cases(REDUCED)
    tmp = tmp_path_factory.mktemp("ep")
    jcases = [dict(c, cfg=_ep(JREDUCED[ARCHS[c["name"]]])) for c in cases]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"meshes": MESHES, "cases": jcases}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                           env=env, stderr=subprocess.PIPE, text=True)
    ranks = run_ranks("repro_torch.launch.fed_ranks:moe_ep_layer", 4,
                      args=({"meshes": MESHES, "cases": cases,
                             "device": "cpu"},), device="cpu", timeout=300)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return cases, ranks, pickle.load(f)


def _assemble(ranks, shape, name, x_shape):
    """The mesh's output (each data block from its model peers, which must
    agree bitwise), aux (alike on every rank) and gradients summed over
    the ranks (x's into each rank's block)."""
    D, M = shape
    Bl = x_shape[0] // D
    out = np.zeros(x_shape, np.float32)
    gx = np.zeros(x_shape, np.float32)
    grads, auxes, seen = {}, set(), 0
    for r in ranks:
        got = r.get((shape, name))
        if got is None:
            continue
        seen += 1
        dd, m = got["coords"]
        blk = slice(dd * Bl, (dd + 1) * Bl)
        if m == 0:
            out[blk] = got["out"]
        else:
            assert np.array_equal(out[blk], got["out"])
        auxes.add(got["aux"])
        gx[blk] += got["grads"].pop("x")
        for k, v in got["grads"].items():
            grads[k] = v if k not in grads else _add(grads[k], v)
        assert got["stats"]["calls"]["all_to_all"] == 4    # 2 fwd + 2 bwd
        assert got["stats"]["staged_bytes"] == 0          # CPU tensors
    assert seen == D * M and len(auxes) == 1
    return out, auxes.pop(), {**grads, "x": gx}


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _gap(what, got, want):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    print(f"parity-gap moe_ep {what}: {err:.2e} (scale {scale:.1f})")
    assert err / scale <= BAR, (what, err, scale)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_exchange_on_ranks_equals_reference(runs, shape, name):
    cases, ranks, ref = runs
    case = next(c for c in cases if c["name"] == name)
    out, aux, grads = _assemble(ranks, shape, name, case["x"].shape)
    want = ref[(shape, name)]
    _gap(f"{name} {shape} out", out, want["out"])
    _gap(f"{name} {shape} aux", aux, want["aux"])
    wg = dict(_leaves(want["grads"]))
    got = dict(_leaves(grads))
    assert got.keys() == wg.keys()
    for path in sorted(got):
        _gap(f"{name} {shape} d{'/'.join(path)}", got[path], wg[path])
    # the exchange is the plain emulation's: every data block bitwise
    pt = params_from_numpy(case["params"], "cpu")
    D, M = shape
    Bl = B // D
    for dd in range(D):
        o, a = moe_ep.emulate_ep(pt, torch.as_tensor(
            case["x"][dd * Bl:(dd + 1) * Bl]), case["cfg"], M)
        assert np.array_equal(o.numpy(), out[dd * Bl:(dd + 1) * Bl])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_fallbacks_are_gspmd_bitwise(name):
    """E % M (a model axis of 3 over 4 experts), S % M (an odd sequence on
    2) and no mesh in context: the gspmd path, bitwise; the meshes there
    need no ranks, since the layer falls back before any exchange."""
    case = next(c for c in _cases(REDUCED) if c["name"] == name)
    cfg, p = case["cfg"], params_from_numpy(case["params"], "cpu")
    x = torch.as_tensor(case["x"])
    for mesh, xx in ((PlanMesh((1, 3), ("data", "model")), x),
                     (PlanMesh((1, 2), ("data", "model")), x[:, :15]),
                     (None, x)):
        want = layers.apply_moe_gspmd(p, xx, cfg)
        if mesh is None:
            got = moe_ep.apply_moe_ep(p, xx, cfg)
        else:
            with use_mesh(mesh):
                got = moe_ep.apply_moe_ep(p, xx, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_planning_mesh_is_refused():
    """A fake-backend group moves no data: the exchange refuses its mesh
    (the dry-run's production meshes are for specs only)."""
    from repro_torch.launch.mesh import planning_mesh

    cfg = _ep(REDUCED[ARCHS["granite"]])
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                     num_experts=16))
    p = params_from_numpy(_params(cfg, 0), "cpu")
    with planning_mesh() as mesh:
        assert mesh.planning and mesh.devices.shape == (16, 16)
        with use_mesh(mesh), pytest.raises(ValueError, match="planning"):
            moe_ep.apply_moe_ep(p, torch.zeros((1, 32, cfg.d_model)), cfg)
    import torch.distributed as dist
    assert not dist.is_initialized()
