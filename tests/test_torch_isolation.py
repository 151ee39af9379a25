"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
imports jax or the JAX reference package; entry points run on CUDA by
default, raise without a card, and work on the CPU when asked."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.gram.kernel" in mods and "repro_torch.api" in mods
    assert {"repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.models.layers", "repro_torch.models.backbone",
            "repro_torch.models.moe_ep", "repro_torch.models.modality",
            "repro_torch.configs.gemma2_2b", "repro_torch.launch.steps",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.data.tokens", "repro_torch.kernels.rwkv6.kernel",
            "repro_torch.kernels.rwkv6.ops",
            "repro_torch.kernels.rwkv6.ref", "repro_torch.core.baselines",
            "repro_torch.core.privacy", "repro_torch.graphs",
            "repro_torch.serve_collab.server",
            "repro_torch.serve_collab.tables",
            "repro_torch.launch.serve_collab",
            "repro_torch.checkpoint.store",
            "repro_torch.benchmarks.common",
            "repro_torch.benchmarks.exp1_convergence",
            "repro_torch.benchmarks.exp2_datasets",
            "repro_torch.benchmarks.exp3_groups",
            "repro_torch.benchmarks.comm_cost",
            "repro_torch.benchmarks.ablation_noniid",
            "repro_torch.benchmarks.kernels_bench",
            "repro_torch.benchmarks.run",
            "repro_torch.experiments.sweep",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.feddcl_tabular",
            "repro_torch.analysis", "repro_torch.analysis.hlo_audit",
            "repro_torch.benchmarks.serve_bench",
            "repro_torch.benchmarks.fed_bench",
            "repro_torch.experiments.robust_ablation",
            "repro_torch.examples.end_to_end_driver",
            "repro_torch.examples.feddcl_llm_pretrain",
            "repro_torch.examples.serve_batched"} <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert all(sys.modules[m] is None for m in bad), bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.api import FedDCL
    from repro_torch.core import collab, federated
    from repro_torch.device import resolve_device
    from repro_torch.configs import REDUCED
    from repro_torch.models import mlp, modality
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: resolve_device(None),
                 lambda: FedDCL(m_tilde=2),
                 lambda: collab.DeviceBackend(),
                 lambda: collab.get_backend("device"),
                 lambda: mlp.init_mlp_params(gen, 3, (4,), 1),
                 lambda: modality.synthetic_prefix(
                     gen, REDUCED["musicgen-large"], 1),
                 lambda: federated.run_federated(
                     None, None, [(np.zeros((4, 3)), np.zeros((4, 1)))],
                     opt=None, rounds=1, local_epochs=1),
                 lambda: federated.run_federated(
                     None, None, [(np.zeros((4, 3)), np.zeros((4, 1)))],
                     opt=None, rounds=1, local_epochs=1, engine="scan"),
                 lambda: federated.run_federated(
                     None, None, [(np.zeros((4, 3)), np.zeros((4, 1)))],
                     opt=None, rounds=1, local_epochs=1, engine="scan",
                     cache=federated.PlanCache()),
                 lambda: federated.make_fl_plan(
                     num_silos=1, num_batches=1, batch_size=4, opt=None,
                     batch_loss=None, local_epochs=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert collab.DeviceBackend(device="cpu").device.type == "cpu"
    assert FedDCL(m_tilde=2, device="cpu").device.type == "cpu"


def test_paper_scripts_default_to_cuda(monkeypatch):
    """The experiment scripts resolve their device before any work: without
    a card and without device='cpu' (--device cpu) they raise."""
    from repro_torch.benchmarks import (comm_cost, common, exp1_convergence,
                                        exp3_groups, kernels_bench, run)
    from repro_torch.benchmarks import fed_bench, serve_bench
    from repro_torch.examples import (end_to_end_driver, feddcl_llm_pretrain,
                                      feddcl_tabular, quickstart)
    from repro_torch.experiments import robust_ablation, sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: serve_bench.main(["--fast"]),
                 lambda: fed_bench.main(["--fast"]),
                 lambda: robust_ablation.main(["--fast", "--skip-sharded"]),
                 lambda: end_to_end_driver.main(["--steps", "1"]),
                 lambda: feddcl_llm_pretrain.main(["--steps", "1"]),
                 lambda: common.run_all_methods("battery_small", d=2, c=2),
                 lambda: exp1_convergence.main(["--fast"]),
                 lambda: exp3_groups.scenarios(fast=True),
                 lambda: comm_cost.protocol_comm(),
                 lambda: kernels_bench.run(fast=True),
                 lambda: run.main(["--only", "comm"]),
                 lambda: sweep.main(["--fast"]),
                 lambda: quickstart.main([]),
                 lambda: feddcl_tabular.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_paper_scripts_never_default_to_results():
    """Every experiment script's default output directory is results_torch/, so the
    reference's committed results/ artifacts are never overwritten."""
    import inspect
    from repro_torch.benchmarks import (ablation_noniid, comm_cost, common,
                                        exp1_convergence, exp2_datasets,
                                        exp3_groups)
    from repro_torch.benchmarks import fed_bench, serve_bench
    from repro_torch.examples import end_to_end_driver, feddcl_llm_pretrain
    from repro_torch.experiments import robust_ablation, sweep
    assert common.OUT_DIR == sweep.OUT_DIR == "results_torch"
    fns = [exp1_convergence.run, exp2_datasets.run, exp3_groups.run,
           exp3_groups.scenarios, comm_cost.run, ablation_noniid.run]
    for fn in fns:
        default = inspect.signature(fn).parameters["out_dir"].default
        assert os.path.normpath(default) != "results", fn
    for mod in (exp1_convergence, exp2_datasets, exp3_groups, comm_cost,
                ablation_noniid, sweep, serve_bench, fed_bench,
                robust_ablation, end_to_end_driver, feddcl_llm_pretrain):
        src = Path(mod.__file__).read_text()
        assert '"results"' not in src and '"results/' not in src, mod


def test_llm_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import REDUCED, InputShape, TrainConfig
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import backbone as bb
    cfg = REDUCED["llama3.2-1b"]
    tc = TrainConfig(model=REDUCED["rwkv6-3b"],
                     shape=InputShape("t", 8, 1, "train"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: bb.init_params(cfg, gen),
                 lambda: bb.init_decode_state(cfg, 1, 8),
                 lambda: steps.make_prefill_step(cfg, cache_len=8),
                 lambda: steps.make_serve_step(cfg),
                 lambda: steps.make_train_step(tc.model, tc),
                 lambda: steps.make_federated_local_step(tc.model, tc),
                 lambda: steps.make_federated_local_phase_step(tc.model, tc),
                 lambda: steps.make_federated_round_step(tc.model, tc),
                 lambda: steps.make_federated_multiround_step(tc.model, tc),
                 lambda: steps.make_fedavg_sync_step(tc),
                 lambda: serve.BatchedServer(cfg, None),
                 lambda: serve.main([]),
                 lambda: train.train("rwkv6-3b", steps=1),
                 lambda: train.train("rwkv6-3b", steps=1, silos=2),
                 lambda: train.main(["--arch", "rwkv6-3b", "--reduced"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = bb.init_params(cfg, gen, device="cpu")
    assert params["embed"].device.type == "cpu"
    step = steps.make_prefill_step(cfg, cache_len=8, device="cpu")
    logits, state, nxt = step(params, {"tokens": np.zeros((1, 5), np.int32)})
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert state["cache"]["k"].device.type == "cpu" and int(nxt[0]) == 5
    assert serve.BatchedServer(cfg, params, device="cpu").device.type == "cpu"
    step, opt = steps.make_train_step(tc.model, tc, device="cpu")
    p = bb.init_params(tc.model, gen, device="cpu")
    p, _, metrics = step(p, opt.init(p), {"tokens": np.zeros((1, 8), np.int32),
                                          "labels": np.ones((1, 8), np.int32)})
    assert p["embed"].device.type == "cpu"
    assert np.isfinite(float(metrics["loss"]))


def test_cpu_fit_predict_score_end_to_end():
    """A tiny whole run on the port alone (its own init and schedule)."""
    from repro_torch.api import FedDCL
    from repro_torch.data.partition import split_iid
    from repro_torch.data.tabular import make_dataset, train_test_split
    ds = make_dataset("human_activity", n=600, seed=0)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, 240, 200, seed=0)
    Xs, Ys = split_iid(Xtr, Ytr, d=2, c=[2, 2], n_ij=60, seed=0)
    model = FedDCL(m_tilde=10, hidden=(16,), task="classification", rounds=2,
                   local_epochs=1, anchor_r=300, svd_backend="device",
                   device="cpu")
    setup, res = model.fit(Xs, Ys)
    assert len(res.history) == 2 and np.isfinite(res.history[-1]["loss"])
    pred = model.predict(Xte)
    assert pred.shape == (200,) and pred.dtype.kind == "i"
    acc = model.score(Xte, Yte)
    assert 0.0 <= acc <= 1.0
    assert model.transform(Xte[:5], 1, 1).shape == (5, 10)
    srv = model.serve()                 # step 5, served on the port alone
    req = srv.submit(Xte[:7], 1, 1)
    out = srv.serve()
    assert out.status[req.rid] == "done"
    assert np.array_equal(out[req.rid].argmax(-1), model.predict(Xte[:7], 1, 1))
