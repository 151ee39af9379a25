"""The paper's experiment scripts on the port against the reference's
(``benchmarks/`` and ``experiments/`` at the repository root), on the CPU.

``run_all_methods`` runs with the reference's ``jax.random`` draws injected
(its ``for_config(PRNGKey(seed))`` params and its seed-0 ``round_perms``
schedules, which torch cannot reproduce): every RMSE within 1e-4 relative
(the reference's host == scan bar), every accuracy equal or at most one
test row apart. ``protocol_comm``'s integers are equal; the scenario
matrix's host collaboration representations are bit for bit the
reference's, and its device column within the reference's 1e-3.

    PYTHONPATH=src python tests/test_torch_paper_experiments.py

runs the same parity at Experiment I's full layout (about a minute).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs.feddcl_mlp import PAPER_MLPS as JPAPER_MLPS  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.benchmarks import comm_cost, exp3_groups  # noqa: E402
from repro_torch.benchmarks.common import run_all_methods  # noqa: E402
from repro_torch.experiments import sweep  # noqa: E402
from _jax_oracle import oracle_on_cpu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RMSE_TOL = 1e-4
SCENARIO_KEYS = ["d", "c", "partition", "host_s", "device_s",
                 "rel_frobenius", "speedup"]


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU side: its tensors here are
    tiny, and beside the suite's other parallel workers a pool of threads
    only stalls on its barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference():
    """The reference's experiment scripts, imported from the repository root."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import common, comm_cost as jcomm
    from experiments import sweep as jsweep
    return common, jcomm, jsweep


def _gap(what: str, value: float, bar: float) -> None:
    print(f"parity-gap {what}: {value:.2e} (bar {bar:.0e})")
    assert value <= bar, (what, value, bar)


def reference_draws(dataset, *, d, c, n_ij, local_epochs, seed=0):
    """What the reference's run_all_methods draws with jax.random: the
    initial params of both widths from PRNGKey(seed), and each method's
    minibatch schedule from PRNGKey(0) (its trainers never get `seed`), at
    each method's padded layout (batch 32)."""
    cfg = JPAPER_MLPS[dataset]
    init = {"full" if not r else "reduced": jax.tree.map(
        np.asarray, jmlp.for_config(jax.random.PRNGKey(seed), cfg, reduced=r))
        for r in (False, True)}
    # (silos, epochs a round, rows of the largest silo) of each trainer
    layouts = {"Centralized": (1, 1, d * c * n_ij), "Local": (1, 1, n_ij),
               "FedAvg": (d * c, local_epochs, n_ij),
               "DC": (1, 1, d * c * n_ij),
               "FedDCL": (d, local_epochs, c * n_ij)}
    key = jax.random.PRNGKey(0)

    def schedule(silos, epochs, n):
        n_slots = jfed.pad_silo_data(
            [(np.zeros((n, 1)), np.zeros((n, 1)))], 32).n_slots
        return lambda rnd: np.asarray(
            jfed.round_perms(key, rnd, silos, epochs, n_slots))

    return init, {m: schedule(*lay) for m, lay in layouts.items()}


def compare_methods(dataset, track_rounds=False, **layout):
    """Both packages' run_all_methods on the host engine and backend, the
    port with the reference's draws; returns (port, reference)."""
    common, _, _ = _reference()
    init, schedules = reference_draws(
        dataset, d=layout["d"], c=layout["c"], n_ij=layout["n_ij"],
        local_epochs=layout["local_epochs"])
    want = common.run_all_methods(dataset, track_rounds=track_rounds,
                                  **layout)
    got = run_all_methods(dataset, track_rounds=track_rounds, device="cpu",
                          init_params=init, schedules=schedules, **layout)
    assert got.keys() == want.keys() and got["task"] == want["task"]
    assert list(got["metrics"]) == list(want["metrics"])
    assert got["times"].keys() == want["times"].keys()
    n_test = layout["n_test"]
    for method, w in want["metrics"].items():
        g = got["metrics"][method]
        if want["task"] == "regression":
            _gap(f"{dataset} {method} RMSE", abs(g - w) / abs(w), RMSE_TOL)
        else:
            rows = round(abs(g - w) * n_test)
            print(f"parity-gap {dataset} {method} accuracy: {g:.4f} vs "
                  f"{w:.4f}, {rows} test rows apart (bar 1)")
            assert rows <= 1, (method, g, w)
    return got, want


SMALL = dict(d=2, c=2, rounds=2, n_test=200)


def test_run_all_methods_regression_matches_reference():
    """battery_small, every round's RMSE tracked (the eval path)."""
    got, want = compare_methods("battery_small", track_rounds=True, n_ij=40,
                                local_epochs=2, epochs=3, **SMALL)
    assert got["curves"].keys() == want["curves"].keys()
    for method, w in want["curves"].items():
        g = got["curves"][method]
        assert len(g) == len(w)
        _gap(f"battery_small {method} curve",
             max(abs(a - b) / abs(b) for a, b in zip(g, w)), RMSE_TOL)


def test_run_all_methods_classification_matches_reference():
    """human_activity: its m̃ = 50 needs at least 50 rows a user for the
    PCA maps, in both packages, so n_ij is 60 here."""
    compare_methods("human_activity", n_ij=60, local_epochs=1, epochs=2,
                    **SMALL)


def test_protocol_comm_matches_reference():
    _, jcomm, _ = _reference()
    kw = dict(dataset="battery_small", d=2, c=3, n_ij=60, rounds=5)
    got = comm_cost.protocol_comm(device="cpu", **kw)
    want = jcomm.protocol_comm(**kw)
    assert list(got) == list(want)
    for k, w in want.items():
        assert isinstance(got[k], int) and got[k] == int(w), (k, got[k], w)
    assert got["feddcl_msgs_per_user"] == 2


def test_scenarios_one_cell(tmp_path):
    """A one-cell grid of the scenario matrix: the rows in the reference's
    format, the device column within its 1e-3, and the host column's
    collaboration representations bit for bit the reference's on the same
    draw."""
    from repro.core.protocol import run_protocol as jrun_protocol
    from repro.data.partition import split_iid as jsplit_iid

    rows = exp3_groups.scenarios(seed=0, device="cpu", out_dir=str(tmp_path),
                                 d_grid=[2], c_grid=[1])
    assert [r["partition"] for r in rows] == ["iid", "dirichlet"]
    for r in rows:
        assert list(r) == SCENARIO_KEYS
        _gap(f"scenario d2 c1 {r['partition']} rel_frobenius",
             r["rel_frobenius"], 1e-3)
    assert json.loads((tmp_path / "exp3_scenarios.json").read_text()) == rows
    # the cell's draw, as scenarios() makes it
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2 * exp3_groups.N_IJ + 64, exp3_groups.M))
    Y = rng.integers(0, 5, size=X.shape[0]).astype(np.float64)
    _, setups = exp3_groups.scenario_cell(X, Y, 2, 1, "iid", 0, "cpu")
    Xs, Ys = jsplit_iid(X, Y, 2, [1, 1], exp3_groups.N_IJ, seed=0)
    want = jrun_protocol(Xs, Ys, m_tilde=exp3_groups.M_TILDE,
                         anchor_r=exp3_groups.ANCHOR_R, seed=0,
                         svd_backend="host")
    for a, b in zip(setups["host"].collab_X, want.collab_X):
        assert np.array_equal(a, b)


def test_run_sweep_rows_match_reference():
    """The generic grid loop over each package's FedDCL fit: the same row
    keys, in order, and the same round losses' scale."""
    _, _, jsweep = _reference()
    case = [dict(d=2, c=2, n_ij=34, seed=0)]
    got = sweep.run_sweep(
        case, lambda c: sweep._fit_case(c, 1, 1, device="cpu"), verbose=False)
    want = jsweep.run_sweep(case, lambda c: jsweep._fit_case(c, 1, 1),
                            verbose=False)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert not got[0]["hit"] and np.isfinite(got[0]["final_loss"])
    assert sweep.sweep_configs(True) == jsweep.sweep_configs(True)
    assert sweep.sweep_configs(False) == jsweep.sweep_configs(False)


def test_exp1_cli_writes_results_torch_only(tmp_path):
    """The CLI on the CPU writes the reference's JSON keys into its out dir
    and nothing under results/, neither the repository's nor the working
    directory's."""
    before = sorted((ROOT / "results").iterdir())
    stamps = [p.stat().st_mtime_ns for p in before]
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.exp1_convergence",
         "--fast", "--device", "cpu", "--out-dir", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads((out / "exp1_convergence.json").read_text())
    assert list(res) == ["metrics", "curves", "task", "times"]
    assert list(res["metrics"]) == ["Centralized", "Local", "FedAvg", "DC",
                                    "FedDCL"]
    assert all(np.isfinite(v) for v in res["metrics"].values())
    assert [len(res["curves"][m]) for m in res["metrics"]] == [12, 12, 6, 12, 6]
    assert "claims:" in proc.stdout
    assert not (tmp_path / "results").exists()
    assert sorted((ROOT / "results").iterdir()) == before
    assert [p.stat().st_mtime_ns for p in before] == stamps


def exp1_full_parity():
    """Experiment I at its full layout (battery_small, d = 2, c = 2, n_ij =
    100, 20 rounds x 4 local epochs, 40 epochs, n_test 1000, host engine
    and backend), the port with the reference's draws injected."""
    got, want = compare_methods("battery_small", d=2, c=2, n_ij=100,
                                rounds=20, local_epochs=4, epochs=40,
                                n_test=1000)
    return {"reference": want["metrics"], "port": got["metrics"]}


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_paper_experiments.py
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        print(json.dumps(exp1_full_parity()))
