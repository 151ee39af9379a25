"""The dry-run's per-rank traces of the production meshes on the CPU:
``--both-meshes`` on llama3.2-1b ``train_4k`` (full width, 16 x 16 and
2 x 16 x 16 ranks of torch's fake backend, meta tensors of rank 0's
blocks) writes records with the costs and collectives the reference's
``roofline.analyze`` gives, non-null; and no work is lost: the flops of
a rank times the ranks are at least the one-card trace's (replicated
work shows in ``useful_flops_ratio``, printed under ``-s``). Then the
card phase's rank target at the REDUCED configs on 4 CPU ranks over the
staged collectives. About 35 s. JAX-free.
"""
import json
import math

import pytest

from repro_torch.launch import dryrun


def _record(out, mesh):
    with open(f"{out}/llama3.2-1b__train_4k__{mesh}__baseline.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    args = ["--arch", "llama3.2-1b", "--shape", "train_4k", "--device",
            "cpu", "--out", out]
    assert dryrun.main(args + ["--both-meshes"]) == 0
    assert dryrun.main(args) == 0
    return {m: _record(out, m) for m in ("1x1", "16x16", "2x16x16")}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_production_mesh_record_is_traced_per_rank(records, mesh):
    rec, one = records[mesh], records["1x1"]
    print(f"{mesh}: flops/rank {rec['flops_per_device']:.3e} x "
          f"{rec['chips']} ranks, useful_flops_ratio "
          f"{rec['useful_flops_ratio']:.3f} (one card "
          f"{one['useful_flops_ratio']:.3f}), collective bytes/rank "
          f"{rec['collective_bytes_per_device']:.3e}, peak/rank "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB")
    assert rec["cost_source"] == "traced per rank"
    assert rec["chips"] == {"16x16": 256, "2x16x16": 512}[mesh]
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "compute_s", "memory_s",
                "collective_s", "roofline_bound_s", "peak_bytes"):
        assert rec[key] > 0, key
    assert rec["cross_silo_bytes_per_device"] is not None
    assert rec["silo_block"] == {"16x16": 16, "2x16x16": 256}[mesh]
    assert set(rec["collective_breakdown"]) >= {"all-gather", "total"}
    assert rec["flops_per_device"] * rec["chips"] >= one["flops_per_device"]
    # each rank holds its blocks: far less than the one-card arguments
    assert rec["memory"]["argument_bytes"] * 100 < \
        one["memory"]["argument_bytes"]
    assert rec["fits_one_card"] is True


def test_card_phase_target_on_cpu_over_staged_collectives():
    """``chip_smoke.py``'s phase ``sharded_llm`` target at the REDUCED
    configs on 4 CPU ranks, its collectives through ``launch.staged``'s
    kernels (the CPU key: the tensors into gloo as they are, where the
    card stages pinned copies): the fp32 check (loss, gradients and one train
    step of the plan against ``make_train_step``) and the EP layer within
    the phase's bars, the bf16 steps finite, every collective kind
    counted."""
    from repro_torch.launch import llm_ranks
    from repro_torch.launch.mesh import run_ranks

    spec = {"mesh": (2, 2), "check": (2, 64), "train": (4, 64),
            "steps": 2, "compute_dtype": "bfloat16", "ep": (4, 64),
            "ep_repeats": 1, "reduced": True,
            "check_tc": {"learning_rate": 1e-3, "warmup_steps": 1}}
    got = run_ranks(llm_ranks.card_llama, 4, args=(spec,), device="cpu",
                    backend="staged", timeout=300)
    r0 = got[0]
    assert r0["loss_gap"] <= 1e-5 and r0["grad_gap"] <= 1e-4
    assert r0["step_loss_gap"] <= 1e-5 and r0["step_param_gap"] <= 1e-4
    assert r0["ep_out_gap"] <= 1e-5 and r0["ep_aux_gap"] <= 1e-5
    for r in got:
        assert all(math.isfinite(s["loss"]) for s in r["steps"])
        calls = r["check_collectives"]["calls"]
        assert {"all_gather", "all_reduce", "reduce_scatter"} <= set(calls)
        # CPU tensors go to gloo as they are: nothing staged
        assert r["check_collectives"]["staged_bytes"] == 0 < \
            r["check_collectives"]["wire_bytes"]
        assert r["ep_collectives"]["calls"]["all_to_all"] == 2
