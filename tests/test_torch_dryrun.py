"""The dry-run tier (``repro_torch.launch.{roofline,dryrun,roofline_table}``,
``benchmarks.comm_cost.mesh_amortization``) against the reference.

``model_flops`` must equal the reference's for every arch × shape × kind;
the collective functions, over the port's records (kind, bytes, rank
groups), must reproduce every number ``tests/test_roofline.py`` asserts of
the reference's HLO parser on the same collectives. At reduced configs on
the CPU, the fake-tensor trace of each kind of step counts exactly the
flops, bytes accessed and live bytes that the same counters count over a
real run of that step. The CLI writes the reference's record keys, on the
one-card mesh and as spec-level records on the production meshes, and
exits 1 when a pair fails.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from _jax_oracle import oracle_on_cpu  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.benchmarks import comm_cost  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES, REDUCED  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, roofline, roofline_table  # noqa: E402
from repro_torch.launch.mesh import one_card_mesh  # noqa: E402
from repro_torch.launch.specs import decode_cache_len, make_plan  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

KINDS = ("train", "fed_local", "fed_sync", "prefill", "decode")

# tests/test_roofline.py's module, whose collectives the records restate
HLO = """
HloModule test
ENTRY %main {
  %p0 = bf16[128,512]{1,0} parameter(0)
  %ar = bf16[128,512]{1,0} all-reduce(%p0), replica_groups=[4,2]<=[8], to_apply=%add
  %ag = f32[64,32]{1,0} all-gather(%ar), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %a2a = f32[16,16]{1,0} all-to-all(%ag), replica_groups=[2,4]<=[4,2]T(1,0)
  %rs-start = bf16[8,8]{1,0} reduce-scatter(%a2a), replica_groups={}
  %done = bf16[8,8]{1,0} all-reduce-done(%rs-start)
}
"""


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the real runs here are tiny, and beside the
    suite's other workers a pool of threads only stalls on its barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hw_is_the_h100s():
    assert roofline.HW["peak_flops"] == 989e12
    assert roofline.HW["hbm_bw"] == 3.35e12
    assert roofline.HW["link_bw"] == 450e9
    assert 80e9 < roofline.HW["hbm_bytes"] < 2**37


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch):
    for shape in sorted(INPUT_SHAPES):
        for kind in KINDS:
            for h in (1, 4):
                assert roofline.model_flops(
                    ARCHS[arch], INPUT_SHAPES[shape], kind, h) == \
                    jroofline.model_flops(JARCHS[arch], JSHAPES[shape],
                                          kind, h), (shape, kind)


def _records():
    """The HLO module's collectives as the port records them: every rank
    group spelled out (the reference decodes them from replica_groups)."""
    return [{"kind": op, "bytes": nbytes, "groups": groups}
            for op, nbytes, groups in jroofline.iter_collectives(HLO, 8)]


def test_collective_functions_over_records_reproduce_test_roofline():
    recs = _records()
    assert [r["groups"] for r in recs] == [
        [[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 1, 2, 3], [4, 5, 6, 7]],
        [[0, 2, 4, 6], [1, 3, 5, 7]], [list(range(8))]]
    out = roofline.collective_bytes(recs)
    assert out == jroofline.collective_bytes(HLO)
    assert out["all-reduce"] == 128 * 512 * 2
    assert out["all-gather"] == 64 * 32 * 4
    assert out["all-to-all"] == 16 * 16 * 4
    assert out["reduce-scatter"] == 8 * 8 * 2
    assert out["total"] == sum(v for k, v in out.items() if k != "total")
    xb = roofline.cross_block_bytes(recs, block=2)
    assert xb >= 64 * 32 * 4
    assert xb == jroofline.cross_block_bytes(HLO, block=2, num_devices=8)
    assert roofline.cross_block_bytes(recs, block=8) == 0
    assert list(roofline.iter_collectives(recs)) == list(
        jroofline.iter_collectives(HLO, 8))


def test_model_flops_kinds():
    cfg = ARCHS["llama3.2-1b"]
    tr = roofline.model_flops(cfg, INPUT_SHAPES["train_4k"], "train")
    de = roofline.model_flops(cfg, INPUT_SHAPES["decode_32k"], "decode")
    pf = roofline.model_flops(cfg, INPUT_SHAPES["prefill_32k"], "prefill")
    assert tr > pf > de > 0
    assert abs((tr / (256 * 4096)) / (pf / (32 * 32768)) - 3.0) < 1e-6


def _reference_record_keys():
    """The keys of a record of the reference's run_pair: its analyze over a
    compiled artifact's stand-in, plus what run_pair adds."""
    mem = SimpleNamespace(argument_size_in_bytes=1, output_size_in_bytes=1,
                          temp_size_in_bytes=1, alias_size_in_bytes=0)
    compiled = SimpleNamespace(
        cost_analysis=lambda: {"flops": 1.0, "bytes accessed": 1.0},
        memory_analysis=lambda: mem, as_text=lambda: HLO)
    rec = jroofline.analyze(compiled, JARCHS["llama3.2-1b"],
                            JSHAPES["decode_32k"], "decode", chips=256,
                            silo_block=16)
    return set(rec) | {"mesh", "mode", "plan", "compile_s", "cost_source"}


SMALL = {"train_4k": InputShape("train_4k", 32, 4, "train"),
         "prefill_32k": InputShape("prefill_32k", 32, 2, "prefill"),
         "decode_32k": InputShape("decode_32k", 32, 2, "decode"),
         "long_500k": InputShape("long_500k", 48, 1, "decode")}
TRACED = ("llama3.2-1b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-1.2b",
          "musicgen-large", "deepseek-v3-671b")


def _real(a: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    if a.dtype.is_floating_point:
        return (0.02 * torch.randn(tuple(a.shape), generator=gen)).to(a.dtype)
    return torch.zeros(tuple(a.shape), dtype=a.dtype)


def _shapes(tree, path=()):
    """{path: (shape, dtype)} of a tree of dicts of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, path + (key,)).items()}
    return {path: (tuple(tree.shape), tree.dtype)}


EVERY_KIND = (("train_4k", "baseline"), ("train_4k", "feddcl"),
              ("train_4k", "feddcl_sync"), ("prefill_32k", "baseline"),
              ("decode_32k", "baseline"), ("long_500k", "baseline"))


@pytest.mark.parametrize("arch", TRACED)
def test_fake_trace_counts_what_a_real_run_counts(arch):
    """Each kind of step at a reduced config (every kind for llama and
    granite; train, prefill and decode for the other families): the fake
    trace's flops, bytes accessed and live bytes equal the counters' over
    a real CPU run of the same step on tensors of the plan's shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = REDUCED[arch]
    mesh = one_card_mesh()
    cases = EVERY_KIND if arch in TRACED[:2] else EVERY_KIND[::3] + (
        EVERY_KIND[4],)
    for shape_name, mode in cases:
        shape = SMALL[shape_name]
        tc = dryrun.train_config(arch, cfg, shape, mesh)
        plan = make_plan(cfg, shape, mesh, mode=mode, tc=tc, device="cpu")
        what = (arch, plan.name)
        fake = dryrun.trace_plan(plan, torch.device("cpu"))
        if plan.kind == "prefill":
            # the state the step returns is the one the plan's specs name
            with FakeTensorMode():
                out, _ = dryrun.trace_step(plan.step_fn, dryrun.fake_args(
                    plan.args, torch.device("cpu")))
                got = _shapes(out[1])
            want = bb.init_decode_state(cfg, shape.global_batch,
                                        decode_cache_len(cfg, shape),
                                        device="meta")
            assert got == _shapes(want), what
        gen = torch.Generator().manual_seed(0)
        args = tree_map(lambda a: _real(a, gen), plan.args)
        _, real = dryrun.trace_step(plan.step_fn, args)
        if plan.kind != "fed_sync":
            assert fake["flops"] > 0, what
        assert fake == real, what
        with FakeTensorMode():
            assert dryrun.fake_args(plan.args, torch.device("cpu"))


def _small_world(monkeypatch):
    monkeypatch.setattr(dryrun, "ARCHS", {
        a: REDUCED[a].with_overrides(name=a)
        for a in ("llama3.2-1b", "rwkv6-3b")})
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", SMALL)


def test_cli_writes_the_reference_keys(tmp_path, monkeypatch, capsys):
    _small_world(monkeypatch)
    out = str(tmp_path)
    keys = _reference_record_keys()
    for mode in ("baseline", "feddcl", "feddcl_sync"):
        assert dryrun.main(["--all", "--mode", mode, "--device", "cpu",
                            "--out", out]) == 0
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--both-meshes", "--device", "cpu",
                        "--out", out]) == 0
    assert "all requested dry-runs traced OK" in capsys.readouterr().out
    recs = roofline_table.load(out)
    assert len(recs) == 2 * 4 + 2 + 2 * 4 + 2
    for (arch, shape, mesh, mode), r in recs.items():
        assert keys <= set(r), keys - set(r)
        assert r["mesh"] == mesh and r["mode"] == mode
        if mesh == "1x1":
            assert r["cost_source"] == "fake-tensor trace"
            assert r["chips"] == 1 and r["collective_bytes_per_device"] == 0
            assert r["flops_per_device"] > 0 or r["kind"] == "fed_sync"
            assert r["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
            assert r["fits_one_card"] is True
            assert r["cross_silo_bytes_per_device"] == 0
        else:
            # traced per rank on the fake backend's production mesh
            assert r["cost_source"] == "traced per rank"
            assert r["compute_s"] > 0 and r["peak_bytes"] > 0
            assert r["chips"] == {"16x16": 256, "2x16x16": 512}[mesh]
            assert 0 < r["memory"]["argument_bytes"]
            assert r["cross_silo_bytes_per_device"] is not None
    fed = recs[("llama3.2-1b", "train_4k", "1x1", "feddcl")]
    assert fed["kind"] == "fed_local" and "d=1" in fed["plan"]
    # the spec-level record's per-rank bytes shrink with the mesh
    one = recs[("llama3.2-1b", "decode_32k", "1x1", "baseline")]
    pod = recs[("llama3.2-1b", "decode_32k", "16x16", "baseline")]
    assert pod["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    text = roofline_table.table(recs, mesh="1x1")
    assert text.count("\n") == 41 and "MISSING" in text   # 2 of 10 archs
    assert "| llama3.2-1b | decode_32k | decode |" in text
    assert "| yes |" in text
    assert "| llama3.2-1b | decode_32k | decode |" in roofline_table.table(
        recs, mesh="16x16")
    assert len(roofline_table.missing(recs, "1x1")) == 32
    assert roofline_table.fed_table(out).count("\n") == 1
    assert roofline_table.main([out, "--md", str(tmp_path / "t.md")]) == 0
    assert comm_cost.mesh_amortization(out) == []
    with open(tmp_path / "t.md") as f:
        assert "### 1x1 feddcl" in f.read()


def test_cli_exits_1_when_a_pair_fails(tmp_path, monkeypatch, capsys):
    _small_world(monkeypatch)

    def fails(plan, device):
        raise RuntimeError("trace failed")

    monkeypatch.setattr(dryrun, "trace_plan", fails)
    assert dryrun.main(["--arch", "rwkv6-3b", "--shape", "decode_32k",
                        "--device", "cpu", "--out", str(tmp_path)]) == 1
    assert "1 FAILURES" in capsys.readouterr().out


def test_mesh_amortization_reads_only_measured_multi_rank_records(tmp_path):
    base = {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16"}
    for mode, chips, v in (("baseline", 256, 8.0), ("feddcl", 256, 1.0),
                           ("feddcl_sync", 256, 4.0)):
        with open(tmp_path / f"llama__train_4k__16x16__{mode}.json",
                  "w") as f:
            json.dump({**base, "mode": mode, "chips": chips,
                       "collective_bytes_per_device": v}, f)
    with open(tmp_path / "llama__train_4k__1x1__baseline.json", "w") as f:
        json.dump({**base, "mesh": "1x1", "mode": "baseline", "chips": 1,
                   "collective_bytes_per_device": 0.0}, f)
    assert comm_cost.mesh_amortization(str(tmp_path)) == [{
        "arch": "llama3.2-1b", "mesh": "16x16",
        "baseline_coll_bytes_per_step": 8.0,
        "feddcl_amortized_coll_bytes_per_step": 2.0, "reduction_x": 4.0}]
    assert np.isclose(comm_cost.mesh_amortization(str(tmp_path), H=1)[0][
        "reduction_x"], 8.0 / 5.0)
