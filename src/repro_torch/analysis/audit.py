"""The port's artifact audit: the single-card checks of the reference's
``scripts/feddcl_audit.py`` over the port's FL plans.

A tiny FL plan (3 silos x 16 features, batch 8, adamw 1e-2, 2 rounds x 2
local epochs) is lowered (``core.federated.lower_fl_plan``: bound to one
tenant, run once, on CUDA built, captured and replayed) in every unsharded
flavor and passed through ``analysis.hlo_audit.assert_no_baked_data``:
the plan answers from its arguments, is held to its eager rounds, and once
idle holds no non-splat array of ``--min-elems`` or more elements.

  1. the flavors: fedavg and median, each over the whole run and with an
     eval chunk, and a masked fedavg run under a dropout `availability`;
  2. a closure-baked positive control: a ``batch_loss`` that reads the
     tenant's X from its closure instead of its argument. The behavioural
     check must fail on it, and ``find_baked_constants`` must find the
     closed-over X in the idle plan;
  3. a buffer-resident positive control: a plan whose run leaves its
     buffers filled (no release). ``find_baked_constants`` must find them;
  4. the warm sentinel: a second identical run builds no plan and
     captures no graph (``CompileCounter.count == 0``);
  5. the sharded flavors (``SHARDED_FLAVORS``: fedavg and trimmed_mean
     over the whole run, fedavg with an eval chunk) on a
     ``make_host_mesh(model=1)`` mesh of `ranks` ranks, each lowered on
     every rank and held to the same audit, with the collective census:
     every unsharded flavor runs none, a sharded weighted plan exactly
     {all-reduce: leaves+1} per hierarchy level, a sharded robust one
     {all-reduce: 1, all-gather: leaves+1}. In a group of more than one
     rank they run on its ranks; elsewhere ``launch.mesh.run_ranks``
     spawns `ranks` of them (``--ranks``, default 2).

  PYTHONPATH=src python -m repro_torch.analysis.audit [--device cpu]
      [--min-elems 512] [--ranks 2] [--json]

Exit status: 0 when every check holds, 1 otherwise. Without ``--device``
it runs on CUDA (the spawned ranks too).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.hlo_audit import (BakedDataError, CompileCounter,
                                            assert_no_baked_data,
                                            collective_census,
                                            find_baked_constants)
from repro_torch.core import federated
from repro_torch.core.federated import (FLPlan, PaddedSilos, lower_fl_plan,
                                        pad_silo_data)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import (DEFAULT_RANKS, make_host_mesh,
                                     rank_device, run_ranks)
from repro_torch.models import mlp
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

# the reference script's tenant: 3 silos x 7 batches x 8 x 16 features, so
# the padded X (and the closure-baked control's copy of it) clears 512
SILO_SIZES = (56, 49, 52)
FEATURES, BATCH, ROUNDS, EPOCHS, LR = 16, 8, 2, 2, 1e-2
MIN_ELEMS = 512
# (name, aggregator, eval chunk, dropout)
FLAVORS = (("fedavg/whole", "fedavg", None, False),
           ("fedavg/chunk", "fedavg", 1, False),
           ("median/whole", "median", None, False),
           ("median/chunk", "median", 1, False),
           ("fedavg/dropout", "fedavg", None, True))
# (name, aggregator, eval chunk), each on a make_host_mesh(model=1) mesh
SHARDED_FLAVORS = (("sharded/fedavg/whole", "fedavg", None),
                   ("sharded/trimmed_mean/whole", "trimmed_mean", None),
                   ("sharded/fedavg/chunk", "fedavg", 1))
# each round drops one silo
DROPOUT = np.array([[1, 0, 1], [1, 1, 0]], np.float32)


def tenant(seed: int = 0):
    """The reference script's regression silos, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((FEATURES, 1))
    silos = []
    for n in SILO_SIZES:
        X = rng.standard_normal((n, FEATURES))
        silos.append((X, X @ w_true + 0.01 * rng.standard_normal((n, 1))))
    return silos


def batch_loss():
    loss = lambda p, x, y: mlp.mlp_per_example_loss(p, x, y, "regression")
    return federated._make_batch_loss(loss, True, 0.0)


def make_plan(padded: PaddedSilos, loss, aggregator: str,
              device: torch.device, cls=FLPlan, mesh=None) -> FLPlan:
    return cls(num_silos=padded.num_silos, num_batches=padded.num_batches,
               batch_size=padded.batch_size, opt=adamw(LR), batch_loss=loss,
               local_epochs=EPOCHS, aggregator=aggregator, masked=True,
               device=device, mesh=mesh)


class RetainingPlan(FLPlan):
    """The buffer-resident positive control: a plan that skips the release,
    so its buffers keep the last tenant after a run. On the CPU, where no
    buffers are filled, it keeps the tenant's stack as the captured path's
    buffers would hold it."""

    def _release(self) -> None:
        pass

    def _eager_rounds(self, init_params, args):
        X, Y, w, wr, scale, perms = args
        self._bufs = SimpleNamespace(
            X=X.clone(), Y=Y.clone(), w=w.clone(), wr=wr[-1].clone(),
            scale=scale.clone(), carry=self.carry_init(init_params),
            perms=None if perms is None else perms[-1].clone(), loss=None)
        return super()._eager_rounds(init_params, args)


def closure_baked_plan(padded: PaddedSilos, loss,
                       device: torch.device) -> FLPlan:
    """The closure-baked positive control: its batch_loss reads rows of
    the tenant's X held in its closure, not the batch it is given."""
    baked_X = torch.as_tensor(padded.X, device=device)

    def leaky(p, x, y, w, ref):
        return loss(p, baked_X[0, :x.shape[0]], y, w, ref)

    # feddcl-lint: disable=R004  deliberate: this IS the leak the control verifies the audit can see
    return FLPlan(num_silos=padded.num_silos, num_batches=padded.num_batches,
                  batch_size=padded.batch_size, opt=adamw(LR),
                  batch_loss=leaky, local_epochs=EPOCHS, masked=True,
                  device=device)


def _err(lowered) -> float:
    """The lowered plan as served against its eager rounds, relative to
    max(1, |eager|)."""
    got, want = lowered.run(*lowered.args), lowered.eager(*lowered.args)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def expected_census(aggregator: Optional[str], leaves: int,
                    levels: int) -> Dict[str, int]:
    """The census a flavor must show: none unsharded (aggregator None)."""
    if aggregator is None:
        return {}
    if aggregator in federated.ROBUST_AGGREGATORS:
        return {"all-reduce": levels, "all-gather": (leaves + 1) * levels}
    return {"all-reduce": (leaves + 1) * levels}


def _params(dev: torch.device):
    return mlp.init_mlp_params(torch.Generator().manual_seed(0), FEATURES,
                               (8,), 1, device=dev)


def _flavor(name, plan, lowered, built, t0, min_elems, census, expect):
    return {"flavor": name, "plans": built.plans, "captures": built.captures,
            "replays": plan.replays, "max_rel_err_vs_eager": _err(lowered),
            "baked": find_baked_constants(plan, min_elems),
            "collectives": census, "expected_collectives": expect,
            "audit_s": time.perf_counter() - t0}


def sharded_flavors(device: DeviceLike = None, min_elems: int = MIN_ELEMS
                    ) -> List[Dict[str, Any]]:
    """The sharded flavors on this rank (a rank target: every rank of the
    group runs it): the tenant padded to the shard multiple, each flavor's
    plan lowered on the mesh and audited, its census beside the expected
    one. Raises ``BakedDataError`` when a flavor fails the audit."""
    dev = resolve_device(device or rank_device())
    mesh = make_host_mesh(model=1)
    shards = federated.num_silo_shards(mesh)
    silos = tenant()
    padded = pad_silo_data(silos, BATCH,
                           min_silos=-(-len(silos) // shards) * shards)
    params = _params(dev)
    loss = batch_loss()
    rows = []
    for name, aggregator, chunk in SHARDED_FLAVORS:
        t0 = time.perf_counter()
        with CompileCounter() as built:
            plan = make_plan(padded, loss, aggregator, dev, mesh=mesh)
            lowered = lower_fl_plan(plan, params, padded, rounds=ROUNDS,
                                    eval_chunk=chunk)
        assert_no_baked_data(lowered, min_elems=min_elems)
        expect = expected_census(aggregator, len(tree_leaves(params)),
                                 len(plan.comm.levels))
        rows.append(_flavor(name, plan, lowered, built, t0, min_elems,
                            collective_census(lowered), expect))
    return rows


def run(device: DeviceLike = None, min_elems: int = MIN_ELEMS,
        ranks: int = DEFAULT_RANKS) -> Dict[str, Any]:
    """Every check above on `device`; raises ``BakedDataError`` when a
    flavor fails the audit. Returns the report: each flavor's plans built
    and graphs captured by its lowering, its replay-vs-eager gap, its
    census and its seconds; what each positive control's checks found;
    the warm sentinel's count. The sharded flavors run on this process's
    group when it has more than one rank, else on `ranks` spawned ones
    (rank 0's rows; every rank's must agree)."""
    dev = resolve_device(device)
    padded = pad_silo_data(tenant(), BATCH)
    params = _params(dev)
    loss = batch_loss()
    report: Dict[str, Any] = {"device": str(dev), "min_elems": min_elems,
                              "flavors": []}
    first = None
    for name, aggregator, chunk, dropout in FLAVORS:
        t0 = time.perf_counter()
        with CompileCounter() as built:
            plan = make_plan(padded, loss, aggregator, dev)
            lowered = lower_fl_plan(plan, params, padded, rounds=ROUNDS,
                                    availability=DROPOUT if dropout else None,
                                    eval_chunk=chunk)
        assert_no_baked_data(lowered, min_elems=min_elems)
        report["flavors"].append(_flavor(name, plan, lowered, built, t0,
                                         min_elems,
                                         collective_census(lowered), {}))
        if first is None:
            first = lowered
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        sharded = sharded_flavors(dev, min_elems)
        report["ranks"] = dist.get_world_size()
    else:
        # each rank on its own device: the card's, or the CPU
        per_rank = run_ranks(
            "repro_torch.analysis.audit:sharded_flavors", ranks,
            args=(None if dev.type == "cuda" else "cpu", min_elems),
            timeout=600.0, device=dev)
        sharded = per_rank[0]
        report["ranks"] = ranks
        report["ranks_agree"] = all(
            [(r["collectives"], r["max_rel_err_vs_eager"], r["baked"])
             for r in rows] == [(r["collectives"], r["max_rel_err_vs_eager"],
                                 r["baked"]) for r in sharded]
            for rows in per_rank)
    report["flavors"] += sharded

    # closure-baked control: both halves must see it
    leaky = closure_baked_plan(padded, loss, dev)
    caught = None
    try:
        assert_no_baked_data(lower_fl_plan(leaky, params, padded,
                                           rounds=ROUNDS),
                             min_elems=min_elems)
    except BakedDataError as e:
        caught = str(e)
    report["closure_control"] = {
        "behaviour": caught,
        "structure": [b["path"] for b in find_baked_constants(leaky,
                                                              min_elems)]}
    # buffer-resident control
    kept = make_plan(padded, loss, "fedavg", dev, cls=RetainingPlan)
    lower_fl_plan(kept, params, padded, rounds=ROUNDS)
    report["buffer_control"] = {
        "structure": [b["path"] for b in find_baked_constants(kept,
                                                              min_elems)]}
    # the warm sentinel
    with CompileCounter() as warm:
        first.run(*first.args)
    report["warm_recompiles"] = warm.count
    report["ok"] = ok(report)
    return report


def ok(report: Dict[str, Any]) -> bool:
    """Whether every check holds."""
    closure, buffers = report["closure_control"], report["buffer_control"]
    return (all(not f["baked"] for f in report["flavors"])
            and all(f["collectives"] == f["expected_collectives"]
                    for f in report["flavors"])
            and report.get("ranks_agree", True)
            and closure["behaviour"] is not None
            and bool(closure["structure"]) and bool(buffers["structure"])
            and report["warm_recompiles"] == 0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="the port's FL-plan artifact audit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--min-elems", type=int, default=MIN_ELEMS,
                    help="baked-array threshold in elements")
    ap.add_argument("--ranks", type=int, default=DEFAULT_RANKS,
                    help="ranks the sharded flavors spawn (outside a group)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    try:
        report = run(args.device, args.min_elems, args.ranks)
    except BakedDataError as e:
        print(f"AUDIT_FAILED {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for row in report["flavors"]:
            good = not row["baked"] and \
                row["collectives"] == row["expected_collectives"]
            print(f"{'AUDIT_OK' if good else 'AUDIT_FAILED'} "
                  f"{row['flavor']:26s} baked={len(row['baked'])} "
                  f"plans={row['plans']} captures={row['captures']} "
                  f"vs_eager={row['max_rel_err_vs_eager']:.1e} "
                  f"collectives={row['collectives']}")
        closure, buffers = report["closure_control"], report["buffer_control"]
        print("POSITIVE_CONTROL "
              + ("caught" if closure["behaviour"] and closure["structure"]
                 else "MISSED")
              + f" closure_baked (structure: {closure['structure']})")
        print("POSITIVE_CONTROL "
              + ("caught" if buffers["structure"] else "MISSED")
              + f" buffer_resident (structure: {buffers['structure']})")
        print(f"WARM_RECOMPILES {report['warm_recompiles']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
