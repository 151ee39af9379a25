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
     captures no graph (``CompileCounter.count == 0``).

The reference's sharded flavors and its collective census wait for silo
sharding; they are reported as skipped, never as passed.

  PYTHONPATH=src python -m repro_torch.analysis.audit [--device cpu]
      [--min-elems 512] [--json]

Exit status: 0 when every check that ran holds, 1 otherwise. Without
``--device`` it runs on CUDA.
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

from repro_torch.analysis.hlo_audit import (BakedDataError, CompileCounter,
                                            assert_no_baked_data,
                                            find_baked_constants)
from repro_torch.core import federated
from repro_torch.core.federated import (FLPlan, PaddedSilos, lower_fl_plan,
                                        pad_silo_data)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp
from repro_torch.optim import adamw

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
# each round drops one silo
DROPOUT = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
SKIPPED = {"flavors": ["sharded/fedavg/whole", "sharded/trimmed_mean/whole",
                       "sharded/fedavg/chunk"],
           "collective_census": True,
           "why": "silo sharding is not ported to repro_torch (ROADMAP.md, "
                  "Queue 1, multi-process silo sharding)"}


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
              device: torch.device, cls=FLPlan) -> FLPlan:
    return cls(num_silos=padded.num_silos, num_batches=padded.num_batches,
               batch_size=padded.batch_size, opt=adamw(LR), batch_loss=loss,
               local_epochs=EPOCHS, aggregator=aggregator, masked=True,
               device=device)


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


def run(device: DeviceLike = None, min_elems: int = MIN_ELEMS
        ) -> Dict[str, Any]:
    """Every check above on `device`; raises ``BakedDataError`` when a
    flavor fails the audit. Returns the report: each flavor's plans built
    and graphs captured by its lowering, its replay-vs-eager gap and its
    seconds; what each positive control's checks found; the warm
    sentinel's count; what was skipped and why."""
    dev = resolve_device(device)
    padded = pad_silo_data(tenant(), BATCH)
    params = mlp.init_mlp_params(torch.Generator().manual_seed(0), FEATURES,
                                 (8,), 1, device=dev)
    loss = batch_loss()
    report: Dict[str, Any] = {"device": str(dev), "min_elems": min_elems,
                              "flavors": [], "skipped": SKIPPED}
    first = None
    for name, aggregator, chunk, dropout in FLAVORS:
        t0 = time.perf_counter()
        with CompileCounter() as built:
            plan = make_plan(padded, loss, aggregator, dev)
            lowered = lower_fl_plan(plan, params, padded, rounds=ROUNDS,
                                    availability=DROPOUT if dropout else None,
                                    eval_chunk=chunk)
        assert_no_baked_data(lowered, min_elems=min_elems)
        report["flavors"].append({
            "flavor": name, "plans": built.plans, "captures": built.captures,
            "replays": plan.replays, "max_rel_err_vs_eager": _err(lowered),
            "baked": find_baked_constants(plan, min_elems),
            "audit_s": time.perf_counter() - t0})
        if first is None:
            first = lowered

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
    """Whether every check that ran holds (skips are neither)."""
    closure, buffers = report["closure_control"], report["buffer_control"]
    return (all(not f["baked"] for f in report["flavors"])
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
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    try:
        report = run(args.device, args.min_elems)
    except BakedDataError as e:
        print(f"AUDIT_FAILED {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for row in report["flavors"]:
            print(f"AUDIT_OK {row['flavor']:16s} baked=0 plans={row['plans']}"
                  f" captures={row['captures']} "
                  f"vs_eager={row['max_rel_err_vs_eager']:.1e}")
        closure, buffers = report["closure_control"], report["buffer_control"]
        print("POSITIVE_CONTROL "
              + ("caught" if closure["behaviour"] and closure["structure"]
                 else "MISSED")
              + f" closure_baked (structure: {closure['structure']})")
        print("POSITIVE_CONTROL "
              + ("caught" if buffers["structure"] else "MISSED")
              + f" buffer_resident (structure: {buffers['structure']})")
        print(f"WARM_RECOMPILES {report['warm_recompiles']}")
        print(f"SKIPPED {', '.join(SKIPPED['flavors'])} and the collective "
              f"census: {SKIPPED['why']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
