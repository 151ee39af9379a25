#!/usr/bin/env python
"""What idle cached plans hold on the card: runs run_federated(engine=
"scan", cache=True) on the audit's tenant (``analysis.audit.tenant``: 3
silos x 16 features, batch 8, 2 rounds x 2 epochs), then serve_bench's
fast deployment (cold and warm sweeps), and prints, for every plan in the
two plan caches, whether it captured a graph and each non-splat array of
>= 512 elements it still holds (``hlo_audit.find_baked_constants``).

    python3 scripts/idle_plans.py [SRC]

SRC (default: this checkout's src/) is the source tree to import, so a
copy of another revision can be probed beside this one (that copy needs
this revision's ``analysis/hlo_audit.py`` for ``find_baked_constants``).
Prints one line ``IDLE <SRC> <json>``. Needs a card.
"""
import json
import os
import sys

SRC = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis.hlo_audit import find_baked_constants  # noqa: E402
from repro_torch.benchmarks import serve_bench  # noqa: E402
from repro_torch.core import federated as F  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def main() -> int:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((16, 1))
    silos = []
    for n in (56, 49, 52):
        X = rng.standard_normal((n, 16))
        silos.append((X, X @ w_true + 0.01 * rng.standard_normal((n, 1))))
    p = mlp.init_mlp_params(torch.Generator().manual_seed(0), 16, (8,), 1,
                            device=dev)
    loss = lambda q, x, y: mlp.mlp_per_example_loss(q, x, y, "regression")
    F.run_federated(loss, p, silos, opt=adamw(1e-2), rounds=2,
                    local_epochs=2, batch_size=8, engine="scan", cache=True,
                    device=dev)
    b = serve_bench.build(fast=True, device=dev)
    serve_bench.serve_sweeps(b)
    # the caches' own table: an older revision has no PlanCache.plans()
    plans = [q for q, _ in F.default_plan_cache()._plans.values()] + \
        [q for q, _ in b.srv.cache._plans.values()]
    out = [{"plan": type(q).__name__, "captured": int(q.captures),
            "non_splat": [(f["path"], f["shape"]) for f in
                          find_baked_constants(q, min_elems=512)]}
           for q in plans]
    print("IDLE", SRC, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
