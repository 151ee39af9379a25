"""Where the first federated round of a process spends its time, on one
GPU.

    python3 scripts/fed_warmup_profile.py

At the mnist-width Experiment II layout (chip_smoke.py's, the
collaboration solve on the host), after one cuBLAS matmul (as steps 1-3 of
a fit leave the card), runs under cProfile the first scan-engine call of
the process (2 rounds, plan cache on), then a second plan (another cache
key), a first host-engine round, and last a first ``torch.func.grad``
call. Prints the card's name and power limit, one JSON line with each
call's wall seconds, the first call's parts (FLResult.timings), the
seconds cProfile saw in `compile()` of Python sources and the modules the
first engine call and the first ``torch.func.grad`` imported, then
cProfile's top entries by cumulative time for the first engine call.
"""
from __future__ import annotations

import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from collections import Counter
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import federated as fed, protocol  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fed_warmup_profile: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    Xs, Ys, _, _ = cs.mnist_exp2_layout()
    silos = protocol.run_protocol(Xs, Ys, m_tilde=cs.M_TILDE,
                                  anchor_r=cs.ANCHOR_R, seed=0,
                                  svd_backend="host").fed_silos()
    loss = partial(mlp.mlp_per_example_loss, task="classification")
    p0 = mlp.init_mlp_params(torch.Generator().manual_seed(3), cs.M_TILDE,
                             (500, 100), 10, device=dev)
    a = torch.randn(64, 64, device=dev)
    float((a @ a).sum())
    kw = dict(opt=adamw(1e-3), rounds=2, local_epochs=4, batch_size=32,
              device=dev)
    modules = set(sys.modules)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    first = fed.run_federated(loss, p0, silos, engine="scan", cache=True,
                              **kw)
    prof.disable()
    first_s = time.perf_counter() - t0
    imported = sorted(set(sys.modules) - modules)
    t0 = time.perf_counter()
    second = fed.run_federated(loss, p0, silos, engine="scan", cache=True,
                               reset_opt_per_round=False, **kw)
    second_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fed.run_federated(loss, p0, silos, engine="host", **{**kw, "rounds": 1})
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # what a first torch.func.grad costs the process (the engines take
    # gradients by plain autograd and never call it)
    modules_before = set(sys.modules)
    func_prof = cProfile.Profile()
    t0 = time.perf_counter()
    func_prof.enable()
    torch.func.grad(lambda x: (x * x).sum())(torch.ones(3, device=dev))
    func_prof.disable()
    func_grad_s = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    compile_s = lambda st: sum(
        v[2] for k, v in st.stats.items()
        if k[2] == "<built-in method builtins.compile>")
    # modules imported, by package two levels deep (torch._dynamo, ...)
    by_package = Counter(".".join(m.split(".")[:2]) for m in imported)
    print(json.dumps({
        "first_scan_call_s": first_s, "first_scan_call_parts": first.timings,
        "second_plan_s": second_s, "second_plan_parts": second.timings,
        "first_host_round_s": host_s,
        "compile_of_python_sources_s": compile_s(stats),
        "modules_imported_by_first_call": len(imported),
        "imported_by_package": dict(by_package.most_common(15)),
        "first_torch_func_grad_s": func_grad_s,
        "first_torch_func_grad_compile_s": compile_s(pstats.Stats(func_prof)),
        "modules_imported_by_first_torch_func_grad": len(
            set(sys.modules) - modules_before)}), flush=True)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(30)
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
