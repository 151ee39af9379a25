"""Where a federated local step's time goes beyond the baseline train
step's, at rwkv6-3b's full width and depth on one card.

    python3 scripts/fed_step_gap.py [--steps 4]
    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True python3 scripts/fed_step_gap.py

chip_smoke.py's rwkv6_federated phase runs 2 silos with bf16 AdamW
moments; its rwkv6_train phase, one model with fp32 moments. This script
runs, in one process and in this order, on 2 x 1024 tokens a silo under
TrainConfig's defaults otherwise:

- ``baseline_fp32``: ``make_train_step`` with fp32 moments (the
  rwkv6_train row);
- ``baseline_bf16``: the same with bf16 moments (what the moments' dtype
  costs alone);
- ``federated_bf16``: ``make_federated_local_step`` on 2 silos with bf16
  moments (what the silo stack costs on top: two silos' params and
  moments resident, 66 GB at the peak).

Each prints one JSON line: the wall time per silo step (the first step
left out), peak allocated and reserved memory, and the caching
allocator's retries (a cudaMalloc that failed, after which the allocator
frees its cached blocks, synchronizing the device, and tries again) and
device allocations and frees over the timed steps. The card's name and
power limit print first. The allocator's settings come from
``PYTORCH_CUDA_ALLOC_CONF``, read when the process first touches the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, InputShape, TrainConfig  # noqa: E402
from repro_torch.core.federated import silo_replicate  # noqa: E402
from repro_torch.data.tokens import TokenStream, silo_batches  # noqa: E402
from repro_torch.launch.steps import (make_federated_local_step,  # noqa: E402
                                      make_train_step, silo_opt_init)
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

B, S, D = 2, 1024, 2
STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def measure(name, step, state, batches, silos):
    """Time `step` over `batches` (one call each); the first call warms."""
    times = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        if i == 1:
            before = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(*state, b)[:2]
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) / silos)
    after = torch.cuda.memory_stats()
    row = {"variant": name, "silos": silos, "batch": B, "seq": S,
           "step_s_per_silo": {"min": min(times),
                               "median": statistics.median(times),
                               "max": max(times), "n": len(times)},
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}
    row.update({k: after[k] - before[k] for k in STATS})
    print(json.dumps(row), flush=True)
    return state


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fed_step_gap: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = ARCHS["rwkv6-3b"]
    params = bb.init_params(cfg, torch.Generator(device=dev).manual_seed(5),
                            device=dev)
    stream = TokenStream(cfg.vocab_size, S, B, seed=0)
    for moments, name in (("float32", "baseline_fp32"),
                          ("bfloat16", "baseline_bf16")):
        tc = TrainConfig(model=cfg, shape=InputShape("gap", S, B, "train"),
                         warmup_steps=2, total_steps=args.steps,
                         opt_state_dtype=moments)
        step, opt = make_train_step(cfg, tc, device=dev)
        state = measure(name, step, (params, opt.init(params)),
                        [stream.batch(i) for i in range(args.steps)], 1)
        del state
    tc = TrainConfig(model=cfg, shape=InputShape("gap", S, D * B, "train"),
                     warmup_steps=2, total_steps=args.steps,
                     opt_state_dtype="bfloat16")
    local, opt = make_federated_local_step(cfg, tc, device=dev)
    sp = tree_map(lambda a: a.contiguous(), silo_replicate(params, D))
    del params
    batches = [silo_batches(cfg.vocab_size, S, B, D, i) for i in
               range(args.steps)]
    measure("federated_bf16", local, (sp, silo_opt_init(opt, sp)), batches,
            D)
    return 0


if __name__ == "__main__":
    sys.exit(main())
