"""End-to-end example: train a ~100M-parameter llama-family model on the
synthetic token pipeline under the FedDCL federated schedule (2 silos,
H = 4 local steps a round, then fedavg) and write the loss curve
(counterpart of the reference's ``examples/end_to_end_driver.py``).

~100M config: 8 layers, d_model 512, 8 heads (kv 4), d_ff 2048, vocab
32768; fp32, no remat. The model is dense, and the flash-attention kernel
has no backward, so it trains on the plain attention path (as
``launch.train`` trains the dense family). The silos are a contiguous
stack, each silo's step in place on its slice.

  python -m repro_torch.examples.end_to_end_driver [--steps 200]
      [--device cpu] [--out-dir results_torch]

Writes ``e2e_driver.json`` under the output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.configs import get_arch
from repro_torch.configs.base import (FederatedConfig, InputShape,
                                      ModelConfig, TrainConfig)
from repro_torch.core.federated import silo_replicate
from repro_torch.data.tokens import silo_batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import backbone as bb
from repro_torch.tree import tree_map
from repro_torch.weights import lm_params_from_numpy


def llama_100m() -> ModelConfig:
    return get_arch("llama3.2-1b").with_overrides(
        name="llama-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768)


def run(cfg: ModelConfig, *, steps: int = 200, batch: int = 8, seq: int = 256,
        silos: int = 2, local_steps: int = 4, init_params: Any = None,
        log_every: int = 10, device: DeviceLike = None) -> List[Dict]:
    """Train `steps` federated steps; returns the loss history (every
    `log_every` steps and the last, each silo-meaned, with the elapsed
    seconds). The params are `init_params` (a tree of arrays, e.g. the
    reference's PRNGKey(0) draw), else the port's own draw from seed 0."""
    dev = resolve_device(device)
    shape = InputShape("e2e", seq_len=seq, global_batch=batch, kind="train")
    tc = TrainConfig(model=cfg, shape=shape, learning_rate=1e-3,
                     warmup_steps=20, total_steps=steps,
                     param_dtype="float32", compute_dtype="float32",
                     remat=False,
                     federated=FederatedConfig(num_silos=silos,
                                               local_steps=local_steps))
    params = (lm_params_from_numpy(init_params, dev)
              if init_params is not None else bb.init_params(
                  cfg, torch.Generator(device=dev).manual_seed(0),
                  torch.float32, device=dev))
    print(f"params: {bb.count_params_analytic(cfg)/1e6:.1f}M")
    vstep, opt = steps_lib.make_federated_local_step(
        cfg, tc, use_kernels=False, device=dev)
    sync = steps_lib.make_fedavg_sync_step(tc, device=dev)
    # the steps write each silo's slice in place: the stack owns its storage
    sp = tree_map(lambda a: a.contiguous(), silo_replicate(params, silos))
    del params
    so = steps_lib.silo_opt_init(opt, sp)
    hist = []
    t0 = time.perf_counter()
    for step in range(steps):
        nb = silo_batches(cfg.vocab_size, seq, batch // silos, silos, step,
                          non_iid=True)
        sp, so, m = vstep(sp, so, nb)
        if (step + 1) % local_steps == 0:
            sp, so = sync(sp, so)
        if step % log_every == 0 or step == steps - 1:
            loss = float(torch.mean(m["loss"]))
            hist.append({"step": step, "loss": loss,
                         "elapsed_s": time.perf_counter() - t0})
            print(f"step {step:4d} loss {loss:.4f} "
                  f"({hist[-1]['elapsed_s']:.1f}s)")
    return hist


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--silos", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    hist = run(llama_100m(), steps=args.steps, batch=args.batch, seq=args.seq,
               silos=args.silos, local_steps=args.local_steps,
               device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "e2e_driver.json")
    with open(out, "w") as f:
        json.dump({"config": "llama-100m", "history": hist}, f, indent=1)
    print(f"-> {out}: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
