"""Training entry point, the baseline data-parallel branch (counterpart of
``repro.launch.train``): random weights from the seed, the synthetic
``TokenStream``, ``make_train_step`` each step, the loss logged every
`log_every` steps. Runs on CUDA unless ``device="cpu"`` is asked for.

Not ported yet (each raises NotImplementedError naming ROADMAP.md): the
FedDCL federated branch (``silos > 1``; ``local_steps``,
``rounds_per_dispatch`` and ``non_iid`` belong to it) and ``--checkpoint``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --reduced --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import ARCHS, REDUCED
from repro_torch.configs.base import FederatedConfig, InputShape, TrainConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import backbone as bb


def train(arch: str, *, reduced: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 256, silos: int = 1, local_steps: int = 4,
          rounds_per_dispatch: int = 1,
          lr: float = 3e-4, seed: int = 0, non_iid: bool = False,
          log_every: int = 10, checkpoint_path: str | None = None,
          log_path: str | None = None, param_dtype: str = "float32",
          compute_dtype: str = "float32", device: DeviceLike = None):
    if silos > 1:
        raise NotImplementedError(
            "train(silos > 1): the FedDCL federated round steps are not "
            "ported yet. See ROADMAP.md, Queue 1")
    if checkpoint_path:
        raise NotImplementedError(
            "train(checkpoint_path=...): checkpoint/store.py is not ported "
            "yet. See ROADMAP.md, Queue 1")
    dev = resolve_device(device)
    cfg = (REDUCED if reduced else ARCHS)[arch]
    shape = InputShape("cli", seq_len=seq, global_batch=batch, kind="train")
    tc = TrainConfig(
        model=cfg, shape=shape, learning_rate=lr, warmup_steps=max(steps // 20, 5),
        total_steps=steps, param_dtype=param_dtype, compute_dtype=compute_dtype,
        federated=FederatedConfig(num_silos=silos, local_steps=local_steps),
        remat=False, seed=seed)

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = bb.init_params(cfg, gen, getattr(torch, param_dtype), device=dev)
    n_params = bb.count_params_analytic(cfg)
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M silos={silos} "
          f"H={local_steps} batch={batch}x{seq} device={dev}")

    history = []
    step_fn, opt = steps_lib.make_train_step(cfg, tc, device=dev)
    opt_state = opt.init(params)
    stream = TokenStream(cfg.vocab_size, seq, batch, seed=seed)
    t0 = time.perf_counter()
    for step in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             stream.batch(step))
        if step % log_every == 0 or step == steps - 1:
            rec = {"step": step, "loss": float(metrics["loss"]),
                   "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            print(f"step {step:5d} loss {rec['loss']:.4f} "
                  f"({rec['elapsed_s']:.1f}s)")

    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        with open(log_path, "w") as f:
            json.dump({"arch": cfg.name, "silos": silos, "H": local_steps,
                       "history": history}, f, indent=1)
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--silos", type=int, default=1)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--rounds-per-dispatch", type=int, default=1,
                    help="FedDCL rounds fused into one dispatch (federated "
                         "branch, not ported yet)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)
    train(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
          seq=args.seq, silos=args.silos, local_steps=args.local_steps,
          rounds_per_dispatch=args.rounds_per_dispatch,
          lr=args.lr, seed=args.seed, non_iid=args.non_iid,
          checkpoint_path=args.checkpoint, log_path=args.log,
          device=args.device)


if __name__ == "__main__":
    main()
