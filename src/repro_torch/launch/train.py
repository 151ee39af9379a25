"""Training entry point (counterpart of ``repro.launch.train``): baseline
data-parallel OR FedDCL federated (silo-local steps + periodic cross-silo
aggregation), random weights from the seed, the synthetic token pipeline,
the loss logged every `log_every` steps, the final params optionally
written by ``checkpoint.store``. Runs on CUDA unless ``device="cpu"`` is
asked for.

Training runs a kernel only where it has a gradient: the WKV6 kernels do
(the ssm family), the flash-attention kernel does not, so a dense, moe or
hybrid model trains on the plain attention path, as the reference's
``train`` does (Mamba2's SSD scan has no kernel in either package). A
moe model's loss adds its load-balance term (and, with an MTP head,
deepseek's MTP loss); both come back as metrics beside the loss. A
modality-prefix family (musicgen, chameleon) gets a fresh
``synthetic_prefix`` every step, in both branches, from a generator seeded
from (seed, step): the role of the reference's ``fold_in(key, step)``,
whose draws torch cannot reproduce.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \\
      --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --reduced --steps 11 --silos 2 --local-steps 2 \\
      --rounds-per-dispatch 2 --checkpoint ck.npz --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import ARCHS, REDUCED
from repro_torch.configs.base import FederatedConfig, InputShape, TrainConfig
from repro_torch.core.federated import silo_replicate
from repro_torch.data.tokens import TokenStream, silo_batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import backbone as bb
from repro_torch.models.modality import synthetic_prefix
from repro_torch.tree import tree_map


def step_prefix(cfg, seed: int, step: int, shape, dev: torch.device
                ) -> torch.Tensor:
    """A prefix family's prefix embeddings for training step `step`:
    ``synthetic_prefix`` of prod(shape) rows, reshaped to shape + (P, d),
    drawn from a generator of `dev` seeded from (seed, step) alone."""
    sub = int(np.random.SeedSequence((seed, step)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=dev).manual_seed(sub)
    pe = synthetic_prefix(gen, cfg, int(np.prod(shape)), device=dev)
    return pe.reshape(tuple(shape) + pe.shape[1:])


def train(arch: str, *, reduced: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 256, silos: int = 1, local_steps: int = 4,
          rounds_per_dispatch: int = 1,
          lr: float = 3e-4, seed: int = 0, non_iid: bool = False,
          log_every: int = 10, checkpoint_path: str | None = None,
          log_path: str | None = None, param_dtype: str = "float32",
          compute_dtype: str = "float32", device: DeviceLike = None):
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
    # only a kernel with a gradient may run here: WKV6 has one, flash
    # attention has none (so dense, moe and hybrid train on plain attention)
    kw = dict(use_kernels=cfg.family == "ssm", device=dev)

    history = []
    t0 = time.perf_counter()

    def log(step, loss):
        """Record `loss` (a tensor, silo-meaned) on logged steps only: the
        conversion waits for the device."""
        if step % log_every == 0 or step == steps - 1:
            rec = {"step": step, "loss": float(torch.mean(loss)),
                   "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            print(f"step {step:5d} loss {rec['loss']:.4f} "
                  f"({rec['elapsed_s']:.1f}s)")

    if silos > 1:
        if batch % silos:
            raise ValueError(f"batch {batch} is not a multiple of silos "
                             f"{silos}")
        round_step, opt = steps_lib.make_federated_round_step(cfg, tc, **kw)
        # the steps write each silo's slice in place: the stack owns its
        # storage, not silo_replicate's shared broadcast view
        sp = tree_map(lambda a: a.contiguous(), silo_replicate(params, silos))
        del params
        so = steps_lib.silo_opt_init(opt, sp)

        def stacked_batches(step0, h):
            """h consecutive per-silo batches, stacked with leading dim h
            (a prefix family's prefix (h, silos, batch/silos, P, d))."""
            nbs = [silo_batches(cfg.vocab_size, seq, batch // silos, silos,
                                step0 + i, seed=seed, non_iid=non_iid)
                   for i in range(h)]
            b = {k: np.stack([nb[k] for nb in nbs]) for k in nbs[0]}
            if cfg.prefix_frontend:
                b["prefix_embeds"] = torch.stack([
                    step_prefix(cfg, seed, step0 + i, (silos, batch // silos),
                                dev) for i in range(h)])
            return b

        def log_round(step0, metrics):
            for i in range(int(metrics["loss"].shape[0])):
                log(step0 + i, metrics["loss"][i])

        rpd = max(rounds_per_dispatch, 1)
        if rpd > 1:
            multi_step, _ = steps_lib.make_federated_multiround_step(
                cfg, tc, **kw)

            def multiround_batches(step0, r, h):
                bs = [stacked_batches(step0 + i * h, h) for i in range(r)]
                stack = lambda xs: (torch.stack(xs)
                                    if isinstance(xs[0], torch.Tensor)
                                    else np.stack(xs))
                return {k: stack([b[k] for b in bs]) for k in bs[0]}

        n_rounds = steps // local_steps
        rnd = 0
        while rnd < n_rounds:
            step0 = rnd * local_steps
            if rpd > 1 and n_rounds - rnd >= rpd:
                sp, so, metrics = multi_step(
                    sp, so, multiround_batches(step0, rpd, local_steps))
                for r in range(rpd):
                    log_round(step0 + r * local_steps,
                              tree_map(lambda a, r=r: a[r], metrics))
                rnd += rpd
            else:
                sp, so, metrics = round_step(
                    sp, so, stacked_batches(step0, local_steps))
                log_round(step0, metrics)
                rnd += 1
        rem = steps % local_steps
        if rem:
            # the trailing steps of an unfinished round: local steps, no sync
            phase, _ = steps_lib.make_federated_local_phase_step(cfg, tc, **kw)
            sp, so, metrics = phase(sp, so, stacked_batches(steps - rem, rem))
            log_round(steps - rem, metrics)
        params = tree_map(lambda a: a[0].clone(), sp)
        del sp, so
    else:
        step_fn, opt = steps_lib.make_train_step(cfg, tc, **kw)
        opt_state = opt.init(params)
        stream = TokenStream(cfg.vocab_size, seq, batch, seed=seed)
        for step in range(steps):
            b = stream.batch(step)
            if cfg.prefix_frontend:
                b["prefix_embeds"] = step_prefix(cfg, seed, step, (batch,),
                                                 dev)
            params, opt_state, metrics = step_fn(params, opt_state, b)
            log(step, metrics["loss"])

    if checkpoint_path:
        store.save(checkpoint_path, params,
                   {"arch": cfg.name, "steps": steps, "reduced": reduced})
        print(f"checkpoint -> {checkpoint_path}")
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
                    help="FedDCL rounds per call of the multiround step "
                         "(1 = one call per round)")
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
