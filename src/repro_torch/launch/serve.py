"""Batched serving: continuous-batching-lite over the cached decode
path (per-slot prefill + per-token decode with slot reuse); counterpart of
``repro.launch.serve``.

A queue of prompts is served by a fixed-width slot table: finished
sequences release their slot to the next queued request mid-flight; the
decode step always runs the full (padded) batch. Slot positions and
current tokens live on the host (NumPy) and go to the device once per
step; the decode state (dense and moe: the KV cache; ssm: rwkv6's
recurrent and token-shift states; hybrid: the Mamba2 states and the shared
block's KV cache) lives on the device and is updated in place. A moe model with the gspmd dispatch takes its expert capacity from
each step's batch, as the reference's does, so a request's tokens depend
on what the other slots hold. On CUDA
every decode runs as a captured graph (``make_captured_serve_step``): one
for the full batch and one per slot for its B=1 prompt steps.

Unlike the reference, admission zeroes a slot's recurrent state (ssm:
all of it; hybrid: the Mamba2 states, not the shared KV cache): the
reference's ``_prefill_slot`` decodes a new prompt from whatever state the
slot's last request left, which the position mask hides from attention
and a recurrence does not. A KV cache is left as it is: zeroing its
``pos`` would turn the -1 "empty" marks into position 0 and show every
stale key.

A modality-prefix family (musicgen, chameleon) is served from its tokens
alone, as the reference's server serves it: ``_prefill_slot`` decodes the
prompt from position 0 and no request carries a prefix. MLA (deepseek)
decodes against its latent cache.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--device cpu]
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m [--device cpu]
    python -m repro_torch.launch.serve --arch zamba2-1.2b [--device cpu]
    python -m repro_torch.launch.serve --arch musicgen-large [--device cpu]
    python -m repro_torch.launch.serve --arch deepseek-v3-671b [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, REDUCED
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import (make_captured_serve_step,
                                     make_serve_step)
from repro_torch.models import backbone as bb
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (P,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeResult(Dict[int, List[int]]):
    """{rid: tokens} plus `.status`: {rid: done|truncated|pending}.

    "done" reached `max_new`, "truncated" was admitted and emitted tokens
    but was cut off by `max_steps`, "pending" never reached a slot.
    """

    def __init__(self, outputs: Dict[int, List[int]],
                 status: Dict[int, str]):
        super().__init__(outputs)
        self.status = status


def _stream_seed(seed: int, rid: int, n: int) -> int:
    """A sampling seed that depends only on (seed, request id, tokens
    emitted so far): never on the slot or on the batch-mates."""
    return int(np.random.SeedSequence((seed, rid, n)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class BatchedServer:
    """Slot-table continuous batching over decode_step (fp32, as the
    reference's server). `capture` (default: on CUDA) runs the decode
    steps as CUDA graphs; False runs them eagerly."""

    def __init__(self, cfg, params, *, slots: int = 4, cache_len: int = 512,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None, capture: Optional[bool] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.temperature = temperature
        self.seed = seed
        self.state = bb.init_decode_state(cfg, slots, cache_len,
                                          torch.float32, device=self.device)
        self.pos = np.zeros((slots,), np.int32)
        self.cur_tok = np.zeros((slots, 1), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        if capture is None:
            capture = self.device.type == "cuda"
        make = make_captured_serve_step if capture else make_serve_step
        self._decode = make(cfg, compute_dtype=torch.float32,
                            device=self.device)

    @property
    def captures(self) -> int:
        """Decode graphs captured (0 for an eager server)."""
        return getattr(self._decode, "captures", 0)

    def _prefill_slot(self, slot: int, req: Request):
        # per-slot prefill on a B=1 view of the slot's state (every decode
        # state leaf carries batch at axis 1): the prompt decodes as P
        # single-sequence steps, written in place into the slot's rows, and
        # live slots' state is untouched by construction
        toks = req.prompt
        self.pos[slot] = len(toks)
        # a fresh recurrence: the slot's last request left its state
        for a in tree_leaves(self._recurrent_state()):
            a[:, slot].zero_()
        if len(toks) == 0:
            # empty prompt: nothing to prefill (and no logits to sample
            # from) — seed the slot with token 0 at pos 0 and let the next
            # batched decode step produce the first output token
            self.cur_tok[slot, 0] = 0
            return
        sub = tree_map(lambda a: a[:, slot:slot + 1], self.state)
        for i, t in enumerate(toks):
            logits, sub = self._decode(self.params, sub,
                                       np.full((1, 1), int(t), np.int32),
                                       np.full((1,), i, np.int32))
        nxt = self._sample(logits[0, 0], req)
        req.out.append(nxt)
        self.cur_tok[slot, 0] = nxt

    def _recurrent_state(self):
        """The state a new request must not inherit: every recurrent leaf
        (rwkv6's, the Mamba2 blocks'), no KV cache."""
        if self.cfg.family == "ssm":
            return self.state
        if self.cfg.family == "hybrid":
            return {k: v for k, v in self.state.items()
                    if k != "shared_cache"}
        return {}

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        if self.temperature <= 0:
            return int(torch.argmax(logits))
        # per-request stream, drawn on the host: the same tokens for the
        # same logits on any device, slot layout or admission order
        g = torch.Generator().manual_seed(
            _stream_seed(self.seed, req.rid, len(req.out)))
        probs = torch.softmax(logits.float().cpu() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=g))

    def serve(self, requests: List[Request], *, max_steps: int = 10_000
              ) -> ServeResult:
        queue = deque(requests)
        steps = 0
        while (any(self.active) or queue) and steps < max_steps:
            # admit
            for s in range(self.slots):
                if self.active[s] is None and queue:
                    req = queue.popleft()
                    self.active[s] = req
                    self._prefill_slot(s, req)
            if not any(self.active):
                break
            # one batched decode step; only LIVE slots advance their
            # position, and released slots decode token 0 at position 0
            live = np.asarray([0 if r is None else 1 for r in self.active],
                              np.int32)
            logits, self.state = self._decode(self.params, self.state,
                                              self.cur_tok, self.pos)
            self.pos = self.pos + live
            steps += 1
            greedy = (logits[:, 0].argmax(-1).tolist()
                      if self.temperature <= 0 else None)
            new_toks = self.cur_tok.copy()
            for s, req in enumerate(self.active):
                if req is None:
                    continue
                nxt = (greedy[s] if greedy is not None
                       else self._sample(logits[s, 0], req))
                req.out.append(nxt)
                new_toks[s, 0] = nxt
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.active[s] = None      # release slot mid-flight...
                    self.pos[s] = 0            # ...and reset it
                    new_toks[s, 0] = 0
            self.cur_tok = new_toks
        status = {r.rid: ("done" if r.done
                          else "truncated" if r.out else "pending")
                  for r in requests}
        return ServeResult({r.rid: r.out for r in requests}, status)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REDUCED[args.arch]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = bb.init_params(cfg, gen, torch.float32, device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(4, 12)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    server = BatchedServer(cfg, params, slots=args.slots, cache_len=256,
                           device=dev)
    t0 = time.perf_counter()
    outs = server.serve(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in outs.values())
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, slots={args.slots}, device={dev})")
    for rid, toks in sorted(outs.items()):
        print(f"  req {rid}: {len(toks)} tokens -> {toks[:8]}... "
              f"[{outs.status[rid]}]")
    return outs


if __name__ == "__main__":
    main()
