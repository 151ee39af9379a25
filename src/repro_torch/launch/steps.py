"""The serving steps: ``make_prefill_step`` and ``make_serve_step`` return
the prefill and the decode step (counterpart of ``repro.launch.steps``; the
train and federated steps come with the training slice).

``make_*`` fixes the device (CUDA unless the caller asks for the CPU) and
the step moves its token inputs there, so a caller can hand over NumPy.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import backbone as bb


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      compute_dtype=torch.bfloat16,
                      cache_dtype=torch.bfloat16, use_kernels: bool = True,
                      device: DeviceLike = None) -> Callable:
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        return bb.prefill(params, _on(batch["tokens"], dev), cfg,
                          cache_len=cache_len, compute_dtype=compute_dtype,
                          cache_dtype=cache_dtype, use_kernels=use_kernels)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                    device: DeviceLike = None) -> Callable:
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, state, tokens, cur_pos):
        return bb.decode_step(params, state, _on(tokens, dev),
                              _on(cur_pos, dev), cfg,
                              compute_dtype=compute_dtype)

    return serve_step
