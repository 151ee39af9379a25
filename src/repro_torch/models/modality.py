"""Modality-frontend stubs (counterpart of ``repro.models.modality``).

musicgen-large : EnCodec conditioning frames  -> (B, prefix_len, d_model)
chameleon-34b  : ViT/VQ patch embeddings      -> (B, prefix_len, d_model)

``synthetic_prefix`` draws statistically plausible stand-ins (unit-variance
rows with a smooth correlation along the frame / patch axis) for smoke runs
and training; ``prefix_spec`` gives their shape and dtype. Torch cannot
reproduce ``jax.random``: ``smooth_prefix`` is the deterministic half, so a
test can feed it the reference's own noise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

EMA_KEEP = 0.7              # h <- EMA_KEEP * h + (1 - EMA_KEEP) * x


def _check(cfg: ModelConfig) -> None:
    if not cfg.prefix_frontend:
        raise ValueError(f"{cfg.name} has no modality prefix")


def prefix_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16
                ) -> Tuple[torch.Size, torch.dtype]:
    """(shape (batch, prefix_len, d_model), dtype) of a prefix input."""
    _check(cfg)
    return torch.Size((batch, cfg.prefix_len, cfg.d_model)), dtype


def smooth_prefix(noise: torch.Tensor) -> torch.Tensor:
    """White noise (B, P, d) -> its causal EMA over the P axis, each row
    divided by its population std + 1e-6, fp32."""
    noise = noise.float()
    h = torch.zeros_like(noise[:, 0])
    steps = []
    for t in range(noise.shape[1]):
        h = EMA_KEEP * h + (1.0 - EMA_KEEP) * noise[:, t]
        steps.append(h)
    smooth = torch.stack(steps, dim=1)
    return smooth / (torch.std(smooth, dim=-1, keepdim=True,
                               unbiased=False) + 1e-6)


def synthetic_prefix(generator: Optional[torch.Generator], cfg: ModelConfig,
                     batch: int, dtype=torch.float32,
                     device: DeviceLike = None) -> torch.Tensor:
    """(batch, prefix_len, d_model) prefix embeddings: normal noise drawn
    on `device` from `generator` (a generator of that device), smoothed by
    ``smooth_prefix``, in `dtype`."""
    _check(cfg)
    dev = resolve_device(device)
    noise = torch.randn((batch, cfg.prefix_len, cfg.d_model),
                        generator=generator, dtype=torch.float32, device=dev)
    return smooth_prefix(noise).to(dtype)
