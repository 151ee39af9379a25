"""Learning-rate schedules as step -> lr callables (counterpart of
``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.as_tensor(lr, dtype=torch.float32)


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).float()
        warm = peak * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return f
