"""Expert-parallel MoE (counterpart of ``repro.models.moe_ep``).

The reference exchanges each device's capacity buffers with one
``all_to_all`` over its mesh's "model" axis. With no mesh, or a model
axis of one device, it takes the gspmd path (``layers.apply_moe_gspmd``).
The port has no mesh: a process alone takes that fallback, and a process
in a ``torch.distributed`` group of more than one rank, where the experts
would be spread over the ranks, raises, since the exchange waits for
multi-process sharding (ROADMAP.md, Queue 1, multi-process silo sharding).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig


def apply_moe_ep(p, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, S, d), aux loss)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{cfg.name}: expert-parallel dispatch over "
            f"{dist.get_world_size()} ranks needs the all_to_all exchange, "
            "which is not ported. See ROADMAP.md, Queue 1, multi-process "
            "silo sharding")
    from repro_torch.models.layers import apply_moe_gspmd
    return apply_moe_gspmd(p, x, cfg)
