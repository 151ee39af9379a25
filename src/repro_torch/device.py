"""The one rule for where the port runs.

Entry points take ``device=None`` and run on CUDA. Without a card they
raise, unless the caller asks for the CPU explicitly (``device="cpu"``),
as the tests do: a run that silently fell back to the CPU would report CPU
numbers as if they came from the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
