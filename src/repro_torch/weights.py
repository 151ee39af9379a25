"""Carry MLP weights between the JAX reference and the port.

Both keep the layout ``{"layers": [{"w": (in, out), "b": (out,)}]}``, so
no transposes are needed: the JAX side hands over
``jax.tree.map(np.asarray, params)`` and gets back the same tree of NumPy
arrays from ``mlp_params_to_numpy``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def mlp_params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of arrays (NumPy, or tensors anywhere) -> fp32 tensors on
    `device`."""
    dev = resolve_device(device)
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32, copy=True)
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return tree_map(leaf, tree)


def mlp_params_to_numpy(tree: Any) -> Any:
    """The inverse: a tree of tensors -> a tree of float32 NumPy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.float32),
                    tree)
