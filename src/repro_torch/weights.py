"""Carry weights between the JAX reference and the port.

Both packages keep the same layouts, so no transposes are needed: the MLP's
``{"layers": [{"w": (in, out), "b": (out,)}]}`` and the LM's stacked tree
(``embed`` (V, d), ``layers.attn.wq`` (L, d, H, hd), ...; the hybrid's
``layers.mamba.w_in`` (L, d, 2·inner + 2N + H), ``conv_w`` (L, K, C) and
its unstacked ``shared_block``; a prefix family's ``ln_prefix`` (d,);
MLA's ``attn.w_dq`` (L, d, r_q), ``w_uq`` (L, r_q, H, nope + rope),
``w_dkv`` (L, d, r_kv + rope), ``w_uk`` (L, r_kv, H, nope), ``w_uv``
(L, r_kv, H, v) and ``wo`` (L, H, v, d)). The JAX side
hands over ``jax.tree.map(np.asarray, params)`` and gets back the same tree
of NumPy arrays from ``*_params_to_numpy``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> Any:
    """A tree of arrays (NumPy, or tensors anywhere) -> tensors of `dtype`
    on `device`, same keys and layouts."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype, copy=True)
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: a tree of tensors (any float type) -> a tree of float32
    NumPy arrays."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


# the MLP's and the LM's trees carry over the same way
mlp_params_from_numpy = lm_params_from_numpy = params_from_numpy
mlp_params_to_numpy = lm_params_to_numpy = params_to_numpy
