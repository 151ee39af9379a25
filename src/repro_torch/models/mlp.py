"""Fully-connected nets for the paper's tabular experiments (§4), as pure
functions on a params dict in the JAX reference's layout:
``{"layers": [{"w": (in, out), "b": (out,)}, ...]}`` (counterpart of
``repro.models.mlp``). ReLU hidden activations, linear output for
regression, logits for classification.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from repro_torch.configs.feddcl_mlp import MLPConfig
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def init_mlp_params(generator: torch.Generator, in_dim: int,
                    hidden: Sequence[int], out_dim: int, *,
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Params:
    """He-normal weights and zero biases, drawn on the CPU from `generator`
    and moved to `device`. Torch cannot reproduce ``jax.random``: parity
    runs inject the reference's params (``repro_torch.weights``)."""
    dev = resolve_device(device)
    dims = [in_dim, *hidden, out_dim]
    layers = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / dims[i])
        layers.append({"w": w.to(device=dev, dtype=dtype),
                       "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                        device=dev)})
    return {"layers": layers}


def mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x
    n = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        h = h @ lp["w"] + lp["b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def mlp_per_example_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
                         task: str) -> torch.Tensor:
    """(n,) per-example losses — what the federated engine masks/weights for
    zero-padded ragged silos. Classification is logsumexp − gold logit."""
    pred = mlp_forward(params, x)
    if task == "regression":
        return torch.mean(torch.square(pred - y), dim=-1)
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, y.long()[:, None])[:, 0]
    return logz - gold


def mlp_loss(params: Params, x: torch.Tensor, y: torch.Tensor, task: str,
             l2: float = 0.0) -> torch.Tensor:
    """The mean of `mlp_per_example_loss`, plus l2 · Σ‖w‖² over the weights."""
    loss = torch.mean(mlp_per_example_loss(params, x, y, task))
    if l2:
        sq = sum(torch.sum(torch.square(lp["w"])) for lp in params["layers"])
        loss = loss + l2 * sq
    return loss


def mlp_metric(params: Params, x: torch.Tensor, y: torch.Tensor,
               task: str) -> float:
    """RMSE for regression (paper Fig. 4/5), accuracy for classification."""
    pred = mlp_forward(params, x)
    if task == "regression":
        return float(torch.sqrt(torch.mean(torch.square(pred - y))))
    return float(torch.mean((torch.argmax(pred, -1) == y.long()).float()))


def for_config(generator: torch.Generator, cfg: MLPConfig, *, reduced: bool,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Params:
    """`init_mlp_params` at a Table 3 network: input width m̂ when
    `reduced` (DC / FedDCL), else m."""
    in_dim = cfg.reduced_dim if reduced else cfg.in_dim
    return init_mlp_params(generator, in_dim, cfg.hidden, cfg.out_dim,
                           device=device, dtype=dtype)
