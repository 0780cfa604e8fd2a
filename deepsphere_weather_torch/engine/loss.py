"""Losses: area-weighted MSE.

Port of `deepsphere_weather_tpu/engine/loss.py`. `AreaWeights` are the
normalized spherical-Voronoi cell areas, cached under the JAX package's
`areaw_<sampling key>` key so both stacks share the file. `weighted_mse`
has the same reductions: 'mean' = sum(w * se) / sum(w) / n_datapoints /
n_features, 'sum' = sum(w * se) * n_nodes, 'none' = w * se. On a node
mesh each rank holds a node shard and returns its share of the 'mean'
(`w_sum`, the sum of every node's weight).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..sphere.cache import cached_arrays
from ..sphere.remap import area_weights as _area_weights

__all__ = ["AreaWeights", "weighted_mse"]


def AreaWeights(sampling, device="cuda") -> torch.Tensor:
    """Normalized spherical-Voronoi cell-area weights, fp32 [V]."""
    device = resolve_device(device)
    key = f"areaw_{sampling.cache_key()}"
    arrs = cached_arrays(key, lambda: {"w": _area_weights(sampling)})
    return torch.as_tensor(np.asarray(arrs["w"], np.float32), device=device)


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 reduction: str = "mean", w_sum=None) -> torch.Tensor:
    """Area-weighted MSE over [..., node, feature] tensors; leading dims
    are data points, `weights` is [node] (None: unit weights).

    `w_sum` (a tensor or a number) is the 'mean' normaliser when pred,
    target and weights hold one rank's node shard: the sum of the weights
    over every node. 'mean'
    then returns the rank's share, the local sum(w * se) / w_sum /
    n_points / n_features; the shares of the node ranks sum to the loss."""
    se = (pred - target) ** 2
    if weights is None:
        weights = torch.ones(se.shape[-2], dtype=se.dtype, device=se.device)
    wse = se * weights.reshape((1,) * (se.dim() - 2) + (-1, 1))
    if reduction == "none":
        return wse
    n_points = int(np.prod(se.shape[:-2]))
    if reduction == "mean":
        w_sum = weights.sum() if w_sum is None else w_sum
        return wse.sum() / w_sum / n_points / se.shape[-1]
    if reduction == "sum":
        return wse.sum() * weights.shape[0]
    raise ValueError(f"invalid reduction {reduction!r}")
