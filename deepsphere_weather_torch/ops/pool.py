"""Hierarchical HEALPix pooling on nested ordering (reshape + reduce).

Port of the HEALPix pool/unpool pairs of `deepsphere_weather_tpu/ops/pool.py`.
All ops take and return [batch, node, channel]; pools return
(pooled, idx), idx None unless the unpool needs it. The general remap
pools and the equiangular pools are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["HealpixAvgPool", "HealpixAvgUnpool", "HealpixMaxPool",
           "HealpixMaxUnpool", "build_pool_unpool"]


class HealpixAvgPool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x):
        B, V, C = x.shape
        # mean accumulated in fp32, as jnp.mean does for bf16
        g = x.reshape(B, V // self.k, self.k, C).float()
        return g.mean(dim=2).to(x.dtype), None


class HealpixAvgUnpool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x, idx=None):
        return torch.repeat_interleave(x, self.k, dim=1)


class HealpixMaxPool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x):
        B, V, C = x.shape
        g = x.reshape(B, V // self.k, self.k, C)
        # torch.argmax returns the FIRST maximal index, as jnp.argmax does:
        # ties (common in bf16) unpool to the same child on both stacks
        return g.amax(dim=2), g.argmax(dim=2)            # idx [B, V/k, C]


class HealpixMaxUnpool:
    def __init__(self, kernel_size: int = 4):
        self.k = int(kernel_size)

    def __call__(self, x, idx):
        B, D, C = x.shape
        # one_hot by comparison (F.one_hot checks its values on the host,
        # which torch.func.vmap refuses): [B, D, k, C]
        children = torch.arange(self.k, device=idx.device)
        onehot = (idx[:, :, None, :] == children[:, None]).to(x.dtype)
        return (onehot * x[:, :, None, :]).reshape(B, D * self.k, C)


def build_pool_unpool(pool_method: str, src_sampling, dst_sampling):
    """(pool, unpool) between two nested HEALPix levels."""
    method = pool_method.lower()
    if method not in ("max", "avg") or src_sampling.name != "healpix":
        raise NotImplementedError(
            f"pool_method {pool_method!r} on {src_sampling.name!r} is not "
            "ported yet (hierarchical HEALPix max and avg only)")
    ratio = src_sampling.n_nodes // dst_sampling.n_nodes
    if method == "max":
        return HealpixMaxPool(ratio), HealpixMaxUnpool(ratio)
    return HealpixAvgPool(ratio), HealpixAvgUnpool(ratio)
