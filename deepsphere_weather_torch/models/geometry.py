"""Model geometry: per-level graphs, Chebyshev operators, pool/unpool ops.

Port of `deepsphere_weather_tpu/models/geometry.py` for HEALPix knn graphs
with hierarchical pooling. Levels of at most `dense_threshold` nodes keep a
dense Laplacian; larger levels use the block-sparse operator (the CUDA
kernel on the card), stored in `operator_dtype`. The default threshold is
the JAX package's: 2048 for a bf16 operator, 8192 otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import sparse

from .._device import resolve_device
from ..ops.bcsr import BlockSparseOperator
from ..ops.cheb import ChebOperator
from ..ops.pool import build_pool_unpool
from ..sphere import (
    Sampling,
    build_graph,
    build_sampling,
    check_conv_type,
    check_pool_method,
    check_sampling,
    coarsen_sampling_kwargs,
)
from ..sphere.cache import cached_arrays

__all__ = ["ModelGeometry", "build_model_geometry"]


@dataclasses.dataclass
class ModelGeometry:
    """Static geometry consumed by an architecture."""

    samplings: List[Sampling]
    cheb_ops: List[ChebOperator]
    pools: List                               # len depth-1
    unpools: List
    conv_type: str

    @property
    def n_nodes(self) -> List[int]:
        return [s.n_nodes for s in self.samplings]


def cached_graph_laplacian(name: str, kwargs: Dict, k: int, graph_type: str):
    """(sampling, prepared Laplacian CSR), cached under the JAX package's
    `lap_v2_*` key so both stacks share the file."""
    samp = build_sampling(name, kwargs)
    key = f"lap_v2_{samp.cache_key()}_k{k}_{graph_type}"

    def _build():
        g = build_graph(name, kwargs, k=k, graph_type=graph_type, sampling=samp)
        L = g.L.tocsr()
        return {"data": L.data, "indices": L.indices, "indptr": L.indptr,
                "shape": np.asarray(L.shape)}

    arrs = cached_arrays(key, _build)
    L = sparse.csr_matrix((arrs["data"], arrs["indices"], arrs["indptr"]),
                          shape=tuple(arrs["shape"]))
    return samp, L


def build_model_geometry(
    sampling: str,
    sampling_kwargs: Dict,
    depth: int = 3,
    knn: int = 20,
    graph_type: str = "knn",
    conv_type: str = "graph",
    pool_method: str = "max",
    kernel_size_pooling: int = 4,
    dense_threshold: Optional[int] = None,
    operator_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> ModelGeometry:
    sampling = check_sampling(sampling)
    conv_type = check_conv_type(conv_type, sampling)
    pool_method = check_pool_method(pool_method)
    if conv_type != "graph":
        raise NotImplementedError("conv_type='image' is not ported yet")
    device = resolve_device(device)
    op_dtype = torch.float32 if operator_dtype is None else operator_dtype
    if dense_threshold is None:
        dense_threshold = 2048 if op_dtype == torch.bfloat16 else 8192

    coarsening = int(np.sqrt(kernel_size_pooling))
    kwargs_list = [dict(sampling_kwargs)]
    for _ in range(1, depth):
        kwargs_list.append(
            coarsen_sampling_kwargs(sampling, kwargs_list[-1], coarsening))

    samplings: List[Sampling] = []
    cheb_ops: List[ChebOperator] = []
    for kw in kwargs_list:
        samp, L = cached_graph_laplacian(sampling, kw, knn, graph_type)
        samplings.append(samp)
        if samp.n_nodes <= dense_threshold:
            op = ChebOperator(dense=torch.as_tensor(
                np.asarray(L.todense(), dtype=np.float32), device=device))
        else:
            op = ChebOperator(bcsr=BlockSparseOperator.from_scipy(
                L, symmetric=True, dtype=op_dtype, device=device))
        cheb_ops.append(op)

    pools, unpools = [], []
    for lvl in range(depth - 1):
        p, u = build_pool_unpool(pool_method, samplings[lvl],
                                 samplings[lvl + 1])
        pools.append(p)
        unpools.append(u)
    return ModelGeometry(samplings=samplings, cheb_ops=cheb_ops, pools=pools,
                         unpools=unpools, conv_type=conv_type)
