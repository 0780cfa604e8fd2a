"""Model geometry: per-level graphs, Chebyshev operators, pool/unpool ops.

Port of `deepsphere_weather_tpu/models/geometry.py`: every sampling, graph
type ('knn', 'voronoi', 'mesh'), pool method and `conv_type`. Levels of at
most `dense_threshold` nodes keep a dense Laplacian; larger levels use the
block-sparse operator (the CUDA kernel on the card), stored in
`operator_dtype`. The default threshold is the JAX package's: 2048 for a
bf16 operator, 8192 otherwise. `conv_type='image'` (equiangular only)
builds no operator: its `cheb_ops` are None per level. `shard_geometry`
gives one node rank's part of any geometry (node-parallel training).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from .._device import resolve_device
from ..ops.bcsr import BlockSparseOperator
from ..ops.cheb import ChebOperator
from ..ops.pool import (
    HealpixAvgPool,
    HealpixAvgUnpool,
    HealpixMaxPool,
    HealpixMaxUnpool,
    ShardedPool,
    ShardedUnpool,
    build_pool_unpool,
)
from ..parallel.collectives import NodeShard
from ..parallel.mesh import ProcessMesh, node_range
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

__all__ = ["ModelGeometry", "build_model_geometry", "shard_geometry"]


@dataclasses.dataclass
class ModelGeometry:
    """Static geometry consumed by an architecture. A node rank's shard
    (`shard_geometry`) holds each level's node range in `node_ranges` and
    row-sharded operators; its `n_nodes` are the local counts."""

    samplings: List[Sampling]
    # None per level for 'image' (a node shard's: its NodeShard)
    cheb_ops: List[Optional[ChebOperator]]
    pools: List                               # len depth-1
    unpools: List
    conv_type: str
    lonlat_ratio: Optional[float] = None      # nlon / nlat (equiangular)
    node_ranges: Optional[List[Tuple[int, int]]] = None

    @property
    def n_nodes(self) -> List[int]:
        if self.node_ranges is not None:
            return [v1 - v0 for v0, v1 in self.node_ranges]
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
    cheb_ops: List[Optional[ChebOperator]] = []
    for kw in kwargs_list:
        if conv_type == "image":
            samplings.append(build_sampling(sampling, kw))
            cheb_ops.append(None)
            continue
        samp, L = cached_graph_laplacian(sampling, kw, knn, graph_type)
        samplings.append(samp)
        if samp.n_nodes <= dense_threshold:
            op = ChebOperator(dense=torch.as_tensor(
                np.asarray(L.todense(), dtype=np.float32), device=device))
        else:
            # knn and mesh Laplacians are symmetric; any other graph type
            # carries its transpose for the backward
            op = ChebOperator(bcsr=BlockSparseOperator.from_scipy(
                L, symmetric=(graph_type in ("knn", "mesh")), dtype=op_dtype,
                device=device))
        cheb_ops.append(op)

    pools, unpools = [], []
    for lvl in range(depth - 1):
        p, u = build_pool_unpool(pool_method, samplings[lvl],
                                 samplings[lvl + 1],
                                 kernel_size=kernel_size_pooling,
                                 device=device)
        pools.append(p)
        unpools.append(u)
    lonlat_ratio = None
    if sampling == "equiangular":
        lonlat_ratio = sampling_kwargs["nlon"] / sampling_kwargs["nlat"]
    return ModelGeometry(samplings=samplings, cheb_ops=cheb_ops, pools=pools,
                         unpools=unpools, conv_type=conv_type,
                         lonlat_ratio=lonlat_ratio)


def shard_geometry(geometry: ModelGeometry,
                   mesh: Optional[ProcessMesh]) -> ModelGeometry:
    """This rank's part of `geometry` on a node mesh: at every level the
    node range of its node shard and the operator's rows for it
    (`ChebOperator.row_shard` over the mesh's node group). Without a mesh
    or with one node shard, `geometry` itself.

    Nested HEALPix ordering keeps the hierarchical pools inside a shard,
    so they stay as they are. Every other pool and unpool (equiangular
    windows, the remap pools) crosses the node ranges and becomes a
    `ShardedPool` / `ShardedUnpool`, which gathers its input over the
    node group; an image convolution's level holds its `NodeShard` in
    place of an operator, and the ConvBlock gathers likewise.

    Raises ValueError when a level's nodes do not divide over the node
    ranks (JAX's `device_put` refuses such an uneven layout too)."""
    if mesh is None or mesh.n_node == 1:
        return geometry
    for lvl, n_lvl in enumerate(geometry.n_nodes):
        if n_lvl % mesh.n_node:
            raise ValueError(f"level {lvl}: {n_lvl} nodes do not divide over "
                             f"{mesh.n_node} node ranks")
    ranges = [node_range(n_lvl, mesh) for n_lvl in geometry.n_nodes]
    shards = [NodeShard(v0, v1, mesh.node_group) for v0, v1 in ranges]
    local = (HealpixMaxPool, HealpixAvgPool, HealpixMaxUnpool,
             HealpixAvgUnpool)
    # a pool maps level l to l + 1; an unpool l + 1 to l (the downscaling
    # network's unpool included: coarse level 1 to fine level 0); lists of
    # local pools stay the geometry's own
    pools, unpools = geometry.pools, geometry.unpools
    if not all(isinstance(p, local) for p in pools):
        pools = [p if isinstance(p, local)
                 else ShardedPool(p, shards[lvl], shards[lvl + 1])
                 for lvl, p in enumerate(pools)]
    if not all(isinstance(u, local) for u in unpools):
        unpools = [u if isinstance(u, local)
                   else ShardedUnpool(u, shards[lvl + 1], shards[lvl])
                   for lvl, u in enumerate(unpools)]
    cheb_ops = [shard if op is None
                else op.row_shard(shard.v0, shard.v1, mesh.node_group)
                for op, shard in zip(geometry.cheb_ops, shards)]
    return dataclasses.replace(geometry, node_ranges=ranges, pools=pools,
                               unpools=unpools, cheb_ops=cheb_ops)
