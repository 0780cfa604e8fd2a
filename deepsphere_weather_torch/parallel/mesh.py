"""Process meshes and batch sharding for node- and data-parallel training.

Port of `deepsphere_weather_tpu/parallel/mesh.py`. The JAX package lays a
('data', 'node', 'member') device mesh over one process and lets GSPMD
insert the collectives; here each rank is one process, and its
`ProcessMesh` says which shard it holds and over which process groups it
talks:

- 'data': the batch is split over `n_data` ranks; gradients and losses
  are averaged over the data group (`engine/step.py`);
- 'node': the sphere is split over `n_node` ranks into contiguous node
  ranges. Nested HEALPix ordering keeps hierarchical pooling inside a
  shard; each Laplacian product gathers its input over the node group
  (the row-sharded operators of `ops/`, set up by
  `models.geometry.shard_geometry`).

Rank layout: rank = data_rank * n_node + node_rank, the JAX mesh's
reshape (n_data, n_node, n_member). The 'member' axis comes with the
ensembles (ROADMAP Queue 1). `put_device_dataset` and
`shard_window_indices` serve the device-resident dataset of the training
driver: the pre-scaled mirror moves onto the device once, and each step
moves only a [B, W] index batch.

The caller initialises `torch.distributed` (`init_process_group`) and
chooses its backend: `nccl` for one card per rank, `gloo` for ranks that
share one card and on the CPU. Nothing here picks or switches it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["ProcessMesh", "make_mesh", "training_mesh", "node_range",
           "batch_range", "shard_batch", "put_device_dataset",
           "shard_window_indices", "TRAIN_BATCH_KEYS"]

# batch keys the train and validation steps read; other keys pass through
TRAIN_BATCH_KEYS = ("dynamic", "bc", "static")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in an n_data x n_node mesh, its process groups
    and its device."""

    data_rank: int
    n_data: int
    node_rank: int
    n_node: int
    data_group: object       # the ranks holding this rank's node range
    node_group: object       # the ranks holding this rank's batch rows
    device: torch.device

    @property
    def rank(self) -> int:
        return self.rank_of(self.data_rank, self.node_rank)

    def rank_of(self, data_rank: int, node_rank: int) -> int:
        """Global rank of the mesh position (data_rank, node_rank)."""
        return data_rank * self.n_node + node_rank


def _require_initialized() -> None:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: the caller "
                           "calls init_process_group (and picks its backend) "
                           "before building a mesh")


def make_mesh(n_data: Optional[int] = None, n_member: int = 1,
              n_node: int = 1, world_size: Optional[int] = None,
              device="cuda") -> Optional[ProcessMesh]:
    """An n_data x n_node mesh over the ranks of the default process
    group; `world_size` defaults to its size. Every rank must call this
    together (each process group is created on every rank).

    `n_data=None` takes as many data shards as fit, leaving the rest idle
    with a warning. Returns this rank's `ProcessMesh`, or None on a rank
    the mesh leaves idle."""
    if n_member > 1:
        raise NotImplementedError(
            "make_mesh: the 'member' axis is not ported yet (it comes with "
            "the ensembles, ROADMAP Queue 1 item 9)")
    if world_size is None:
        _require_initialized()
        world_size = dist.get_world_size()
    have = int(world_size)
    if n_member * n_node > have:
        raise ValueError(
            f"make_mesh: n_member*n_node = {n_member * n_node} exceeds the "
            f"{have} available ranks (a zero-rank mesh would fail later "
            "with an opaque error)")
    if n_data is None:
        n_data = have // (n_member * n_node)
        if have % (n_member * n_node):
            warnings.warn(
                f"make_mesh: {have} ranks are not divisible by "
                f"n_member*n_node = {n_member * n_node}; using "
                f"{n_data * n_node * n_member} ranks and leaving "
                f"{have - n_data * n_node * n_member} idle", stacklevel=2)
    if n_data * n_node * n_member > have:
        raise ValueError(
            f"make_mesh: {n_data}x{n_node}x{n_member} mesh needs "
            f"{n_data * n_node * n_member} ranks, have {have}")
    _require_initialized()
    if dist.get_world_size() != have:
        raise ValueError(f"make_mesh: world_size {have} is not the process "
                         f"group's {dist.get_world_size()}")
    device = resolve_device(device)
    rank = dist.get_rank()
    # every rank creates every group, in one order (torch.distributed
    # requires it); each keeps its own two
    node_groups = [dist.new_group([d * n_node + j for j in range(n_node)])
                   for d in range(n_data)]
    data_groups = [dist.new_group([d * n_node + j for d in range(n_data)])
                   for j in range(n_node)]
    if rank >= n_data * n_node:
        return None
    d, j = divmod(rank, n_node)
    return ProcessMesh(data_rank=d, n_data=n_data, node_rank=j, n_node=n_node,
                       data_group=data_groups[j], node_group=node_groups[d],
                       device=device)


def training_mesh(n_data_parallel: int = 1, n_node_parallel: int = 1,
                  n_member: int = 1, device="cuda") -> Optional[ProcessMesh]:
    """The mesh of the config's `n_data_parallel` / `n_node_parallel`;
    None for 1 x 1 x 1 (the single-process step, no collectives). Raises
    RuntimeError if the layout needs more ranks than the default process
    group has."""
    n_data = max(int(n_data_parallel), 1)
    n_node = max(int(n_node_parallel), 1)
    n_member = max(int(n_member), 1)
    if n_data * n_node * n_member == 1:
        return None
    have = dist.get_world_size() if dist.is_initialized() else 1
    need = n_data * n_node * n_member
    if need > have:
        raise RuntimeError(
            f"training mesh {n_data}(data) x {n_node}(node) x "
            f"{n_member}(member) needs {need} ranks; the process group has "
            f"{have} (set n_data_parallel/n_node_parallel to fit, or start "
            "more ranks)")
    return make_mesh(n_data=n_data, n_node=n_node, n_member=n_member,
                     device=device)


def _split(n: int, parts: int, index: int, what: str) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{n} {what} do not divide over {parts} ranks")
    size = n // parts
    return index * size, (index + 1) * size


def node_range(n_nodes: int, mesh: ProcessMesh) -> Tuple[int, int]:
    """(v0, v1): the contiguous node range of this rank's node shard."""
    return _split(n_nodes, mesh.n_node, mesh.node_rank, "nodes")


def batch_range(batch_size: int, mesh: ProcessMesh) -> Tuple[int, int]:
    """(b0, b1): the batch rows of this rank's data shard."""
    return _split(batch_size, mesh.n_data, mesh.data_rank, "batch rows")


def shard_batch(batch: Dict, mesh: Optional[ProcessMesh]) -> Dict:
    """This rank's shard of a loader batch, on the mesh's device:
    'dynamic' / 'bc' [B, W, V, F] -> the data shard's batch rows and the
    node shard's node range; 'static' [V, F] -> the node range; other keys
    pass through. Arrays may be numpy or tensors. Without a mesh the batch
    is returned as it is."""
    if mesh is None:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if k not in TRAIN_BATCH_KEYS or v is None:
            out[k] = v
            continue
        t = torch.as_tensor(v)
        v0, v1 = node_range(t.shape[-2], mesh)
        if k == "static":
            t = t[v0:v1]
        else:
            b0, b1 = batch_range(t.shape[0], mesh)
            t = t[b0:b1, ..., v0:v1, :]
        out[k] = t.contiguous().to(mesh.device)
    return out


def put_device_dataset(dataset, mesh: Optional[ProcessMesh] = None,
                       device="cuda") -> Dict:
    """A dataset's pre-scaled mirror and static fields on the device, once
    (`data.loader.AutoregressiveDataset.mirror_arrays`): the `data` dict
    of `engine.make_cached_train_step`. Every timestep stays on every data
    rank (a batch gathers arbitrary rows); with a node axis, a rank holds
    its node range, as `shard_batch` gives it. On a mesh the mesh's device
    is used, else `device`."""
    dyn, bc, static = dataset.mirror_arrays()
    device = mesh.device if mesh is not None else resolve_device(device)
    nodes = slice(None)
    if mesh is not None and mesh.n_node > 1:
        nodes = slice(*node_range(dyn.shape[1], mesh))

    def put(v, node_axis):
        if v is None:
            return None
        t = torch.as_tensor(v)
        t = t[nodes] if node_axis == 0 else t[:, nodes]
        return t.contiguous().to(device)

    return {"dynamic": put(dyn, 1), "bc": put(bc, 1),
            "static": put(static, 0)}


def shard_window_indices(widx, mesh: Optional[ProcessMesh] = None,
                         device="cuda") -> torch.Tensor:
    """A [B, W] window-index batch on the device: on a mesh, the data
    shard's batch rows (`batch_range`) on the mesh's device."""
    t = torch.as_tensor(np.asarray(widx, np.int64))
    if mesh is None:
        return t.to(resolve_device(device))
    b0, b1 = batch_range(t.shape[0], mesh)
    return t[b0:b1].to(mesh.device)
