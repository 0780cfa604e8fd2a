"""The collectives of node-, data- and member-parallel training, written out.

On the TPU, GSPMD inserted every collective that a sharded step needs
(`deepsphere_weather_tpu/parallel/mesh.py`); PyTorch has no such
partitioner, so the port issues them itself:

- `gather_rows`: an all-gather of equal shards, concatenated in rank
  order; before every Laplacian product of a node-sharded level, forward
  and backward (the row-sharded operators in `ops/`), and of the member
  losses over the member group (`engine/step.py`);
- `all_reduce_`: the gradient reductions and the reported losses
  (`engine/step.py`);
- `broadcast_`: rank 0's parameters to every rank (`weights.py`).

Three of them are differentiable and run under `torch.func.vmap` (the
member steps), each a registered op with a vmap rule that folds the
mapped axis into one collective for every member:

- `all_reduce_sum`: the sum over a group forward, the sum of the ranks'
  gradients backward (BatchNorm statistics over a node or data mesh,
  `models/layers.py`);
- `gather_nodes`: the node axis gathered over a group forward; backward
  a reduce-scatter, every rank's gradient for the whole input summed and
  the rank's rows kept (the pools and the image convolution whose
  windows cross node ranges, `NodeShard`);
- the node gather of the row-sharded products (`all_gather_op`, inside
  their autograd Functions).

A process group is passed to a registered op as its index in this
module's registry (`group_key`). The caller initialises
`torch.distributed` and picks its backend (`nccl` for one card per rank;
`gloo` for ranks that share a card, and on the CPU). `collective_counts`
counts the calls, as `ops.bcsr.launch_counts` counts kernel launches, so
that a run can show what it made.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

__all__ = ["gather_rows", "all_reduce_", "broadcast_", "collective_counts",
           "reset_collective_counts", "group_key", "all_gather_op",
           "all_reduce_sum", "gather_nodes", "NodeShard"]

collective_counts: Dict[str, int] = {"all_gather": 0, "all_reduce": 0,
                                     "broadcast": 0}


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0


def gather_rows(x_local: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' equal shards of one tensor, concatenated along `dim` in
    the group's rank order (each rank holds the next slice)."""
    x_local = x_local.contiguous()
    parts = [torch.empty_like(x_local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x_local, group=group)
    collective_counts["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In place: the sum ('sum') or the mean ('mean') of `t` over the
    group's ranks; returns `t`."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    collective_counts["all_reduce"] += 1
    if op == "mean":
        t.div_(dist.get_world_size(group))
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: `t` of global rank `src` on every rank of the group."""
    dist.broadcast(t, src=src, group=group)
    collective_counts["broadcast"] += 1
    return t


# ---------------------------------------------------------------------------
# Registered collectives (differentiable, and batched under vmap)
# ---------------------------------------------------------------------------

_groups: List[object] = []


def group_key(group) -> int:
    """The index of `group` in the registry the registered ops read."""
    for i, g in enumerate(_groups):
        if g is group:
            return i
    _groups.append(group)
    return len(_groups) - 1


@torch.library.custom_op("deepsphere_weather_torch::all_gather",
                         mutates_args=())
def all_gather_op(x: torch.Tensor, group: int, dim: int) -> torch.Tensor:
    """`gather_rows` over the registered group `group` (a non-negative
    `dim`); under vmap one gather for every mapped slice."""
    return gather_rows(x, _groups[group], dim)


def _all_gather_vmap(info, in_dims, x, group, dim):
    if in_dims[0] is None:
        return all_gather_op(x, group, dim), None
    return all_gather_op(x.movedim(in_dims[0], 0), group, dim + 1), 0


torch.library.register_vmap(all_gather_op, _all_gather_vmap)


@torch.library.custom_op("deepsphere_weather_torch::all_reduce_sum",
                         mutates_args=())
def _all_reduce_op(x: torch.Tensor, group: int) -> torch.Tensor:
    return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                       _groups[group])


def _all_reduce_vmap(info, in_dims, x, group):
    # elementwise over the group: the mapped axis reduces with the rest
    return _all_reduce_op(x, group), in_dims[0]


torch.library.register_vmap(_all_reduce_op, _all_reduce_vmap)


class _AllReduceSum(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, group):
        return _all_reduce_op(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_reduce_op(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable: the
    backward is the sum of the ranks' gradients, so each rank's input
    receives the gradient of every rank's loss through the sum."""
    return _AllReduceSum.apply(x, group_key(group))


class _GatherNodes(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, group, dim):
        return all_gather_op(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.group, ctx.dim = inputs
        ctx.rows = x.shape[ctx.dim]
        ctx.index = dist.get_rank(_groups[ctx.group])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a reduce-scatter: the ranks' gradients summed, this rank's rows
        full = _all_reduce_op(g, ctx.group)
        return full.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None, None


def gather_nodes(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' equal shards of `x` along `dim`, concatenated in the
    group's rank order, differentiable: the backward sums every rank's
    gradient for the whole tensor and keeps this rank's rows."""
    return _GatherNodes.apply(x, group_key(group), dim)


@dataclasses.dataclass(frozen=True)
class NodeShard:
    """One node rank's rows [v0, v1) of a level whose ranks in `group`
    hold consecutive equal ranges: an op whose windows cross the ranges
    runs on `gather(x)` and keeps `local(y)`."""

    v0: int
    v1: int
    group: object

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, v1 - v0, C] -> [B, n, C], n the level's nodes
        (`gather_nodes`)."""
        return gather_nodes(x, self.group, 1)

    def local(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a [B, n, C] result."""
        return y[:, self.v0:self.v1]
