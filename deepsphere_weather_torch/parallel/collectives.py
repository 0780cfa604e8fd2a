"""The collectives of node- and data-parallel training, written out.

On the TPU, GSPMD inserted every collective that a sharded step needs
(`deepsphere_weather_tpu/parallel/mesh.py`); PyTorch has no such
partitioner, so the port issues them itself:

- `gather_rows`: an all-gather of equal shards, concatenated in rank
  order; before every Laplacian product of a node-sharded level, forward
  and backward (the row-sharded operators in `ops/`);
- `all_reduce_`: the gradient reductions and the reported losses
  (`engine/step.py`);
- `broadcast_`: rank 0's parameters to every rank (`weights.py`).

The caller initialises `torch.distributed` and picks its backend (`nccl`
for one card per rank; `gloo` for ranks that share a card, and on the
CPU). `collective_counts` counts the calls, as `ops.bcsr.launch_counts`
counts kernel launches, so that a run can show what it issued.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["gather_rows", "all_reduce_", "broadcast_", "collective_counts",
           "reset_collective_counts"]

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
