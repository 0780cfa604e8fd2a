"""Node-, data- and member-parallel training over torch.distributed process
groups."""

from .collectives import (  # noqa: F401
    NodeShard,
    all_reduce_,
    all_reduce_sum,
    broadcast_,
    collective_counts,
    gather_nodes,
    gather_rows,
    reset_collective_counts,
)
from .mesh import (  # noqa: F401
    ProcessMesh,
    batch_range,
    make_mesh,
    member_range,
    mesh_barrier,
    node_range,
    put_device_dataset,
    shard_batch,
    shard_window_indices,
    training_mesh,
)
