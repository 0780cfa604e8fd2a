"""Node- and data-parallel training over torch.distributed process groups."""

from .collectives import (  # noqa: F401
    all_reduce_,
    broadcast_,
    collective_counts,
    gather_rows,
    reset_collective_counts,
)
from .mesh import (  # noqa: F401
    ProcessMesh,
    batch_range,
    make_mesh,
    node_range,
    put_device_dataset,
    shard_batch,
    shard_window_indices,
    training_mesh,
)
