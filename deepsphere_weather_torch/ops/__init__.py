"""Graph operators: Chebyshev convolution, block-sparse SpMM, pooling."""

from .bcsr import (  # noqa: F401
    BlockSparseOperator,
    ShardedBlockSparseOperator,
    bcsr_from_scipy,
    bcsr_spmm,
    bcsr_spmm_reference,
    bcsr_spmm_rows,
    bcsr_spmm_rows_reference,
    bcsr_super_from_scipy,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    bcsr_super_spmm_rows,
    bcsr_super_spmm_rows_reference,
    launch_counts,
    plain_nonzero_slots,
    reset_launch_counts,
    super_nonzero_slots,
)
from .cheb import ChebOperator, cheb_conv  # noqa: F401
from .pool import (  # noqa: F401
    HealpixAvgPool,
    HealpixAvgUnpool,
    HealpixMaxPool,
    HealpixMaxUnpool,
    build_pool_unpool,
)
