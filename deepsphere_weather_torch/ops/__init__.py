"""Graph operators: Chebyshev convolution, block-sparse SpMM, pooling."""

from .bcsr import (  # noqa: F401
    BlockSparseOperator,
    bcsr_from_scipy,
    bcsr_super_from_scipy,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    launch_counts,
    reset_launch_counts,
)
from .cheb import ChebOperator, cheb_conv  # noqa: F401
from .pool import (  # noqa: F401
    HealpixAvgPool,
    HealpixAvgUnpool,
    HealpixMaxPool,
    HealpixMaxUnpool,
    build_pool_unpool,
)
