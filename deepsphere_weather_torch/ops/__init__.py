"""Operators: Chebyshev convolution, block-sparse SpMM, equiangular image
convolution, pooling."""

from .bcsr import (  # noqa: F401
    BlockSparseOperator,
    EllOperator,
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
    ell_spmm,
    ell_spmm_reference,
    ell_spmm_rows,
    ell_spmm_rows_reference,
    launch_counts,
    plain_nonzero_slots,
    reset_launch_counts,
    super_nonzero_slots,
)
from .cheb import ChebOperator, cheb_conv  # noqa: F401
from .conv2d import (  # noqa: F401
    equiangular_1d_to_2d,
    equiangular_2d_to_1d,
    equiangular_conv2d,
)
from .pool import (  # noqa: F401
    EllMatrix,
    EquiangularAvgPool,
    EquiangularAvgUnpool,
    EquiangularMaxPool,
    EquiangularMaxUnpool,
    GeneralAvgPool,
    GeneralAvgUnpool,
    GeneralLearnPool,
    GeneralLearnUnpool,
    GeneralMaxAreaPool,
    GeneralMaxAreaUnpool,
    GeneralMaxValPool,
    GeneralMaxValUnpool,
    HealpixAvgPool,
    HealpixAvgUnpool,
    HealpixMaxPool,
    HealpixMaxUnpool,
    build_pool_unpool,
    sparse_to_ell,
)
