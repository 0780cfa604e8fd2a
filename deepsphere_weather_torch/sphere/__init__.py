"""Sphere geometry: samplings, graphs, Laplacians, conservative remapping."""

from .samplings import (  # noqa: F401
    Sampling,
    build_sampling,
    coarsen_sampling_kwargs,
    check_sampling,
    check_conv_type,
    check_pool_method,
    check_skip_connection,
    VALID_SAMPLINGS,
)
from .graph import (  # noqa: F401
    SphereGraph,
    build_graph,
    estimate_lmax,
    scale_operator,
    prepare_laplacian,
    compute_cotan_laplacian,
    laplacian_to_ell,
)
from .remap import (  # noqa: F401
    cell_areas,
    area_weights,
    compute_interpolation_weights,
    build_pooling_matrices,
)
from .cache import cache_dir, cached_arrays, cached_sparse  # noqa: F401
