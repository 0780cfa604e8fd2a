"""Sphere geometry: HEALPix sampling, knn graphs, prepared Laplacians."""

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
)
from .cache import cache_dir, cached_arrays  # noqa: F401
