"""Port sphere geometry vs the JAX package: samplings, graphs, remap weights.

Tiny grids of every sampling family (equiangular 8x16 and 10x20 — the
latter coarsens to odd dimensions —, icosahedral 4, cubed 4, gauss nlat 8
octahedral, healpix 4). Bars:

- pixel centers bit-equal; coarsened kwargs and `cache_key()` equal (the
  two stacks share cache files);
- prepared knn / voronoi / mesh Laplacians at 1e-6 (max abs difference
  over max abs), with the same sparsity and `is_symmetric`;
- conservative interpolation weights (normalization 'fracarea' and None)
  and the pooling matrices at 1e-6, the port's also held to the
  conservativity invariants (row sums the destination areas, column sums
  the source areas; unit rows after 'fracarea')."""

import numpy as np
import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_tpu.sphere import (  # noqa: E402
    build_graph as jbuild_graph,
    build_pooling_matrices as jbuild_pooling_matrices,
    build_sampling as jbuild_sampling,
    coarsen_sampling_kwargs as jcoarsen,
    compute_interpolation_weights as jweights,
)

from deepsphere_weather_torch.sphere import (  # noqa: E402
    build_graph,
    build_pooling_matrices,
    build_sampling,
    coarsen_sampling_kwargs,
    compute_interpolation_weights,
)
from deepsphere_weather_torch.sphere.remap import cell_areas  # noqa: E402

GRIDS = {
    "equiangular8x16": ("equiangular", {"nlat": 8, "nlon": 16}),
    "equiangular10x20": ("equiangular", {"nlat": 10, "nlon": 20}),
    "icosahedral4": ("icosahedral", {"subdivisions": 4}),
    "cubed4": ("cubed", {"subdivisions": 4}),
    "gauss8": ("gauss", {"nlat": 8, "nlon": "ecmwf-octahedral"}),
    "healpix4": ("healpix", {"subdivisions": 4, "nest": True}),
}
# samplings only: the regular and the explicit-pl Gauss grids
EXTRA = {
    "gauss8_regular": ("gauss", {"nlat": 8, "nlon": 16}),
    "gauss8_pl": ("gauss", {"nlat": 8, "nlon": [8, 12, 16, 20, 20, 16, 12, 8]}),
}
TOL = 1e-6


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def sparse_rel(A, B):
    A, B = A.tocsr(), B.tocsr()
    return abs(A - B).max() / abs(B).max()


@pytest.mark.parametrize("grid", list(GRIDS) + list(EXTRA))
def test_sampling_bit_equal(grid):
    name, kw = {**GRIDS, **EXTRA}[grid]
    s, js = build_sampling(name, kw), jbuild_sampling(name, kw)
    assert s.name == js.name and s.kwargs == js.kwargs
    np.testing.assert_array_equal(s.lon, js.lon)
    np.testing.assert_array_equal(s.lat, js.lat)
    assert s.cache_key() == js.cache_key()
    for coarsening in (2, 3):
        ckw = coarsen_sampling_kwargs(name, kw, coarsening)
        assert ckw == jcoarsen(name, kw, coarsening)
    if grid in GRIDS:
        c = build_sampling(name, coarsen_sampling_kwargs(name, kw, 2))
        jc = jbuild_sampling(name, jcoarsen(name, kw, 2))
        np.testing.assert_array_equal(c.lon, jc.lon)
        np.testing.assert_array_equal(c.lat, jc.lat)
        assert c.cache_key() == jc.cache_key()


def test_sampling_sizes():
    """The node counts the configurations rely on (10 f^2 + 2
    icosahedral vertices, 6 n^2 cube cells, 20 + 4 i points per gauss
    ring, 12 nside^2 HEALPix pixels)."""
    sizes = {g: build_sampling(*GRIDS[g]).n_nodes for g in GRIDS}
    assert sizes == {"equiangular8x16": 128, "equiangular10x20": 200,
                     "icosahedral4": 162, "cubed4": 96, "gauss8": 208,
                     "healpix4": 192}


@pytest.mark.parametrize("graph_type", ["knn", "voronoi", "mesh"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_laplacian_matches_jax(grid, graph_type):
    name, kw = GRIDS[grid]
    g = build_graph(name, kw, k=8, graph_type=graph_type)
    jg = jbuild_graph(name, kw, k=8, graph_type=graph_type)
    assert g.L.shape == jg.L.shape and g.L.dtype == jg.L.dtype
    assert sparse_rel(g.L, jg.L) <= TOL
    assert g.is_symmetric == jg.is_symmetric
    # knn and mesh are symmetric by construction, voronoi's M^-1 L is not
    assert g.is_symmetric == (graph_type != "voronoi")
    assert (g.W is None) == (graph_type != "knn")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_interpolation_weights_match_jax(grid):
    name, kw = GRIDS[grid]
    src = build_sampling(name, kw)
    dst = build_sampling(name, coarsen_sampling_kwargs(name, kw, 2))
    jsrc = jbuild_sampling(name, kw)
    jdst = jbuild_sampling(name, jcoarsen(name, kw, 2))
    W, a_src, a_dst = compute_interpolation_weights(src, dst,
                                                    normalization=None)
    jW, ja_src, ja_dst = jweights(jsrc, jdst, normalization=None)
    assert W.shape == (dst.n_nodes, src.n_nodes)
    assert sparse_rel(W, jW) <= TOL
    assert rel(a_src, ja_src) <= TOL and rel(a_dst, ja_dst) <= TOL
    # conservativity: the overlaps tile both tessellations
    np.testing.assert_allclose(np.asarray(W.sum(axis=1)).ravel(), a_dst,
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(W.sum(axis=0)).ravel(), a_src,
                               rtol=1e-4)
    np.testing.assert_allclose(a_src.sum(), 4 * np.pi, rtol=1e-6)
    np.testing.assert_allclose(a_src, cell_areas(src), rtol=1e-12)

    Wn, _, _ = compute_interpolation_weights(src, dst)
    jWn, _, _ = jweights(jsrc, jdst)
    assert sparse_rel(Wn, jWn) <= TOL
    np.testing.assert_allclose(np.asarray(Wn.sum(axis=1)).ravel(), 1.0,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="unknown normalization"):
        compute_interpolation_weights(src, dst, normalization="bogus")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_pooling_matrices_match_jax(grid):
    name, kw = GRIDS[grid]
    src = build_sampling(name, kw)
    dst = build_sampling(name, coarsen_sampling_kwargs(name, kw, 2))
    pool, unpool = build_pooling_matrices(src, dst)
    jpool, junpool = jbuild_pooling_matrices(
        jbuild_sampling(name, kw), jbuild_sampling(name, jcoarsen(name, kw, 2)))
    assert pool.shape == (dst.n_nodes, src.n_nodes)
    assert unpool.shape == (src.n_nodes, dst.n_nodes)
    assert pool.dtype == np.float32 and unpool.dtype == np.float32
    assert sparse_rel(pool, jpool) <= TOL
    assert sparse_rel(unpool, junpool) <= TOL
    # pool rows are weighted averages
    np.testing.assert_allclose(np.asarray(pool.sum(axis=1)).ravel(), 1.0,
                               rtol=1e-5)
    # the unpool conserves the area-weighted field: sum_s a_s (U y)_s =
    # sum_d a_d y_d for any coarse field y
    a_src, a_dst = cell_areas(src), cell_areas(dst)
    y = np.random.default_rng(0).standard_normal(dst.n_nodes)
    assert abs(a_src @ (unpool @ y) - a_dst @ y) <= 1e-5 * (a_dst @ abs(y))
