"""Port public functions vs the JAX package: the storage introspection of
the reference's chunk study (`data.zarrstore.memory_size`, `disk_size`,
`profile_zarr_io`), the graph's coordinates (`SphereGraph.lon`, `.lat`,
`.coords_3d`), the functional Chebyshev forms (`ops.cheb.ell_matvec`,
`cheb_basis_dense`, `cheb_basis_ell`, `ChebOperator.n_nodes`) and the
sparse-matrix disk cache (`sphere.cache.cached_sparse`).

Inputs come from np.random.default_rng. Sizes, byte counts, coordinates,
node counts and cached matrices are equal; fp32 products within 1e-5 of
the largest reference value (summation order only). `profile_zarr_io`'s
read rates are host timings: both packages report the same keys, and the
port's are positive."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import sparse  # noqa: E402

from deepsphere_weather_tpu.data import zarrstore as jzarr  # noqa: E402
from deepsphere_weather_tpu.ops import cheb as jcheb  # noqa: E402
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402
from deepsphere_weather_tpu.sphere import cache as jcache  # noqa: E402

from deepsphere_weather_torch.data import zarrstore  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    ChebOperator,
    cheb_basis_dense,
    cheb_basis_ell,
    ell_matvec,
)
from deepsphere_weather_torch.ops import cheb as cheb_module  # noqa: E402
from deepsphere_weather_torch.ops.cheb import _transposed_ell  # noqa: E402
from deepsphere_weather_torch.sphere import build_graph, cached_sparse  # noqa: E402
from deepsphere_weather_torch.sphere.graph import laplacian_to_ell  # noqa: E402

TOL = 1e-5
KNN = 8
GRAPHS = {"healpix4": ("healpix", {"subdivisions": 4, "nest": True}),
          "equiangular8x16": ("equiangular", {"nlat": 8, "nlon": 16})}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    name, kw = GRAPHS[request.param]
    return build_graph(name, kw, k=KNN), jbuild_graph(name, kw, k=KNN)


# ---------------------------------------------------------------------------
# storage introspection
# ---------------------------------------------------------------------------

def _store(create, path):
    rng = np.random.default_rng(0)
    g = create(path, attrs={"feature_order": ["a", "b"]}, overwrite=True)
    for name, shape, chunks, dtype in (("a", (40, 192), (8, 192), np.float32),
                                       ("b", (40, 192), (40, 16), np.float64),
                                       ("c", (40, 192, 2), (8, 192, 2),
                                        np.float32)):
        arr = g.create_array(name, shape=shape, chunks=chunks, dtype=dtype,
                             compressor="zlib")
        arr[...] = rng.standard_normal(shape).astype(dtype)
    return g


def test_store_sizes_match_jax(tmp_path):
    _store(zarrstore.create_group, tmp_path / "port.zarr")
    _store(jzarr.create_group, tmp_path / "jax.zarr")
    for path in (tmp_path / "port.zarr", tmp_path / "jax.zarr"):
        g, jg = zarrstore.open_group(path), jzarr.open_group(path)
        assert zarrstore.memory_size(g) == jzarr.memory_size(jg) == \
            40 * 192 * (4 + 8 + 2 * 4)
        for name in ("a", "b", "c"):
            assert zarrstore.memory_size(g[name]) == \
                jzarr.memory_size(jg[name])
        assert zarrstore.disk_size(path) == jzarr.disk_size(path) > 0
        assert zarrstore.disk_size(str(path)) == jzarr.disk_size(path)


def test_profile_zarr_io_matches_jax(tmp_path):
    path = tmp_path / "s.zarr"
    _store(zarrstore.create_group, path)
    got = zarrstore.profile_zarr_io(path, n=2)
    want = jzarr.profile_zarr_io(path, n=2)
    rates = ("read_time_slice_MBps", "read_node_series_MBps",
             "read_full_MBps")
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in got if k not in rates} == \
        {k: want[k] for k in want if k not in rates}
    assert got["arrays"] == ["a", "b"]
    assert all(np.isfinite(got[k]) and got[k] > 0 for k in rates)
    # a store with no 2-D array: both refuse
    g = zarrstore.create_group(tmp_path / "no2d.zarr", overwrite=True)
    g.create_array("c", shape=(4, 8, 2), chunks=(4, 8, 2), dtype=np.float32)
    for fn in (zarrstore.profile_zarr_io, jzarr.profile_zarr_io):
        with pytest.raises(ValueError, match="no 2-D arrays"):
            fn(tmp_path / "no2d.zarr")


# ---------------------------------------------------------------------------
# graph coordinates, the functional Chebyshev forms
# ---------------------------------------------------------------------------

def test_graph_coordinates_match_jax(graphs):
    g, jg = graphs
    for attr in ("lon", "lat", "coords_3d"):
        np.testing.assert_array_equal(getattr(g, attr), getattr(jg, attr))
    assert g.coords_3d.shape == (g.n_nodes, 3)


def _x(n, m=6, seed=1):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_cheb_bases_match_jax(graphs, K):
    g, jg = graphs
    x = _x(g.n_nodes)
    want = np.asarray(jcheb.cheb_basis_dense(
        jnp.asarray(jg.laplacian_dense()), jnp.asarray(x), K))
    got = cheb_basis_dense(torch.from_numpy(g.laplacian_dense()),
                           torch.from_numpy(x), K)
    assert got.shape == (K, g.n_nodes, 6) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL
    cols, vals = g.laplacian_ell()
    jcols, jvals = jg.laplacian_ell()
    want = np.asarray(jcheb.cheb_basis_ell(
        jnp.asarray(jcols), jnp.asarray(jvals), jnp.asarray(x), K))
    got = cheb_basis_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                         torch.from_numpy(x), K)
    assert got.shape == (K, g.n_nodes, 6)
    assert rel_err(got.numpy(), want) <= TOL


def test_ell_matvec_and_its_gradient_match_jax(graphs):
    """One product, and the gradient in x of a loss over it, on a
    Laplacian made non-symmetric by scaling its rows (the gradient then
    needs L^T's layout)."""
    g, _ = graphs
    rng = np.random.default_rng(2)
    L = sparse.diags(rng.uniform(0.5, 1.5, g.n_nodes)) @ g.L
    assert abs(L - L.T).max() > 0
    cols, vals = laplacian_to_ell(L.tocsr())
    x, r = _x(g.n_nodes, 5, 3), _x(g.n_nodes, 5, 4)

    def jloss(xj):
        return jnp.sum(jcheb.ell_matvec(jnp.asarray(cols), jnp.asarray(vals),
                                        xj) * r)
    want_y = np.asarray(jcheb.ell_matvec(jnp.asarray(cols),
                                         jnp.asarray(vals), jnp.asarray(x)))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = ell_matvec(torch.from_numpy(cols), torch.from_numpy(vals), xt)
    (y * torch.from_numpy(r)).sum().backward()
    assert y.shape == (g.n_nodes, 5)
    assert rel_err(y.detach().numpy(), want_y) <= TOL
    assert rel_err(xt.grad.numpy(), want_g) <= TOL
    np.testing.assert_allclose(want_g, (L.T @ r).astype(np.float32),
                               rtol=0, atol=TOL * np.abs(want_g).max())


@pytest.mark.parametrize("graph_type", ["knn", "voronoi"])
def test_ell_forms_promote_and_differentiate_vals_as_jax(graph_type,
                                                        monkeypatch):
    """`ell_matvec` and `cheb_basis_ell` (K=3) as JAX's einsum over the
    ELL arrays: bf16 x against fp32 vals gives fp32 values, and a loss
    over either has a gradient in vals (and in x) equal to `jax.grad`'s,
    on a symmetric (knn) and a non-symmetric (voronoi, M^-1 L) layout."""
    name, kw = GRAPHS["healpix4"]
    g = build_graph(name, kw, k=KNN, graph_type=graph_type)
    assert g.is_symmetric == (graph_type == "knn")
    cols, vals = g.laplacian_ell()
    n = g.n_nodes
    x = _x(n, 5, 5)
    xb = jnp.asarray(x, jnp.bfloat16)
    # bf16 x, fp32 vals: fp32 out, the same values as JAX's promotion
    for fn, jfn, args in ((ell_matvec, jcheb.ell_matvec, ()),
                          (cheb_basis_ell, jcheb.cheb_basis_ell, (3,))):
        want = jfn(jnp.asarray(cols), jnp.asarray(vals), xb, *args)
        got = fn(torch.from_numpy(cols), torch.from_numpy(vals),
                 torch.from_numpy(np.array(xb.astype(jnp.float32)))
                 .bfloat16(), *args)
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        assert rel_err(got.numpy(), np.asarray(want)) <= TOL
    # the gradients in vals and x of <f(vals, x), r>
    for fn, jfn, args, shape in (
            (ell_matvec, jcheb.ell_matvec, (), (n, 5)),
            (cheb_basis_ell, jcheb.cheb_basis_ell, (3,), (3, n, 5))):
        r = np.random.default_rng(6).standard_normal(shape).astype(
            np.float32)

        def jloss(v, xj):
            return jnp.sum(jfn(jnp.asarray(cols), v, xj, *args) * r)
        want_gv, want_gx = jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(vals), jnp.asarray(x))
        vt = torch.from_numpy(vals).requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        (fn(torch.from_numpy(cols), vt, xt, *args)
         * torch.from_numpy(r)).sum().backward()
        assert vt.grad is not None and vt.grad.dtype == torch.float32
        assert float(np.abs(np.asarray(want_gv)).max()) > 0
        assert rel_err(vt.grad.numpy(), np.asarray(want_gv)) <= TOL
        assert rel_err(xt.grad.numpy(), np.asarray(want_gx)) <= TOL
    # L^T's layout, built on the device, is `laplacian_to_ell` of L^T
    cols_t, vals_t = _transposed_ell(torch.from_numpy(cols),
                                     torch.from_numpy(vals))
    want_cols, want_vals = laplacian_to_ell(g.L.T.tocsr())
    np.testing.assert_array_equal(cols_t.numpy(), want_cols)
    np.testing.assert_array_equal(vals_t.numpy(), want_vals)
    # vals alone needing a gradient builds no transposed layout
    monkeypatch.setattr(cheb_module, "_transposed_ell", None)
    vt = torch.from_numpy(vals).requires_grad_()
    ell_matvec(torch.from_numpy(cols), vt, torch.from_numpy(x)).sum() \
        .backward()
    assert vt.grad.shape == vals.shape


def test_cheb_operator_node_counts_match_jax(graphs):
    g, jg = graphs
    for mode in ("dense", "ell", "bcsr"):
        op = ChebOperator.from_graph(g, mode, device="cpu")
        jop = jcheb.ChebOperator.from_graph(jg, mode=mode, use_pallas=True)
        assert op.n_nodes == jop.n_nodes == g.n_nodes


# ---------------------------------------------------------------------------
# the sparse-matrix cache
# ---------------------------------------------------------------------------

def test_cached_sparse_shares_the_jax_files(tmp_path, monkeypatch):
    monkeypatch.setenv("DSW_TPU_CACHE", str(tmp_path))
    mat = sparse.random(30, 20, density=0.2, random_state=5, format="csr",
                        dtype=np.float64)
    built = []

    def builder():
        built.append(1)
        return mat.tocoo()

    got = cached_sparse("port-key", builder)
    again = cached_sparse("port-key", builder)
    # the JAX package reads the port's file without building
    jgot = jcache.cached_sparse("port-key", lambda: pytest.fail("rebuilt"))
    # and the port reads the JAX package's
    jmade = jcache.cached_sparse("jax-key", lambda: mat.T)
    from_jax = cached_sparse("jax-key", lambda: pytest.fail("rebuilt"))
    assert len(built) == 1
    for m, want in ((got, mat), (again, mat), (jgot, mat), (jmade, mat.T),
                    (from_jax, mat.T)):
        assert isinstance(m, sparse.csr_matrix) and m.shape == want.shape
        assert abs(m - want).max() == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.name for p in tmp_path.glob("*_sparse.npz"))
