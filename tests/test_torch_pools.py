"""Port pools and unpools vs the JAX package (`ops/pool.py` of both).

Every (pool method, sampling) pair the JAX factory `build_pool_unpool`
accepts, on tiny grids: hierarchical max/avg on HEALPix-4 and on
equiangular 8x16, 10x20 and 5x10 (odd: 5x10 -> 2x5, the trailing row and
column cropped by the pool, zero-padded or resized back by the unpool);
the remap methods interp, maxarea, maxval and learn on every sampling
family. Inputs come from np.random.default_rng; each case runs the pool,
then the unpool on the pool's output and indices, and differentiates
<pool(x), g1> + <unpool(pool(x)), g2> with respect to x and the learned
logits. Bars (max abs error over max abs of the JAX value): fp32 1e-6,
bf16 1e-2, values and gradients; the argmax indices equal. Also: the
factory's refusals with the JAX messages, the first-index tie rule of the
argmax pools, the MaxVal scatter where two destinations chose one source,
and both under `torch.func.vmap` and `torch.export`."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.ops.pool import (  # noqa: E402
    EllMatrix as JEllMatrix,
    build_pool_unpool as jbuild_pool_unpool,
    sparse_to_ell as jsparse_to_ell,
)
from deepsphere_weather_tpu.sphere import (  # noqa: E402
    build_sampling as jbuild_sampling,
    coarsen_sampling_kwargs as jcoarsen,
)

from deepsphere_weather_torch.ops.pool import (  # noqa: E402
    EllMatrix,
    GeneralLearnPool,
    GeneralLearnUnpool,
    GeneralMaxValPool,
    GeneralMaxValUnpool,
    build_pool_unpool,
    sparse_to_ell,
)
from deepsphere_weather_torch.sphere import (  # noqa: E402
    build_pooling_matrices,
    build_sampling,
    coarsen_sampling_kwargs,
)

GRIDS = {
    "healpix4": ("healpix", {"subdivisions": 4, "nest": True}),
    "equiangular8x16": ("equiangular", {"nlat": 8, "nlon": 16}),
    "equiangular10x20": ("equiangular", {"nlat": 10, "nlon": 20}),
    "equiangular5x10": ("equiangular", {"nlat": 5, "nlon": 10}),
    "icosahedral4": ("icosahedral", {"subdivisions": 4}),
    "cubed4": ("cubed", {"subdivisions": 4}),
    "gauss8": ("gauss", {"nlat": 8, "nlon": "ecmwf-octahedral"}),
}
HIERARCHICAL = ("max", "avg")
REMAP = ("interp", "maxarea", "maxval", "learn")
CASES = ([(m, g) for m in HIERARCHICAL for g in GRIDS
          if GRIDS[g][0] in ("healpix", "equiangular")]
         + [(m, g) for m in REMAP for g in GRIDS])
TOL = {"fp32": 1e-6, "bf16": 1e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
B, C = 2, 3


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def samplings(grid):
    name, kw = GRIDS[grid]
    return ((build_sampling(name, kw),
             build_sampling(name, coarsen_sampling_kwargs(name, kw, 2))),
            (jbuild_sampling(name, kw),
             jbuild_sampling(name, jcoarsen(name, kw, 2))))


def run_jax(pool, unpool, x, g1, g2, logits):
    """(pooled, idx, unpooled, {grad name: array}) of the JAX pair."""
    def f(p):
        kw = {"w": p["pool"]} if "pool" in p else {}
        y, idx = pool(p["x"], **kw)
        kw = {"w": p["unpool"]} if "unpool" in p else {}
        z = unpool(y, idx, **kw)
        loss = ((y.astype(jnp.float32) * g1).sum()
                + (z.astype(jnp.float32) * g2).sum())
        return loss, (y, idx, z)
    params = {"x": x, **logits}
    (_, (y, idx, z)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    return y, idx, z, grads


def run_port(pool, unpool, x, g1, g2, logits):
    x = x.clone().requires_grad_()
    logits = {k: v.clone().requires_grad_() for k, v in logits.items()}
    kw = {"w": logits["pool"]} if "pool" in logits else {}
    y, idx = pool(x, **kw)
    kw = {"w": logits["unpool"]} if "unpool" in logits else {}
    z = unpool(y, idx, **kw)
    loss = (y.float() * g1).sum() + (z.float() * g2).sum()
    loss.backward()
    grads = {"x": x.grad, **{k: v.grad for k, v in logits.items()}}
    return y, idx, z, grads


def np32(t):
    return np.asarray(t.detach().float().cpu().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float32), np.float64)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("method,grid", CASES)
def test_pool_unpool_matches_jax(method, grid, dt):
    (src, dst), (jsrc, jdst) = samplings(grid)
    pool, unpool = build_pool_unpool(method, src, dst, device="cpu")
    jpool, junpool = jbuild_pool_unpool(method, jsrc, jdst)
    assert type(pool).__name__ == type(jpool).__name__
    assert type(unpool).__name__ == type(junpool).__name__
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, src.n_nodes, C)).astype(np.float32)
    g1 = rng.standard_normal((B, dst.n_nodes, C)).astype(np.float32)
    g2 = rng.standard_normal((B, src.n_nodes, C)).astype(np.float32)
    logits = {}
    if method == "learn":
        for name, op, jop in (("pool", pool, jpool),
                              ("unpool", unpool, junpool)):
            np.testing.assert_array_equal(op.init().numpy(),
                                          np.asarray(jop.init()))
            # away from the init, so that the softmax weighs otherwise
            logits[name] = (np.asarray(jop.init())
                            + 0.3 * rng.standard_normal(jop.init().shape)
                            ).astype(np.float32)
    jy, jidx, jz, jg = run_jax(jpool, junpool, jnp.asarray(x, JDT[dt]),
                               jnp.asarray(g1), jnp.asarray(g2),
                               {k: jnp.asarray(v) for k, v in logits.items()})
    y, idx, z, g = run_port(pool, unpool, torch.from_numpy(x).to(TDT[dt]),
                            torch.from_numpy(g1), torch.from_numpy(g2),
                            {k: torch.from_numpy(v) for k, v in logits.items()})
    assert y.dtype == z.dtype == TDT[dt]
    assert tuple(y.shape) == jy.shape == (B, dst.n_nodes, C)
    assert tuple(z.shape) == jz.shape == (B, src.n_nodes, C)
    if jidx is None:
        assert idx is None
    else:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for what, got, ref in (("pooled", y, jy), ("unpooled", z, jz)):
        assert rel_err(np32(got), np32(ref)) <= TOL[dt], what
    assert set(g) == set(jg)
    for k in jg:
        assert g[k].dtype == (TDT[dt] if k == "x" else torch.float32), k
        assert rel_err(np32(g[k]), np32(jg[k])) <= TOL[dt], f"grad {k}"


@pytest.mark.parametrize("grid", ["icosahedral4", "cubed4", "gauss8"])
@pytest.mark.parametrize("method", HIERARCHICAL)
def test_hierarchical_refusal_matches_jax(method, grid):
    (src, dst), (jsrc, jdst) = samplings(grid)
    with pytest.raises(ValueError) as jerr:
        jbuild_pool_unpool(method, jsrc, jdst)
    with pytest.raises(ValueError) as err:
        build_pool_unpool(method, src, dst, device="cpu")
    assert str(err.value) == str(jerr.value)
    assert "requires healpix/equiangular" in str(err.value)


def test_unknown_method_refusal_matches_jax():
    (src, dst), (jsrc, jdst) = samplings("healpix4")
    with pytest.raises(ValueError) as jerr:
        jbuild_pool_unpool("median", jsrc, jdst)
    with pytest.raises(ValueError) as err:
        build_pool_unpool("median", src, dst, device="cpu")
    assert str(err.value) == str(jerr.value) == "unknown pool_method 'median'"


@pytest.mark.parametrize("grid", ["gauss8", "equiangular5x10"])
def test_ell_layout_matches_jax(grid):
    (src, dst), _ = samplings(grid)
    pool_mat, unpool_mat = build_pooling_matrices(src, dst)
    x = np.random.default_rng(3).standard_normal(
        (B, src.n_nodes, C)).astype(np.float32)
    for mat in (pool_mat, unpool_mat):
        cols, vals = sparse_to_ell(mat)
        jcols, jvals = jsparse_to_ell(mat)
        np.testing.assert_array_equal(cols, jcols)
        np.testing.assert_array_equal(vals, jvals)
    y = EllMatrix.from_scipy(pool_mat, device="cpu").apply(torch.from_numpy(x))
    jy = JEllMatrix.from_scipy(pool_mat).apply(jnp.asarray(x))
    assert rel_err(y.numpy(), np.asarray(jy)) <= TOL["fp32"]
    want = np.stack([pool_mat @ xb for xb in x])
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method,grid", [("max", "healpix4"),
                                         ("max", "equiangular10x20"),
                                         ("maxval", "gauss8")])
def test_argmax_ties_take_the_first_index(method, grid):
    """A constant field ties every window (and, for maxval, every pair of
    equal weights): both stacks take the first slot, and the gradient of
    the max is split evenly over the tie."""
    (src, dst), (jsrc, jdst) = samplings(grid)
    pool, unpool = build_pool_unpool(method, src, dst, device="cpu")
    jpool, junpool = jbuild_pool_unpool(method, jsrc, jdst)
    x = np.full((1, src.n_nodes, 2), 0.5, np.float32)
    g1 = np.random.default_rng(5).standard_normal(
        (1, dst.n_nodes, 2)).astype(np.float32)
    g2 = np.zeros((1, src.n_nodes, 2), np.float32)
    jy, jidx, _, jg = run_jax(jpool, junpool, jnp.asarray(x), jnp.asarray(g1),
                              jnp.asarray(g2), {})
    y, idx, _, g = run_port(pool, unpool, torch.from_numpy(x),
                            torch.from_numpy(g1), torch.from_numpy(g2), {})
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if method == "max":
        assert (idx == 0).all()
    else:
        # the first support slot whose weight is the row's largest
        w = pool.vals.numpy()
        want = pool.cols.numpy()[np.arange(len(w)), w.argmax(axis=1)]
        np.testing.assert_array_equal(idx[0, :, 0].numpy(), want)
    assert rel_err(g["x"].numpy(), np.asarray(jg["x"])) <= TOL["fp32"]


def _shared_source_input(pool):
    """(x, s): a source s in two destinations' supports, given a value
    that wins both their argmaxes."""
    cols, vals = pool.cols.numpy(), pool.vals.numpy()
    support = [set(cols[d][vals[d] > 0]) for d in range(len(cols))]
    s = next(s for s in range(pool.n_in)
             if sum(s in sup for sup in support) >= 2)
    x = np.random.default_rng(9).standard_normal(
        (B, pool.n_in, C)).astype(np.float32)
    x[:, s, :] = 1e3
    return x, s


def test_maxval_scatter_adds_repeated_indices():
    (src, dst), (jsrc, jdst) = samplings("gauss8")
    pool, unpool = build_pool_unpool("maxval", src, dst, device="cpu")
    jpool, junpool = jbuild_pool_unpool("maxval", jsrc, jdst)
    x, s = _shared_source_input(pool)
    y, idx = pool(torch.from_numpy(x))
    chosen = (idx == s).sum(dim=1)
    assert (chosen >= 2).all()              # repeated in every (b, c)
    z = unpool(y, idx)
    want = np.zeros((B, src.n_nodes, C), np.float32)
    for b in range(B):
        for c in range(C):
            np.add.at(want[b, :, c], idx[b, :, c].numpy(), y[b, :, c].numpy())
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-6)
    jy, jidx = jpool(jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert rel_err(z.numpy(), np.asarray(junpool(jy, jidx))) <= TOL["fp32"]
    assert float(z[0, s, 0]) == pytest.approx(
        float(y[0, idx[0, :, 0] == s, 0].sum()), rel=1e-6)


@pytest.mark.parametrize("method", ["maxval", "learn", "maxarea"])
def test_pools_under_vmap_and_export(method):
    """A member axis mapped by torch.func.vmap gives each member's own
    pool and unpool (the MaxVal scatter with its repeated indices
    included); torch.export of the pair gives the eager result."""
    (src, dst), _ = samplings("gauss8")
    pool, unpool = build_pool_unpool(method, src, dst, device="cpu")
    x, _ = _shared_source_input(
        build_pool_unpool("maxval", src, dst, device="cpu")[0])
    xs = torch.from_numpy(np.stack([x, -x, 2 * x]))

    def pair(x):
        if isinstance(pool, GeneralLearnPool):
            y, idx = pool(x, w=pool.init_logits)
        else:
            y, idx = pool(x)
        return unpool(y, idx)

    mapped = torch.func.vmap(pair)(xs)
    for m in range(len(xs)):
        torch.testing.assert_close(mapped[m], pair(xs[m]), rtol=0, atol=0)

    class Pair(torch.nn.Module):
        def forward(self, x):
            return pair(x)

    program = torch.export.export(Pair(), (xs[0],), strict=False)
    torch.testing.assert_close(program.module()(xs[1]), pair(xs[1]),
                               rtol=0, atol=0)


def test_learned_pools_start_at_interp():
    """softmax(log w) = w: the learned pair at its initial logits is the
    interp pair."""
    (src, dst), _ = samplings("icosahedral4")
    lp, lu = build_pool_unpool("learn", src, dst, device="cpu")
    ip, iu = build_pool_unpool("interp", src, dst, device="cpu")
    assert isinstance(lp, GeneralLearnPool)
    assert isinstance(lu, GeneralLearnUnpool)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, src.n_nodes, C)).astype(np.float32))
    torch.testing.assert_close(lp(x)[0], ip(x)[0], rtol=1e-5, atol=1e-6)
    y = ip(x)[0]
    torch.testing.assert_close(lu(y), iu(y), rtol=1e-5, atol=1e-6)
    assert isinstance(build_pool_unpool("maxval", src, dst, device="cpu")[1],
                      GeneralMaxValUnpool)
    assert isinstance(build_pool_unpool("maxval", src, dst, device="cpu")[0],
                      GeneralMaxValPool)
