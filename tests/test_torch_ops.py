"""Port ops vs the JAX package: Laplacian, BCSR layouts, super-row SpMM,
Chebyshev convolution (all three branches, dense and block-sparse) and
HEALPix pooling. Inputs come from np.random.default_rng; the JAX side runs
its Pallas operator in interpret mode on the CPU, as its own tests do.

Tolerances are max abs error / max abs of the reference: fp32 1e-5
(summation order only), bf16 1e-2 for one matvec (one bf16 output
rounding) and 3e-2 for a convolution (a few chained bf16 roundings)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.ops import pool as jpool  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import cheb_conv as jcheb_conv  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
    bcsr_from_scipy as jbcsr_from_scipy,
    bcsr_super_from_scipy as jbcsr_super_from_scipy,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    ChebOperator,
    HealpixAvgPool,
    HealpixAvgUnpool,
    HealpixMaxPool,
    HealpixMaxUnpool,
    bcsr_from_scipy,
    bcsr_super_from_scipy,
    bcsr_super_spmm,
    bcsr_super_spmm_reference,
    cheb_conv,
    launch_counts,
)
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402

KNN = 8
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
MV_TOL = {"fp32": 1e-5, "bf16": 1e-2}
CONV_TOL = {"fp32": 1e-5, "bf16": 3e-2}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=[4, 8], ids=["hp4", "hp8"])
def graphs(request):
    kw = {"subdivisions": request.param, "nest": True}
    return build_graph("healpix", kw, k=KNN), jbuild_graph("healpix", kw, k=KNN)


def test_laplacian_matches_jax(graphs):
    g, gj = graphs
    assert g.L.shape == gj.L.shape
    d = np.abs((g.L - gj.L).toarray()).max()
    assert d <= 1e-6 * np.abs(gj.L.toarray()).max()


def _dense_from_super(svals, ucols, n_pad):
    n_s, R, bs, ubs = svals.shape
    dense = np.zeros((n_s * R * bs, n_pad), np.float32)
    for s in range(n_s):
        for u in range(ucols.shape[1]):
            c = int(ucols[s, u])
            for r in range(R):
                row0 = (s * R + r) * bs
                dense[row0:row0 + bs, c * bs:(c + 1) * bs] += \
                    svals[s, r, :, u * bs:(u + 1) * bs]
    return dense


def test_bcsr_layouts_match_jax(graphs):
    g, gj = graphs
    vals, cols, n_pad = bcsr_from_scipy(g.L)
    jvals, jcols, jn_pad = jbcsr_from_scipy(gj.L)
    assert n_pad == jn_pad
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(cols, jcols)
    svals, ucols, n_pad = bcsr_super_from_scipy(g.L, rows_per_super=2)
    jsvals, _use, _wait, jucols, ucount, _sched, _ = jbcsr_super_from_scipy(
        gj.L, rows_per_super=2)
    assert svals.shape == jsvals.shape and ucols.shape == jucols.shape
    # the union slot order differs (the TPU layout follows its DMA slot
    # schedule, the port's is sorted): the matrices they encode agree
    dense = _dense_from_super(svals, ucols, n_pad)
    np.testing.assert_array_equal(dense, _dense_from_super(jsvals, jucols, n_pad))
    n = g.n_nodes
    np.testing.assert_array_equal(dense[:n, :n], g.L.toarray())
    # sorted unions; padding slots repeat a real column
    for s in range(ucols.shape[0]):
        real = ucols[s, :ucount[s]]
        assert np.all(np.diff(real) > 0)
        assert np.all(ucols[s, ucount[s]:] == real[-1])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_super_spmm_matches_jax_interpret(graphs, dt):
    g, gj = graphs
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.n_nodes, 96)).astype(np.float32)
    op = BlockSparseOperator.from_scipy(g.L, symmetric=True,
                                        dtype=TORCH_DT[dt], device="cpu")
    jop = JBlockSparseOperator.from_scipy(gj.L, symmetric=True, m_tile=128,
                                          interpret=True, dtype=JAX_DT[dt])
    before = launch_counts["bcsr_super_spmm"]
    y = op.matvec(torch.from_numpy(x).to(TORCH_DT[dt]))
    assert launch_counts["bcsr_super_spmm"] == before   # plain version on CPU
    yj = jop.matvec(jnp.asarray(x, JAX_DT[dt]))
    assert y.dtype == TORCH_DT[dt] and y.shape == (g.n_nodes, 96)
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= MV_TOL[dt]
    assert rel_err(y.float().numpy(), g.L @ x) <= MV_TOL[dt]


@pytest.mark.parametrize("a_dt,x_dt", [("fp32", "bf16"), ("bf16", "fp32")])
def test_super_spmm_mixed_dtypes(graphs, a_dt, x_dt):
    # bf16 x rounds fp32 A to bf16; fp32 x widens bf16 A exactly; the
    # output follows x
    g, _ = graphs
    svals, ucols, _ = bcsr_super_from_scipy(g.L)
    n_s, R, bs, _ = svals.shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(
        (n_s * R * bs, 128)).astype(np.float32)).to(TORCH_DT[x_dt])
    a = torch.from_numpy(svals).to(TORCH_DT[a_dt])
    y = bcsr_super_spmm(a, torch.from_numpy(ucols), x)
    assert y.dtype == TORCH_DT[x_dt]
    a_cast = a.to(TORCH_DT[x_dt]).float()
    want = bcsr_super_spmm_reference(a_cast, torch.from_numpy(ucols), x.float())
    np.testing.assert_allclose(y.float().numpy(), want.to(TORCH_DT[x_dt]).float().numpy(),
                               rtol=0, atol=0)


def test_spmm_rejects_bad_input_and_never_falls_back(graphs):
    g, _ = graphs
    svals, ucols, _ = bcsr_super_from_scipy(g.L)
    a, u = torch.from_numpy(svals), torch.from_numpy(ucols)
    with pytest.raises(ValueError):
        bcsr_super_spmm(a, u, torch.zeros(128, 128))          # wrong row count
    with pytest.raises(TypeError):
        bcsr_super_spmm(a, u.long(), torch.zeros(a.shape[0] * 256, 128))
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BlockSparseOperator.from_scipy(g.L)


# (Fin, Fout) picks the branch: Fout < Fin runs Clenshaw; otherwise dense
# operators run the batch-major input side and block-sparse ones the
# node-major input side
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["dense", "bcsr"])
@pytest.mark.parametrize("fin,fout", [(5, 12), (12, 3)],
                         ids=["input_side", "clenshaw"])
def test_cheb_conv_matches_jax(graphs, dt, mode, fin, fout):
    g, gj = graphs
    rng = np.random.default_rng(5)
    B, K = 2, 3
    x = rng.standard_normal((B, g.n_nodes, fin)).astype(np.float32)
    w = (rng.standard_normal((fin, K, fout)) / np.sqrt(fin * K)).astype(np.float32)
    b = rng.standard_normal(fout).astype(np.float32) * 0.1
    op = ChebOperator.from_graph(g, mode=mode, dtype=TORCH_DT[dt], device="cpu")
    if mode == "dense":
        jop = JChebOperator.from_graph(gj, mode="dense")
    else:
        jop = JChebOperator(bcsr=JBlockSparseOperator.from_scipy(
            gj.L, symmetric=True, interpret=True, dtype=JAX_DT[dt]))
    y = cheb_conv(op, torch.from_numpy(x).to(TORCH_DT[dt]),
                  torch.from_numpy(w), torch.from_numpy(b))
    yj = jcheb_conv(jop, jnp.asarray(x, JAX_DT[dt]), jnp.asarray(w),
                    jnp.asarray(b))
    assert y.dtype == TORCH_DT[dt] and y.shape == (B, g.n_nodes, fout)
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= CONV_TOL[dt]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_healpix_pools_match_jax_with_ties(dt):
    rng = np.random.default_rng(6)
    # small integers: most 4-children groups hold ties
    x = rng.integers(-2, 3, size=(2, 48, 5)).astype(np.float32)
    xt = torch.from_numpy(x).to(TORCH_DT[dt])
    xj = jnp.asarray(x, JAX_DT[dt])
    pooled, idx = HealpixMaxPool(4)(xt)
    jpooled, jidx = jpool.HealpixMaxPool(4)(xj)
    g = x.reshape(2, 12, 4, 5)
    assert (g == g.max(axis=2, keepdims=True)).sum(axis=2).max() > 1   # ties
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pooled.float().numpy(),
                                  np.asarray(jpooled, np.float32))
    up = HealpixMaxUnpool(4)(pooled, idx)
    jup = jpool.HealpixMaxUnpool(4)(jpooled, jidx)
    np.testing.assert_array_equal(up.float().numpy(), np.asarray(jup, np.float32))
    avg, _ = HealpixAvgPool(4)(xt)
    javg, _ = jpool.HealpixAvgPool(4)(xj)
    np.testing.assert_array_equal(avg.float().numpy(), np.asarray(javg, np.float32))
    np.testing.assert_array_equal(
        HealpixAvgUnpool(4)(avg).float().numpy(),
        np.asarray(jpool.HealpixAvgUnpool(4)(javg), np.float32))
