"""The plain-BCSR SpMM and the operator's gradient vs the JAX package.

The plain version of the plain-BCSR kernel is held against the JAX
interpreter kernel (`_bcsr_matmul(interpret=True)`) in both of its
regimes; `BlockSparseOperator`'s gradient (its `autograd.Function`) on the
super-row and the plain layout, symmetric and not, against the JAX
interpret-mode operator's custom VJP and against 2 L^T (L x). Inputs come
from np.random.default_rng. Tolerances (max abs error / max abs of the
reference): fp32 1e-5 (summation order only), bf16 1e-2 (one bf16 output
rounding per product)."""

import jax
import numpy as np
import pytest
from scipy import sparse

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
    _bcsr_matmul,
)

from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.models import geometry as geometry_mod  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    bcsr_from_scipy,
    bcsr_spmm,
    bcsr_super_from_scipy,
    launch_counts,
)
from deepsphere_weather_torch.ops import bcsr as bcsr_mod  # noqa: E402
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax, seeded_params  # noqa: E402

KNN = 8
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"fp32": 1e-5, "bf16": 1e-2}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def nonsymmetric(L, seed=0):
    """D @ L with a random positive diagonal D: the knn pattern, not
    symmetric."""
    d = np.random.default_rng(seed).uniform(0.5, 2.0, L.shape[0])
    return (sparse.diags(d.astype(np.float32)) @ L).tocsr().astype(np.float32)


@pytest.fixture(scope="module", params=[4, 8], ids=["hp4", "hp8"])
def graph(request):
    return build_graph("healpix", {"subdivisions": request.param,
                                   "nest": True}, k=KNN)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_plain_spmm_matches_jax_interpreter_kernel(graph, dt):
    vals, cols, n_pad = bcsr_from_scipy(graph.L)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n_pad, 256)).astype(np.float32)
    before = launch_counts["bcsr_spmm"]
    y = bcsr_spmm(torch.from_numpy(vals).to(TORCH_DT[dt]),
                  torch.from_numpy(cols), torch.from_numpy(x).to(TORCH_DT[dt]))
    assert launch_counts["bcsr_spmm"] == before      # plain version on CPU
    yj = _bcsr_matmul(jnp.asarray(vals, JAX_DT[dt]), jnp.asarray(cols),
                      jnp.asarray(x, JAX_DT[dt]), m_tile=128, interpret=True)
    assert y.dtype == TORCH_DT[dt] and y.shape == (n_pad, 256)
    assert rel_err(y.float().numpy(), np.asarray(yj, np.float32)) <= TOL[dt]
    n = graph.n_nodes
    assert rel_err(y.float().numpy()[:n], graph.L @ x[:n]) <= TOL[dt]


def test_plain_spmm_regimes_for_fp32_a_against_bf16_x(graph):
    # round_a=False widens both operands (the interpreter kernel K4);
    # round_a=True rounds A to bf16 first (the compiled kernel K3)
    vals, cols, n_pad = bcsr_from_scipy(graph.L)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n_pad, 128)).astype(np.float32)
    a, c = torch.from_numpy(vals), torch.from_numpy(cols)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    widened = bcsr_spmm(a, c, xb, round_a=False)
    rounded = bcsr_spmm(a, c, xb, round_a=True)
    assert widened.dtype == rounded.dtype == torch.bfloat16
    yj = _bcsr_matmul(jnp.asarray(vals), jnp.asarray(cols),
                      jnp.asarray(x, jnp.bfloat16), m_tile=128, interpret=True)
    assert rel_err(widened.float().numpy(), np.asarray(yj, np.float32)) <= TOL["bf16"]
    # each regime is exactly its definition
    np.testing.assert_array_equal(
        widened.float().numpy(),
        bcsr_spmm(a, c, xb.float()).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        rounded.float().numpy(),
        bcsr_spmm(a.to(torch.bfloat16), c, xb).float().numpy())
    # the compiled regime against scipy with A rounded to bf16
    a_bf16 = sparse.csr_matrix(graph.L)
    a_bf16.data = torch.from_numpy(a_bf16.data.astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    n = graph.n_nodes
    ref = a_bf16 @ xb.float().numpy()[:n]
    assert rel_err(rounded.float().numpy()[:n], ref) <= TOL["bf16"]


def test_plain_spmm_rejects_bad_input(graph):
    vals, cols, n_pad = bcsr_from_scipy(graph.L)
    a, c = torch.from_numpy(vals), torch.from_numpy(cols)
    with pytest.raises(ValueError):
        bcsr_spmm(a, c, torch.zeros(n_pad + 128, 128))        # wrong rows
    with pytest.raises(TypeError):
        bcsr_spmm(a, c.long(), torch.zeros(n_pad, 128))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("rows_per_super", [2, 0], ids=["super", "plain"])
def test_operator_gradient_matches_jax(graph, dt, symmetric, rows_per_super):
    mat = graph.L if symmetric else nonsymmetric(graph.L)
    op = BlockSparseOperator.from_scipy(
        mat, symmetric=symmetric, dtype=TORCH_DT[dt],
        rows_per_super=rows_per_super, device="cpu")
    assert op.symmetric == symmetric
    assert (op.svals is not None) == (rows_per_super == 2)
    assert (op.svals_t is not None) == (rows_per_super == 2 and not symmetric)
    assert (op.vals_t is not None) == (rows_per_super == 0 and not symmetric)
    jop = JBlockSparseOperator.from_scipy(
        mat, symmetric=symmetric, m_tile=128, interpret=True,
        dtype=JAX_DT[dt])
    rng = np.random.default_rng(3)
    n = graph.n_nodes
    x = rng.standard_normal((n, 96)).astype(np.float32)
    g = rng.standard_normal((n, 96)).astype(np.float32)
    xt = torch.from_numpy(x).to(TORCH_DT[dt]).requires_grad_()
    y = op.matvec(xt)
    y.backward(torch.from_numpy(g).to(TORCH_DT[dt]))
    _, vjp = jax.vjp(jop.matvec, jnp.asarray(x, JAX_DT[dt]))
    (gj,) = vjp(jnp.asarray(g, JAX_DT[dt]))
    assert xt.grad.dtype == TORCH_DT[dt]
    assert rel_err(xt.grad.float().numpy(), np.asarray(gj, np.float32)) <= TOL[dt]
    assert rel_err(xt.grad.float().numpy(), mat.T @ g) <= TOL[dt]


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("rows_per_super", [2, 0], ids=["super", "plain"])
def test_operator_gradient_is_2_lt_l_x(graph, symmetric, rows_per_super):
    mat = graph.L if symmetric else nonsymmetric(graph.L)
    op = BlockSparseOperator.from_scipy(mat, symmetric=symmetric,
                                        rows_per_super=rows_per_super,
                                        device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (graph.n_nodes, 40)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (op.matvec(xt) ** 2).sum().backward()
    want = 2.0 * (mat.T @ (mat @ x))
    assert rel_err(xt.grad.numpy(), want) <= 1e-5
    if not symmetric:     # the premise: a symmetric backward would be wrong
        assert rel_err(2.0 * (mat @ (mat @ x)), want) > 1e-2


def test_super_forward_with_plain_transposed_backward():
    # a non-symmetric operator whose transpose exists only as plain BCSR:
    # the backward runs the plain kernel, and the row counts of the two
    # layouts differ (3 row blocks: 4 super-row rows blocks, 3 plain)
    rng = np.random.default_rng(5)
    n = 300
    mat = sparse.random(n, n, density=0.02, random_state=rng,
                        dtype=np.float32).tocsr() + sparse.eye(n, dtype=np.float32)
    mat = mat.tocsr()
    svals, ucols, _ = bcsr_super_from_scipy(mat, rows_per_super=2)
    vals_t, cols_t, _ = bcsr_from_scipy(mat.T.tocsr())
    op = BlockSparseOperator(
        n, svals=torch.from_numpy(svals), ucols=torch.from_numpy(ucols),
        vals_t=torch.from_numpy(vals_t), cols_t=torch.from_numpy(cols_t))
    assert op.rows == 512 and op.transpose_layout()[0] == "plain"
    x = rng.standard_normal((n, 70)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (op.matvec(xt) ** 2).sum().backward()
    assert rel_err(xt.grad.numpy(), 2.0 * (mat.T @ (mat @ x))) <= 1e-5


def test_operator_arrays_get_no_gradient(graph):
    op = BlockSparseOperator.from_scipy(graph.L, device="cpu")
    op.svals.requires_grad_()
    xt = torch.ones(graph.n_nodes, 8, requires_grad=True)
    op.matvec(xt).sum().backward()
    assert op.svals.grad is None and xt.grad is not None


def test_gradient_comes_from_the_autograd_function(graph, monkeypatch):
    # On the card the kernel fills its output through ctypes, so nothing
    # of the product is differentiable by itself. Make the CPU plain
    # version just as opaque: the gradient must still reach x (through
    # the operator's autograd.Function) and equal 2 L^T (L x).
    def opaque(fn):
        def run(*args, **kw):
            with torch.no_grad():
                return fn(*args, **kw).detach()
        return run

    monkeypatch.setattr(bcsr_mod, "bcsr_super_spmm_reference",
                        opaque(bcsr_mod.bcsr_super_spmm_reference))
    monkeypatch.setattr(bcsr_mod, "bcsr_spmm_reference",
                        opaque(bcsr_mod.bcsr_spmm_reference))
    monkeypatch.setattr(bcsr_mod, "ell_spmm_reference",
                        opaque(bcsr_mod.ell_spmm_reference))
    x = np.random.default_rng(6).standard_normal(
        (graph.n_nodes, 24)).astype(np.float32)
    for rows_per_super in (2, 0):
        op = BlockSparseOperator.from_scipy(
            graph.L, rows_per_super=rows_per_super, device="cpu")
        xt = torch.from_numpy(x).requires_grad_()
        y = op.matvec(xt)
        assert y.requires_grad
        (y ** 2).sum().backward()
        want = 2.0 * (graph.L.T @ (graph.L @ x))
        assert np.abs(xt.grad.numpy()).max() > 0
        assert rel_err(xt.grad.numpy(), want) <= 1e-5

    # the same for a whole model whose level 0 is block-sparse: every
    # level-0 weight gets its gradient
    info = {"input_n_feature": 3, "output_n_feature": 2, "input_n_time": 2,
            "output_n_time": 1, "input_shape_info": {"dynamic": {"node": 768}},
            "output_shape_info": {"dynamic": {"node": 768}}}
    model = UNetSpherical(info, "healpix", {"subdivisions": 8, "nest": True},
                          knn=KNN, increment_learning=True,
                          dense_threshold=767, device="cpu")
    model.load_state_dict(params_from_jax(seeded_params(model, 7)))
    assert model.geometry.cheb_ops[0].bcsr is not None
    xm = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 2, 768, 3)).astype(np.float32))
    model(xm).square().sum().backward()
    for name in ("conv1", "uconv1", "uconv1_final"):
        w = getattr(model, name).convblock1.weight.grad
        assert w is not None and float(w.abs().max()) > 0, name


def test_geometry_symmetric_follows_graph_type(monkeypatch):
    kw = {"subdivisions": 4, "nest": True}
    geom = geometry_mod.build_model_geometry(
        "healpix", kw, depth=2, knn=KNN, dense_threshold=100, device="cpu")
    op = geom.cheb_ops[0].bcsr
    assert op is not None and op.symmetric and op.svals_t is None

    # a graph type whose Laplacian is not symmetric must carry the
    # transposed layout (the port builds knn graphs only, so the
    # Laplacian of such a graph is stood in for)
    real = geometry_mod.cached_graph_laplacian
    seen = []

    def fake(name, kwargs, k, graph_type):
        seen.append(graph_type)
        samp, L = real(name, kwargs, k, "knn")
        return samp, nonsymmetric(L)

    monkeypatch.setattr(geometry_mod, "cached_graph_laplacian", fake)
    for graph_type, symmetric in (("voronoi", False), ("mesh", True),
                                  ("knn", True)):
        geom = geometry_mod.build_model_geometry(
            "healpix", kw, depth=2, knn=KNN, graph_type=graph_type,
            dense_threshold=100, device="cpu")
        op = geom.cheb_ops[0].bcsr
        assert op.symmetric == symmetric, graph_type
        assert (op.svals_t is not None) == (not symmetric), graph_type
    assert seen[0] == "voronoi"
