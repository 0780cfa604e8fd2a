"""The fp32 product over the operator's nonzeros (`ell_spmm`, the CUDA
kernel `kernels/ell_spmm.cu` on the card, its plain version here) and the
ELL mode of `ChebOperator`, against the JAX package.

On the CPU the wrapper runs its plain version, which adds the same
rounded products in the kernel's order. The same scipy matrix (HEALPix-4
and -8 knn graphs, and a voronoi HEALPix-4 stand-in, which is not
symmetric) and the same numpy inputs go to both packages:

- the port's `laplacian_to_ell` equals the JAX arrays exactly;
- an fp32 `BlockSparseOperator.matvec` runs the ELL product and equals
  the JAX interpret-mode `BlockSparseOperator.matvec` and JAX's
  `ell_matvec` within 1e-5, its gradient `jax.grad`'s within 1e-5 (the
  voronoi one through the transposed layout);
- a row range equals the full product's rows, and the vmapped member
  product the per-member loop, exactly;
- the union tables the kernel reads a layout through (`ell_tables`, of
  the whole layout, of the transposed one and of a row shard) map every
  slot back to its column, padding slots to row 0, and a product through
  them (the union's x rows gathered, then the local index) equals the
  plain version bit for bit and JAX's `ell_matvec` within 1e-5;
- `cheb_conv` on `ChebOperator(mode='ell')` matches the JAX ELL operator
  within 1e-5, forward and gradients;
- an fp32 UNetSpherical with block-sparse levels 0 and 1 matches the JAX
  model (ELL at those levels) at the same weights within 1e-5, forward
  and gradients, and `torch.export` traces it through the op's fake;
- fp32 x goes to the ELL wrapper and bf16 x to the super-row kernel's.

Tolerances: max abs error / max abs (the repo's fp32 bar)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import (  # noqa: E402
    ChebOperator as JChebOperator,
    cheb_conv as jcheb_conv,
    ell_matvec as jell_matvec,
)
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere.graph import (  # noqa: E402
    build_graph as jbuild_graph,
    laplacian_to_ell as jlaplacian_to_ell,
)

from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    ChebOperator,
    EllOperator,
    EllTables,
    cheb_conv,
    ell_spmm,
    ell_spmm_reference,
    ell_spmm_rows,
    ell_spmm_rows_reference,
    ell_tables,
    launch_counts,
)
from deepsphere_weather_torch.ops import bcsr as bcsr_mod  # noqa: E402
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402
from deepsphere_weather_torch.sphere.graph import laplacian_to_ell  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    seeded_params,
)

TOL = 1e-5
KNN = 8
GRAPHS = {"knn4": (4, "knn"), "knn8": (8, "knn"), "voronoi4": (4, "voronoi")}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    """The JAX package's graph: its L goes to both packages."""
    subdiv, graph_type = GRAPHS[request.param]
    return jbuild_graph("healpix", {"subdivisions": subdiv, "nest": True},
                        k=KNN, graph_type=graph_type)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_laplacian_to_ell_equals_jax(graph):
    for mat in (graph.L, graph.L.T.tocsr()):
        cols, vals = laplacian_to_ell(mat)
        jcols, jvals = jlaplacian_to_ell(mat)
        assert cols.dtype == np.int32 and vals.dtype == np.float32
        np.testing.assert_array_equal(cols, jcols)
        np.testing.assert_array_equal(vals, jvals)


def test_graph_laplacian_ell_is_laplacian_to_ell():
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=KNN)
    for got, want in zip(g.laplacian_ell(), laplacian_to_ell(g.L)):
        np.testing.assert_array_equal(got, want)


def test_fp32_matvec_and_gradient_match_jax(graph):
    L, sym = graph.L, graph.is_symmetric
    n = L.shape[0]
    op = BlockSparseOperator.from_scipy(L, symmetric=sym, device="cpu")
    assert op.ell is not None and op.ell.symmetric == sym
    jop = JBlockSparseOperator.from_scipy(L, symmetric=sym, m_tile=128,
                                          interpret=True, dtype=jnp.float32)
    jcols, jvals = (jnp.asarray(a) for a in jlaplacian_to_ell(L))
    x_np, g_np = _np((n, 44), 1), _np((n, 44), 2)
    x = torch.from_numpy(x_np).requires_grad_()
    y = op.matvec(x)
    assert y.dtype == torch.float32 and y.shape == (n, 44)
    xj = jnp.asarray(x_np)
    assert rel_err(y.detach().numpy(), np.asarray(jop.matvec(xj))) <= TOL
    assert rel_err(y.detach().numpy(),
                   np.asarray(jell_matvec(jcols, jvals, xj))) <= TOL
    y.backward(torch.from_numpy(g_np))
    gj = jnp.asarray(g_np)
    for jmv in (jop.matvec, lambda v: jell_matvec(jcols, jvals, v)):
        want = jax.grad(lambda v: jnp.sum(jmv(v) * gj))(xj)
        assert rel_err(x.grad.numpy(), np.asarray(want)) <= TOL


def test_row_ranges_equal_full_rows(graph):
    L = graph.L
    n = L.shape[0]
    op = EllOperator.from_scipy(L, symmetric=graph.is_symmetric, device="cpu")
    x = torch.from_numpy(_np((n, 24), 3))
    for vals, cols in ((op.vals, op.cols), (op.vals_t, op.cols_t)):
        if vals is None:
            continue
        full = ell_spmm(vals, cols, x)
        for n_node in (2, 4):
            for r in range(n_node):
                r0, r1 = r * n // n_node, (r + 1) * n // n_node
                assert torch.equal(ell_spmm_rows(vals, cols, x, r0, r1),
                                   full[r0:r1])
    # a row shard of the operator holds exactly those rows of both layouts
    shard = op.row_shard(n // 4, n // 2, group=None)
    kind, vals, cols, nz, r0, rows = shard.forward_layout()
    assert (kind, r0, rows) == ("ell", n // 4, n)
    assert isinstance(nz, EllTables) and nz.loc.shape == vals.shape
    assert torch.equal(vals, op.vals[n // 4:n // 2])
    assert torch.equal(cols, op.cols[n // 4:n // 2])
    _, vals_t, _, _, _, _ = shard.transpose_layout()
    assert torch.equal(vals_t, (op.vals if graph.is_symmetric
                                else op.vals_t)[n // 4:n // 2])


def _layouts(op):
    """(label, vals, cols, tables) of each ELL layout of `op`: forward,
    transposed when L is not symmetric."""
    out = [("forward", op.vals, op.cols, op.tables)]
    if not op.symmetric:
        out.append(("transposed", op.vals_t, op.cols_t, op.tables_t))
    return out


def _blocks(tables):
    """(first row, end row, union) of each block of `tables`."""
    firsts, offs = tables.blocks.numpy()
    urows = tables.urows.numpy()
    return [(int(firsts[b]), int(firsts[b + 1]), urows[offs[b]:offs[b + 1]])
            for b in range(len(firsts) - 1)]


def _check_tables(vals, cols, tables, n_x):
    """The union tables of (vals, cols): blocks of consecutive rows that
    cover the layout, each union sorted, distinct, within x's n_x rows
    and holding exactly the columns its rows name; every slot's local
    index maps back to its column, so a padding slot (value 0, column 0)
    to row 0; umax and rmax the largest union and block."""
    c, loc = cols.numpy(), tables.loc.numpy().astype(np.int64)
    assert tables.loc.dtype == torch.int16 and loc.shape == c.shape
    assert tables.blocks.dtype == tables.urows.dtype == torch.int32
    blocks = _blocks(tables)
    assert blocks[0][0] == 0 and blocks[-1][1] == c.shape[0]
    assert all(e == f for (_, e, _), (f, _, _) in zip(blocks, blocks[1:]))
    for f, e, u in blocks:
        assert f < e and np.all(np.diff(u) > 0) and u[-1] < n_x
        np.testing.assert_array_equal(u, np.unique(c[f:e]))
        np.testing.assert_array_equal(u[loc[f:e]], c[f:e])
    assert tables.umax == max(len(u) for _, _, u in blocks)
    assert tables.rmax == max(e - f for f, e, _ in blocks)
    padded = (vals.numpy() == 0) & (c == 0)
    for f, e, u in blocks:
        if padded[f:e].any():
            assert u[0] == 0
    return blocks


def _tables_product(vals, tables, x):
    """The product as the kernel computes it, in plain PyTorch: each
    block's union rows of x gathered (its shared-memory slab), then its
    rows' products read through the local index, in the slot order."""
    return torch.cat([
        ell_spmm_reference(vals[f:e], tables.loc[f:e].int(),
                           x[torch.from_numpy(u).long()])
        for f, e, u in _blocks(tables)])


def test_union_tables_map_slots_to_columns(graph):
    n = graph.L.shape[0]
    op = EllOperator.from_scipy(graph.L, symmetric=graph.is_symmetric,
                                device="cpu")
    for _, vals, cols, tables in _layouts(op):
        blocks = _check_tables(vals, cols, tables, n)
        # nested HEALPix keeps a block's neighbourhood small: whole blocks
        rows = bcsr_mod.ELL_BLOCK_ROWS
        assert [e - f for f, e, _ in blocks[:-1]] == [rows] * (len(blocks) - 1)


def test_row_shard_tables_cover_its_rows_against_full_x(graph):
    n = graph.L.shape[0]
    op = EllOperator.from_scipy(graph.L, symmetric=graph.is_symmetric,
                                device="cpu")
    x = torch.from_numpy(_np((n, 12), 14))
    for v0, v1 in ((0, n // 2), (n // 4, n // 2), (n // 3, n)):
        shard = op.row_shard(v0, v1, group=None)
        for (_, fvals, fcols, _), layout in zip(
                _layouts(op), (shard.forward_layout(),
                               shard.transpose_layout())):
            _, vals, cols, tables, r0, rows = layout
            assert (r0, rows) == (v0, n)
            assert torch.equal(cols, fcols[v0:v1])
            _check_tables(vals, cols, tables, n)
            assert torch.equal(_tables_product(vals, tables, x),
                               ell_spmm_reference(fvals, fcols, x)[v0:v1])


def test_product_through_tables_equals_plain_version(graph):
    n = graph.L.shape[0]
    op = EllOperator.from_scipy(graph.L, symmetric=graph.is_symmetric,
                                device="cpu")
    x_np = _np((n, 20), 15)
    x = torch.from_numpy(x_np)
    for label, vals, cols, tables in _layouts(op):
        got = _tables_product(vals, tables, x)
        assert torch.equal(got, ell_spmm_reference(vals, cols, x)), label
        want = jell_matvec(jnp.asarray(cols), jnp.asarray(vals),
                           jnp.asarray(x_np))
        assert rel_err(got.numpy(), np.asarray(want)) <= TOL, label


def test_tables_split_wide_unions():
    # rows whose columns scatter over x: a block is halved until its
    # union names at most the cap
    rng = np.random.default_rng(16)
    n, width = 300, 9
    cols = torch.from_numpy(rng.integers(0, n, (n, width)).astype(np.int32))
    cols[::7, -2:] = 0                                # padded slots
    vals = torch.from_numpy(rng.standard_normal((n, width)).astype(
        np.float32))
    vals[::7, -2:] = 0
    tables = ell_tables(cols)
    blocks = _check_tables(vals, cols, tables, n)
    assert tables.umax <= bcsr_mod.ELL_UNION_CAP
    assert tables.rmax < bcsr_mod.ELL_BLOCK_ROWS
    assert len(blocks) > n // bcsr_mod.ELL_BLOCK_ROWS + 1
    x = torch.from_numpy(_np((n, 8), 17))
    assert torch.equal(_tables_product(vals, tables, x),
                       ell_spmm_reference(vals, cols, x))


def test_ell_ops_take_the_tables_unmapped():
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=KNN)
    op = EllOperator.from_scipy(g.L, device="cpu")
    loc, blocks, urows, umax, rmax = op.tables
    x = torch.from_numpy(_np((3, g.n_nodes, 8), 18))
    y = torch.func.vmap(lambda xi: bcsr_mod.spmm_ell(
        op.vals, op.cols, loc, blocks, urows, xi, umax, rmax))(x)
    assert torch.equal(y, torch.stack([ell_spmm_reference(op.vals, op.cols,
                                                          xi) for xi in x]))
    with pytest.raises(NotImplementedError, match="arrays themselves"):
        torch.func.vmap(lambda li: bcsr_mod.spmm_ell(
            op.vals, op.cols, li, blocks, urows, x[0], umax, rmax))(
                loc.expand(2, *loc.shape))


def test_plain_version_adds_in_the_kernels_order():
    # the j-ordered sum of rounded products: row 0 holds 1, 2^-24, 2^-24
    # against x = 1; left to right both tiny terms round away
    vals = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -24], [0.0, 0.0, 0.0]])
    cols = torch.zeros(2, 3, dtype=torch.int32)
    x = torch.ones(2, 4)
    y = ell_spmm_reference(vals, cols, x)
    assert torch.equal(y[0], torch.ones(4)) and not y[1].any()
    assert torch.equal(ell_spmm_rows_reference(vals, cols, x, 1, 2), y[1:])


def test_wrapper_refusals():
    vals = torch.zeros(4, 3)
    cols = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(TypeError, match="fp32"):
        ell_spmm(vals, cols, torch.zeros(4, 8, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        ell_spmm(vals, cols.long(), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="inconsistent ELL layout"):
        ell_spmm(vals, cols[:, :2], torch.zeros(4, 8))
    with pytest.raises(ValueError, match="row range"):
        ell_spmm_rows(vals, cols, torch.zeros(4, 8), 2, 2)
    with pytest.raises(ValueError, match="4 rows"):
        EllOperator(4, vals[:3], cols[:3])


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "nonsym"])
def test_vmap_member_product_equals_loop(sym, monkeypatch):
    g = jbuild_graph("healpix", {"subdivisions": 4, "nest": True}, k=KNN,
                     graph_type="knn" if sym else "voronoi")
    n = g.L.shape[0]
    op = BlockSparseOperator.from_scipy(g.L, symmetric=sym, device="cpu")
    widths = []

    def record(vals, cols, x):
        widths.append(x.shape[1])
        return ell_spmm_reference(vals, cols, x)
    monkeypatch.setattr(bcsr_mod, "ell_spmm_reference", record)
    x = torch.from_numpy(_np((3, n, 10), 4))
    with torch.no_grad():
        y = torch.func.vmap(op.matvec)(x)
        assert widths == [3 * 12]          # one product, 10 -> 12 a member
        loop = torch.stack([op.matvec(xi) for xi in x])
    assert torch.equal(y, loop)

    def loss(xi):
        return (op.matvec(xi) ** 2).sum()
    widths.clear()
    grads = torch.func.vmap(torch.func.grad(loss))(x)
    assert widths == [3 * 12] * 2          # forward, backward
    assert torch.equal(grads, torch.stack([torch.func.grad(loss)(xi)
                                           for xi in x]))
    want = np.stack([2.0 * (g.L.T @ (g.L @ xi)) for xi in x.numpy()])
    assert rel_err(grads.numpy(), want) <= TOL


@pytest.mark.parametrize("fin,fout", [(6, 10), (10, 3)],
                         ids=["input-side", "clenshaw"])
def test_cheb_conv_ell_matches_jax(graph, fin, fout):
    L = graph.L
    n, B, K = L.shape[0], 2, 3
    op = ChebOperator(ell=EllOperator.from_scipy(
        L, symmetric=graph.is_symmetric, device="cpu"))
    jop = JChebOperator.from_graph(graph, mode="ell")
    x_np, w_np, b_np = _np((B, n, fin), 5), _np((fin, K, fout), 6), _np(
        (fout,), 7)
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np).requires_grad_()
    y = cheb_conv(op, x, w, torch.from_numpy(b_np))
    yj, vjp = jax.vjp(lambda a, b: jcheb_conv(jop, a, b, jnp.asarray(b_np)),
                      jnp.asarray(x_np), jnp.asarray(w_np))
    assert y.shape == (B, n, fout)
    assert rel_err(y.detach().numpy(), np.asarray(yj)) <= TOL
    g_np = _np((B, n, fout), 8)
    y.backward(torch.from_numpy(g_np))
    gx, gw = vjp(jnp.asarray(g_np))
    assert rel_err(x.grad.numpy(), np.asarray(gx)) <= TOL
    assert rel_err(w.grad.numpy(), np.asarray(gw)) <= TOL


def test_cheb_operator_from_graph_ell():
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=KNN,
                    graph_type="voronoi")
    op = ChebOperator.from_graph(g, mode="ell", device="cpu")
    cols, vals = g.laplacian_ell()
    assert op.dense is None and op.bcsr is None
    assert torch.equal(op.ell.cols, torch.from_numpy(cols))
    assert torch.equal(op.ell.vals, torch.from_numpy(vals))
    assert not op.ell.symmetric
    x = torch.from_numpy(_np((g.n_nodes, 5), 9))
    assert rel_err(op.matvec(x).numpy(), g.L @ x.numpy()) <= TOL
    with pytest.raises(ValueError, match="'dense', 'bcsr' or 'ell'"):
        ChebOperator.from_graph(g, mode="coo", device="cpu")


SUBDIV, B = 8, 2
V = 12 * SUBDIV ** 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
INFO = {"input_n_feature": F_DYN + F_BC + F_STATIC, "output_n_feature": F_DYN,
        "input_n_time": 3, "output_n_time": 1,
        "input_shape_info": {"dynamic": {"node": V}},
        "output_shape_info": {"dynamic": {"node": V}}}


@pytest.fixture(scope="module")
def unet_pair():
    """fp32 models with levels 0 and 1 block-sparse (768 and 192 nodes
    above the threshold), the same seeded weights."""
    kw = dict(knn=KNN, pool_method="max", increment_learning=True,
              numeric_precision="float32", dense_threshold=V // 4 - 1)
    samp = {"subdivisions": SUBDIV, "nest": True}
    model = UNetSpherical(INFO, "healpix", samp, device="cpu", **kw)
    jmodel = JUNetSpherical(INFO, "healpix", samp, **kw)
    tree = seeded_params(model, 3)
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree)


def test_unet_block_sparse_fp32_matches_jax(unet_pair, monkeypatch):
    model, jmodel, jparams = unet_pair
    ops = model.geometry.cheb_ops
    assert [o.bcsr is not None for o in ops] == [True, True, False]
    assert [o.ell_cols is not None for o in jmodel.geometry.cheb_ops] == [
        True, True, False]
    calls = {"ell": 0, "bcsr": 0}

    def count(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(bcsr_mod, "ell_spmm_reference",
                        count("ell", bcsr_mod.ell_spmm_reference))
    monkeypatch.setattr(bcsr_mod, "bcsr_super_spmm_reference",
                        count("bcsr", bcsr_mod.bcsr_super_spmm_reference))
    x_np = _np((B, 3, V, F_DYN + F_BC + F_STATIC), 10)
    g_np = _np((B, 1, V, F_DYN), 11)
    before = dict(launch_counts)
    model.zero_grad(set_to_none=True)
    y = model(torch.from_numpy(x_np))
    (y * torch.from_numpy(g_np)).sum().backward()
    # 10 + 8 products forward at levels 0 and 1, as many backward but the
    # first convolution's 2 (its input needs no gradient)
    assert calls == {"ell": 18 + 16, "bcsr": 0}
    assert launch_counts == before            # plain versions on the CPU
    def fwd_bwd(params, xj, gj):
        yj, vjp = jax.vjp(lambda p: jmodel.apply(p, xj), params)
        return yj, vjp(gj)[0]
    yj, gj = jax.jit(fwd_bwd)(jparams, jnp.asarray(x_np), jnp.asarray(g_np))
    assert rel_err(y.detach().numpy(), np.asarray(yj)) <= TOL
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(gj)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        r = np.asarray(flat_ref[path])
        if np.abs(r).max() > 0:
            assert rel_err(g, r) <= TOL, jax.tree_util.keystr(path)


def test_export_traces_through_the_ell_op(unet_pair):
    model, _, _ = unet_pair
    x = torch.from_numpy(_np((B, 3, V, F_DYN + F_BC + F_STATIC), 12))
    with torch.no_grad():
        ep = torch.export.export(model, (x,), strict=False)
        want = model(x)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "deepsphere_weather_torch.spmm_ell.default" in targets
    assert "deepsphere_weather_torch.spmm.default" not in targets
    with torch.no_grad():
        assert torch.equal(ep.module()(x), want)


@pytest.mark.parametrize("op_dt,x_dt,route", [
    (torch.float32, torch.float32, "ell"),
    (torch.float32, torch.bfloat16, "bcsr_super"),
    (torch.bfloat16, torch.bfloat16, "bcsr_super"),
    (torch.bfloat16, torch.float32, "bcsr_super")])
def test_counters_route_by_dtype(op_dt, x_dt, route, monkeypatch):
    g = build_graph("healpix", {"subdivisions": 4, "nest": True}, k=KNN)
    op = BlockSparseOperator.from_scipy(g.L, dtype=op_dt, device="cpu")
    assert (op.ell is not None) == (op_dt == torch.float32)
    calls = []
    for name in ("ell_spmm_reference", "bcsr_super_spmm_reference",
                 "bcsr_spmm_reference"):
        fn = getattr(bcsr_mod, name)

        def run(*args, fn=fn, name=name, **kw):
            calls.append(name[:-len("_spmm_reference")])
            return fn(*args, **kw)
        monkeypatch.setattr(bcsr_mod, name, run)
    x = torch.from_numpy(_np((g.n_nodes, 8), 13)).to(x_dt).requires_grad_()
    y = op.matvec(x)
    y.float().sum().backward()
    assert calls == [route, route]
    assert y.dtype == (torch.bfloat16 if x_dt == torch.bfloat16
                       else torch.float32)
