"""Node- and data-parallel training of the port vs the JAX package.

- The row-range products (the plain versions of K2 and of K3's row-sharded
  form) against the rows of the full products, exactly, for aligned and
  unaligned ranges; and against the rows of the JAX interpret-mode
  `BlockSparseOperator.matvec` (fp32 1e-5, bf16 2e-2 of the max abs).
- The row-sharded operator's gradient on 2 spawned `gloo` ranks: the
  ranks' rows of d/dx sum((Lx)^2) against 2 L^T (L x) (1e-5), for the knn
  L and a non-symmetric D L, super-row and plain layouts.
- The mesh helpers' validation, as `tests/test_parallel.py` holds the JAX
  ones (the member axis counted), and `shard_geometry`'s refusal of an
  uneven level.
- One train step of HEALPix-8 UNetSpherical (level 0 block-sparse, AR2,
  RNN, Adam, batch 4) on 1 x 2, 2 x 1 and 2 x 2 meshes of spawned ranks
  against the JAX single-device `make_train_step` at the same weights and
  batch, with the bars of `tests/test_parallel.py`: loss rel 1e-4,
  parameters atol 1e-5 in fp32; both 3e-2 in bf16. The gradients Adam
  steps on, reduced over the mesh, against `jax.grad` of the JAX loss,
  per key (max abs error over max abs: fp32 1e-5, bf16 3e-2, a
  one-element bf16 gradient over the sum of its terms' magnitudes, as
  `tests/test_torch_train.py` holds the unsharded ones): Adam's first
  update has the size lr whatever the gradient's, so only this check sees
  a wrong reduction. Every rank holds the same parameters after the step,
  and one forward gathers once per Laplacian product (22).

Ranks run `tests/torch_parallel_worker.py` (torch only, no JAX) under a
60 s process-group timeout; each run of ranks is limited to 120 s. Every
run of ranks starts at once, and the JAX reference is computed while
they work.
"""

import jax
import numpy as np
import pytest
from scipy import sparse

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.loss import weighted_mse as jweighted_mse  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_ar_loss_fn as jmake_ar_loss_fn,
    make_context,
    make_train_step as jmake_train_step,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    AreaWeights,
    make_ar_loss_fn,
    weighted_mse,
)
from deepsphere_weather_torch.engine.step import _node_weights  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical, shard_geometry  # noqa: E402
from deepsphere_weather_torch.ops import (  # noqa: E402
    BlockSparseOperator,
    bcsr_from_scipy,
    bcsr_spmm,
    bcsr_spmm_rows,
    bcsr_spmm_rows_reference,
    bcsr_super_from_scipy,
    bcsr_super_spmm,
    bcsr_super_spmm_rows,
    launch_counts,
)
from deepsphere_weather_torch.ops.bcsr import _run_rows  # noqa: E402
from deepsphere_weather_torch.parallel import (  # noqa: E402
    ProcessMesh,
    make_mesh,
    node_range,
    shard_batch,
    training_mesh,
)
from deepsphere_weather_torch.sphere import build_graph, build_sampling  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax, seeded_params  # noqa: E402
from torch_grad_terms import term_sums  # noqa: E402
from torch_parallel_worker import (  # noqa: E402
    gradient_worker,
    join_ranks,
    start_ranks,
    train_worker,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

SUBDIV, KNN, N = 8, 8, 768
SAMPLING = {"subdivisions": SUBDIV, "nest": True}
F_DYN, F_BC, F_STATIC, BATCH = 2, 1, 2, 4
AR = ([-3, -2, -1], [0], 1, 2)
PRECISIONS = {"fp32": "float32", "bf16": "bfloat16"}
DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
JAX_TOL = {"fp32": 1e-5, "bf16": 2e-2}
# tests/test_parallel.py's bars: loss rel 1e-4 and parameters atol 1e-5 in
# fp32; bf16 roundings at the same cast points in another order: 3e-2
LOSS_TOL = {"fp32": 1e-4, "bf16": 3e-2}
PARAM_TOL = {"fp32": 1e-5, "bf16": 3e-2}
# gradients: tests/test_torch_train.py's bars
GRAD_TOL = {"fp32": 1e-5, "bf16": 3e-2}
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
# block-sparse products per model call: 5 convolutions at level 0, 4 at
# level 1, 2 at level 2, K - 1 = 2 products each
GATHERS_PER_FORWARD = 22


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def nonsymmetric(L):
    d = np.random.default_rng(0).uniform(0.5, 2.0, L.shape[0])
    return (sparse.diags(d.astype(np.float32)) @ L).tocsr().astype(np.float32)


@pytest.fixture(scope="module")
def graph():
    return build_graph("healpix", SAMPLING, k=KNN)


# ---------------------------------------------------------------------------
# Row-range products (plain versions of the kernels)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["super", "plain"])
def test_row_range_equals_rows_of_full_product(graph, dt, layout):
    # HEALPix-8: 6 row blocks, 3 super-rows; every range, aligned or not
    rng = np.random.default_rng(1)
    if layout == "super":
        a, idx, n_pad = bcsr_super_from_scipy(graph.L)
        full_fn, rows_fn, unit = bcsr_super_spmm, bcsr_super_spmm_rows, 256
    else:
        a, idx, n_pad = bcsr_from_scipy(graph.L)
        full_fn, rows_fn, unit = bcsr_spmm, bcsr_spmm_rows, 128
    a = torch.from_numpy(a).to(DT[dt])
    idx = torch.from_numpy(idx)
    x = torch.from_numpy(rng.standard_normal((n_pad, 192)).astype(
        np.float32)).to(DT[dt])
    full = full_fn(a, idx, x)
    before = dict(launch_counts)
    for b in range(a.shape[0]):
        for e in range(b + 1, a.shape[0] + 1):
            y = rows_fn(a, idx, x, b, e)
            assert y.dtype == DT[dt] and y.shape == ((e - b) * unit, 192)
            assert torch.equal(y, full[b * unit:e * unit])
    assert launch_counts == before          # plain versions on the CPU


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("rows_per_super", [2, 0], ids=["super", "plain"])
@pytest.mark.parametrize("n_node", [2, 3])
def test_row_shard_layouts_match_jax_rows(graph, dt, rows_per_super, n_node):
    # each node shard's rows of L @ x from its row-range launch: equal to
    # the full product's rows, and to the JAX operator's within its bar.
    # A 2-way split of 768 rows lands mid super-row (384 of 256 x 3)
    op = BlockSparseOperator.from_scipy(graph.L, dtype=DT[dt],
                                        rows_per_super=rows_per_super,
                                        device="cpu")
    op.ell = None      # fp32 x on the block layout (its own route: ELL)
    jop = JBlockSparseOperator.from_scipy(graph.L, m_tile=128, interpret=True,
                                          dtype=JAX_DT[dt])
    rng = np.random.default_rng(2)
    x_np = rng.standard_normal((N, 96)).astype(np.float32)
    x = torch.from_numpy(x_np).to(DT[dt])
    full = op.matvec(x)
    yj = np.asarray(jop.matvec(jnp.asarray(x_np, JAX_DT[dt])), np.float32)
    for r in range(n_node):
        v0, v1 = r * N // n_node, (r + 1) * N // n_node
        shard = op.row_shard(v0, v1, group=None)
        kind, a, _, _, r0, _ = shard.forward_layout()
        assert kind == ("super" if rows_per_super else "plain")
        unit = 256 if rows_per_super else 128
        assert r0 == v0 // unit * unit and a.shape[0] == -(-v1 // unit) - v0 // unit
        x_full = torch.nn.functional.pad(x, (0, 32))
        y = _run_rows(shard.forward_layout(), x_full, v0, v1)[:, :96]
        assert torch.equal(y, full[v0:v1])
        assert rel_err(y.float().numpy(), yj[v0:v1]) <= JAX_TOL[dt]


@pytest.mark.parametrize("round_a", [True, False])
def test_plain_row_range_keeps_both_regimes(graph, round_a):
    # fp32 A against bf16 x: each regime's row range is its full product's
    # rows (round_a=True rounds A to bf16, False keeps it fp32)
    vals, cols, n_pad = bcsr_from_scipy(graph.L)
    a, c = torch.from_numpy(vals), torch.from_numpy(cols)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n_pad, 128)).astype(np.float32)).to(torch.bfloat16)
    full = bcsr_spmm(a, c, x, round_a=round_a)
    y = bcsr_spmm_rows_reference(a, c, x, 2, 5, round_a=round_a)
    assert torch.equal(y, full[256:640])


def test_row_range_rejects_bad_input(graph):
    svals, ucols, n_pad = bcsr_super_from_scipy(graph.L)
    a, idx = torch.from_numpy(svals), torch.from_numpy(ucols)
    x = torch.zeros(n_pad, 128)
    for b, e in ((-1, 1), (0, 0), (2, 1), (0, 4), (3, 4)):
        with pytest.raises(ValueError, match="range"):
            bcsr_super_spmm_rows(a, idx, x, b, e)
    with pytest.raises(ValueError, match="128-row blocks"):
        bcsr_super_spmm_rows(a, idx, torch.zeros(n_pad - 1, 128), 0, 1)
    vals, cols, _ = bcsr_from_scipy(graph.L)
    with pytest.raises(ValueError, match="range"):
        bcsr_spmm_rows(torch.from_numpy(vals), torch.from_numpy(cols), x, 5, 7)


def test_row_shard_checks_block_columns(graph):
    # a shard whose block-columns address blocks past the full x is refused
    # once, when it is built
    op = BlockSparseOperator.from_scipy(graph.L, device="cpu")
    cut = BlockSparseOperator(256, svals=op.svals[:1], ucols=op.ucols[:1])
    assert int(op.ucols[:1].max()) >= 2
    with pytest.raises(ValueError, match="outside the full x"):
        cut.row_shard(0, 128, group=None)
    with pytest.raises(ValueError, match="not within"):
        op.row_shard(700, 800, group=None)


# ---------------------------------------------------------------------------
# The row-sharded operator's gradient on 2 ranks
# ---------------------------------------------------------------------------

GRAD_CASES = [("knn-super", True, 2), ("knn-plain", True, 0),
              ("DL-super", False, 2), ("DL-plain", False, 0)]


@pytest.mark.parametrize("case", range(len(GRAD_CASES)),
                         ids=[c[0] for c in GRAD_CASES])
def test_sharded_gradient_is_2_lt_l_x(runs, case):
    x, mats, ranks = runs["gradient"]
    _, sym, rps = GRAD_CASES[case]
    mat = mats[sym].astype(np.float64)
    parts = [r[case] for r in ranks]
    assert all(p["kind"] == ("super" if rps else "plain") for p in parts)
    y = np.concatenate([p["y"] for p in parts])
    grad = np.concatenate([p["grad"] for p in parts])
    assert rel_err(y, mat @ x) <= 1e-5
    assert rel_err(grad, 2.0 * (mat.T @ (mat @ x))) <= 1e-5
    if not sym:       # the premise: a symmetric backward would be wrong
        assert rel_err(2.0 * (mat @ (mat @ x)), mat.T @ (mat @ x) * 2) > 1e-2


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def test_mesh_validation():
    # tests/test_parallel.py:233-247, over ranks instead of devices
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(n_node=64, world_size=8, device="cpu")
    with pytest.raises(ValueError, match="needs"):
        make_mesh(n_data=8, n_node=3, world_size=8, device="cpu")
    with pytest.warns(UserWarning, match="idle"), \
            pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(n_node=3, world_size=8, device="cpu")
    # the member axis counts in each message, and a member mesh that fits
    # passes validation (to the process group it needs)
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(n_member=3, n_node=3, world_size=8, device="cpu")
    with pytest.raises(ValueError, match="needs 16 ranks"):
        make_mesh(n_data=2, n_node=2, n_member=4, world_size=8, device="cpu")
    with pytest.warns(UserWarning, match="idle"), \
            pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(n_member=3, world_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(n_member=2, world_size=8, device="cpu")
    assert training_mesh(1, 1, 1) is None
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        training_mesh(2, 2, device="cpu")


def _mesh(n_data, n_node, data_rank, node_rank):
    return ProcessMesh(data_rank=data_rank, n_data=n_data,
                       node_rank=node_rank, n_node=n_node, data_group=None,
                       node_group=None, device=torch.device("cpu"))


def test_shard_batch_and_ranges():
    rng = np.random.default_rng(5)
    batch = {"dynamic": rng.standard_normal((4, 5, 12, 2)),
             "bc": torch.from_numpy(rng.standard_normal((4, 5, 12, 1))),
             "static": rng.standard_normal((12, 3)), "time": np.arange(4)}
    mesh = _mesh(2, 3, 1, 2)
    assert mesh.rank == 5 and node_range(12, mesh) == (8, 12)
    out = shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["dynamic"].numpy(),
                                  batch["dynamic"][2:4, :, 8:12])
    np.testing.assert_array_equal(out["bc"].numpy(),
                                  batch["bc"].numpy()[2:4, :, 8:12])
    np.testing.assert_array_equal(out["static"].numpy(),
                                  batch["static"][8:12])
    assert out["time"] is batch["time"]
    assert all(v is batch[k] for k, v in shard_batch(batch, None).items())
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch({"dynamic": batch["dynamic"][:3]}, mesh)
    with pytest.raises(ValueError, match="do not divide"):
        node_range(10, mesh)


@pytest.mark.parametrize("weighted", [True, False], ids=["area", "unit"])
@pytest.mark.parametrize("n_node", [2, 4])
def test_loss_shares_sum_to_the_jax_loss(weighted, n_node):
    # each node rank's share: its nodes of the whole weights over their
    # whole sum, with no collective; the shares sum to the JAX loss
    rng = np.random.default_rng(6)
    pred, target = rng.standard_normal((2, 3, 4, N, 2)).astype(np.float32)
    w = (AreaWeights(build_sampling("healpix", SAMPLING), device="cpu")
         if weighted else None)
    ref = float(jweighted_mse(jnp.asarray(pred), jnp.asarray(target),
                              None if w is None else jnp.asarray(w.numpy())))
    shares = []
    for r in range(n_node):
        mesh = _mesh(1, n_node, 0, r)
        v0, v1 = node_range(N, mesh)
        weights, w_sum = _node_weights(w, v1 - v0, mesh)
        assert weights is None if w is None else torch.equal(weights, w[v0:v1])
        shares.append(float(weighted_mse(
            torch.from_numpy(pred[..., v0:v1, :]),
            torch.from_numpy(target[..., v0:v1, :]), weights, w_sum=w_sum)))
    assert sum(shares) == pytest.approx(ref, rel=1e-6)
    assert _node_weights(w, N, _mesh(2, 1, 0, 0)) == (w, None)
    if weighted:       # the rank's weights, not the whole vector
        with pytest.raises(ValueError, match="area_w has"):
            _node_weights(w[:N // n_node], N // n_node, _mesh(1, n_node, 0, 0))


def test_shard_geometry_refuses_an_uneven_level():
    info = tensor_info()
    model = UNetSpherical(info, "healpix", SAMPLING, knn=KNN, device="cpu")
    geom = model.geometry
    assert shard_geometry(geom, None) is geom
    assert shard_geometry(geom, _mesh(2, 1, 0, 0)) is geom
    # 768 / 192 / 48 nodes over 5 and over 64 node ranks
    for n_node in (5, 64):
        with pytest.raises(ValueError, match="do not divide over"):
            shard_geometry(geom, _mesh(1, n_node, 0, 0))


# ---------------------------------------------------------------------------
# One train step on a mesh against the JAX single-device step
# ---------------------------------------------------------------------------

def tensor_info():
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": 3, "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": N}},
            "output_shape_info": {"dynamic": {"node": N}}}


def _weights_and_batch():
    """Each precision's seeded weights (port state dict and JAX tree), the
    batch, the AR weights and the area weights."""
    rng = np.random.default_rng(21)
    W = JARIndexer.build(*AR).window_size
    batch = {"dynamic": rng.standard_normal((BATCH, W, N, F_DYN)),
             "bc": rng.standard_normal((BATCH, W, N, F_BC)),
             "static": rng.standard_normal((N, F_STATIC))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    w = np.linspace(1.0, 0.5, 3).astype(np.float32)
    area_w = AreaWeights(build_sampling("healpix", SAMPLING),
                         device="cpu").numpy()
    trees = {}
    for dt, prec in PRECISIONS.items():
        model = UNetSpherical(tensor_info(), "healpix", SAMPLING, knn=KNN,
                              pool_method="max", increment_learning=True,
                              numeric_precision=prec, dense_threshold=N - 1,
                              device="cpu")
        trees[dt] = seeded_params(model, 3)
        for block in trees[dt].values():
            if isinstance(block, dict):
                block["rezero_weight"] *= 0.1
    return trees, batch, w, area_w


def _state_dict(tree):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_steps(trees, batch, w, area_w):
    """The JAX single-device step's total, per-iteration losses and
    parameters after it, and `jax.grad` of its loss at the step's
    weights (both as port state dicts), at each precision."""
    g0 = jbuild_graph("healpix", SAMPLING, k=KNN)
    out = {}
    for dt, prec in PRECISIONS.items():
        jmodel = JUNetSpherical(tensor_info(), "healpix", SAMPLING, knn=KNN,
                                pool_method="max", increment_learning=True,
                                numeric_precision=prec)
        jmodel.geometry.cheb_ops[0] = JChebOperator(
            bcsr=JBlockSparseOperator.from_scipy(
                g0.L, symmetric=True, interpret=True, dtype=JAX_DT[dt]))
        jindexer = JARIndexer.build(*AR)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        ctx = make_context(jmodel, jnp.asarray(area_w))
        _, grads = jax.jit(jax.value_and_grad(
            jmake_ar_loss_fn(jmodel, jindexer, 3, "RNN"), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, trees[dt]), jbatch,
                jnp.asarray(w), ctx)
        jparams = jax.tree_util.tree_map(jnp.asarray, trees[dt])
        opt = optax.adam(1e-3, eps=1e-7)
        step = jmake_train_step(jmodel, jindexer, opt, 3, "RNN")
        p, _, total, per_iter = step(jparams, opt.init(jparams), jbatch,
                                     jnp.asarray(w), ctx)
        out[dt] = {"total": float(total), "per_iter": np.asarray(per_iter),
                   "params": _state_dict(p), "grads": _state_dict(grads)}
    return out


def _term_sums(trees, batch, w, area_w):
    """The sums of terms' magnitudes of the one-element bf16 gradients
    (`torch_grad_terms`), from the unsharded port model's backward at the
    step's weights and batch."""
    model = UNetSpherical(tensor_info(), "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          numeric_precision="bfloat16", dense_threshold=N - 1,
                          device="cpu")
    model.load_state_dict(params_from_jax(trees["bf16"]))
    sums = term_sums(model)
    total, _ = make_ar_loss_fn(model, ARIndexer.build(*AR), 3, "RNN")(
        {k: torch.from_numpy(v) for k, v in batch.items()}, w,
        torch.from_numpy(area_w))
    total.backward()
    return sums


@pytest.fixture(scope="module")
def runs(graph, tmp_path_factory):
    """Every run of ranks (the sharded gradients on 2 ranks, one train
    step on each mesh) started at once; the JAX reference computed while
    they run; then their results."""
    trees, batch, w, area_w = _weights_and_batch()
    x = np.random.default_rng(4).standard_normal((N, 40)).astype(np.float32)
    mats = {True: graph.L.astype(np.float32), False: nonsymmetric(graph.L)}
    handles = {"gradient": start_ranks(
        gradient_worker, 2, tmp_path_factory.mktemp("grad"),
        [(mats[sym], sym, rps, x) for _, sym, rps in GRAD_CASES])}
    for name, (n_data, n_node) in MESHES.items():
        cfg = {"n_data": n_data, "n_node": n_node, "n": N, "knn": KNN,
               "n_in": F_DYN + F_BC + F_STATIC, "info": tensor_info(),
               "sampling": SAMPLING, "ar": AR, "batch": batch, "w": w,
               "area_w": area_w,
               "runs": {PRECISIONS[dt]: params_from_jax(tree)
                        for dt, tree in trees.items()}}
        handles[name] = start_ranks(train_worker, n_data * n_node,
                                    tmp_path_factory.mktemp(f"mesh{name}"),
                                    cfg)
    try:
        reference = _jax_steps(trees, batch, w, area_w)
        reference["bf16"]["sums"] = _term_sums(trees, batch, w, area_w)
    finally:
        results = {name: join_ranks(h) for name, h in handles.items()}
    results["gradient"] = (x, mats, results["gradient"])
    results["reference"] = reference
    return results


@pytest.fixture(params=list(MESHES))
def mesh_run(request, runs):
    n_data, n_node = MESHES[request.param]
    return n_data, n_node, runs[request.param]


@pytest.fixture
def reference(runs):
    return runs["reference"]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_mesh_step_losses_match_jax(mesh_run, reference, dt):
    _, _, ranks = mesh_run
    ref = reference[dt]
    for r in ranks:
        got = r[PRECISIONS[dt]]
        assert rel_err(got["total"], ref["total"]) <= LOSS_TOL[dt]
        assert rel_err(got["per_iter"], ref["per_iter"]) <= LOSS_TOL[dt]
        # the validation step, before the update, gives the same loss
        assert got["val_total"] == pytest.approx(got["total"], rel=1e-6)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_mesh_step_params_match_jax(mesh_run, reference, dt):
    _, _, ranks = mesh_run
    ref = reference[dt]["params"]
    params = ranks[0][PRECISIONS[dt]]["params"]
    assert set(params) == set(ref)
    for k, v in params.items():
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=PARAM_TOL[dt],
                                   err_msg=k)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_mesh_step_gradients_match_jax(mesh_run, reference, dt):
    # the gradients Adam stepped on, on every rank: the node ranks' shares
    # summed, the data shards averaged, equal to the single-device gradient
    _, _, ranks = mesh_run
    ref = reference[dt]["grads"]
    sums = reference[dt].get("sums", {})
    for r in ranks:
        grads = r[PRECISIONS[dt]]["grads"]
        assert set(grads) == set(ref)
        for k, g in grads.items():
            if k in sums:
                e = np.abs(g.astype(np.float64) - ref[k]).max() / sums[k]
            else:
                e = rel_err(g, ref[k])
            assert e <= GRAD_TOL[dt], (k, e)


def test_mesh_ranks_hold_identical_params(mesh_run):
    n_data, n_node, ranks = mesh_run
    assert [(r["data_rank"], r["node_rank"]) for r in ranks] == [
        (d, j) for d in range(n_data) for j in range(n_node)]
    for prec in PRECISIONS.values():
        for r in ranks[1:]:
            for k, v in r[prec]["params"].items():
                np.testing.assert_array_equal(v, ranks[0][prec]["params"][k],
                                              err_msg=k)


def test_mesh_forward_gathers_once_per_product(mesh_run):
    _, n_node, ranks = mesh_run
    want = GATHERS_PER_FORWARD if n_node > 1 else 0
    for r in ranks:
        assert [r[p]["gathers"] for p in PRECISIONS.values()] == [want] * 2
    if len(ranks) == 4:     # 4 ranks over n_node=3: one idle, warned
        assert all(r["idle_warning"] for r in ranks)
        assert [r["idle_mesh"] for r in ranks] == [(1, 3)] * 3 + [None]
