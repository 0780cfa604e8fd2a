"""Port UNetSpherical over every sampling, graph type and pool method vs
the JAX package: the configurations of chip_smoke.py's grids400 phase at
tiny stand-ins.

One model per grids400 configuration, at a tiny stand-in of its own
sampling (equiangular 8x16 and 10x20 — odd dimensions at the coarsest
level —, icosahedral 4, cubed 4, gauss nlat 8, HEALPix-4), knn 8, level 0
forced block-sparse on both sides (`dense_threshold = V - 1`; JAX: Pallas
in interpret mode, port: the kernel's plain version). Every parameter, the
learned pools' logits included, is drawn from np.random.default_rng and
loaded on both sides through `weights.py`. Forward at fp32 1e-5 and bf16
3e-2 (max abs error over max abs of the JAX output); one AR1 training loss
(area-weighted MSE, RNN strategy) and its gradients per key at fp32 1e-5,
a one-element gradient (ReZero weight, increment scale: one sum whose
terms cancel) against the sum of its terms' magnitudes
(`torch_grad_terms`), as `tests/test_torch_train.py` holds them. The
voronoi rows run level 0's backward on the transposed super-row layout.
The helpers here serve `tests/test_torch_configs.py` too."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_ar_loss_fn as jmake_ar_loss_fn,
    make_context,
)
from deepsphere_weather_tpu.models import get_model as jget_model  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import AreaWeights, make_ar_loss_fn  # noqa: E402
from deepsphere_weather_torch.models import get_model  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    seeded_params,
)
from torch_grad_terms import term_sums  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

KNN, B = 8, 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
F_IN = F_DYN + F_BC + F_STATIC
INPUT_K = [-3, -2, -1]
TOL = {"fp32": 1e-5, "bf16": 3e-2}
PRECISION = {"fp32": "float32", "bf16": "bfloat16"}
# a tiny stand-in of each shipped sampling directory
STAND_IN = {
    "Healpix_400km": ("healpix", {"subdivisions": 4, "nest": True}),
    "Healpix_100km": ("healpix", {"subdivisions": 4, "nest": True}),
    "Equiangular_400km": ("equiangular", {"nlat": 8, "nlon": 16}),
    "Equiangular_400km_tropics": ("equiangular", {"nlat": 10, "nlon": 20}),
    "Icosahedral_400km": ("icosahedral", {"subdivisions": 4}),
    "Cubed_400km": ("cubed", {"subdivisions": 4}),
    "O24": ("gauss", {"nlat": 8, "nlon": "ecmwf-octahedral"}),
}
# chip_smoke.py's grids400 configurations (sampling directory, pool,
# graph type)
GRIDS400 = [("Equiangular_400km", "max", "voronoi"),
            ("Equiangular_400km_tropics", "avg", "knn"),
            ("Icosahedral_400km", "learn", "mesh"),
            ("Cubed_400km", "maxarea", "knn"),
            ("O24", "maxval", "voronoi"),
            ("Healpix_400km", "interp", "mesh")]


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def tensor_info(n, n_in=None, f_in=F_IN):
    return {"input_n_feature": f_in, "output_n_feature": F_DYN,
            "input_n_time": len(INPUT_K), "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": n if n_in is None
                                             else n_in}},
            "output_shape_info": {"dynamic": {"node": n}}}


def seeded_tree(model, seed):
    tree = seeded_params(model, seed)
    for block in tree.values():
        if isinstance(block, dict) and "rezero_weight" in block:
            block["rezero_weight"] *= 0.1
    return tree


def build_grid_pair(sampling_dir, pool, graph, dt, seed=0):
    """(port model, JAX model, JAX params), level 0 block-sparse on both
    sides, the same seeded weights."""
    name, kw = STAND_IN[sampling_dir]
    n = build_sampling(name, kw).n_nodes
    common = dict(sampling=name, sampling_kwargs=kw, knn=KNN,
                  pool_method=pool, graph_type=graph,
                  increment_learning=True, numeric_precision=PRECISION[dt])
    model = get_model("UNetSpherical", tensor_info(n), dense_threshold=n - 1,
                      device="cpu", **common)
    jmodel = jget_model("UNetSpherical", tensor_info(n), **common)
    L = jbuild_graph(name, kw, k=KNN, graph_type=graph).L
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            L, symmetric=graph in ("knn", "mesh"), interpret=True,
            dtype=jnp.bfloat16 if dt == "bf16" else np.float32))
    tree = seeded_tree(model, seed)
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree)


def grads_tree(model):
    return params_to_jax({k: p.grad for k, p in model.named_parameters()})


def assert_trees_close(got, ref, tol, sums=None):
    """Key by key, max abs error over max abs of the reference; with
    `sums` ({port parameter name: sum of its terms' magnitudes}), a
    one-element gradient over that sum instead (`torch_grad_terms`)."""
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_ref)
    scales = {"".join(f"[{p!r}]" for p in k.split(".")): v
              for k, v in (sums or {}).items()}
    for path, g in flat_got:
        r = np.asarray(flat_ref[path])
        key = jax.tree_util.keystr(path)
        if sums is not None and r.size == 1:
            e = np.abs(np.asarray(g, np.float64) - r).max() / scales[key]
        else:
            e = rel_err(g, r)
        assert e <= tol, (key, e)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("sampling_dir,pool,graph", GRIDS400,
                         ids=[f"{s}-{p}-{g}" for s, p, g in GRIDS400])
def test_grids400_forward_matches_jax(sampling_dir, pool, graph, dt):
    model, jmodel, jparams = build_grid_pair(sampling_dir, pool, graph, dt)
    op = model.geometry.cheb_ops[0].bcsr
    assert op is not None and all(o.dense is not None
                                  for o in model.geometry.cheb_ops[1:])
    assert op.svals.dtype == (torch.bfloat16 if dt == "bf16"
                              else torch.float32)
    # voronoi's M^-1 L is not symmetric: its backward runs the
    # transposed super-row layout
    assert (op.svals_t is not None) == (graph == "voronoi")
    assert op.transpose_layout()[1] is (op.svals_t if graph == "voronoi"
                                        else op.svals)
    if pool == "learn":
        assert {"pool0", "unpool0", "pool1", "unpool1"} <= set(jparams)
    n = model.input_n_node
    x = np.random.default_rng(11).standard_normal(
        (B, len(INPUT_K), n, F_IN)).astype(np.float32)
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    jy = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    assert y.shape == (B, 1, n, F_DYN)
    assert rel_err(y.numpy(), np.asarray(jy)) <= TOL[dt]


@pytest.mark.parametrize("sampling_dir,pool,graph", GRIDS400,
                         ids=[f"{s}-{p}-{g}" for s, p, g in GRIDS400])
def test_grids400_training_gradients_match_jax(sampling_dir, pool, graph):
    model, jmodel, jparams = build_grid_pair(sampling_dir, pool, graph,
                                             "fp32", seed=1)
    n = model.input_n_node
    settings = (INPUT_K, [0], 1, 1)
    indexer, jindexer = ARIndexer.build(*settings), JARIndexer.build(*settings)
    rng = np.random.default_rng(21)
    W = indexer.window_size
    batch = {"dynamic": rng.standard_normal((B, W, n, F_DYN)),
             "bc": rng.standard_normal((B, W, n, F_BC)),
             "static": rng.standard_normal((n, F_STATIC))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    area_w = AreaWeights(model.geometry.samplings[0], device="cpu")
    w = np.array([1.0, 0.5], np.float32)

    sums = term_sums(model)
    total, per_iter = make_ar_loss_fn(model, indexer, 2)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, w, area_w)
    total.backward()
    jloss = jmake_ar_loss_fn(jmodel, jindexer, 2)
    ctx = make_context(jmodel, jnp.asarray(area_w.numpy()))
    (jtotal, jper_iter), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams, jax.tree_util.tree_map(
            jnp.asarray, batch), jnp.asarray(w), ctx)
    assert rel_err(per_iter.detach().numpy(), np.asarray(jper_iter)) <= 1e-5
    grads = grads_tree(model)
    if pool == "learn":
        assert float(np.abs(grads["pool0"]).max()) > 0
        assert float(np.abs(grads["unpool0"]).max()) > 0
    assert_trees_close(grads, jgrads, TOL["fp32"], sums=sums)
