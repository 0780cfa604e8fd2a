"""Port model vs the JAX package at HEALPix-8 (768 / 192 / 48 nodes, knn 8),
level 0 forced through the block-sparse operator on both sides (JAX:
Pallas in interpret mode; port: the kernel's plain version). Every
parameter, the zero-initialized ReZero weights and increment scale
included, is drawn from np.random.default_rng and loaded on both sides
through `weights.py`, so every convolution branch contributes.

Tolerances (max abs error / max abs of the reference): fp32 1e-5 per
block and for the model (summation order only; 1e-4 for the 6-step
rollout, where errors feed back), bf16 3e-2 (bf16 roundings at the same
cast points, in a different summation order)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_rollout_block as jmake_rollout_block,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine.step import make_rollout_block  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    seeded_params,
)

SUBDIV, KNN, B = 8, 8, 2
V = 12 * SUBDIV ** 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
F_IN = F_DYN + F_BC + F_STATIC
INPUT_K, OUTPUT_K = [-3, -2, -1], [0]
TOL = {"fp32": 1e-5, "bf16": 3e-2}
PRECISION = {"fp32": "float32", "bf16": "bfloat16"}
LEVEL = {"conv1": 0, "conv2": 1, "conv3": 2, "uconv2": 1, "uconv1": 0,
         "uconv1_final": 0}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def tensor_info():
    return {
        "input_n_feature": F_IN, "output_n_feature": F_DYN,
        "input_n_time": len(INPUT_K), "output_n_time": len(OUTPUT_K),
        "input_shape_info": {"dynamic": {"node": V}},
        "output_shape_info": {"dynamic": {"node": V}},
    }


def build_pair(dt, seed=0):
    """(port model, JAX model, JAX params) with identical seeded weights."""
    model = UNetSpherical(
        tensor_info(), "healpix", {"subdivisions": SUBDIV, "nest": True},
        knn=KNN, pool_method="max", increment_learning=True,
        numeric_precision=PRECISION[dt], dense_threshold=V - 1, device="cpu")
    jmodel = JUNetSpherical(
        tensor_info(), "healpix", {"subdivisions": SUBDIV, "nest": True},
        knn=KNN, pool_method="max", increment_learning=True,
        numeric_precision=PRECISION[dt])
    g0 = jbuild_graph("healpix", {"subdivisions": SUBDIV, "nest": True}, k=KNN)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            g0.L, symmetric=True, interpret=True,
            dtype=jnp.bfloat16 if dt == "bf16" else np.float32))
    tree = seeded_params(model, seed)
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request):
    return (request.param,) + build_pair(request.param)


def test_geometry_forces_level0_bcsr(pair):
    _, model, _, _ = pair
    ops = model.geometry.cheb_ops
    assert ops[0].bcsr is not None and ops[1].dense is not None
    want = torch.bfloat16 if model.compute_dtype == torch.bfloat16 else torch.float32
    assert ops[0].bcsr.svals.dtype == want


def test_weight_bridge_keeps_jax_layout(pair):
    dt, model, jmodel, jparams = pair
    jinit = jmodel.init(jax.random.key(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jinit)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams) == shapes
    back = params_to_jax(model.state_dict())
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                               jax.tree_util.tree_flatten_with_path(jparams)[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(kp))
    assert float(back["conv1"]["rezero_weight"][0]) != 0.0
    assert float(back["res_increment"][0]) != 0.0


@pytest.mark.parametrize("name", list(LEVEL))
def test_resblock_matches_jax(pair, name):
    dt, model, jmodel, jparams = pair
    lvl = LEVEL[name]
    blk = getattr(model, name)
    n = model.geometry.n_nodes[lvl]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, n, blk.in_channels)).astype(np.float32)
    y = blk(torch.from_numpy(x).to(model.compute_dtype),
            cheb_op=model.geometry.cheb_ops[lvl])
    yj = jmodel._blocks[name].apply(
        jparams[name], jnp.asarray(x, jmodel.compute_dtype),
        cheb_op=jmodel.geometry.cheb_ops[lvl])
    assert y.dtype == model.compute_dtype
    assert rel_err(y.detach().float().numpy(), np.asarray(yj, np.float32)) <= TOL[dt]


def test_unet_matches_jax(pair):
    dt, model, jmodel, jparams = pair
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, len(INPUT_K), V, F_IN)).astype(np.float32)
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    yj = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    assert y.dtype == torch.float32 and y.shape == (B, 1, V, F_DYN)
    assert rel_err(y.numpy(), np.asarray(yj)) <= TOL[dt]


def test_rollout_blocks_match_jax():
    # 2 blocks of 3 steps with boundary conditions and static features;
    # the history carry threads from block to block on both sides
    model, jmodel, jparams = build_pair("fp32", seed=1)
    indexer = ARIndexer.build(INPUT_K, OUTPUT_K, 1, 1)
    jindexer = JARIndexer.build(INPUT_K, OUTPUT_K, 1, 1)
    rollout, H = make_rollout_block(model, indexer, 3)
    jrollout, jH = jmake_rollout_block(jmodel, jindexer, 3)
    assert H == jH == 4
    rng = np.random.default_rng(13)
    hist = rng.standard_normal((B, H, V, F_DYN)).astype(np.float32)
    static = rng.standard_normal((V, F_STATIC)).astype(np.float32)
    geom = jmodel.geometry_pytree()
    h, jh = torch.from_numpy(hist), jnp.asarray(hist)
    for blk in range(2):
        bc = rng.standard_normal(
            (B, 3, len(INPUT_K), V, F_BC)).astype(np.float32)
        h, _, preds = rollout(h, None, torch.from_numpy(bc),
                              torch.from_numpy(static))
        jh, _, jpreds = jrollout(jparams, jh, None, jnp.asarray(bc),
                                 jnp.asarray(static), geom)
        assert preds.shape == (B, 3, 1, V, F_DYN)
        assert rel_err(preds.numpy(), np.asarray(jpreds)) <= 1e-4, blk
        assert rel_err(h.numpy(), np.asarray(jh)) <= 1e-4, blk


def test_rollout_keep_first_mask_matches_jax():
    # overlapping output windows with stack_most_recent_prediction=False:
    # the keep-first written-mask decides which prediction is fed back and
    # must thread across blocks (HEALPix-4, dense levels, no BC or static)
    kw = {"subdivisions": 4, "nest": True}
    n = 12 * 4 ** 2
    info = {"input_n_feature": F_DYN, "output_n_feature": F_DYN,
            "input_n_time": 2, "output_n_time": 2,
            "input_shape_info": {"dynamic": {"node": n}},
            "output_shape_info": {"dynamic": {"node": n}}}
    model = UNetSpherical(info, "healpix", kw, knn=KNN, pool_method="max",
                          increment_learning=True, device="cpu")
    jmodel = JUNetSpherical(info, "healpix", kw, knn=KNN, pool_method="max",
                            increment_learning=True)
    tree = seeded_params(model, 2)
    model.load_state_dict(params_from_jax(tree))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    args = ([-2, -1], [0, 1], 1, 1)
    rollout, H = make_rollout_block(
        model, ARIndexer.build(*args, stack_most_recent_prediction=False), 3)
    jrollout, _ = jmake_rollout_block(
        jmodel, JARIndexer.build(*args, stack_most_recent_prediction=False), 3)
    with pytest.raises(ValueError, match="wmask"):
        rollout(torch.zeros(B, H, n, F_DYN), None, None, None)
    rng = np.random.default_rng(14)
    hist = rng.standard_normal((B, H, n, F_DYN)).astype(np.float32)
    h, w = torch.from_numpy(hist), torch.zeros(H, dtype=torch.bool)
    jh, jw = jnp.asarray(hist), jnp.zeros((H,), bool)
    geom = jmodel.geometry_pytree()
    for blk in range(2):
        h, w, preds = rollout(h, w, None, None)
        jh, jw, jpreds = jrollout(jparams, jh, jw, None, None, geom)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert preds.shape == (B, 3, 2, n, F_DYN)
        assert rel_err(preds.numpy(), np.asarray(jpreds)) <= 1e-4, blk
        assert rel_err(h.numpy(), np.asarray(jh)) <= 1e-4, blk
