"""Node-sharded training of non-nested geometries vs the JAX package.

The six geometries that `shard_geometry` refused before remap and
equiangular pools gathered over the node group (HEALPix-4 with 'interp'
and 'learn' pools, equiangular 8x16 with 'max' pools and with 'avg'
pools and `conv_type='image'`, Gauss nlat 8 with 'maxval', cubed 4 with
'maxarea'; knn 8, the tiny stand-ins of `tests/test_torch_grids400.py`;
the port's level 0 block-sparse, its row shards on the plain versions of
K2 and of the dense product, the JAX model's dense, its own default at
these sizes: `tests/test_torch_grids400.py` holds the block-sparse
operator against the JAX one in Pallas interpret mode), each UNetSpherical with seeded weights
(the learned pools' logits included), one AR1 train step (RNN, batch 2,
Adam lr 1e-4, eps 1e-3) on a 1 x 2 node mesh of spawned `gloo` ranks:
every pool and unpool of these geometries, and the image convolution,
gathers its input over the node group and keeps the rank's rows (its
backward a reduce-scatter, `parallel.gather_nodes`). Against the JAX
single-device loss and `jax.grad` at the same weights and batch:

- the global loss, fp32 1e-5;
- the gradients Adam stepped on, reduced over the node group, per key
  (max abs error over max abs, fp32 1e-5; a one-element gradient over
  the sum of its terms' magnitudes, `torch_grad_terms`), the learned
  pools' logits included;
- the parameters after the step against optax's Adam on the JAX
  gradients, fp32 1e-5, identical on both ranks;
- each level's node range, and the pools wrapped as `ShardedPool` /
  `ShardedUnpool`.

A copy whose gather kept only the rank's own rows of the gradient (no
reduce-scatter) failed here: conv1's ReZero weight read 1.5e-4 apart,
over its terms' sum.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    make_ar_loss_fn as jmake_ar_loss_fn,
    make_context,
)
from deepsphere_weather_tpu.models import get_model as jget_model  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import AreaWeights, make_ar_loss_fn  # noqa: E402
from deepsphere_weather_torch.models import get_model  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax  # noqa: E402
from test_torch_grids400 import (  # noqa: E402
    F_BC,
    F_DYN,
    F_STATIC,
    INPUT_K,
    KNN,
    STAND_IN,
    seeded_tree,
    tensor_info,
)
from torch_grad_terms import term_sums  # noqa: E402
from torch_parallel_worker import grid_worker, join_ranks, start_ranks  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# the six cases of `tests/test_torch_configs.py`'s sharding test
CASES = [("Healpix_400km", "interp", "graph"),
         ("Healpix_400km", "learn", "graph"),
         ("Equiangular_400km", "max", "graph"),
         ("Equiangular_400km", "avg", "image"),
         ("O24", "maxval", "graph"),
         ("Cubed_400km", "maxarea", "graph")]
IDS = [f"{s}-{p}-{c}" for s, p, c in CASES]
AR = (INPUT_K, [0], 1, 0)
# Adam with eps 1e-3: with eps 1e-7 an element whose gradient is
# rounding-small steps by lr in each package's own direction
# (`tests/test_torch_members.py`)
B, LR, EPS, FP32 = 2, 1e-4, 1e-3, 1e-5


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _case(i, sampling_dir, pool, conv_type):
    """The port settings, weights, batch and area weights of one case."""
    name, kw = STAND_IN[sampling_dir]
    n = build_sampling(name, kw).n_nodes
    settings = dict(sampling=name, sampling_kwargs=kw, knn=KNN,
                    pool_method=pool, conv_type=conv_type,
                    increment_learning=True, dense_threshold=n - 1)
    model = get_model("UNetSpherical", tensor_info(n), device="cpu",
                      **settings)
    tree = seeded_tree(model, 30 + i)
    params = params_from_jax(tree)
    rng = np.random.default_rng(40 + i)
    W = ARIndexer.build(*AR).window_size
    batch = {"dynamic": rng.standard_normal((B, W, n, F_DYN)),
             "bc": rng.standard_normal((B, W, n, F_BC)),
             "static": rng.standard_normal((n, F_STATIC))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    area_w = AreaWeights(model.geometry.samplings[0], device="cpu").numpy()
    return {"info": tensor_info(n), "settings": settings, "params": params,
            "tree": tree, "batch": batch, "area_w": area_w}


def _reference(case):
    """One case's JAX reference: loss, gradients (port names), parameters
    after one Adam step, and the term sums of the one-element gradients
    (from the single-process port's backward)."""
    settings, batch, area_w = case["settings"], case["batch"], case["area_w"]
    n = case["info"]["input_shape_info"]["dynamic"]["node"]
    w = np.ones(1, np.float32)
    model = get_model("UNetSpherical", case["info"], device="cpu",
                      **settings)
    model.load_state_dict(case["params"])
    sums = term_sums(model)
    make_ar_loss_fn(model, ARIndexer.build(*AR), 1)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, w,
        torch.from_numpy(area_w))[0].backward()

    jmodel = jget_model("UNetSpherical", tensor_info(n),
                        **{k: v for k, v in settings.items()
                           if k != "dense_threshold"})
    jparams = jax.tree_util.tree_map(jnp.asarray, case["tree"])
    (total, _), grads = jax.jit(jax.value_and_grad(
        jmake_ar_loss_fn(jmodel, JARIndexer.build(*AR), 1), has_aux=True))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(w),
        make_context(jmodel, jnp.asarray(area_w)))
    opt = optax.adam(LR, eps=EPS)
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    after = optax.apply_updates(jparams, updates)

    def flat(t):
        return {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, t)).items()}

    return {"total": float(total), "grads": flat(grads),
            "params": flat(after), "sums": sums, "n": n}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks started on every case at once; the JAX references
    computed while they run."""
    cases = [_case(i, *c) for i, c in enumerate(CASES)]
    cfg = {"cases": [{k: v for k, v in c.items() if k != "tree"}
                     for c in cases],
           "ar": AR, "w": np.ones(1, np.float32), "lr": LR, "eps": EPS}
    handle = start_ranks(grid_worker, 2, tmp_path_factory.mktemp("grids"),
                         cfg)
    try:
        # XLA compiles apart from the GIL: three cases at a time
        with ThreadPoolExecutor(3) as pool:
            refs = list(pool.map(_reference, cases))
    finally:
        ranks = join_ranks(handle)
    return ranks, refs


@pytest.fixture(params=range(len(CASES)), ids=IDS)
def case(request, runs):
    ranks, refs = runs
    i = request.param
    return CASES[i], [r[i] for r in ranks], refs[i]


def test_sharded_grid_loss_matches_jax(case):
    _, ranks, ref = case
    for r in ranks:
        assert rel_err(r["losses"][0][0], ref["total"]) <= FP32


def test_sharded_grid_gradients_match_jax(case):
    (_, pool, _), ranks, ref = case
    for r in ranks:
        grads = r["grads"][0]
        assert sorted(grads) == sorted(ref["grads"])
        if pool == "learn":
            assert {"pool0", "unpool0", "pool1", "unpool1"} <= set(grads)
        for k, g in grads.items():
            r_k = ref["grads"][k]
            if r_k.size == 1:
                e = np.abs(np.asarray(g, np.float64) - r_k).max() / ref["sums"][k]
            else:
                e = rel_err(g, r_k)
            assert e <= FP32, (k, e)


def test_sharded_grid_params_match_jax(case):
    _, ranks, ref = case
    for k, v in ranks[0]["params"].items():
        assert rel_err(v, ref["params"][k]) <= FP32, k
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)


def test_sharded_grid_ranges_and_pools(case):
    (sampling_dir, pool, _), ranks, ref = case
    n0 = ref["n"]
    for j, r in enumerate(ranks):
        lo, hi = r["ranges"][0]
        assert (lo, hi) == (j * n0 // 2, (j + 1) * n0 // 2)
        wrapped = {"ShardedPool", "ShardedUnpool"}
        assert set(r["pools"]) == wrapped
