"""Port UNetSpherical at the shipped Healpix_100km configurations vs the
JAX package: the eight configurations that chip_smoke.py's shipped100km
phase holds card against CPU (every graph type with the max pool, every
pool with the knn graph), at a HEALPix-4 stand-in.

Each configuration is read from `configs/UNetSpherical/Healpix_100km/`
and built with its own model settings (pool, graph type, no increment
learning, pooling kernel 4) at its own fp32, but on HEALPix-4 with knn 8:
levels of 192, 48 and 12 nodes, level 0 forced block-sparse on both sides
(`dense_threshold = V - 1`; the port's fp32 operator sends every product
to its ELL form, here the kernel's plain version; JAX: Pallas in
interpret mode). Every parameter, the learned pools' logits included, is
drawn from np.random.default_rng and loaded on both sides through
`weights.py`. The inputs are the shipped traffic's, 7 features (4
static, 1 boundary, 2 dynamic) at the config's lags [-18, -12, -6] to 2
outputs, at batch 2. Checked at fp32 1e-5 (max abs error over max abs of
the JAX value): the forward, and the config's AR6 RNN loss (area-weighted
MSE, 7 iterations) with every gradient per key, a one-element gradient
against the sum of its terms' magnitudes (`torch_grad_terms`).
MaxPool-Graph_knn's loss with `remat=True` is held against the port's
without remat and against JAX's with remat at 1e-5.

Over seven iterations some ReLU input or max-pool gap falls within
fp32 rounding of its kink: at seed 0 one ReLU input of the voronoi
config's loss sits 1.2e-8 (of its call's largest |x|) from zero, and the
port's level 0 on its ELL form and on its dense form already take it on
opposite sides, which moves some gradients by 4e-4. So the loss of each
configuration is taken on JAX's decisions, as chip_smoke.py takes the
card's on the CPU: JAX records each ReLU's (x > 0) and each argmax pool's
maximal set in call order (ordered debug callbacks in the jitted loss),
the port takes them (`torch_steer.steer`), and every decision that
differs from the port's own must sit within KINK_TOL of its kink or
tie."""

import json
from pathlib import Path

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
from deepsphere_weather_tpu.ops import pool as jpool  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import AreaWeights, make_ar_loss_fn  # noqa: E402
from deepsphere_weather_torch.models import get_model  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax  # noqa: E402
from test_torch_grids400 import (  # noqa: E402
    assert_trees_close,
    grads_tree,
    rel_err,
    seeded_tree,
)
from torch_grad_terms import term_sums  # noqa: E402
from torch_steer import steer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CONFIG_DIR = (Path(__file__).resolve().parent.parent / "configs"
              / "UNetSpherical" / "Healpix_100km")
# chip_smoke.py's shipped100km card-vs-CPU configurations, and the one it
# trains with remat
CONFIGS = ["MaxPool-Graph_knn", "MaxPool-Graph_voronoi", "MaxPool-Graph_mesh",
           "AvgPool-Graph_knn", "InterpPool-Graph_knn", "MaxAreaPool-Graph_knn",
           "MaxValPool-Graph_knn", "LearnPool-Graph_knn"]
REMAT_CONFIG = "MaxPool-Graph_knn"
STAND_IN = {"subdivisions": 4, "nest": True}
KNN, B = 8, 2
F_DYN, F_BC, F_STATIC = 2, 1, 4
F_IN = F_DYN + F_BC + F_STATIC
TOL = 1e-5
# a decision the port takes from JAX against its own must sit this close
# to its kink or tie (over its call's largest |x|): fp32 rounding
KINK_TOL = 1e-6


def _config(name):
    with open(CONFIG_DIR / f"{name}.json") as f:
        return json.load(f)


def _tensor_info(n, n_time):
    return {"input_n_feature": F_IN, "output_n_feature": F_DYN,
            "input_n_time": n_time, "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": n}},
            "output_shape_info": {"dynamic": {"node": n}}}


def build_pair(name, seed=0):
    """(port model, JAX model, JAX params, config) of the shipped config
    `name` at the stand-in, the same seeded weights, level 0
    block-sparse fp32 on both sides."""
    cfg = _config(name)
    ms = cfg["model_settings"]
    assert cfg["training_settings"]["numeric_precision"] == "float32"
    kw = {k: v for k, v in ms.items() if k != "architecture_name"}
    kw.update(sampling_kwargs=STAND_IN, knn=KNN,
              pool_method=str(ms["pool_method"]).lower(),
              numeric_precision="float32")
    n = build_sampling(ms["sampling"], STAND_IN).n_nodes
    info = _tensor_info(n, len(cfg["ar_settings"]["input_k"]))
    model = get_model(ms["architecture_name"], info, dense_threshold=n - 1,
                      device="cpu", **kw)
    jmodel = jget_model(ms["architecture_name"], info, **kw)
    graph = ms["graph_type"]
    L = jbuild_graph(ms["sampling"], STAND_IN, k=KNN, graph_type=graph).L
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            L, symmetric=graph in ("knn", "mesh"), interpret=True,
            dtype=np.float32))
    tree = seeded_tree(model, seed)
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree), cfg


class _RecordedPool:
    """An argmax pool of the JAX package that records its decisions (the
    maximal elements of each output's candidates, [B, D, W, C], as
    `torch_steer` records the port's) before pooling."""

    def __init__(self, pool, put):
        self.pool, self.put = pool, put

    def __call__(self, x, **kw):
        if isinstance(self.pool, jpool.HealpixMaxPool):
            B, V, C = x.shape
            g = x.reshape(B, V // self.pool.k, self.pool.k, C)
        else:                                           # GeneralMaxValPool
            g = jnp.take(x, self.pool.cols, axis=1) * self.pool.vals[
                None, :, :, None].astype(x.dtype)
            g = jnp.where((self.pool.vals > 0)[None, :, :, None], g,
                          -jnp.inf)
        jax.debug.callback(self.put, g == g.max(axis=2, keepdims=True),
                           ordered=True)
        return self.pool(x, **kw)


jax.tree_util.register_pytree_node(
    _RecordedPool, lambda p: ((p.pool,), p.put),
    lambda put, children: _RecordedPool(children[0], put))


def record_jax_decisions(jmodel):
    """Make the JAX model record its ReLU and argmax-pool decisions in
    call order; returns the list they are appended to (torch tensors)."""
    decisions = []

    def put(mask):
        decisions.append(torch.from_numpy(np.array(mask)))

    for rb in jmodel._blocks.values():
        for blk in rb.blocks:
            if blk.act:
                def relu(x, act=blk.act_fun):
                    jax.debug.callback(put, x > 0, ordered=True)
                    return act(x)
                blk.act_fun = relu
    pools = jmodel.geometry.pools
    for i, p in enumerate(pools):
        if isinstance(p, (jpool.HealpixMaxPool, jpool.GeneralMaxValPool)):
            pools[i] = _RecordedPool(p, put)
    return decisions


def _ar(cfg):
    ar = cfg["ar_settings"]
    settings = (ar["input_k"], ar["output_k"], ar["forecast_cycle"],
                ar["ar_iterations"])
    return (ARIndexer.build(*settings), JARIndexer.build(*settings),
            ar["ar_iterations"] + 1)


def _batch(n, window, seed):
    rng = np.random.default_rng(seed)
    batch = {"dynamic": rng.standard_normal((B, window, n, F_DYN)),
             "bc": rng.standard_normal((B, window, n, F_BC)),
             "static": rng.standard_normal((n, F_STATIC))}
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _port_loss(model, indexer, n_iter, batch, w, area_w, remat=False):
    sums = term_sums(model)
    model.zero_grad()
    total, per_iter = make_ar_loss_fn(model, indexer, n_iter, remat=remat)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, w, area_w)
    total.backward()
    return per_iter.detach().numpy(), grads_tree(model), sums


def _jax_loss(jmodel, jparams, jindexer, n_iter, batch, w, area_w,
              remat=False):
    jloss = jmake_ar_loss_fn(jmodel, jindexer, n_iter, remat=remat)
    ctx = make_context(jmodel, jnp.asarray(area_w.numpy()))
    (_, jper_iter), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams, jax.tree_util.tree_map(
            jnp.asarray, batch), jnp.asarray(w), ctx)
    return np.asarray(jper_iter), jgrads


@pytest.mark.parametrize("name", CONFIGS)
def test_healpix100km_forward_and_ar6_gradients_match_jax(name):
    model, jmodel, jparams, cfg = build_pair(name)
    geom = model.geometry
    op = geom.cheb_ops[0].bcsr
    # level 0 block-sparse fp32 with its ELL form, levels 1-2 dense
    assert op is not None and op.ell is not None
    assert all(o.dense is not None for o in geom.cheb_ops[1:])
    graph = cfg["model_settings"]["graph_type"]
    assert op.ell.symmetric == (graph != "voronoi")
    if cfg["model_settings"]["pool_method"] == "Learn":
        assert {"pool0", "unpool0", "pool1", "unpool1"} <= set(jparams)
    n = model.input_n_node
    x = np.random.default_rng(11).standard_normal(
        (B, len(cfg["ar_settings"]["input_k"]), n, F_IN)).astype(np.float32)
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    jy = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    assert y.shape == (B, 1, n, F_DYN)
    assert rel_err(y.numpy(), np.asarray(jy)) <= TOL

    indexer, jindexer, n_iter = _ar(cfg)
    assert n_iter == 7 and cfg["training_settings"][
        "ar_training_strategy"] == "RNN"
    batch = _batch(n, indexer.window_size, 21)
    area_w = AreaWeights(geom.samplings[0], device="cpu")
    w = np.linspace(1.0, 0.4, n_iter).astype(np.float32)
    decisions = record_jax_decisions(jmodel)
    jper_iter, jgrads = _jax_loss(jmodel, jparams, jindexer, n_iter, batch,
                                  w, area_w)
    assert decisions
    taken, gaps = steer(model, decisions)
    per_iter, grads, sums = _port_loss(model, indexer, n_iter, batch, w,
                                       area_w)
    assert len(taken) == len(decisions)
    assert max(gaps, default=0.0) <= KINK_TOL, gaps
    assert per_iter.shape == (n_iter,)
    assert rel_err(per_iter, jper_iter) <= TOL
    if cfg["model_settings"]["pool_method"] == "Learn":
        assert float(np.abs(grads["pool0"]).max()) > 0
        assert float(np.abs(grads["unpool0"]).max()) > 0
    assert_trees_close(grads, jgrads, TOL, sums=sums)


def test_healpix100km_remat_step_matches_without_and_jax():
    model, jmodel, jparams, cfg = build_pair(REMAT_CONFIG, seed=1)
    indexer, jindexer, n_iter = _ar(cfg)
    n = model.input_n_node
    batch = _batch(n, indexer.window_size, 22)
    area_w = AreaWeights(model.geometry.samplings[0], device="cpu")
    w = np.ones(n_iter, np.float32)
    plain = _port_loss(model, indexer, n_iter, batch, w, area_w)
    remat = _port_loss(model, indexer, n_iter, batch, w, area_w, remat=True)
    jper_iter, jgrads = _jax_loss(jmodel, jparams, jindexer, n_iter, batch,
                                  w, area_w, remat=True)
    for per_iter, grads, sums in (remat, plain):
        assert rel_err(per_iter, jper_iter) <= TOL
        assert_trees_close(grads, jgrads, TOL, sums=sums)
    assert rel_err(remat[0], plain[0]) <= TOL
    assert_trees_close(remat[1], plain[1], TOL, sums=plain[2])
