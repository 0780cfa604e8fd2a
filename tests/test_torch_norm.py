"""Port normalization (BatchNorm with running statistics, LayerNorm) vs the
JAX package.

At HEALPix-4 (192 nodes, knn 8) with level 0 block-sparse on both sides
(the JAX operator in Pallas interpret mode, the port's through its
autograd Function on the kernels' plain versions), weights drawn by
`weights.seeded_params` (normalization scales from U(0.5, 1.5), so no
branch is zeroed) and loaded on both sides through `weights.py`:

- `ConvBlock`, `ResBlock` and `UNetSpherical` with 'batch' and 'layer'
  norm, before and after the activation: the train-mode output and the
  collected statistics (`stats_out`) within 1e-5 (fp32), the eval-mode
  output with a given norm_state within 1e-5, the bf16 model within 2e-2
  (max abs error / max abs);
- the init (zero BN scale and bias in each ResBlock's last block, no conv
  bias) and `init_norm_state`'s keys against the JAX tree's;
- `fold_running_stats` within 1e-6;
- 3 `with_norm_state` train steps, plain and device-cached: losses,
  parameters and running statistics within 2e-4 (the trainer bar);
- eval-mode validation and `make_rollout_block(norm_state=...)` within
  1e-5;
- `norm_state.npz` written by either package loads in the other (exact);
- a BatchNorm experiment through both CLIs (`cli.train_predict`) from one
  initial checkpoint, then `--resume`d by each package from the port's
  experiment: training and eval-mode validation losses within 2e-4, RMSE
  within 3e-3, the running statistics saved by each and read by the JAX
  package.

Why the train steps use Adam with eps 1e-3 and the CLI's statistics are
held through its validation losses: BatchNorm makes some gradients
exactly zero in exact arithmetic (the bias of a norm whose output feeds a
Chebyshev conv and another BatchNorm: a constant field passes the conv's
Laplacian terms as 0 and the next norm removes it), so the two packages
compute rounding noise there, which Adam with eps 1e-7 turns into steps
of size lr in each package's own direction. The losses do not see those
parameters; the next norm's running mean does (measured: 1.5% apart after
a CLI epoch, with every loss within 2e-4). With eps 1e-3 the noise stays
noise over 3 steps.
"""

import json
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.cli.train_predict import main as jmain  # noqa: E402
from deepsphere_weather_tpu.data import (  # noqa: E402
    SphericalDataset as JSphericalDataset,
    StaticDataset as JStaticDataset,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
)
from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.step import (  # noqa: E402
    fold_running_stats as jfold_running_stats,
    make_cached_train_step as jmake_cached_train_step,
    make_context,
    make_rollout_block as jmake_rollout_block,
    make_train_step as jmake_train_step,
    make_validation_fn as jmake_validation_fn,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.models.layers import (  # noqa: E402
    ConvBlock as JConvBlock,
    ResBlock as JResBlock,
)
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402
from deepsphere_weather_tpu.utils import Checkpointer as JCheckpointer  # noqa: E402
from deepsphere_weather_tpu.utils.checkpoint import save_pytree  # noqa: E402

from deepsphere_weather_torch.cli.train_predict import main  # noqa: E402
from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    fold_running_stats,
    make_cached_train_step,
    make_rollout_block,
    make_train_step,
    make_validation_fn,
)
from deepsphere_weather_torch.models import (  # noqa: E402
    ConvBlock,
    ResBlock,
    UNetSpherical,
)
from deepsphere_weather_torch.ops import BlockSparseOperator  # noqa: E402
from deepsphere_weather_torch.ops.cheb import ChebOperator  # noqa: E402
from deepsphere_weather_torch.sphere import build_graph  # noqa: E402
from deepsphere_weather_torch.utils import Checkpointer  # noqa: E402
from deepsphere_weather_torch.weights import (  # noqa: E402
    norm_state_from_jax,
    norm_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_params,
)

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, B = 192, 8, 4
F_DYN, F_BC, F_STATIC = 2, 1, 2
FP32, BF16, TRAIN_TOL, FOLD_TOL = 1e-5, 2e-2, 2e-4, 1e-6
PRECISION = {"fp32": "float32", "bf16": "bfloat16"}
KINDS = [("batch", False), ("batch", True), ("layer", False),
         ("layer", True)]
AR2 = ([-3, -2, -1], [0], 1, 2)
ADAM_EPS_BN = 1e-3


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def assert_trees_close(got, ref, tol):
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_ref) > 0
    for path, g in flat_got:
        e = rel_err(g, flat_ref[path])
        assert e <= tol, (jax.tree_util.keystr(path), e)


@pytest.fixture(scope="module")
def level0():
    """(port operator, JAX operator) of the HEALPix-4 knn-8 Laplacian,
    block-sparse, fp32 and bf16."""
    L = build_graph("healpix", SAMPLING, k=KNN).L
    ops = {}
    for dt, tdt, jdt in (("fp32", torch.float32, np.float32),
                         ("bf16", torch.bfloat16, jnp.bfloat16)):
        ops[dt] = (
            ChebOperator(bcsr=BlockSparseOperator.from_scipy(
                L, symmetric=True, dtype=tdt, device="cpu")),
            JChebOperator(bcsr=JBlockSparseOperator.from_scipy(
                jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
                interpret=True, dtype=jdt)))
    return ops


def seeded_norm_state(state, seed):
    """Running statistics drawn from a seed: mean N(0, 0.1), var
    U(0.5, 1.5), in the JAX nesting."""
    rng = np.random.default_rng(seed)
    tree = norm_state_to_jax(state)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    fill(tree)
    return tree


def load_norm_state(module, tree):
    """In place: the module's running statistics from a JAX tree."""
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for k, v in norm_state_from_jax(tree).items():
            buffers[k].copy_(v)


def stats_tree(stats):
    """A port stats_out (nested like the JAX one) as numpy."""
    return jax.tree_util.tree_map(lambda t: t.numpy(), stats)


@pytest.mark.parametrize("kind,before", KINDS,
                         ids=[f"{k}-{'before' if b else 'after'}"
                              for k, b in KINDS])
@pytest.mark.parametrize("block", ["conv", "res"])
def test_blocks_match_jax(level0, kind, before, block):
    op, jop = level0["fp32"]
    kw = dict(batch_norm=kind, batch_norm_before_activation=before)
    if block == "conv":
        blk = ConvBlock(6, 8, op, device="cpu", **kw)
        jblk = JConvBlock(6, 8, jop, **kw)
    else:
        blk = ResBlock(6, (10, 8), op, kw, device="cpu")
        jblk = JResBlock(6, (10, 8), jop, kw)
    tree = seeded_params(blk, 1)
    blk.load_state_dict(params_from_jax(tree))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    x = np.random.default_rng(2).standard_normal((B, V, 6)).astype(np.float32)

    stats, jstats = {}, {}
    y = blk(torch.from_numpy(x), stats_out=stats)
    jy = jblk.apply(jparams, jnp.asarray(x), stats_out=jstats)
    assert rel_err(y.detach().numpy(), jy) <= FP32
    if kind == "batch":
        assert_trees_close(stats_tree(stats), jstats, FP32)
        ns = seeded_norm_state(dict(blk.named_buffers()), 3)
        load_norm_state(blk, ns)
        y = blk(torch.from_numpy(x), train=False)
        jy = jblk.apply(jparams, jnp.asarray(x), train=False,
                        norm_state=jax.tree_util.tree_map(jnp.asarray, ns))
        assert rel_err(y.detach().numpy(), jy) <= FP32
    else:
        assert stats == {} and jstats == {}


def build_pair(dt, kind, before, seed=0):
    """(port model, JAX model, JAX params) with identical seeded weights,
    level 0 block-sparse on both sides."""
    info = _info()
    kw = dict(knn=KNN, pool_method="max", increment_learning=True,
              numeric_precision=PRECISION[dt], batch_norm=kind,
              batch_norm_before_activation=before)
    model = UNetSpherical(info, "healpix", SAMPLING, dense_threshold=V - 1,
                          device="cpu", **kw)
    jmodel = JUNetSpherical(info, "healpix", SAMPLING, **kw)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
            interpret=True,
            dtype=jnp.bfloat16 if dt == "bf16" else np.float32))
    tree = seeded_params(model, seed)
    for blk in tree.values():
        if isinstance(blk, dict):
            blk["rezero_weight"] *= 0.1
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree)


def train_apply(jmodel):
    """The JAX model's train-mode forward returning its statistics."""
    def fn(p, a):
        stats = {}
        return jmodel.apply(p, a, stats_out=stats), stats
    return fn


UNET_CASES = [("fp32", "batch", False), ("fp32", "batch", True),
              ("fp32", "layer", False), ("bf16", "batch", False)]


@pytest.mark.parametrize("dt,kind,before", UNET_CASES,
                         ids=[f"{d}-{k}-{'before' if b else 'after'}"
                              for d, k, b in UNET_CASES])
def test_unet_matches_jax(dt, kind, before):
    model, jmodel, jparams = build_pair(dt, kind, before)
    x = np.random.default_rng(4).standard_normal(
        (B, 3, V, F_DYN + F_BC + F_STATIC)).astype(np.float32)
    tol = FP32 if dt == "fp32" else BF16
    stats = {}
    with torch.no_grad():
        y = model(torch.from_numpy(x), stats_out=stats)
    jy, jstats = jax.jit(train_apply(jmodel))(jparams, jnp.asarray(x))
    assert rel_err(y.numpy(), jy) <= tol
    if kind != "batch":
        return
    assert_trees_close(stats_tree(stats), jstats, tol)
    ns = seeded_norm_state(model.norm_state(), 5)
    load_norm_state(model, ns)
    with torch.no_grad():
        y = model(torch.from_numpy(x), train=False)
    jy = jax.jit(lambda p, a, n: jmodel.apply(p, a, train=False,
                                              norm_state=n))(
        jparams, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, ns))
    assert rel_err(y.numpy(), jy) <= tol


@pytest.mark.parametrize("kind", ["batch", "layer"])
def test_init_matches_jax(kind):
    model, jmodel, _ = build_pair("fp32", kind, False)
    jtree = jmodel.init(jax.random.key(0))
    tree = params_to_jax(model.state_dict())
    # the same parameter tree: no conv bias beside a norm
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jtree))
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        assert v.shape == np.asarray(
            dict(jax.tree_util.tree_flatten_with_path(jtree)[0])[path]).shape
    fresh = UNetSpherical(_info(), "healpix", SAMPLING, knn=KNN,
                          pool_method="max", batch_norm=kind, device="cpu")
    for name in UNetSpherical.BLOCKS:
        res = getattr(fresh, name)
        last = getattr(res, f"convblock{res.n_blocks}")
        first = res.convblock1
        assert last.bias is None and first.bias is None
        zero = kind == "batch"
        assert bool((last.norm_scale == 0).all()) == zero
        assert bool((last.norm_bias == 0).all())
        jlast = jtree[name][f"convblock{res.n_blocks}"]
        assert bool((np.asarray(jlast["norm_scale"]) == 0).all()) == zero
        if res.n_blocks > 1:
            assert bool((first.norm_scale == 1).all())
    if kind == "batch":
        jstate = jmodel.init_norm_state()
        state = norm_state_to_jax(fresh.init_norm_state())
        assert (jax.tree_util.tree_structure(state)
                == jax.tree_util.tree_structure(jstate))
        for (path, v), (_, jv) in zip(
                jax.tree_util.tree_flatten_with_path(state)[0],
                jax.tree_util.tree_flatten_with_path(jstate)[0]):
            np.testing.assert_array_equal(v, np.asarray(jv), str(path))
        assert fresh.has_batch_norm and jmodel.has_batch_norm
    else:
        assert fresh.init_norm_state() == {} == jmodel.init_norm_state()
        assert not fresh.has_batch_norm


def _info():
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": 3,
            "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


def test_fold_running_stats_matches_jax():
    rng = np.random.default_rng(6)
    state = {"conv1.convblock1.mean": rng.standard_normal(8),
             "conv1.convblock1.var": rng.uniform(0.5, 1.5, 8)}
    stats = {k: rng.standard_normal((3, 8)) for k in state}
    state = {k: torch.tensor(v, dtype=torch.float32) for k, v in state.items()}
    stats = {k: torch.tensor(v, dtype=torch.float32) for k, v in stats.items()}
    jout = jfold_running_stats(
        jax.tree_util.tree_map(jnp.asarray, norm_state_to_jax(state)),
        jax.tree_util.tree_map(jnp.asarray, norm_state_to_jax(stats)))
    out = fold_running_stats(state, stats)
    assert out is state
    assert_trees_close(norm_state_to_jax(out), jout, FOLD_TOL)


def make_batch(rng, indexer, batch=B):
    W = indexer.window_size
    return {"dynamic": rng.standard_normal((batch, W, V, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((batch, W, V, F_BC)).astype(np.float32),
            "static": rng.standard_normal((V, F_STATIC)).astype(np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _area_w():
    w = np.random.default_rng(7).uniform(0.5, 1.5, V).astype(np.float32)
    return w / w.sum()


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_train_steps_with_norm_state_match_jax(cached):
    model, jmodel, jparams = build_pair("fp32", "batch", False, seed=8)
    jparams = jax.tree_util.tree_map(jnp.array, jparams)
    indexer = ARIndexer.build(*AR2)
    jindexer = JARIndexer.build(*AR2)
    area_w = _area_w()
    w = np.linspace(1.0, 0.5, 3).astype(np.float32)
    # Adam with eps 1e-3 (module docstring)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=ADAM_EPS_BN)
    jopt = optax.adam(1e-3, eps=ADAM_EPS_BN)
    jopt_state = jopt.init(jparams)
    jns = jmodel.init_norm_state()
    ctx = make_context(jmodel, jnp.asarray(area_w))
    rng = np.random.default_rng(9)
    tw = torch.from_numpy(area_w)
    if cached:
        T = 16
        data = {"dynamic": rng.standard_normal((T, V, F_DYN)).astype(np.float32),
                "bc": rng.standard_normal((T, V, F_BC)).astype(np.float32),
                "static": rng.standard_normal((V, F_STATIC)).astype(np.float32)}
        step = make_cached_train_step(model, indexer, opt, 3,
                                      with_norm_state=True)
        jstep = jmake_cached_train_step(jmodel, jindexer, jopt, 3,
                                        with_norm_state=True)
        jdata = jax.tree_util.tree_map(jnp.asarray, data)
    else:
        step = make_train_step(model, indexer, opt, 3, with_norm_state=True)
        jstep = jmake_train_step(jmodel, jindexer, jopt, 3,
                                 with_norm_state=True)
    for i in range(3):
        if cached:
            widx = np.array([t + indexer.rel_offsets
                             for t in rng.integers(3, 12, B)])
            total, per_iter = step(to_torch(data), torch.from_numpy(widx), w,
                                   tw)
            jparams, jopt_state, jns, jtotal, jper = jstep(
                jparams, jopt_state, jns, jdata, jnp.asarray(widx),
                jnp.asarray(w), ctx)
        else:
            batch = make_batch(rng, indexer)
            total, per_iter = step(to_torch(batch), w, tw)
            jparams, jopt_state, jns, jtotal, jper = jstep(
                jparams, jopt_state, jns,
                jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(w),
                ctx)
        assert rel_err(per_iter.numpy(), jper) <= TRAIN_TOL, i
        assert rel_err(total.item(), float(jtotal)) <= TRAIN_TOL, i
    assert_trees_close(params_to_jax(model.state_dict()), jparams, TRAIN_TOL)
    state = norm_state_to_jax(model.norm_state())
    assert_trees_close(state, jns, TRAIN_TOL)
    # the statistics moved off their initial mean 0 / var 1
    assert np.abs(state["conv1"]["convblock1"]["mean"]).max() > 0


def test_eval_validation_and_rollout_match_jax():
    model, jmodel, jparams = build_pair("fp32", "batch", False, seed=10)
    ns = seeded_norm_state(model.norm_state(), 11)
    load_norm_state(model, ns)
    jns = jax.tree_util.tree_map(jnp.asarray, ns)
    indexer = ARIndexer.build(*AR2)
    jindexer = JARIndexer.build(*AR2)
    area_w = _area_w()
    w = np.ones(3, np.float32)
    batch = make_batch(np.random.default_rng(12), indexer)
    ctx = make_context(jmodel, jnp.asarray(area_w))

    total, per = make_validation_fn(model, indexer, 3, eval_mode=True)(
        to_torch(batch), w, torch.from_numpy(area_w))
    jtotal, jper = jmake_validation_fn(jmodel, jindexer, 3, eval_mode=True)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(w),
        {**ctx, "norm_state": jns})
    assert rel_err(per.numpy(), jper) <= FP32
    assert rel_err(total.item(), float(jtotal)) <= FP32
    # eval mode differs from train mode (the statistics are used)
    ttotal, _ = make_validation_fn(model, indexer, 3)(
        to_torch(batch), w, torch.from_numpy(area_w))
    assert abs(ttotal.item() - total.item()) > 1e-3 * abs(total.item())

    rollout, H = make_rollout_block(model, indexer, 4,
                                    norm_state=model.norm_state())
    jrollout, jH = jmake_rollout_block(jmodel, jindexer, 4, norm_state=jns)
    rng = np.random.default_rng(13)
    hist = rng.standard_normal((B, H, V, F_DYN)).astype(np.float32)
    bc = rng.standard_normal((B, 4, 3, V, F_BC)).astype(np.float32)
    static = rng.standard_normal((V, F_STATIC)).astype(np.float32)
    with torch.no_grad():
        _, _, preds = rollout(torch.from_numpy(hist), None,
                              torch.from_numpy(bc), torch.from_numpy(static))
    _, _, jpreds = jrollout(jparams, jnp.asarray(hist), None, jnp.asarray(bc),
                            jnp.asarray(static), jmodel.geometry_pytree())
    assert preds.shape == (B, 4, 1, V, F_DYN)
    assert rel_err(preds.numpy(), jpreds) <= FP32


def test_norm_state_files_cross_packages(tmp_path):
    model, jmodel, _ = build_pair("fp32", "batch", True, seed=14)
    ns = seeded_norm_state(model.norm_state(), 15)
    load_norm_state(model, ns)
    Checkpointer(tmp_path / "port").save_norm_state(model.norm_state())
    got = JCheckpointer(tmp_path / "port").load_norm_state(
        jmodel.init_norm_state())
    assert_trees_close(got, ns, 0.0)
    jns = seeded_norm_state(model.norm_state(), 16)
    JCheckpointer(tmp_path / "jax").save_norm_state(
        jax.tree_util.tree_map(jnp.asarray, jns))
    out = Checkpointer(tmp_path / "jax").load_norm_state(model.norm_state())
    assert out is not None
    assert_trees_close(norm_state_to_jax(model.norm_state()), jns, 0.0)
    assert Checkpointer(tmp_path / "none").load_norm_state(
        model.norm_state()) is None


# --- the CLI ----------------------------------------------------------------

DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
CONFIG = {
    "model_settings": {
        "sampling_name": "Healpix_toy", "sampling": "healpix",
        "sampling_kwargs": SAMPLING, "knn": KNN,
        "architecture_name": "UNetSpherical", "increment_learning": True,
        "pool_method": "Max", "batch_norm": True,
        "pretrained_model_name": "init"},
    "training_settings": {
        "epochs": 1, "learning_rate": 0.002, "training_batch_size": 8,
        "validation_batch_size": 8, "scoring_interval": 5,
        "gradient_clipping": 1.0, "ar_scheduler_factor": 0.5,
        "early_stopping_patience": 2,
        # beyond any loss change: every growth falls on a fixed count of
        # scorings, whatever the last digits of the two losses
        "early_stopping_minimum_improvement": 10.0,
        "seed_random_shuffling": 3},
    "ar_settings": {"input_k": [-3, -2, -1], "output_k": [0],
                    "forecast_cycle": 1, "ar_iterations": 1},
    "dataloader_settings": {"num_workers": 1},
}
NAME = "RNN-AR1-UNetSpherical-Healpix_toy-Graph_knn-k8-MaxPooling"


@pytest.fixture(scope="module")
def bn_experiments(tmp_path_factory):
    """A BatchNorm toy experiment through both CLIs from one initial
    checkpoint, then each package's --resume of a copy of the port's."""
    root = tmp_path_factory.mktemp("bn_cli")
    jgenerate_toy_data(root / "data_port", sampling_kwargs=SAMPLING,
                       n_timesteps=200, seed=7)
    shutil.copytree(root / "data_port", root / "data_jax")
    info = jget_ar_model_tensor_info(
        CONFIG["ar_settings"],
        JSphericalDataset.open(root / "data_port" / DYN),
        data_static=JStaticDataset.open(root / "data_port" / STATIC),
        data_bc=JSphericalDataset.open(root / "data_port" / BC))
    model = UNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          batch_norm=True, device="cpu")
    tree = seeded_params(model, 17)
    for blk in tree.values():
        if isinstance(blk, dict):
            blk["rezero_weight"] *= 0.1
    for side in ("port", "jax"):
        save_pytree(root / f"exp_{side}" / "init" / "model_weights"
                    / "model.npz", tree)
    (root / "config.json").write_text(json.dumps(CONFIG))
    out = {"root": root}
    out["port"] = main(root / "config.json", root / "data_port",
                       root / "exp_port", force=True,
                       ar_iterations_prediction=3, verbose=False,
                       device="cpu")
    out["jax"] = jmain(root / "config.json", root / "data_jax",
                       root / "exp_jax", force=True,
                       ar_iterations_prediction=3, verbose=False)
    for side in ("port", "jax"):
        shutil.copytree(root / "exp_port", root / f"resume_{side}")
    out["resume_port"] = main(root / "config.json", root / "data_port",
                              root / "resume_port", resume=True,
                              ar_iterations_prediction=3, verbose=False,
                              device="cpu")
    out["resume_jax"] = jmain(root / "config.json", root / "data_jax",
                              root / "resume_jax", resume=True,
                              ar_iterations_prediction=3, verbose=False)
    return out


def _info_json(exp):
    return json.loads((exp / "training_info/ar_training_info.json")
                      .read_text())


@pytest.mark.parametrize("run", ["fresh", "resume"])
def test_bn_cli_matches_jax(bn_experiments, run):
    key = "" if run == "fresh" else "resume_"
    (exp, gs) = bn_experiments[f"{key}port"]
    (jexp, jgs) = bn_experiments[f"{key}jax"]
    info, jinfo = _info_json(exp), _info_json(jexp)
    assert info["iterations"] == jinfo["iterations"]
    assert info["ar_growth_events"] == jinfo["ar_growth_events"]
    assert rel_err(info["training_total_loss"],
                   jinfo["training_total_loss"]) <= TRAIN_TOL
    assert rel_err(info["validation_total_loss"],
                   jinfo["validation_total_loss"]) <= TRAIN_TOL
    # the running statistics, saved by each package, read by the JAX one
    # (the JAX resume above read the port's: it raises without them);
    # their values are held through the eval-mode validation losses
    template = norm_state_to_jax(_bn_state_template())
    ns = JCheckpointer(exp).load_norm_state(template)
    jns = JCheckpointer(jexp).load_norm_state(template)
    for (path, v), (_, jv), (_, v0) in zip(
            *(jax.tree_util.tree_flatten_with_path(t)[0]
              for t in (ns, jns, template))):
        assert v.shape == jv.shape == v0.shape
        assert np.isfinite(v).all() and not np.array_equal(v, v0), path
    assert np.isfinite(gs["RMSE"]).all()
    assert rel_err(gs["RMSE"], jgs["RMSE"]) <= 3e-3


def _bn_state_template():
    return UNetSpherical(_info(), "healpix", SAMPLING, knn=KNN,
                         pool_method="max", batch_norm=True,
                         device="cpu").init_norm_state()
