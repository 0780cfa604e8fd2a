"""Port training path vs the JAX package: the AR loss and its gradient, the
train, validation and device-cache steps, an Adam trajectory, the area
weights, the weighted MSE and the AR scheduler.

The loss/gradient comparisons run at HEALPix-8 (768 / 192 / 48 nodes,
knn 8) with level 0 block-sparse on both sides (JAX: Pallas in interpret
mode; port: the kernels' plain versions through the operator's
`autograd.Function`). Every parameter is drawn from np.random.default_rng
(`seeded_params`, with the ReZero weights scaled down to U(0.05, 0.15) so
that the rollout of random weights stays bounded: at U(0.5, 1.5) the loss
grows several-fold per iteration) and loaded on both sides through
`weights.py`; gradients are compared key by key after `params_to_jax`.
(A ReLU input within fp32 rounding of zero flips with the summation order
and alone moves gradients past 1e-5: `tests/test_torch_cuda.py` shows one
between the card and the CPU.)

Tolerances (max abs error / max abs of the reference): fp32 1e-5
(summation order only), bf16 3e-2 (bf16 roundings at the same cast
points, in another summation order). A bf16 gradient of one element (the
ReZero weights, the increment scale) is one sum over a whole block's
output in which bf16 products cancel: it is held to 3e-2 of the sum of
its terms' magnitudes (`torch_grad_terms.term_sums`), not of itself. The
60-step Adam trajectory is held to a per-step relative loss difference of
1.6e-4 (`docs/PARITY_NUMERIC.md` §3)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepsphere_weather_tpu.data.ar import ARIndexer as JARIndexer  # noqa: E402
from deepsphere_weather_tpu.engine.loss import AreaWeights as JAreaWeights  # noqa: E402
from deepsphere_weather_tpu.engine.loss import weighted_mse as jweighted_mse  # noqa: E402
from deepsphere_weather_tpu.engine.scheduler import (  # noqa: E402
    ARScheduler as JARScheduler,
    EarlyStopping as JEarlyStopping,
)
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
from deepsphere_weather_tpu.sphere import build_sampling as jbuild_sampling  # noqa: E402
from deepsphere_weather_tpu.sphere import remap as jremap  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    ARScheduler,
    AreaWeights,
    EarlyStopping,
    make_ar_loss_fn,
    make_cached_train_step,
    make_cached_validation_fn,
    make_train_step,
    make_validation_fn,
    weighted_mse,
)
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.sphere.remap import (  # noqa: E402
    area_weights,
    clean_polygon,
    spherical_polygon_area,
    voronoi_cells,
)
from deepsphere_weather_torch.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
    seeded_params,
)
from torch_grad_terms import term_sums  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SUBDIV, KNN, B = 8, 8, 2
F_DYN, F_BC, F_STATIC = 2, 1, 2
TOL = {"fp32": 1e-5, "bf16": 3e-2}
PRECISION = {"fp32": "float32", "bf16": "bfloat16"}
# (input_k, output_k, forecast_cycle, ar_iterations, stack_most_recent)
AR2 = ([-3, -2, -1], [0], 1, 2, True)
KEEP_FIRST = ([-2, -1], [0, 1], 1, 2, False)   # overlapping outputs


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def tensor_info(n, n_in_time, n_out_time):
    return {"input_n_feature": F_DYN + F_BC + F_STATIC,
            "output_n_feature": F_DYN, "input_n_time": n_in_time,
            "output_n_time": n_out_time,
            "input_shape_info": {"dynamic": {"node": n}},
            "output_shape_info": {"dynamic": {"node": n}}}


def build_pair(dt, settings, subdiv=SUBDIV, seed=0):
    """(port model, JAX model, JAX params) with identical seeded weights;
    at HEALPix-8 level 0 is block-sparse on both sides, at HEALPix-4 every
    level is dense."""
    kw = {"subdivisions": subdiv, "nest": True}
    n = 12 * subdiv ** 2
    info = tensor_info(n, len(settings[0]), len(settings[1]))
    sparse0 = subdiv >= 8
    model = UNetSpherical(
        info, "healpix", kw, knn=KNN, pool_method="max",
        increment_learning=True, numeric_precision=PRECISION[dt],
        dense_threshold=n - 1 if sparse0 else None, device="cpu")
    jmodel = JUNetSpherical(
        info, "healpix", kw, knn=KNN, pool_method="max",
        increment_learning=True, numeric_precision=PRECISION[dt])
    if sparse0:
        g0 = jbuild_graph("healpix", kw, k=KNN)
        jmodel.geometry.cheb_ops[0] = JChebOperator(
            bcsr=JBlockSparseOperator.from_scipy(
                g0.L, symmetric=True, interpret=True,
                dtype=jnp.bfloat16 if dt == "bf16" else np.float32))
    tree = seeded_params(model, seed)
    for block in tree.values():
        if isinstance(block, dict):
            block["rezero_weight"] *= 0.1
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, jax.tree_util.tree_map(jnp.asarray, tree)


def indexers(settings):
    *args, recent = settings
    return (ARIndexer.build(*args, stack_most_recent_prediction=recent),
            JARIndexer.build(*args, stack_most_recent_prediction=recent))


def make_batch(rng, indexer, n, batch=B):
    W = indexer.window_size
    return {"dynamic": rng.standard_normal((batch, W, n, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((batch, W, n, F_BC)).astype(np.float32),
            "static": rng.standard_normal((n, F_STATIC)).astype(np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def ar_weights(n):
    return np.linspace(1.0, 0.5, n).astype(np.float32)


@pytest.mark.parametrize("dt,strategy,settings", [
    ("fp32", "RNN", AR2), ("bf16", "RNN", AR2), ("fp32", "AR", AR2),
    ("fp32", "RNN", KEEP_FIRST)], ids=["rnn-fp32", "rnn-bf16", "ar-fp32",
                                        "keep-first-fp32"])
def test_ar_loss_and_gradients_match_jax(dt, strategy, settings):
    model, jmodel, jparams = build_pair(dt, settings)
    indexer, jindexer = indexers(settings)
    n_scan = indexer.ar_iterations + 1
    n = model.input_n_node
    rng = np.random.default_rng(21)
    batch = make_batch(rng, indexer, n)
    samp = build_sampling("healpix", {"subdivisions": SUBDIV, "nest": True})
    area_w = AreaWeights(samp, device="cpu")
    w = ar_weights(n_scan)

    sums = term_sums(model)
    loss_fn = make_ar_loss_fn(model, indexer, n_scan, strategy)
    total, per_iter = loss_fn(to_torch(batch), w, area_w)
    total.backward()

    jloss = jmake_ar_loss_fn(jmodel, jindexer, n_scan, strategy)
    ctx = make_context(jmodel, jnp.asarray(area_w.numpy()))
    (jtotal, jper_iter), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams, jax.tree_util.tree_map(
            jnp.asarray, batch), jnp.asarray(w), ctx)

    assert per_iter.shape == (n_scan,)
    assert rel_err(per_iter.detach().numpy(), np.asarray(jper_iter)) <= TOL[dt]
    assert rel_err(total.item(), float(jtotal)) <= TOL[dt]
    # the level-0 operator carried the gradient: every convolution weight
    # of the level-0 blocks has one
    assert float(np.abs(grads_tree(model)["conv1"]["convblock1"]["weight"]).max()) > 0
    assert_trees_close(grads_tree(model), jgrads, TOL[dt],
                       sums=sums if dt == "bf16" else None)


def test_remat_matches_plain_backward():
    model, _, _ = build_pair("fp32", AR2)
    indexer, _ = indexers(AR2)
    batch = to_torch(make_batch(np.random.default_rng(22), indexer,
                                model.input_n_node))
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        total, per_iter = make_ar_loss_fn(model, indexer, 3, "RNN",
                                          remat=remat)(batch, ar_weights(3))
        total.backward()
        out.append((total.item(), per_iter.detach().numpy(),
                    grads_tree(model)))
    (t0, p0, g0), (t1, p1, g1) = out
    assert t0 == pytest.approx(t1, rel=1e-6)
    np.testing.assert_allclose(p0, p1, rtol=1e-6)
    assert_trees_close(g1, g0, 1e-6)


def test_cached_steps_match_uncached():
    # two models with the same weights: one trained on host-assembled
    # batches, one on window indices into a device-resident timeline
    indexer, _ = indexers(AR2)
    models = [build_pair("fp32", AR2, subdiv=4, seed=3)[0] for _ in range(2)]
    n = models[0].input_n_node
    rng = np.random.default_rng(23)
    T = 12
    data = {"dynamic": rng.standard_normal((T, n, F_DYN)).astype(np.float32),
            "bc": rng.standard_normal((T, n, F_BC)).astype(np.float32),
            "static": rng.standard_normal((n, F_STATIC)).astype(np.float32)}
    tdata = to_torch(data)
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-7) for m in models]
    step = make_train_step(models[0], indexer, opts[0], 3)
    cstep = make_cached_train_step(models[1], indexer, opts[1], 3)
    val = make_validation_fn(models[0], indexer, 3)
    cval = make_cached_validation_fn(models[1], indexer, 3)
    w = ar_weights(3)
    for t0s in ([3, 5], [4, 3], [6, 4]):
        widx = np.array([t + indexer.rel_offsets for t in t0s])
        batch = {"dynamic": data["dynamic"][widx], "bc": data["bc"][widx],
                 "static": data["static"]}
        total, per_iter = step(to_torch(batch), w)
        ctotal, cper_iter = cstep(tdata, torch.from_numpy(widx), w)
        assert total.item() == pytest.approx(ctotal.item(), rel=1e-6)
        np.testing.assert_allclose(per_iter.numpy(), cper_iter.numpy(),
                                   rtol=1e-6)
        vtotal, _ = val(to_torch(batch), w)
        cvtotal, _ = cval(tdata, torch.from_numpy(widx), w)
        assert not vtotal.requires_grad
        assert vtotal.item() == pytest.approx(cvtotal.item(), rel=1e-6)
    assert_trees_close(params_to_jax(models[1].state_dict()),
                       params_to_jax(models[0].state_dict()), 1e-6)


def test_adam_trajectory_matches_jax():
    # 60 Adam steps at HEALPix-4, fp32, dense levels, batch 8, a fresh
    # batch each step (the protocol of docs/PARITY_NUMERIC.md §3): the JAX
    # package's make_train_step with optax.adam(1e-3, eps=1e-7) against
    # the port's with torch.optim.Adam(lr=1e-3, eps=1e-7), same weights
    model, jmodel, jparams = build_pair("fp32", AR2, subdiv=4, seed=4)
    # the step donates its params: hand JAX its own copy
    jparams = jax.tree_util.tree_map(jnp.array, jparams)
    indexer, jindexer = indexers(AR2)
    n = model.input_n_node
    samp = build_sampling("healpix", {"subdivisions": 4, "nest": True})
    area_w = AreaWeights(samp, device="cpu")
    w = ar_weights(3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-7)
    step = make_train_step(model, indexer, opt, 3)
    jopt = optax.adam(1e-3, eps=1e-7)
    jopt_state = jopt.init(jparams)
    jstep = jmake_train_step(jmodel, jindexer, jopt, 3)
    ctx = make_context(jmodel, jnp.asarray(area_w.numpy()))
    rng = np.random.default_rng(24)
    losses, jlosses = [], []
    for _ in range(60):
        batch = make_batch(rng, indexer, n, batch=8)
        total, _ = step(to_torch(batch), w, area_w)
        jparams, jopt_state, jtotal, _ = jstep(
            jparams, jopt_state, jax.tree_util.tree_map(jnp.asarray, batch),
            jnp.asarray(w), ctx)
        losses.append(total.item())
        jlosses.append(float(jtotal))
    losses, jlosses = np.array(losses), np.array(jlosses)
    assert losses[-5:].mean() < 0.8 * losses[:5].mean()     # it learns
    assert np.max(np.abs(losses - jlosses) / np.abs(jlosses)) <= 1.6e-4


def test_area_weights_match_jax():
    kw = {"subdivisions": 8, "nest": True}
    w = area_weights(build_sampling("healpix", kw))      # computed, uncached
    jw = np.asarray(JAreaWeights(jbuild_sampling("healpix", kw)))
    assert w.dtype == np.float32 and w.shape == (768,)
    assert np.abs(w - jw).max() <= 1e-6 * np.abs(jw).max()
    assert w.sum() == pytest.approx(1.0, rel=1e-5)
    np.testing.assert_allclose(
        AreaWeights(build_sampling("healpix", kw), device="cpu").numpy(), jw,
        rtol=0,
        atol=1e-6 * np.abs(jw).max())


@pytest.mark.parametrize("orientation", ["as_sorted", "reversed"])
@pytest.mark.parametrize("subdiv", [2, 4])
def test_polygon_helpers_match_jax(subdiv, orientation):
    # every Voronoi cell of a HEALPix grid (whose cocircular generators
    # give duplicate vertices), as scipy sorts it or reversed, with one
    # vertex repeated: the same cleaned polygon and area on both sides,
    # the areas summing to the sphere's and matching scipy's
    samp = build_sampling("healpix", {"subdivisions": subdiv, "nest": True})
    sv = voronoi_cells(samp)
    areas = []
    for node, region in enumerate(sv.regions):
        verts = sv.vertices[region]
        if orientation == "reversed":
            verts = verts[::-1]
        verts = np.insert(verts, 1, verts[1], axis=0)
        center = samp.coords_3d[node]
        got = clean_polygon(verts, center)
        np.testing.assert_array_equal(got, jremap.clean_polygon(verts, center))
        assert len(got) < len(verts)
        areas.append(spherical_polygon_area(got))
        assert areas[-1] == jremap.spherical_polygon_area(got)
    np.testing.assert_allclose(areas, sv.calculate_areas(), rtol=1e-9)
    assert sum(areas) == pytest.approx(4 * np.pi, rel=1e-9)
    assert clean_polygon(np.zeros((0, 3)), center).shape == (0, 3)
    assert spherical_polygon_area(got[:2]) == 0.0


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("shape", [(3, 2, 48, 2), (48, 3)],
                         ids=["batched", "unbatched"])
def test_weighted_mse_matches_jax(reduction, shape):
    rng = np.random.default_rng(25)
    pred, target = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2))
    w = rng.uniform(0.5, 1.5, shape[-2]).astype(np.float32)
    for weights in (w, None):
        got = weighted_mse(torch.from_numpy(pred), torch.from_numpy(target),
                           None if weights is None else torch.from_numpy(weights),
                           reduction=reduction)
        ref = jweighted_mse(jnp.asarray(pred), jnp.asarray(target),
                            None if weights is None else jnp.asarray(weights),
                            reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        weighted_mse(torch.from_numpy(pred), torch.from_numpy(target),
                     reduction="max")


@pytest.mark.parametrize("method", ["LinearStep", "ExponentialStep",
                                    "Constant", "DiracDelta"])
def test_ar_scheduler_state_dicts_cross_load(method):
    kw = dict(method=method, factor=0.3, fixed_ar_weights=[0],
              initial_ar_absolute_weights=[1, 0.5], max_ar_iterations=4)
    sides = [ARScheduler(**kw), JARScheduler(**kw)]
    stops = [EarlyStopping(patience=2, minimum_improvement=0.01,
                           minimum_iterations=3),
             JEarlyStopping(patience=2, minimum_improvement=0.01,
                            minimum_iterations=3)]
    scores = [1.0, 0.9, 0.895, 0.9, 0.7, 0.71, 0.705, 0.72, 0.73]
    for i, score in enumerate(scores):
        for s in sides:
            s.step()
        hits = [es.check(score) for es in stops]
        assert hits[0] == hits[1]
        if hits[0] and sides[0].can_update():
            for s, es in zip(sides, stops):
                s.update()
                if i % 2:
                    es.reset_counter()
                else:
                    es.reset()
        # each side continues from the other's state
        sides = [ARScheduler.from_state_dict(sides[1].state_dict()),
                 JARScheduler.from_state_dict(sides[0].state_dict())]
        stops = [EarlyStopping.from_state_dict(stops[1].state_dict()),
                 JEarlyStopping.from_state_dict(stops[0].state_dict())]
        assert sides[0].state_dict() == sides[1].state_dict()
        assert stops[0].state_dict() == stops[1].state_dict()
        np.testing.assert_array_equal(sides[0].ar_weights, sides[1].ar_weights)
        np.testing.assert_array_equal(sides[0].padded_weights(6),
                                      sides[1].padded_weights(6))
        assert sides[0].ramp_in_progress == sides[1].ramp_in_progress
    assert sides[0].current_ar_iterations >= 2
