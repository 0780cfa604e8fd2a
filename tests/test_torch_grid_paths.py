"""The paths that consume the new pools and architectures, on the CPU.

- A member step (`torch.func.grad` under `vmap`) over the remap pools,
  the learned logits under per-member clipping, against each member's
  single step: losses and clipped gradients per key at fp32 1e-5.
- `torch.export` of a 2-member ensemble rollout over the MaxVal gather
  and scatter (K5's rule over the operator), saved and loaded, against
  each member's in-process block rollout at fp32 1e-5.
- `prob.bn_update` over a BatchNorm variant architecture against the JAX
  package's at fp32 1e-5.

The tiny stand-in grids and helpers are `tests/test_torch_grids400.py`'s."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.models import get_model as jget_model  # noqa: E402

from deepsphere_weather_torch.models import get_model  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax  # noqa: E402
from test_torch_grids400 import (  # noqa: E402
    B,
    F_DYN,
    INPUT_K,
    KNN,
    STAND_IN,
    TOL,
    rel_err,
    seeded_tree,
    tensor_info,
)


def _pool_model(sampling_dir, pool, seed, **kw):
    name, skw = STAND_IN[sampling_dir]
    n = build_sampling(name, skw).n_nodes
    model = get_model("UNetSpherical", tensor_info(n), sampling=name,
                      sampling_kwargs=skw, knn=KNN, pool_method=pool,
                      graph_type="voronoi", dense_threshold=n - 1,
                      device="cpu", **kw)
    return model, seeded_tree(model, seed)


@pytest.mark.parametrize("sampling_dir,pool", [("Icosahedral_400km", "learn"),
                                               ("O24", "maxval")])
def test_member_step_over_remap_pools(sampling_dir, pool):
    """Two members in one member step (`torch.func.grad` under `vmap`
    over the gather/scatter pools and, for 'learn', the logits), each
    clipped by its own norm, against each member's single step: losses
    and clipped gradients per key at fp32 1e-5."""
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine import (
        Adam,
        make_member_train_step,
        make_train_step,
    )
    from deepsphere_weather_torch.models import MemberStack

    model, tree0 = _pool_model(sampling_dir, pool, 7)
    tree1 = seeded_tree(model, 8)
    states = [params_from_jax(t) for t in (tree0, tree1)]
    indexer = ARIndexer.build(INPUT_K, [0], 1, 1)
    n = model.input_n_node
    rng = np.random.default_rng(9)
    W = indexer.window_size
    batch = {"dynamic": rng.standard_normal((B, W, n, F_DYN)),
             "bc": rng.standard_normal((B, W, n, 1)),
             "static": rng.standard_normal((n, 2))}
    batch = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in batch.items()}
    w = np.ones(2, np.float32)
    # the clip bound between the members' norms: one member clips
    norms = []
    for state in states:
        model.load_state_dict(state)
        opt = Adam(model.parameters(), 1e-3)
        make_train_step(model, indexer, opt, 2)(batch, w)
        norms.append(float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                          for p in model.parameters()))))
    clip = float(np.sqrt(norms[0] * norms[1]))
    assert max(norms) > min(norms) * 1.01, norms
    singles = []
    for state in states:
        model.load_state_dict(state)
        opt = Adam(model.parameters(), 1e-3, gradient_clipping=clip)
        _, per_iter = make_train_step(model, indexer, opt, 2)(batch, w)
        singles.append((per_iter.numpy(), {k: p.grad.clone() for k, p
                                           in model.named_parameters()}))
    stack = MemberStack.from_states(model, states)
    opt = Adam(stack.parameters(), 1e-3, gradient_clipping=clip,
               member_axis=True)
    _, per_iter = make_member_train_step(stack, indexer, opt, 2)(batch, w)
    grads = {k: p.grad for k, p in stack.named_parameters()}
    if pool == "learn":
        assert {"pool0", "unpool0"} <= set(grads)
    for i, (s_iter, s_grads) in enumerate(singles):
        assert rel_err(per_iter[i].numpy(), s_iter) <= TOL["fp32"]
        for k, g in s_grads.items():
            assert rel_err(grads[k][i].numpy(), g.numpy()) <= TOL["fp32"], k


def test_ensemble_export_over_maxval_pools(tmp_path):
    """`torch.export` of a 2-member ensemble rollout (K5's rule over the
    operator, vmap over the MaxVal gather and scatter), saved and loaded,
    against each member's in-process block rollout: fp32 1e-5."""
    from deepsphere_weather_torch.data.ar import ARIndexer
    from deepsphere_weather_torch.engine.step import make_rollout_block
    from deepsphere_weather_torch.serve import (
        ForecastService,
        export_ensemble_rollout,
        save_artifact,
    )

    model, tree0 = _pool_model("O24", "maxval", 11)
    states = [params_from_jax(t) for t in (tree0, seeded_tree(model, 12))]
    V = model.input_n_node
    rng = np.random.default_rng(13)
    static = rng.standard_normal((V, 2)).astype(np.float32)
    hist = rng.standard_normal((2, 4, V, F_DYN)).astype(np.float32)
    bc = rng.standard_normal((2, 2, 3, V, 1)).astype(np.float32)
    save_artifact(tmp_path / "ens", export_ensemble_rollout(
        model, states, input_k=INPUT_K, output_k=[0], forecast_cycle=1,
        batch_size=2, block_size=2, n_bc_features=1, static=static))
    out = ForecastService.from_dir(tmp_path / "ens").predict(hist, n_steps=2,
                                                             bc=bc)
    assert out.shape == (2, 2, 2, 1, V, F_DYN)
    rollout, _ = make_rollout_block(
        model, ARIndexer.build(INPUT_K, [0], 1, 1), 2)
    for i, state in enumerate(states):
        model.load_state_dict(state)
        with torch.no_grad():
            _, _, ref = rollout(torch.from_numpy(hist), None,
                                torch.from_numpy(bc), torch.from_numpy(static))
        assert rel_err(out[i], ref.numpy()) <= TOL["fp32"]


def test_bn_update_on_a_variant_matches_jax(tmp_path):
    """`prob.bn_update` over a BatchNorm ResNetSpherical (HEALPix-4,
    level 0 block-sparse) against the JAX package's on the same toy
    store: every running statistic at fp32 1e-5."""
    from deepsphere_weather_tpu.data import (
        GlobalStandardScaler as JGlobalStandardScaler,
    )
    from deepsphere_weather_tpu.data import generate_toy_data as jtoy
    from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator
    from deepsphere_weather_tpu.ops.pallas_spmm import (
        BlockSparseOperator as JBlockSparseOperator,
    )
    from deepsphere_weather_tpu.prob import bn_update as jbn_update
    from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph

    from deepsphere_weather_torch.data import (
        GlobalStandardScaler,
        SphericalDataset,
        StaticDataset,
        get_ar_model_tensor_info,
    )
    from deepsphere_weather_torch.prob import bn_update
    from deepsphere_weather_torch.weights import norm_state_to_jax

    name, skw = STAND_IN["Healpix_400km"]
    jdyn, jbc, jstatic = jtoy(tmp_path, sampling_kwargs=skw, n_timesteps=40,
                              seed=5)
    dyn = SphericalDataset.open(
        tmp_path / "Data/dynamic/time_chunked/dynamic.zarr")
    bc = SphericalDataset.open(tmp_path / "Data/bc/time_chunked/bc.zarr")
    static = StaticDataset.open(tmp_path / "Data/static.zarr")
    ar = {"input_k": INPUT_K, "output_k": [0], "forecast_cycle": 1,
          "ar_iterations": 1}
    info = get_ar_model_tensor_info(ar, dyn, data_static=static, data_bc=bc)
    kw = dict(sampling=name, sampling_kwargs=skw, knn=KNN, batch_norm=True)
    model = get_model("ResNetSpherical", info, dense_threshold=191,
                      device="cpu", **kw)
    jmodel = jget_model("ResNetSpherical", info, **kw)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph(name, skw, k=KNN).L, symmetric=True, interpret=True))
    tree = seeded_tree(model, 14)
    model.load_state_dict(params_from_jax(tree))
    common = dict(input_k=ar["input_k"], output_k=ar["output_k"],
                  forecast_cycle=1, ar_iterations=1, batch_size=4,
                  max_batches=2, num_workers=1)
    state = bn_update(model, data_dynamic=dyn, data_bc=bc, data_static=static,
                      scaler=GlobalStandardScaler().fit_dataset(dyn), **common)
    jstate = jbn_update(jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
                        data_dynamic=jdyn, data_bc=jbc, data_static=jstatic,
                        scaler=JGlobalStandardScaler().fit_dataset(jdyn),
                        **common)
    got = dict(jax.tree_util.tree_flatten_with_path(
        norm_state_to_jax(state))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    assert got.keys() == want.keys() and len(got) > 0
    for k, v in want.items():
        assert rel_err(got[k], v) <= TOL["fp32"], k
