"""Port SWAG, BatchNorm re-estimation, ensemble stores, probabilistic
verification and the SWAG fine-tuning CLI vs the JAX package.

- `SWAG`: the flat order (the JAX tree's leaf order, not
  `named_parameters()`'s), `collect_model` over more snapshots than
  `max_num_models` (the ring wraps): `state_arrays` within 1e-7; `sample`
  full-rank and blockwise, with and without covariance, fed the z1 / z2
  that JAX's `sample` draws from its key (recomputed with
  `jax.random.split` and `jax.random.normal`): within 1e-6; the
  `no_cov_mat` refusal; `load_state_arrays`' resize rule and its error;
  `model_swag.npz` written by either package loads in the other.
- `bn_update` of a BatchNorm UNet (HEALPix-4, level 0 block-sparse) on
  toy data: within 1e-5.
- `verif.probabilistic` (CRPS fair and biased, spread/skill, rank
  histogram) on random ensembles, and `probabilistic` of both packages on
  one ensemble store: within 1e-10.
- `AutoregressiveSWAGPredictions` of a BatchNorm model (each member's
  statistics re-estimated by `bn_update`, its forecast in eval mode): the
  member stores within 1e-5.
- `engine.optim.swa_schedule` equals optax's `linear_schedule` exactly, and
  `Adam(lr_schedule=...)` steps with it from the first update.
- `cli.finetune_swag.main` on one toy experiment, trained once by the
  port's CLI and copied for each package: fine-tune losses within 2e-4,
  the SWAG state within 2e-4 (the deviation columns, differences of
  parameters, of the parameters' scale); with both packages' samplers patched to the
  same members (drawn by JAX, carried over): the member, ensemble and
  median stores (`AutoregressiveSWAGPredictions`, `build_ensemble_store`,
  `ensemble_median`) and the median and probabilistic skills within 1e-5.
- `cli.export_model --swag_samples` (sampler patched) equals the
  `member_dirs` artifact of the same parameters within 1e-5;
  `cli.finetune_swag` refuses a missing card unless asked for the CPU.
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

import deepsphere_weather_tpu.prob.swag as jswag_mod  # noqa: E402
from deepsphere_weather_tpu.cli.finetune_swag import main as jfinetune  # noqa: E402
from deepsphere_weather_tpu.data import (  # noqa: E402
    GlobalStandardScaler as JGlobalStandardScaler,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.ops.cheb import ChebOperator as JChebOperator  # noqa: E402
from deepsphere_weather_tpu.ops.pallas_spmm import (  # noqa: E402
    BlockSparseOperator as JBlockSparseOperator,
)
from deepsphere_weather_tpu.data import SphericalDataset as JSphericalDataset  # noqa: E402
from deepsphere_weather_tpu.prob import (  # noqa: E402
    AutoregressiveSWAGPredictions as JAutoregressiveSWAGPredictions,
    EnsembleForecastDataset as JEnsembleForecastDataset,
)
from deepsphere_weather_tpu.prob import SWAG as JSWAG  # noqa: E402
from deepsphere_weather_tpu.prob import bn_update as jbn_update  # noqa: E402
from deepsphere_weather_tpu.verif import probabilistic as jprobabilistic  # noqa: E402
from deepsphere_weather_tpu.sphere import build_graph as jbuild_graph  # noqa: E402
from deepsphere_weather_tpu.verif.probabilistic import (  # noqa: E402
    crps_ensemble as jcrps_ensemble,
    ensemble_spread_skill as jensemble_spread_skill,
    rank_histogram as jrank_histogram,
)

import deepsphere_weather_torch.prob.swag as swag_mod  # noqa: E402
from deepsphere_weather_torch.cli.export_model import main as export_main  # noqa: E402
from deepsphere_weather_torch.cli.finetune_swag import main as finetune  # noqa: E402
from deepsphere_weather_torch.cli.train_predict import main as train_main  # noqa: E402
from deepsphere_weather_torch.data import (  # noqa: E402
    GlobalStandardScaler,
    SphericalDataset,
    StaticDataset,
)
from deepsphere_weather_torch.engine import Adam, swa_schedule  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.prob import (  # noqa: E402
    SWAG,
    AutoregressiveSWAGPredictions,
    EnsembleForecastDataset,
    bn_update,
)
from deepsphere_weather_torch.serve import load_artifact  # noqa: E402
from deepsphere_weather_torch.utils.checkpoint import save_arrays  # noqa: E402
from deepsphere_weather_torch.verif import (  # noqa: E402
    crps_ensemble,
    ensemble_spread_skill,
    probabilistic,
    rank_histogram,
)
from deepsphere_weather_torch.weights import (  # noqa: E402
    norm_state_to_jax,
    params_from_jax,
    params_to_jax,
    seeded_params,
)

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN = 192, 8
STATE_TOL, SAMPLE_TOL, FP32, TRAIN_TOL, VERIF_TOL = 1e-7, 1e-6, 1e-5, 2e-4, 1e-10
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"
AR = {"input_k": [-3, -2, -1], "output_k": [0], "forecast_cycle": 1,
      "ar_iterations": 1}


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _info():
    return {"input_n_feature": 5, "output_n_feature": 2, "input_n_time": 3,
            "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": V}},
            "output_shape_info": {"dynamic": {"node": V}}}


@pytest.fixture(scope="module")
def snapshots():
    """A UNet (the names the flat order must sort: uconv1 beside
    uconv1_final, ...) and 7 seeded parameter trees."""
    model = UNetSpherical(_info(), "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          device="cpu")
    return model, [seeded_params(model, s) for s in range(7)]


def collected(model, trees, max_num_models=5, no_cov_mat=False):
    swag = SWAG(model, max_num_models=max_num_models, no_cov_mat=no_cov_mat)
    jswag = JSWAG(jax.tree_util.tree_map(jnp.asarray, trees[0]),
                  max_num_models=max_num_models, no_cov_mat=no_cov_mat)
    for tree in trees:
        swag.collect_model(params_from_jax(tree))
        jswag.collect_model(jax.tree_util.tree_map(jnp.asarray, tree))
    return swag, jswag


def test_flat_order_is_the_jax_leaf_order(snapshots):
    model, trees = snapshots
    swag = SWAG(model)
    jpaths = ["/".join(str(p.key) for p in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(trees[0])[0]]
    assert [n.replace(".", "/") for n in swag._names] == jpaths
    # named_parameters() order differs (it would unflatten wrongly)
    assert [n for n, _ in model.named_parameters()] != swag._names


@pytest.mark.parametrize("no_cov_mat", [False, True], ids=["cov", "no_cov"])
def test_collect_matches_jax(snapshots, no_cov_mat):
    model, trees = snapshots
    swag, jswag = collected(model, trees, no_cov_mat=no_cov_mat)
    got, want = swag.state_arrays(), jswag.state_arrays()
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["scalars"], want["scalars"])
    # 7 collections into a ring of 5: the head wrapped (no columns
    # without covariance)
    assert list(got["scalars"]) == ([7, 0, 0] if no_cov_mat else [7, 5, 2])
    for k in ("mean", "sq_mean", "cov_cols"):
        assert got[k].shape == want[k].shape
        if np.abs(want[k]).max() > 0:
            assert rel_err(got[k], want[k]) <= STATE_TOL, k
    mean, var = swag.export_numpy_params()
    jmean, jvar = jswag.export_numpy_params()
    assert rel_err(mean, jmean) <= STATE_TOL
    assert rel_err(var, jvar) <= STATE_TOL


@pytest.mark.parametrize("block", [False, True], ids=["fullrank", "block"])
@pytest.mark.parametrize("cov", [True, False], ids=["cov", "diag"])
def test_sample_formula_matches_jax(snapshots, block, cov):
    model, trees = snapshots
    swag, jswag = collected(model, trees)
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    n = swag.state.mean.shape[0]
    z1 = np.asarray(jax.random.normal(k1, (n,)))
    z2 = np.asarray(jax.random.normal(k2, (swag.max_num_models,)))
    got = swag.sample_from(torch.from_numpy(z1), torch.from_numpy(z2),
                           scale=0.3, cov=cov, block=block)
    want = jswag.sample(key, scale=0.3, cov=cov, block=block)
    flat_got = np.concatenate([np.ravel(np.asarray(v)) for _, v in
                               jax.tree_util.tree_flatten_with_path(
                                   params_to_jax(got))[0]])
    flat_want = np.concatenate([np.ravel(np.asarray(v)) for v in
                                jax.tree_util.tree_leaves(want)])
    assert rel_err(flat_got, flat_want) <= SAMPLE_TOL
    # the port's own draw: the right tree, finite, and not the mean
    drawn = swag.sample(torch.Generator().manual_seed(0), scale=0.3, cov=cov,
                        block=block)
    assert sorted(drawn) == sorted(got)
    assert all(torch.isfinite(v).all() for v in drawn.values())
    assert any(not torch.equal(drawn[k], swag.mean_params[k])
               for k in drawn)


def test_no_cov_mat_refuses_cov(snapshots):
    model, trees = snapshots
    swag, _ = collected(model, trees[:2], no_cov_mat=True)
    with pytest.raises(RuntimeError, match="no_cov_mat=True"):
        swag.sample(cov=True)
    swag.sample(cov=False)


def test_load_state_arrays_resize_rule(snapshots):
    model, trees = snapshots
    src, _ = collected(model, trees[:3], max_num_models=4)
    arrays = src.state_arrays()
    # a larger buffer takes the columns and moves the head to n_cols
    big = SWAG(model, max_num_models=8)
    big.load_state_arrays(arrays)
    jbig = JSWAG(jax.tree_util.tree_map(jnp.asarray, trees[0]),
                 max_num_models=8)
    jbig.load_state_arrays(arrays)
    got, want = big.state_arrays(), jbig.state_arrays()
    np.testing.assert_array_equal(got["scalars"], want["scalars"])
    np.testing.assert_array_equal(got["cov_cols"], want["cov_cols"])
    assert got["cov_cols"].shape[0] == 8
    # a buffer too small for the valid columns refuses
    tiny = SWAG(model, max_num_models=2)
    with pytest.raises(ValueError, match="covariance columns"):
        tiny.load_state_arrays(arrays)


def test_swag_files_cross_packages(snapshots, tmp_path):
    model, trees = snapshots
    swag, jswag = collected(model, trees)
    swag.save(tmp_path / "port_swag.npz")
    jswag.save(tmp_path / "jax_swag.npz")
    jin = JSWAG(jax.tree_util.tree_map(jnp.asarray, trees[0]),
                max_num_models=5)
    jin.load(tmp_path / "port_swag.npz")
    pin = SWAG(model, max_num_models=5)
    pin.load(tmp_path / "jax_swag.npz")
    for a, b in ((jin.state_arrays(), swag.state_arrays()),
                 (pin.state_arrays(), jswag.state_arrays())):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the mean unflattens to the same tree on both sides
    assert rel_err(np.asarray(params_to_jax(pin.mean_params)["conv1"][
        "convblock1"]["weight"]), np.asarray(jswag.mean_params["conv1"][
            "convblock1"]["weight"])) <= STATE_TOL


# --- bn_update ---------------------------------------------------------------

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("swag_toy")
    jdyn, jbc, jstatic = jgenerate_toy_data(root, sampling_kwargs=SAMPLING,
                                            n_timesteps=80, seed=13)
    return {"jax": (jdyn, jbc, jstatic),
            "port": (SphericalDataset.open(root / DYN),
                     SphericalDataset.open(root / BC),
                     StaticDataset.open(root / STATIC)),
            "info": jget_ar_model_tensor_info(AR, jdyn, data_static=jstatic,
                                              data_bc=jbc)}


def bn_pair(info, seed):
    """(port model, JAX model, seeded JAX tree): a BatchNorm UNet, level 0
    block-sparse on both sides."""
    kw = dict(knn=KNN, pool_method="max", increment_learning=True,
              batch_norm=True)
    model = UNetSpherical(info, "healpix", SAMPLING, dense_threshold=V - 1,
                          device="cpu", **kw)
    jmodel = JUNetSpherical(info, "healpix", SAMPLING, **kw)
    jmodel.geometry.cheb_ops[0] = JChebOperator(
        bcsr=JBlockSparseOperator.from_scipy(
            jbuild_graph("healpix", SAMPLING, k=KNN).L, symmetric=True,
            interpret=True, dtype=np.float32))
    tree = seeded_params(model, seed)
    for blk in tree.values():
        if isinstance(blk, dict):
            blk["rezero_weight"] *= 0.1
    model.load_state_dict(params_from_jax(tree))
    return model, jmodel, tree


@pytest.mark.parametrize("keep_first", [False, True],
                         ids=["recent", "keep_first"])
def test_bn_update_matches_jax(toy, keep_first):
    ar = ({"input_k": [-2, -1], "output_k": [0, 1], "forecast_cycle": 1,
           "ar_iterations": 2} if keep_first else {**AR, "ar_iterations": 2})
    jdyn, jbc, jstatic = toy["jax"]
    dyn, bc, static = toy["port"]
    info = jget_ar_model_tensor_info(ar, jdyn, data_static=jstatic,
                                     data_bc=jbc)
    model, jmodel, tree = bn_pair(info, 21)
    common = dict(input_k=ar["input_k"], output_k=ar["output_k"],
                  forecast_cycle=ar["forecast_cycle"],
                  ar_iterations=ar["ar_iterations"], batch_size=8,
                  max_batches=3, num_workers=1)
    before = {k: v.clone() for k, v in model.norm_state().items()}
    state = bn_update(model, data_dynamic=dyn, data_bc=bc,
                      data_static=static,
                      scaler=GlobalStandardScaler().fit_dataset(dyn),
                      **common)
    jstate = jbn_update(jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
                        data_dynamic=jdyn, data_bc=jbc, data_static=jstatic,
                        scaler=JGlobalStandardScaler().fit_dataset(jdyn),
                        **common)
    got = norm_state_to_jax(state)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert rel_err(g, w) <= FP32, path
    # the model's own statistics are left as they were
    for k, v in model.norm_state().items():
        assert torch.equal(v, before[k])


def test_swag_predictions_with_batchnorm_match_jax(toy, tmp_path,
                                                   monkeypatch):
    """Each member sampled in turn (both samplers patched to the same
    members), its BatchNorm statistics re-estimated by `bn_update` and its
    forecast rolled in eval mode with them: the member stores within
    1e-5."""
    jdyn, jbc, jstatic = toy["jax"]
    dyn, bc, static = toy["port"]
    model, jmodel, tree = bn_pair(toy["info"], 22)
    trees = [tree, seeded_params(model, 23)]
    for blk in trees[1].values():
        if isinstance(blk, dict):
            blk["rezero_weight"] *= 0.1
    jtrees = iter([jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    ptrees = iter([params_from_jax(t) for t in trees])
    monkeypatch.setattr(jswag_mod.SWAG, "sample",
                        lambda self, *a, **k: next(jtrees))
    monkeypatch.setattr(swag_mod.SWAG, "sample",
                        lambda self, *a, **k: next(ptrees))
    bn_kw = dict(input_k=AR["input_k"], output_k=AR["output_k"],
                 forecast_cycle=AR["forecast_cycle"], ar_iterations=1,
                 batch_size=8, max_batches=2, num_workers=1)
    # two steps: the random network's eval-mode rollout grows fast
    pred_kw = dict(input_k=AR["input_k"], output_k=AR["output_k"],
                   forecast_cycle=AR["forecast_cycle"], ar_iterations=1,
                   batch_size=4, forecast_reference_times=None)
    scaler = GlobalStandardScaler().fit_dataset(dyn)
    jscaler = JGlobalStandardScaler().fit_dataset(jdyn)
    out = AutoregressiveSWAGPredictions(
        model, SWAG(model), nb_samples=2, out_dir=tmp_path / "port",
        bn_update_data=dict(data_dynamic=dyn.subset(0, 40), data_bc=bc,
                            data_static=static, scaler=scaler, **bn_kw),
        data_dynamic=dyn.subset(40, 60), data_bc=bc.subset(40, 60),
        data_static=static, scaler=scaler, **pred_kw)
    jout = JAutoregressiveSWAGPredictions(
        jmodel, JSWAG(jax.tree_util.tree_map(jnp.asarray, tree)),
        rng=jax.random.key(0), nb_samples=2, out_dir=tmp_path / "jax",
        bn_update_data=dict(data_dynamic=jdyn.subset(0, 40), data_bc=jbc,
                            data_static=jstatic, scaler=jscaler, **bn_kw),
        data_dynamic=jdyn.subset(40, 60), data_bc=jbc.subset(40, 60),
        data_static=jstatic, scaler=jscaler, **pred_kw)
    for fc, jfc in zip(out["members"], jout["members"]):
        for name in fc.feature_order:
            assert rel_err(fc.variables[name][...],
                           jfc.variables[name][...]) <= FP32, name
    a, b = (out["members"][m].variables["z500"][...] for m in (0, 1))
    assert np.abs(a - b).max() > 0
    # the model has its own weights back
    np.testing.assert_array_equal(
        model.conv1.rezero_weight.detach().numpy(),
        tree["conv1"]["rezero_weight"])


# --- probabilistic verification and the SWA schedule ------------------------

def test_probabilistic_metrics_match_jax():
    rng = np.random.default_rng(31)
    members = rng.standard_normal((5, 6, 40, 2))
    obs = rng.standard_normal((6, 40, 2))
    for fair in (True, False):
        assert rel_err(crps_ensemble(members, obs, fair=fair),
                       jcrps_ensemble(members, obs, fair=fair)) <= VERIF_TOL
    got, want = ensemble_spread_skill(members, obs), \
        jensemble_spread_skill(members, obs)
    assert sorted(got) == sorted(want)
    for k in got:
        assert rel_err(got[k], want[k]) <= VERIF_TOL, k
    np.testing.assert_array_equal(rank_histogram(members, obs),
                                  jrank_histogram(members, obs))
    with pytest.raises(ValueError, match="fair CRPS needs >= 2"):
        crps_ensemble(members[:1], obs)


@pytest.mark.parametrize("base,target,start", [
    (0.007, 0.001, 10), (0.002, 0.001, 0), (0.005, 0.0005, 3)])
def test_swa_schedule_is_optax_linear_schedule(base, target, start):
    sched = swa_schedule(base, target, start)
    ref = (optax.linear_schedule(init_value=base, end_value=target,
                                 transition_steps=start) if start > 0
           else None)
    for count in range(start + 5):
        want = (float(np.float32(target)) if ref is None
                else float(ref(jnp.asarray(count, jnp.int32))))
        assert sched(count) == want, count
    # the optimizer steps with the rate of the count before each update
    p = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p], lr=base, lr_schedule=sched)
    for count in range(start + 2):
        p.grad = torch.ones(3)
        opt.step()
        assert opt.param_groups[0]["lr"] == sched(count)
    assert opt.updates == start + 2


# --- the fine-tuning CLI and the SWAG export ---------------------------------

CONFIG = {
    "model_settings": {
        "sampling_name": "Healpix_toy", "sampling": "healpix",
        "sampling_kwargs": SAMPLING, "knn": KNN,
        "architecture_name": "UNetSpherical", "increment_learning": True,
        "pool_method": "Max"},
    "training_settings": {
        "epochs": 1, "learning_rate": 0.002, "training_batch_size": 8,
        "validation_batch_size": 8, "scoring_interval": 3,
        "gradient_clipping": 1.0, "early_stopping_patience": 50,
        "seed_random_shuffling": 3},
    "ar_settings": AR,
    "dataloader_settings": {"num_workers": 1},
}
NAME = "RNN-AR1-UNetSpherical-Healpix_toy-Graph_knn-k8-MaxPooling"
N_SAMPLES = 2


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """One toy experiment trained by the port's CLI, copied for each
    package and fine-tuned by each (the JAX package first: its sampler
    draws the members, which the port's patched sampler returns)."""
    root = tmp_path_factory.mktemp("swag_cli")
    jgenerate_toy_data(root / "data_port", sampling_kwargs=SAMPLING,
                       n_timesteps=200, seed=7)
    (root / "config.json").write_text(json.dumps(CONFIG))
    train_main(root / "config.json", root / "data_port", root / "exp",
               force=True, ar_iterations_prediction=1, verbose=False,
               device="cpu")
    # with the scaler the training fitted and saved
    shutil.copytree(root / "data_port", root / "data_jax")
    for side in ("port", "jax"):
        shutil.copytree(root / "exp" / NAME, root / side / NAME)
    drawn = []
    real_sample = jswag_mod.SWAG.sample

    def jax_sample(self, rng, scale=1.0, cov=True, block=False):
        tree = real_sample(self, rng, scale=scale, cov=cov, block=block)
        drawn.append(tree)
        return tree

    kw = dict(epochs=1, nb_samples=N_SAMPLES, swag_freq=1,
              ar_iterations_prediction=2, max_num_models=4,
              sampling_scale=0.5, verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jswag_mod.SWAG, "sample", jax_sample)
        jout, jgs = jfinetune(root / "jax" / NAME, root / "data_jax", **kw)

    carried = iter(drawn)

    def port_sample(self, generator=None, scale=1.0, cov=True, block=False):
        return params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      next(carried)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(swag_mod.SWAG, "sample", port_sample)
        out, gs = finetune(root / "port" / NAME, root / "data_port",
                           device="cpu", **kw)
    return {"root": root, "port": (out, gs), "jax": (jout, jgs),
            "drawn": drawn}


def _info_json(exp):
    return json.loads((exp / "swag_finetune/training_info"
                       "/ar_training_info.json").read_text())


def test_finetune_swag_matches_jax(finetuned):
    root = finetuned["root"]
    exp, jexp = root / "port" / NAME, root / "jax" / NAME
    info, jinfo = _info_json(exp), _info_json(jexp)
    assert info["iterations"] == jinfo["iterations"]
    assert len(info["iterations"]) >= 3
    assert rel_err(info["training_total_loss"],
                   jinfo["training_total_loss"]) <= TRAIN_TOL
    assert rel_err(info["validation_total_loss"],
                   jinfo["validation_total_loss"]) <= TRAIN_TOL
    # the posterior: the pretrained weights + one collection per scoring
    with np.load(exp / "model_weights/model_swag.npz") as z, \
            np.load(jexp / "model_weights/model_swag.npz") as jz:
        assert sorted(z.files) == sorted(jz.files)
        np.testing.assert_array_equal(z["scalars"], jz["scalars"])
        assert z["scalars"][0] == 1 + len(info["iterations"])
        for k in ("mean", "sq_mean"):
            assert rel_err(z[k], jz[k]) <= TRAIN_TOL, k
        # the deviation columns w - mean are differences of parameters
        # held to 2e-4 of their scale: the same scale bounds them
        assert (np.abs(z["cov_cols"] - jz["cov_cols"]).max()
                / np.abs(jz["mean"]).max()) <= TRAIN_TOL
    # the experiment's own weights are untouched; the fine-tune has its own
    assert (exp / "swag_finetune/model_weights/model.npz").exists()
    np.testing.assert_array_equal(
        np.load(exp / "model_weights/model.npz")["conv1/rezero_weight"],
        np.load(root / "exp" / NAME / "model_weights/model.npz")[
            "conv1/rezero_weight"])


def test_swag_predictions_and_skills_match_jax(finetuned):
    (out, gs), (jout, jgs) = finetuned["port"], finetuned["jax"]
    assert len(finetuned["drawn"]) == N_SAMPLES
    for m, (fc, jfc) in enumerate(zip(out["members"], jout["members"])):
        for name in fc.feature_order:
            assert rel_err(fc.variables[name][...],
                           jfc.variables[name][...]) <= FP32, (m, name)
    ens, jens = out["ensemble"], jout["ensemble"]
    assert ens.n_member == jens.n_member == N_SAMPLES
    assert ens.group.attrs == jens.group.attrs
    for name in ens.feature_order:
        assert rel_err(ens.variables[name][...],
                       jens.variables[name][...]) <= FP32
        assert rel_err(out["median"].variables[name][...],
                       jout["median"].variables[name][...]) <= FP32
    assert rel_err(gs["RMSE"], jgs["RMSE"]) <= FP32
    root = finetuned["root"]
    for f in ("swag_median_global_skill.npz",
              "swag_probabilistic_global_skill.npz"):
        with np.load(root / "port" / NAME / "model_skills" / f) as z, \
                np.load(root / "jax" / NAME / "model_skills" / f) as jz:
            for k in jz.files:
                if jz[k].dtype.kind == "f" and np.isfinite(jz[k]).all():
                    assert rel_err(z[k], jz[k]) <= FP32, (f, k)
    with np.load(root / "port" / NAME / "model_skills"
                 / "swag_probabilistic_global_skill.npz") as z:
        assert np.isfinite(z["skill_CRPS"]).all()


def test_probabilistic_verifier_matches_jax_on_one_store(finetuned):
    """Both packages' `probabilistic` on the port's ensemble store against
    the observations: within 1e-10."""
    root = finetuned["root"]
    path = root / "port" / NAME / "model_predictions" / "swag" / "ensemble.zarr"
    got = probabilistic(EnsembleForecastDataset.open(path),
                        SphericalDataset.open(root / "data_port" / DYN))
    want = jprobabilistic(JEnsembleForecastDataset.open(path),
                          JSphericalDataset.open(root / "data_jax" / DYN))
    assert sorted(got.skills) == sorted(want.skills)
    for k in want.skills:
        assert rel_err(got[k], want[k]) <= VERIF_TOL, k


def test_export_swag_samples_equals_member_dirs(finetuned, monkeypatch):
    root = finetuned["root"]
    exp = root / "port" / NAME
    samples = [params_from_jax(jax.tree_util.tree_map(np.asarray, t))
               for t in finetuned["drawn"]]
    dirs = []
    for m, s in enumerate(samples):
        d = root / f"member{m}"
        save_arrays(d / "model_weights" / "model.npz",
                    {k.replace(".", "/"): v.numpy() for k, v in s.items()})
        dirs.append(d)
    it = iter(samples)
    monkeypatch.setattr(swag_mod.SWAG, "sample",
                        lambda self, *a, **k: next(it))
    kw = dict(batch_size=2, block_size=2, verbose=False, device="cpu")
    export_main(exp, root / "data_port", out=root / "art_swag",
                swag_samples=N_SAMPLES, **kw)
    export_main(exp, root / "data_port", out=root / "art_dirs",
                member_dirs=dirs, **kw)
    (a, _, _), (b, _, _) = (load_artifact(root / "art_swag"),
                            load_artifact(root / "art_dirs"))
    assert a.n_members == b.n_members == N_SAMPLES
    m = a.meta
    rng = np.random.default_rng(41)
    hist = rng.standard_normal((N_SAMPLES, m["batch_size"],
                                m["history_size"], m["n_node"],
                                m["n_dynamic_features"])).astype(np.float32)
    bc = rng.standard_normal((m["batch_size"], m["block_size"],
                              m["n_input_k"], m["n_node"],
                              m["n_bc_features"])).astype(np.float32)
    _, pa = a.call(hist, bc)
    _, pb = b.call(hist, bc)
    assert np.isfinite(pa.numpy()).all()
    assert rel_err(pa.numpy(), pb.numpy()) <= FP32


def test_finetune_swag_refuses_a_missing_card(tmp_path):
    # the entry point runs on the card unless asked for the CPU
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal path does not run")
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune(tmp_path / "exp", tmp_path / "data", verbose=False)
