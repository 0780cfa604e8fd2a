"""Port predictions, verification and the train -> predict -> verify CLI
vs the JAX package.

At HEALPix-4 (192 nodes, knn 8), fp32, from the same seeded weights
(`weights.seeded_params`, ReZero weights x 0.1) on the same toy store:

- `AutoregressivePredictions`: 6 reference times in batches of 4 and 2,
  6 AR steps in blocks of 4 and a tail of 2, boundary conditions and
  scalers: the forecasts within 1e-5 (max abs error / max abs, per
  variable), and the two stores with the same arrays, chunks and
  attributes (coordinates exact);
- the deterministic verifier: each package's verifier on each package's
  store (and on the space-chunked copies) gives the same skills within
  1e-6, and the same global summary;
- the CLI: both `main`s train, predict and verify one toy experiment from
  one initial checkpoint (`pretrained_model_name`): the same experiment
  tree, the plots under figs/ included, and RMSE per leadtime within 3e-3
  relative (`docs/benchmarks/parity_protocol.json`); then each package
  `--resume`s the other's experiment.
"""

import json
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from deepsphere_weather_tpu.cli.train_predict import main as jmain  # noqa: E402
from deepsphere_weather_tpu.data import (  # noqa: E402
    GlobalStandardScaler as JGlobalStandardScaler,
    SphericalDataset as JSphericalDataset,
    StaticDataset as JStaticDataset,
    generate_toy_data as jgenerate_toy_data,
    get_ar_model_tensor_info as jget_ar_model_tensor_info,
)
from deepsphere_weather_tpu.engine import (  # noqa: E402
    AutoregressivePredictions as JAutoregressivePredictions,
    rechunk_forecasts_for_verification as jrechunk,
)
from deepsphere_weather_tpu.engine.prediction import (  # noqa: E402
    ForecastDataset as JForecastDataset,
)
from deepsphere_weather_tpu.models import UNetSpherical as JUNetSpherical  # noqa: E402
from deepsphere_weather_tpu.utils.checkpoint import save_pytree  # noqa: E402
from deepsphere_weather_tpu.verif import (  # noqa: E402
    SkillDataset as JSkillDataset,
    deterministic as jdeterministic,
    global_summary as jglobal_summary,
)

from deepsphere_weather_torch.cli.train_predict import main  # noqa: E402
from deepsphere_weather_torch.data import (  # noqa: E402
    GlobalStandardScaler,
    SphericalDataset,
    StaticDataset,
)
from deepsphere_weather_torch.engine import (  # noqa: E402
    AreaWeights,
    AutoregressivePredictions,
    rechunk_forecasts_for_verification,
)
from deepsphere_weather_torch.engine.prediction import ForecastDataset  # noqa: E402
from deepsphere_weather_torch.models import UNetSpherical  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.verif import (  # noqa: E402
    SkillDataset,
    deterministic,
    global_summary,
)
from deepsphere_weather_torch.weights import params_from_jax, seeded_params  # noqa: E402

SAMPLING = {"subdivisions": 4, "nest": True}
KNN = 8
FORECAST_TOL, SKILL_TOL, RMSE_TOL = 1e-5, 1e-6, 3e-3
AR = {"input_k": [-3, -2, -1], "output_k": [0], "forecast_cycle": 1}
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"
STATIC = "Data/static.zarr"


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


def seeded_tree(info, seed):
    model = UNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                          pool_method="max", increment_learning=True,
                          device="cpu")
    tree = seeded_params(model, seed)
    for block in tree.values():
        if isinstance(block, dict):
            block["rezero_weight"] *= 0.1
    return model, tree


@pytest.fixture(scope="module")
def forecasts(tmp_path_factory):
    """Both packages' forecasts of one test period from the same weights
    (the port's kept in RAM too, the JAX one's store-backed)."""
    root = tmp_path_factory.mktemp("predict")
    jgenerate_toy_data(root / "data", sampling_kwargs=SAMPLING,
                       n_timesteps=160, seed=9)
    d = root / "data"
    port = (SphericalDataset.open(d / DYN), SphericalDataset.open(d / BC),
            StaticDataset.open(d / STATIC))
    jax_ = (JSphericalDataset.open(d / DYN), JSphericalDataset.open(d / BC),
            JStaticDataset.open(d / STATIC))
    info = jget_ar_model_tensor_info({**AR, "ar_iterations": 5}, jax_[0],
                                     data_static=jax_[2], data_bc=jax_[1])
    model, tree = seeded_tree(info, 13)
    model.load_state_dict(params_from_jax(tree))
    jmodel = JUNetSpherical(info, "healpix", SAMPLING, knn=KNN,
                            pool_method="max", increment_learning=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    test = slice(120, 160)
    kw = dict(**AR, ar_iterations=5, ar_blocks=4, batch_size=4, rounding=None)
    frts = port[0].time[[125, 127, 130, 133, 136, 140]]
    fc = AutoregressivePredictions(
        model, data_dynamic=port[0].subset(test.start, test.stop),
        data_bc=port[1].subset(test.start, test.stop), data_static=port[2],
        scaler=GlobalStandardScaler().fit_dataset(port[0]),
        scaler_bc=GlobalStandardScaler().fit_dataset(port[1]),
        forecast_reference_times=frts, zarr_fpath=root / "port.zarr",
        keep_in_memory=True, **kw)
    jfc = JAutoregressivePredictions(
        jmodel, params, data_dynamic=jax_[0].subset(test.start, test.stop),
        data_bc=jax_[1].subset(test.start, test.stop), data_static=jax_[2],
        scaler=JGlobalStandardScaler().fit_dataset(jax_[0]),
        scaler_bc=JGlobalStandardScaler().fit_dataset(jax_[1]),
        forecast_reference_times=frts, zarr_fpath=root / "jax.zarr", **kw)
    return {"root": root, "port": fc, "jax": jfc,
            "obs": (port[0].subset(test.start, test.stop),
                    jax_[0].subset(test.start, test.stop))}


def test_forecasts_match_jax(forecasts):
    fc, jfc = forecasts["port"], forecasts["jax"]
    assert fc.in_memory and not jfc.in_memory
    assert (fc.n_frt, fc.n_leadtime) == (jfc.n_frt, jfc.n_leadtime) == (6, 6)
    store = ForecastDataset.open(forecasts["root"] / "port.zarr")
    for name in jfc.feature_order:
        want = jfc.variables[name][...]
        assert np.isfinite(want).all()
        assert rel(store.variables[name][...], want) <= FORECAST_TOL, name
        # the RAM buffer serves what the store holds
        np.testing.assert_array_equal(fc.variables[name][...],
                                      store.variables[name][...])


def _meta(path):
    """Every JSON metadata file of a store, by relative path."""
    return {str(p.relative_to(path)): json.loads(p.read_text())
            for p in sorted(path.rglob(".z*"))}


def test_forecast_stores_have_the_same_layout(forecasts):
    root = forecasts["root"]
    assert _meta(root / "port.zarr") == _meta(root / "jax.zarr")
    fc = ForecastDataset.open(root / "port.zarr")
    jfc = forecasts["jax"]
    np.testing.assert_array_equal(fc.forecast_reference_time,
                                  jfc.forecast_reference_time)
    np.testing.assert_array_equal(fc.leadtime_hours, jfc.leadtime_hours)
    np.testing.assert_array_equal(fc.lat, jfc.lat)
    np.testing.assert_array_equal(fc.lon, jfc.lon)


def _assert_skills_close(got, want, tol=SKILL_TOL):
    assert sorted(got.skills) == sorted(want.skills)
    for k, v in want.skills.items():
        g = got.skills[k]
        assert g.shape == v.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(v))
        if np.isfinite(v).any():
            assert rel(g, v) <= tol, k
    np.testing.assert_array_equal(got.leadtime_hours, want.leadtime_hours)
    assert got.feature_order == want.feature_order


@pytest.mark.parametrize("store", ["port", "jax", "port_space", "jax_space"])
def test_verifiers_agree_on_either_store(forecasts, store, tmp_path):
    """Each package's verifier on one store: the same skills."""
    root = forecasts["root"]
    writer, _, space = store.partition("_")
    path = root / f"{writer}.zarr"
    if space:           # the space-chunked copy, written by its own package
        fc = ForecastDataset.open(path) if writer == "port" else \
            JForecastDataset.open(path)
        copy = rechunk_forecasts_for_verification if writer == "port" \
            else jrechunk
        copy(fc, tmp_path / "space.zarr", node_chunk=64)
        path = tmp_path / "space.zarr"
    obs, jobs = forecasts["obs"]
    skill = deterministic(ForecastDataset.open(path), obs)
    jskill = jdeterministic(JForecastDataset.open(path), jobs)
    _assert_skills_close(skill, jskill)
    assert skill["RMSE"].shape == (6, 192, 2)
    w = AreaWeights(build_sampling("healpix", SAMPLING), device="cpu").numpy()
    _assert_skills_close(global_summary(skill, w), jglobal_summary(jskill, w))
    # the skill files load in the other package
    skill.save(tmp_path / "p.npz")
    jskill.save(tmp_path / "j.npz")
    _assert_skills_close(SkillDataset.load(tmp_path / "j.npz"), jskill)
    _assert_skills_close(JSkillDataset.load(tmp_path / "p.npz"), jskill)


def test_verifier_on_port_vs_jax_forecasts(forecasts):
    # the forecasts differ by fp32 summation order only: so do the skills
    obs, jobs = forecasts["obs"]
    skill = deterministic(forecasts["port"], obs)
    jskill = jdeterministic(forecasts["jax"], jobs)
    assert rel(skill["RMSE"], jskill["RMSE"]) <= 1e-4


# --- the CLI --------------------------------------------------------------

CONFIG = {
    "model_settings": {
        "sampling_name": "Healpix_toy", "sampling": "healpix",
        "sampling_kwargs": SAMPLING, "knn": KNN,
        "architecture_name": "UNetSpherical", "increment_learning": True,
        "pool_method": "Max", "pretrained_model_name": "init"},
    "training_settings": {
        "epochs": 1, "learning_rate": 0.002, "training_batch_size": 8,
        "validation_batch_size": 8, "scoring_interval": 5,
        "gradient_clipping": 1.0, "lr_plateau_decay": 0.3,
        "early_stopping_reset_on_growth": "full",
        "ar_scheduler_factor": 0.5, "early_stopping_patience": 2,
        "seed_random_shuffling": 3},
    "ar_settings": {"input_k": [-3, -2, -1], "output_k": [0],
                    "forecast_cycle": 1, "ar_iterations": 2},
    "dataloader_settings": {"num_workers": 2},
}
NAME = "RNN-AR2-UNetSpherical-Healpix_toy-Graph_knn-k8-MaxPooling"


def _files(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """One toy experiment through both CLIs: the same data (each main
    fits and saves its scaler in its own copy), one initial checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    jgenerate_toy_data(root / "data_port", sampling_kwargs=SAMPLING,
                       n_timesteps=300, seed=7)
    shutil.copytree(root / "data_port", root / "data_jax")
    info = jget_ar_model_tensor_info(
        CONFIG["ar_settings"],
        JSphericalDataset.open(root / "data_port" / DYN),
        data_static=JStaticDataset.open(root / "data_port" / STATIC),
        data_bc=JSphericalDataset.open(root / "data_port" / BC))
    _, tree = seeded_tree(info, 5)
    for side in ("port", "jax"):
        save_pytree(root / f"exp_{side}" / "init" / "model_weights"
                    / "model.npz", tree)
    (root / "config.json").write_text(json.dumps(CONFIG))
    exp, gs = main(root / "config.json", root / "data_port",
                   root / "exp_port", force=True,
                   ar_iterations_prediction=4, verbose=False, device="cpu")
    jexp, jgs = jmain(root / "config.json", root / "data_jax",
                      root / "exp_jax", force=True,
                      ar_iterations_prediction=4, verbose=False)
    return {"root": root, "port": (exp, gs), "jax": (jexp, jgs)}


def test_cli_matches_jax(experiments):
    (exp, gs), (jexp, jgs) = experiments["port"], experiments["jax"]
    assert exp.name == jexp.name == NAME
    # the experiment tree: the JAX driver's files, its plots included
    assert _files(exp) == _files(jexp)
    assert [f for f in _files(exp) if f.endswith(".png")] == [
        "figs/skills/global_skills.png", "figs/skills/skill_maps_t850.png",
        "figs/skills/skill_maps_z500.png",
        "figs/training_info/loss_curves.png",
        "figs/training_info/per_leadtime_loss.png"]
    assert sorted(p.name for p in exp.rglob("*") if p.is_dir()) == \
        sorted(p.name for p in jexp.rglob("*") if p.is_dir())
    for f in ("config.json", "tensor_info.json"):
        assert json.loads((exp / f).read_text()) == \
            json.loads((jexp / f).read_text())
    info = json.loads((exp / "training_info/ar_training_info.json")
                      .read_text())
    jinfo = json.loads((jexp / "training_info/ar_training_info.json")
                       .read_text())
    assert info["iterations"] == jinfo["iterations"]
    assert info["ar_growth_events"] == jinfo["ar_growth_events"]
    assert rel(info["training_total_loss"], jinfo["training_total_loss"]) \
        <= 2e-4
    # RMSE per leadtime and variable
    assert gs["RMSE"].shape == jgs["RMSE"].shape == (5, 2)
    assert np.isfinite(gs["RMSE"]).all()
    assert rel(gs["RMSE"], jgs["RMSE"]) <= RMSE_TOL
    saved = SkillDataset.load(exp / "model_skills"
                              / "deterministic_global_skill.npz")
    np.testing.assert_array_equal(saved["RMSE"], gs["RMSE"])


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_cli_resumes_the_other_packages_run(experiments, resumer):
    """--resume of the other package's experiment: it loads the weights,
    the Adam state and the schedulers and trains on."""
    root = experiments["root"]
    other = "jax" if resumer == "port" else "port"
    exp_dir = root / f"resume_{resumer}"
    shutil.copytree(root / f"exp_{other}", exp_dir)
    before = (exp_dir / NAME / "model_weights" / "model.npz").read_bytes()
    state = json.loads((exp_dir / NAME / "training_info/state.json")
                       .read_text())
    if resumer == "port":
        exp, gs = main(root / "config.json", root / "data_port", exp_dir,
                       resume=True, ar_iterations_prediction=2,
                       verbose=False, device="cpu")
    else:
        exp, gs = jmain(root / "config.json", root / "data_jax", exp_dir,
                        resume=True, ar_iterations_prediction=2,
                        verbose=False)
    assert (exp / "model_weights" / "model.npz").read_bytes() != before
    assert np.isfinite(gs["RMSE"]).all()
    after = json.loads((exp / "training_info/state.json").read_text())
    # the run went on from the saved AR depth (growth only adds weights)
    assert len(after["ar_scheduler"]["absolute_weights"]) >= \
        len(state["ar_scheduler"]["absolute_weights"])


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal path does not run")
    (tmp_path / "c.json").write_text(json.dumps(CONFIG))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(tmp_path / "c.json", tmp_path, tmp_path / "exp", verbose=False)
