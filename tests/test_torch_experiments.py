"""The port's experiment sweeps (`cli/experiments.py`) against the JAX
package's, at HEALPix-4 (knn 8), fp32, on the CPU.

- `run_reproducibility_experiment` and `run_sweep`: with each package's
  `train_predict.main` replaced by a recorder (the trainings themselves
  are `cli.train_predict`'s, held by `tests/test_torch_training.py` and
  `tests/test_torch_predict_verif.py`), the configs each sweep writes,
  their names and the arguments of each training call are equal, and so
  are the returned keys;
- `run_deep_ensemble(member_parallel=True)` with 2 members, one epoch,
  `remat: true` (the port's member step through its recomputing autograd
  Function; the JAX sweep does not pass the key on to its trainer, and
  remat changes no result), an AR2 forecast: both packages train their members from the
  same weights (the port's seeds 1000 + m are drawn by JAX's
  initialisation here, `_member_weights` replaced), on the same toy
  store; the member configs written are equal, the ensemble and median
  stores and the median's skills (RMSE, MAE, MSE) and the ensemble's
  CRPS within 1e-5. The learning rate is 1e-5: Adam moves an element
  whose gradient is rounding-small by up to the learning rate in either
  package's direction (`tests/test_torch_members.py`), and an epoch of
  such steps at 2e-3 would part the two models by more than the bar
  without any fault.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_tpu.cli import experiments as jexperiments  # noqa: E402
from deepsphere_weather_tpu.cli import train_predict as jtrain_predict  # noqa: E402
from deepsphere_weather_tpu.models import get_model as jget_model  # noqa: E402

from deepsphere_weather_torch.cli import experiments  # noqa: E402
from deepsphere_weather_torch.cli import train_predict  # noqa: E402
from deepsphere_weather_torch.data import generate_toy_data  # noqa: E402
from deepsphere_weather_torch.engine import ForecastDataset  # noqa: E402
from deepsphere_weather_torch.verif import SkillDataset  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax  # noqa: E402

TOL = 1e-5
CONFIG = {
    "model_settings": {"sampling_name": "Healpix_toy", "sampling": "healpix",
                       "sampling_kwargs": {"subdivisions": 4, "nest": True},
                       "knn": 8, "architecture_name": "UNetSpherical",
                       "increment_learning": True, "pool_method": "Max"},
    "training_settings": {"epochs": 1, "learning_rate": 1e-5,
                          "training_batch_size": 8, "scoring_interval": 5,
                          "remat": True},
    "ar_settings": {"input_k": [-3, -2, -1], "output_k": [0],
                    "forecast_cycle": 1, "ar_iterations": 1},
    "dataloader_settings": {"num_workers": 2}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    generate_toy_data(root / "data", sampling_kwargs={"subdivisions": 4,
                                                      "nest": True},
                      n_timesteps=120, seed=7)
    (root / "config.json").write_text(json.dumps(CONFIG))
    return root


def _configs(d):
    """The configs (and tensor_info files) written under `d`, by path;
    the trainer's records (training_info/) hold losses, not configs."""
    return {str(p.relative_to(d)): json.loads(p.read_text())
            for p in sorted(Path(d).rglob("*.json"))
            if p.parent.name != "training_info"}


@pytest.fixture
def recorded(monkeypatch):
    """Each package's train_predict.main replaced by a recorder: the
    config each call got (read back) and its other arguments."""
    calls = {"port": [], "jax": []}

    def recorder(side):
        def main(cfg_path, data_dir, exp_dir, **kw):
            kw.pop("device", None)
            calls[side].append((json.loads(Path(cfg_path).read_text()),
                                Path(cfg_path).name, kw))
            return Path(exp_dir), {"RMSE": np.ones((2, 2))}
        return main
    monkeypatch.setattr(train_predict, "main", recorder("port"))
    monkeypatch.setattr(jtrain_predict, "main", recorder("jax"))
    return calls


def test_reproducibility_and_sweep_write_the_jax_configs(data, tmp_path,
                                                         recorded):
    out = {}
    for side, mod in (("port", experiments), ("jax", jexperiments)):
        kw = {"device": "cpu"} if side == "port" else {}
        r1 = mod.run_reproducibility_experiment(
            data / "config.json", data / "data", tmp_path / side, n_models=2,
            **kw)
        r2 = mod.run_sweep(data / "config.json", data / "data",
                           tmp_path / side,
                           {"knn": [8, 10], "pool_method": ["Max", "Avg"]},
                           **kw)
        r3 = mod.run_activation_experiment(
            data / "config.json", data / "data", tmp_path / side,
            act_funs=["relu", "elu"], **kw)
        out[side] = (sorted(r1), {k: len(v) for k, v in r1.items()},
                     sorted(r2), sorted(r3))
    assert out["port"] == out["jax"]
    assert len(recorded["port"]) == len(recorded["jax"]) == 4 + 4 + 2
    assert recorded["port"] == recorded["jax"]
    assert _configs(tmp_path / "port") == _configs(tmp_path / "jax")


@pytest.fixture(scope="module")
def ensembles(data, tmp_path_factory):
    def jax_weights(model_settings, tensor_info, model_kwargs, geometry,
                    seed, device):
        kw = {k: v for k, v in model_kwargs.items()}
        jm = jget_model(model_settings["architecture_name"], tensor_info,
                        **kw)
        return params_from_jax(jm.init(jax.random.key(seed)))

    mp = pytest.MonkeyPatch()
    mp.setattr(experiments, "_member_weights", jax_weights)
    out = {}
    try:
        for side, mod in (("port", experiments), ("jax", jexperiments)):
            kw = {"device": "cpu"} if side == "port" else {}
            d = tmp_path_factory.mktemp(f"ens_{side}")
            res = mod.run_deep_ensemble(
                data / "config.json", data / "data", d, n_members=2,
                ar_iterations_prediction=2, member_parallel=True, **kw)
            out[side] = (d, res)
    finally:
        mp.undo()
    return out


def test_deep_ensemble_matches_jax(ensembles):
    (pd, pres), (jd, jres) = ensembles["port"], ensembles["jax"]
    assert _configs(pd) == _configs(jd)
    names = sorted(p.name for p in pd.iterdir())
    assert names == sorted(p.name for p in jd.iterdir())
    assert "DeepEnsemble" in names and len(
        [n for n in names if n.endswith("member0") or n.endswith("member1")]
    ) == 2
    for store in ("ensemble.zarr", "median.zarr"):
        a = ForecastDataset.open(pd / "DeepEnsemble" / store)
        b = ForecastDataset.open(jd / "DeepEnsemble" / store)
        assert sorted(a.variables) == sorted(b.variables)
        for v in a.variables:
            x, y = a.variables[v][...], b.variables[v][...]
            assert x.shape == y.shape and np.isfinite(x).all()
            assert np.abs(x - y).max() / np.abs(y).max() <= TOL, (store, v)
    for name, metrics in (("median_global_skill", ("RMSE", "MAE", "MSE")),
                          ("probabilistic_global_skill", ("CRPS",))):
        a = SkillDataset.load(pd / "DeepEnsemble" / f"{name}.npz")
        b = SkillDataset.load(jd / "DeepEnsemble" / f"{name}.npz")
        assert sorted(a.skills) == sorted(b.skills)
        for k in metrics:
            assert np.abs(a[k] - b[k]).max() / np.abs(b[k]).max() <= TOL, k
    assert sorted(pres) == sorted(jres)
