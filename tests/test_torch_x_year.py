"""The port's multi-year free run (`cli.experiments.run_x_year_simulations`,
the reference's 05_exp_X_year_sims.py) against the JAX package's, at
HEALPix-4 (192 nodes, knn 8), fp32, on the CPU.

- One model directory (config.json at the shipped settings' six-hour
  `forecast_cycle` and lags [-18, -12, -6], model_weights/model.npz)
  holds the JAX package's seeded parameters (`init` of its model, its
  ReZero weights scaled by 0.1 so that the free run stays bounded),
  carried over by `weights.params_from_jax` and written by the port's
  `Checkpointer`: both packages' `cli.predict` read the same file. The
  port's level 0 is block-sparse (its ELL product's plain version), as
  `tests/test_torch_artifact.py` builds it.
- Both packages run `run_x_year_simulations` on one toy store from two
  reference times near its end, at a `years` that gives 14 AR
  iterations (15 model calls) and `ar_blocks` 4: three blocks and a tail
  of 3, the analytic TOA-solar generator forcing every step past the
  store. The port's store holds every lead, finite, and equals JAX's
  within 1e-5 (max abs error over max abs, per variable).
- With each package's `cli.predict.main` replaced by a recorder: `years`
  5 at the default step (the config's `forecast_cycle`, 6 h) asks for
  7300 AR iterations in both packages, an explicit `dt_hours` is taken as
  given, and every other argument passes through alike.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_tpu.cli import experiments as jexperiments  # noqa: E402
from deepsphere_weather_tpu.cli import predict as jpredict  # noqa: E402
from deepsphere_weather_tpu.models import get_model as jget_model  # noqa: E402

import deepsphere_weather_torch.models as models_mod  # noqa: E402
from deepsphere_weather_torch.cli import experiments  # noqa: E402
from deepsphere_weather_torch.cli import predict  # noqa: E402
from deepsphere_weather_torch.data import (  # noqa: E402
    GlobalStandardScaler,
    SphericalDataset,
    generate_toy_data,
    get_ar_model_tensor_info,
)
from deepsphere_weather_torch.engine import ForecastDataset  # noqa: E402
from deepsphere_weather_torch.ops import bcsr as bcsr_mod  # noqa: E402
from deepsphere_weather_torch.utils import Checkpointer  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax  # noqa: E402

SAMPLING = {"subdivisions": 4, "nest": True}
V, KNN, N_TIME = 192, 8, 120
TOL = 1e-5
DENSE_THRESHOLD = 100         # level 0 (192 nodes) block-sparse
AR = {"input_k": [-18, -12, -6], "output_k": [0], "forecast_cycle": 6,
      "ar_iterations": 6}
CONFIG = {
    "model_settings": {"sampling_name": "Healpix_toy", "sampling": "healpix",
                       "sampling_kwargs": SAMPLING, "knn": KNN,
                       "architecture_name": "UNetSpherical",
                       "increment_learning": True, "pool_method": "Max"},
    "training_settings": {"epochs": 1, "learning_rate": 0.007,
                          "training_batch_size": 16},
    "ar_settings": AR,
    "dataloader_settings": {"num_workers": 0},
}
# 14 AR iterations at the config's six-hour step: 15 model calls, three
# blocks of AR_BLOCKS and a tail of 3
N_AR, AR_BLOCKS = 14, 4
YEARS = N_AR * AR["forecast_cycle"] / (365 * 24)
DYN = "Data/dynamic/time_chunked/dynamic.zarr"
BC = "Data/bc/time_chunked/bc.zarr"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """(data dir, model dir): the toy store with its global scalers, and
    the experiment holding the JAX package's seeded weights."""
    root = tmp_path_factory.mktemp("x_year")
    data = root / "data"
    dyn, bc, static = generate_toy_data(data, sampling_kwargs=SAMPLING,
                                        n_timesteps=N_TIME, seed=11)
    (data / "Scalers").mkdir()
    for name, ds in (("dynamic", dyn), ("bc", bc)):
        GlobalStandardScaler().fit_dataset(ds).save(
            data / "Scalers" / f"GlobalStandardScaler_{name}.npz")
    exp = root / "exp"
    (exp / "model_weights").mkdir(parents=True)
    (exp / "config.json").write_text(json.dumps(CONFIG))
    info = get_ar_model_tensor_info(AR, dyn, data_static=static, data_bc=bc)
    (exp / "tensor_info.json").write_text(json.dumps(info, default=str))
    ms = CONFIG["model_settings"]
    kw = {k: v for k, v in ms.items() if k != "architecture_name"}
    kw["pool_method"] = kw["pool_method"].lower()
    tree = jget_model(ms["architecture_name"], info, **kw).init(
        jax.random.key(3))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    for blk in tree.values():
        if isinstance(blk, dict) and "rezero_weight" in blk:
            blk["rezero_weight"] = blk["rezero_weight"] * 0.1
    model = models_mod.get_model(ms["architecture_name"], info,
                                 dense_threshold=DENSE_THRESHOLD,
                                 device="cpu", **kw)
    model.load_state_dict(params_from_jax(tree))
    Checkpointer(exp).save_model(model)
    return data, exp


@pytest.fixture
def sparse_port(monkeypatch):
    """The port's `get_model` building level 0 block-sparse; the calls of
    the ELL product's plain version, counted."""
    get_model = models_mod.get_model
    monkeypatch.setattr(models_mod, "get_model", lambda *a, **k: get_model(
        *a, dense_threshold=DENSE_THRESHOLD, **k))
    calls, ref = [0], bcsr_mod.ell_spmm_reference

    def counted(*a, **k):
        calls[0] += 1
        return ref(*a, **k)
    monkeypatch.setattr(bcsr_mod, "ell_spmm_reference", counted)
    return calls


def test_x_year_simulation_matches_jax(model_dir, sparse_port, tmp_path):
    data, exp = model_dir
    dyn = SphericalDataset.open(data / DYN)
    n_bc = SphericalDataset.open(data / BC).n_time
    # two reference times near the store's end: the rollout outruns it
    t0s = [N_TIME - 20, N_TIME - 8]
    frts = [str(t) for t in dyn.time[t0s]]
    assert t0s[0] + AR["forecast_cycle"] * N_AR > n_bc + 2 * AR_BLOCKS
    kw = dict(years=YEARS, forecast_reference_times=frts,
              ar_blocks=AR_BLOCKS, verbose=False)
    fc = experiments.run_x_year_simulations(exp, data, device="cpu", **kw)
    port = tmp_path / "port.zarr"
    (exp / "model_predictions" / "forecast_chunked" /
     "long_forecasts.zarr").rename(port)
    jexperiments.run_x_year_simulations(exp, data, **kw)
    jfc = ForecastDataset.open(exp / "model_predictions" /
                               "forecast_chunked" / "long_forecasts.zarr")
    fc = ForecastDataset.open(port)
    assert (fc.n_frt, fc.n_leadtime) == (jfc.n_frt, jfc.n_leadtime) == (
        2, N_AR + 1)
    # one forward of 2 level-0 products in each of its 5 convolutions a
    # model call; every call in one batch of both reference times
    assert sparse_port[0] == 10 * (N_AR + 1)
    np.testing.assert_array_equal(fc.leadtime_hours, jfc.leadtime_hours)
    np.testing.assert_array_equal(fc.forecast_reference_time,
                                  jfc.forecast_reference_time)
    assert sorted(fc.variables) == sorted(jfc.variables)
    for v in fc.variables:
        got, want = fc.variables[v][...], jfc.variables[v][...]
        assert got.shape == (2, N_AR + 1, V) and np.isfinite(got).all()
        # every lead written (none reads back as the fill value 0)
        assert (np.abs(got).reshape(2 * (N_AR + 1), V).max(1) > 0).all()
        e = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
        assert e <= TOL, (v, e)


def test_x_year_steps_follow_the_config_as_jax(model_dir, monkeypatch):
    data, exp = model_dir
    calls = {"port": [], "jax": []}

    def recorder(side):
        def main(model_dir, data_dir, **kw):
            kw.pop("device", None)
            calls[side].append(kw)
        return main
    monkeypatch.setattr(predict, "main", recorder("port"))
    monkeypatch.setattr(jpredict, "main", recorder("jax"))
    for side, mod in (("port", experiments), ("jax", jexperiments)):
        extra = {"device": "cpu"} if side == "port" else {}
        mod.run_x_year_simulations(exp, data, **extra)
        mod.run_x_year_simulations(exp, data, years=1.0, dt_hours=12,
                                   forecast_reference_times=["2010-01-20"],
                                   ar_blocks=50, bc_generator=None,
                                   verbose=False, **extra)
    assert calls["port"] == calls["jax"]
    assert [c["ar_iterations"] for c in calls["port"]] == [7300, 730]
    assert calls["port"][0]["ar_blocks"] == 1000
    assert calls["port"][0]["bc_generator"] == "toa"
