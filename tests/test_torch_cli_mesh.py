"""The port's CLIs on a 2-rank mesh (`cli/launch.py`) against one process.

Toy HEALPix-4 data (the port's generator, 160 six-hour steps), the
UNetSpherical toy config at fp32 with `n_node_parallel: 2`, run as a user
runs it (`python -m deepsphere_weather_torch.cli.train_predict ...
--device cpu`, `... cli.finetune_swag ...`): the CLI starts its 2 ranks
itself (torch.multiprocessing, start method 'spawn') on `gloo` and each
trains its half of the sphere. Against the same CLI on one process:

- rc 0, the launch line names 2 ranks on gloo;
- the forecast stores, the skills' error measures (RMSE, MAE, MSE,
  CRPS) and the SWAG posterior, member,
  ensemble and median stores within the sharded step's fp32 bar (1e-4,
  `tests/test_torch_parallel.py`'s losses; an epoch apart they read
  about 1e-7 to 1e-5);
- every output file written once, by one process: the write log of
  `tests/write_log_site/sitecustomize.py`, put on the CLIs' path (it
  runs in every process, the spawned ranks too), records each call of
  `SkillDataset.save`, `SWAG.save`, `write_config_file` and the zarr
  store creation (`create_group`) with its process; each path must
  appear once in the log. Were every rank to write the stores and the
  skills, each would appear twice (or the second writer would fail on
  the first one's store: a copy of the CLI whose ranks all write raised
  FileExistsError on the forecast store in its rank 1);
- the rank-0-only lines (prediction, the closing summary) printed once.

The runs go two at a time: the single-process and the 2-rank
`train_predict`, then the two `finetune_swag`s, each on its own copy of
the single-process experiment (the 2-rank one with `n_node_parallel: 2`
in its config). Every process runs torch on one thread
(`OMP_NUM_THREADS=1`).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_torch.data import generate_toy_data  # noqa: E402
from deepsphere_weather_torch.engine import ForecastDataset  # noqa: E402
from deepsphere_weather_torch.verif import SkillDataset  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# the write log's sitecustomize (tests/write_log_site/sitecustomize.py)
SITE = Path(__file__).resolve().parent / "write_log_site"
# the sharded step's fp32 loss bar (tests/test_torch_parallel.py LOSS_TOL)
BAR = 1e-4
LIMIT_S = 300
NAME = "RNN-AR1-UNetSpherical-Healpix_toy-Graph_knn-k8-MaxPooling"
CONFIG = {
    "model_settings": {"sampling_name": "Healpix_toy", "sampling": "healpix",
                       "sampling_kwargs": {"subdivisions": 4, "nest": True},
                       "knn": 8, "architecture_name": "UNetSpherical",
                       "increment_learning": True, "pool_method": "Max"},
    "training_settings": {"epochs": 1, "learning_rate": 0.002,
                          "training_batch_size": 8, "scoring_interval": 5},
    "ar_settings": {"input_k": [-3, -2, -1], "output_k": [0],
                    "forecast_cycle": 1, "ar_iterations": 1},
    "dataloader_settings": {"num_workers": 2}}


def _start(root, tag, module, args):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               DSW_WRITE_LOG=str(root / f"{tag}.log"),
               PYTHONPATH=os.pathsep.join([str(SITE), str(REPO)]))
    env.pop("JAX_PLATFORMS", None)
    out = open(root / f"{tag}.out", "w")
    return tag, out, subprocess.Popen(
        [sys.executable, "-m", f"deepsphere_weather_torch.cli.{module}",
         *args, "--device", "cpu"], cwd=root, env=env, stdout=out,
        stderr=subprocess.STDOUT)


def _wait(root, runs):
    out = {}
    for tag, f, proc in runs:
        try:
            rc = proc.wait(timeout=LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        f.close()
        log = root / f"{tag}.log"
        lines = log.read_text().split("\n")[:-1] if log.exists() else []
        out[tag] = {"rc": rc, "out": (root / f"{tag}.out").read_text(),
                    "writes": [ln for ln in lines
                               if ln.split(" ", 2)[2].startswith("/")]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mesh")
    generate_toy_data(root / "data", sampling_kwargs={"subdivisions": 4,
                                                      "nest": True},
                      n_timesteps=160, seed=7)
    for tag, n_node in (("one", 1), ("two", 2)):
        cfg = json.loads(json.dumps(CONFIG))
        cfg["training_settings"]["n_node_parallel"] = n_node
        (root / f"{tag}.json").write_text(json.dumps(cfg))
    train = [_start(root, f"train_{tag}", "train_predict",
                    ["--config_file", f"{tag}.json", "--data_dir", "data",
                     "--exp_dir", f"exp_{tag}", "--force",
                     "--ar_iterations_prediction", "4"])
             for tag in ("one", "two")]
    res = _wait(root, train)
    assert res["train_one"]["rc"] == 0, res["train_one"]["out"][-3000:]
    # SWAG on two copies of the single-process experiment
    swag = []
    for tag, n_node in (("one", 1), ("two", 2)):
        exp = root / f"swag_{tag}" / NAME
        shutil.copytree(root / "exp_one" / NAME, exp)
        cfg = json.loads((exp / "config.json").read_text())
        cfg["training_settings"]["n_node_parallel"] = n_node
        (exp / "config.json").write_text(json.dumps(cfg))
        swag.append(_start(root, f"swag_{tag}", "finetune_swag",
                           ["--model_dir", str(exp), "--data_dir", "data",
                            "--epochs", "1", "--nb_samples", "2",
                            "--swag_freq", "1",
                            "--ar_iterations_prediction", "4"]))
    res.update(_wait(root, swag))
    return root, res


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _stores_close(one, two):
    a, b = ForecastDataset.open(one), ForecastDataset.open(two)
    assert sorted(a.variables) == sorted(b.variables)
    for name in a.variables:
        x, y = a.variables[name][...], b.variables[name][...]
        assert x.shape == y.shape and np.isfinite(y).all(), name
        assert rel_err(y, x) <= BAR, (name, rel_err(y, x))


def _skills_close(one, two):
    a, b = SkillDataset.load(one), SkillDataset.load(two)
    assert sorted(a.skills) == sorted(b.skills) and a.skills
    # the error measures (a bias is a difference of near-equal means: its
    # relative error is the forecast's times their ratio)
    names = [k for k in ("RMSE", "MAE", "MSE", "CRPS") if k in a.skills]
    assert names
    for name in names:
        x, y = a[name], b[name]
        np.testing.assert_array_equal(np.isfinite(x), np.isfinite(y))
        ok = np.isfinite(x)
        if ok.any() and np.abs(x[ok]).max() > 0:
            assert rel_err(y[ok], x[ok]) <= BAR, (name, rel_err(y[ok],
                                                                x[ok]))


def _written_once(res, launched):
    """Each logged path once; with 2 ranks, all by one process."""
    paths = [line.split(" ", 2)[2] for line in res["writes"]]
    assert paths and len(paths) == len(set(paths)), sorted(
        p for p in set(paths) if paths.count(p) > 1)
    pids = {line.split(" ", 1)[0] for line in res["writes"]}
    assert len(pids) == 1
    if launched:
        assert ("launch: 2 ranks (spawned), backend gloo, devices "
                "{0: 'cpu', 1: 'cpu'}") in res["out"]
    return paths


def test_train_predict_on_two_ranks(runs):
    root, res = runs
    one, two = res["train_one"], res["train_two"]
    assert two["rc"] == 0, two["out"][-3000:]
    assert "training mesh: 1 (data) x 2 (node)" in two["out"]
    assert two["out"].count("] done in ") == 1
    assert (two["out"].count("predicted frts")
            == one["out"].count("predicted frts") > 0)
    paths = _written_once(two, True)
    assert sorted(Path(p).name for p in paths) == sorted(
        Path(p).name for p in _written_once(one, False))
    exp1, exp2 = root / "exp_one" / NAME, root / "exp_two" / NAME
    for store in ("forecast_chunked", "space_chunked"):
        _stores_close(exp1 / "model_predictions" / store / "test_forecasts.zarr",
                      exp2 / "model_predictions" / store / "test_forecasts.zarr")
    for skill in ("deterministic_global_skill", "deterministic_spatial_skill"):
        _skills_close(exp1 / "model_skills" / f"{skill}.npz",
                      exp2 / "model_skills" / f"{skill}.npz")
    assert (exp2 / "model_weights" / "model.npz").exists()


def test_finetune_swag_on_two_ranks(runs):
    root, res = runs
    one, two = res["swag_one"], res["swag_two"]
    assert one["rc"] == 0, one["out"][-3000:]
    assert two["rc"] == 0, two["out"][-3000:]
    assert two["out"].count("SWAG ensemble (2 members) verified") == 1
    paths = _written_once(two, True)
    assert sorted(Path(p).name for p in paths) == sorted(
        Path(p).name for p in _written_once(one, False))
    exp1, exp2 = root / "swag_one" / NAME, root / "swag_two" / NAME
    for store in ("member_00", "member_01", "ensemble", "median"):
        _stores_close(exp1 / "model_predictions" / "swag" / f"{store}.zarr",
                      exp2 / "model_predictions" / "swag" / f"{store}.zarr")
    for skill in ("swag_median_global_skill",
                  "swag_probabilistic_global_skill"):
        _skills_close(exp1 / "model_skills" / f"{skill}.npz",
                      exp2 / "model_skills" / f"{skill}.npz")
    w1 = np.load(exp1 / "model_weights" / "model_swag.npz")
    w2 = np.load(exp2 / "model_weights" / "model_swag.npz")
    assert sorted(w1.files) == sorted(w2.files)
    for k in w1.files:
        if w1[k].size and np.abs(w1[k]).max() > 0:
            assert rel_err(w2[k], w1[k]) <= BAR, k
