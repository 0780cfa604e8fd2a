"""The port's data-preparation CLIs against the JAX package's.

`cli.prepare_toy_data`, `cli.compute_scalers`, `cli.compute_benchmarks`
and `cli.create_configs` of both packages build an experiment's data
directory from nothing, each into its own directory, on toy HEALPix-4
data (a year of six-hour steps, seed 0, as the JAX CLI tests use it,
`tests/test_config_cli.py`). The same files must come out of both, with
the same names: every array of the zarr stores and of every `.npz`
(scalers, climatologies, benchmark skills) equal to 1e-12, every config
equal as JSON.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_torch.data import SphericalDataset, StaticDataset  # noqa: E402

TOL = 1e-12
SUBDIV, STEPS = 4, 1460


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from deepsphere_weather_torch.cli import (
        compute_benchmarks, compute_scalers, prepare_toy_data)
    from deepsphere_weather_tpu.cli import (
        compute_benchmarks as jcompute_benchmarks,
        compute_scalers as jcompute_scalers,
        prepare_toy_data as jprepare_toy_data)

    root = tmp_path_factory.mktemp("prep")
    out = {}
    for tag, prep, scal, bench in (
            ("jax", jprepare_toy_data, jcompute_scalers, jcompute_benchmarks),
            ("port", prepare_toy_data, compute_scalers, compute_benchmarks)):
        d = root / tag
        prep.main(d, subdivisions=SUBDIV, n_timesteps=STEPS, seed=0,
                  verbose=False)
        scal.main(d, verbose=False)
        bench.main(d, n_leadtimes=8, verbose=False)
        out[tag] = d
    return out


def _files(d, pattern):
    return sorted(p.relative_to(d) for p in d.rglob(pattern))


def _arrays_close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind in "fc":
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), what)
        ok = np.isfinite(a)
        scale = max(float(np.abs(a[ok]).max()), 1.0) if ok.any() else 1.0
        assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= TOL * scale, what
    else:
        np.testing.assert_array_equal(a, b, what)


def test_prepare_toy_data_matches_jax(dirs):
    j, p = dirs["jax"], dirs["port"]
    for rel in ("Data/dynamic/time_chunked/dynamic.zarr",
                "Data/bc/time_chunked/bc.zarr"):
        a, b = SphericalDataset.open(j / rel), SphericalDataset.open(p / rel)
        assert a.feature_order == b.feature_order
        _arrays_close(a.read_all(), b.read_all(), rel)
        _arrays_close(a.time, b.time, rel)
        _arrays_close(a.lat, b.lat, rel)
        _arrays_close(a.lon, b.lon, rel)
    a = StaticDataset.open(j / "Data/static.zarr")
    b = StaticDataset.open(p / "Data/static.zarr")
    assert a.feature_order == b.feature_order
    _arrays_close(a.read_stacked(), b.read_stacked(), "static")


@pytest.mark.parametrize("sub", ["Scalers", "Climatology", "Benchmarks"])
def test_npz_outputs_match_jax(dirs, sub):
    j, p = dirs["jax"] / sub, dirs["port"] / sub
    names = _files(j, "*.npz")
    assert names and names == _files(p, "*.npz"), sub
    for rel in names:
        with np.load(j / rel) as a, np.load(p / rel) as b:
            assert sorted(a.files) == sorted(b.files), rel
            for k in a.files:
                _arrays_close(a[k], b[k], f"{rel}:{k}")


def test_create_configs_matches_jax(tmp_path):
    from deepsphere_weather_torch.cli.create_configs import create_configs
    from deepsphere_weather_tpu.cli.create_configs import (
        create_configs as jcreate_configs)

    n = create_configs(tmp_path / "port")
    assert n == jcreate_configs(tmp_path / "jax") == 108
    names = _files(tmp_path / "jax", "*.json")
    assert len(names) == n and names == _files(tmp_path / "port", "*.json")
    for rel in names:
        assert (json.loads((tmp_path / "port" / rel).read_text())
                == json.loads((tmp_path / "jax" / rel).read_text())), rel
    # the generated grid is the shipped one
    shipped = Path(__file__).resolve().parents[1] / "configs"
    assert names == _files(shipped, "*.json")
