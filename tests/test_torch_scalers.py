"""The port's time-grouped scalers and benchmark skills vs the JAX package.

- `time_group_indices` (numpy alone) against pandas' calendar fields, the
  JAX package's, for each grouping and for ['hour', 'month']: every 6 h
  from 1979 to 2031, plus the year ends and starts where the ISO week
  belongs to the other year, and 29 February. Exact.
- `AnomalyScaler` and `Climatology`: fit, transform, inverse_transform
  and forecast against the JAX package within 1e-12 (max abs error / max
  abs); files saved by either package load in the other; the error for a
  time group the fit never saw; a `SequentialScaler` with an anomaly
  member; `cli.common.resolve_scalers` on a config that names one.
- `persistence_skills` and `climatology_skills` against the JAX package
  within 1e-6 (max abs error / max abs, per metric).
"""

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from deepsphere_weather_tpu.cli.common import (  # noqa: E402
    resolve_scalers as jresolve_scalers,
)
from deepsphere_weather_tpu.data import (  # noqa: E402
    SphericalDataset as JSphericalDataset,
    generate_toy_data as jgenerate_toy_data,
)
from deepsphere_weather_tpu.data.scalers import (  # noqa: E402
    AnomalyScaler as JAnomalyScaler,
    Climatology as JClimatology,
    GlobalStandardScaler as JGlobalStandardScaler,
    SequentialScaler as JSequentialScaler,
    load_scaler as jload_scaler,
    time_group_indices as jtime_group_indices,
)
from deepsphere_weather_tpu.verif import (  # noqa: E402
    climatology_skills as jclimatology_skills,
    persistence_skills as jpersistence_skills,
)

from deepsphere_weather_torch.cli.common import resolve_scalers  # noqa: E402
from deepsphere_weather_torch.data import (  # noqa: E402
    AnomalyScaler,
    Climatology,
    GlobalStandardScaler,
    SequentialScaler,
    SphericalDataset,
    load_scaler,
    time_group_indices,
)
from deepsphere_weather_torch.verif import (  # noqa: E402
    climatology_skills,
    persistence_skills,
)

GROUPINGS = ["month", "weekofyear", "dayofyear", "hour", ["hour", "month"]]
SCALER_TOL, SKILL_TOL = 1e-12, 1e-6
DYN = "Data/dynamic/time_chunked/dynamic.zarr"


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


def six_hourly_times():
    times = np.arange(np.datetime64("1979-01-01T00", "ns"),
                      np.datetime64("2032-01-01T00", "ns"),
                      np.timedelta64(6, "h"))
    edges = np.array(["2004-12-31T23:59", "2005-01-01", "2005-01-02T18",
                      "2008-12-29T06", "2009-12-31", "2010-01-03",
                      "2000-02-29T12", "2004-02-29", "2100-02-28",
                      "1969-12-31T23", "1960-01-01"], dtype="datetime64[ns]")
    return np.concatenate([times, edges])


@pytest.mark.parametrize("groups", GROUPINGS, ids=str)
def test_time_group_indices_match_pandas(groups):
    t = six_hourly_times()
    got = time_group_indices(t, groups)
    np.testing.assert_array_equal(got, jtime_group_indices(t, groups))
    assert got.min() >= 0


def test_iso_week_edges():
    # 2004-12-31 and 2005-01-01 are in ISO week 53 of 2004; 2008-12-29 in
    # week 1 of 2009; the last day of a leap year is day 366
    t = np.array(["2004-12-31", "2005-01-01", "2005-01-03", "2008-12-29",
                  "2008-12-31"], dtype="datetime64[ns]")
    np.testing.assert_array_equal(time_group_indices(t, "weekofyear"),
                                  [52, 52, 0, 0, 0])
    np.testing.assert_array_equal(
        time_group_indices(t, "weekofyear"),
        pd.DatetimeIndex(t).isocalendar().week.to_numpy().astype(int) - 1)
    assert time_group_indices(t[-1:], "dayofyear")[0] == 365


@pytest.fixture(scope="module")
def fields():
    """Fields on 16 nodes x 2 features at 6-hourly times over two years,
    with an annual and a daily cycle."""
    t = np.arange(np.datetime64("2003-01-01", "ns"),
                  np.datetime64("2005-01-01", "ns"), np.timedelta64(6, "h"))
    rng = np.random.default_rng(3)
    doy = (t - t.astype("datetime64[Y]")) / np.timedelta64(1, "D")
    hour = (t - t.astype("datetime64[D]")) / np.timedelta64(1, "h")
    base = (np.sin(2 * np.pi * doy / 365.25)[:, None, None] * 10
            + np.cos(2 * np.pi * hour / 24)[:, None, None] * 2)
    x = (base + rng.standard_normal((len(t), 16, 2)) * [1.0, 3.0]
         + [280.0, 5400.0])
    return x.astype(np.float32), t


@pytest.mark.parametrize("groups", GROUPINGS, ids=str)
@pytest.mark.parametrize("kind", ["anomaly", "climatology"])
@pytest.mark.parametrize("standardized", [True, False],
                         ids=["std", "mean"])
def test_time_grouped_scalers_match_jax(fields, groups, kind, standardized):
    x, t = fields
    cls, jcls = ((AnomalyScaler, JAnomalyScaler) if kind == "anomaly"
                 else (Climatology, JClimatology))
    s = cls(time_groups=groups, standardized=standardized).fit(
        x, t, feature_order=["t850", "z500"])
    js = jcls(time_groups=groups, standardized=standardized).fit(
        x, t, feature_order=["t850", "z500"])
    np.testing.assert_array_equal(s.fitted, js.fitted)
    assert rel(s.mean, js.mean) <= SCALER_TOL
    assert rel(s.std, js.std) <= SCALER_TOL
    sel = slice(100, 180)
    z, jz = s.transform(x[sel], time=t[sel]), js.transform(x[sel], time=t[sel])
    assert rel(z, jz) <= SCALER_TOL
    assert rel(s.inverse_transform(z, time=t[sel]),
               js.inverse_transform(jz, time=t[sel])) <= SCALER_TOL
    if kind == "climatology":
        assert rel(s.forecast(t[sel]), js.forecast(t[sel])) <= SCALER_TOL


@pytest.mark.parametrize("kind", ["anomaly", "climatology"])
def test_time_grouped_scaler_files_cross_load(fields, tmp_path, kind):
    x, t = fields
    cls, jcls = ((AnomalyScaler, JAnomalyScaler) if kind == "anomaly"
                 else (Climatology, JClimatology))
    period = ("2003-01-01", "2004-01-01")
    s = cls("weekofyear", reference_period=period).fit(x, t, ["a", "b"])
    js = jcls("weekofyear", reference_period=period).fit(x, t, ["a", "b"])
    s.save(tmp_path / "port.npz")
    js.save(tmp_path / "jax.npz")
    sel = slice(0, 40)
    for loaded, want in ((load_scaler(tmp_path / "jax.npz"), js),
                         (jload_scaler(tmp_path / "port.npz"), s)):
        assert loaded.kind == kind and loaded.reference_period == period
        assert loaded.feature_order == ["a", "b"]
        np.testing.assert_array_equal(loaded.fitted, want.fitted)
        np.testing.assert_array_equal(loaded.transform(x[sel], time=t[sel]),
                                      want.transform(x[sel], time=t[sel]))
    assert type(load_scaler(tmp_path / "jax.npz")) is cls


def test_absent_group_raises_as_jax(fields):
    x, t = fields
    # fit on January alone: February is a group the fit never saw
    jan = t.astype("datetime64[M]") == np.datetime64("2003-01")
    s = AnomalyScaler("month").fit(x[jan], t[jan])
    js = JAnomalyScaler("month").fit(x[jan], t[jan])
    feb = t.astype("datetime64[M]") == np.datetime64("2003-02")
    msgs = []
    for scaler in (s, js):
        for fn in (scaler.transform, scaler.inverse_transform):
            with pytest.raises(ValueError, match=r"\[1\] were absent") as e:
                fn(x[feb], time=t[feb])
            msgs.append(str(e.value))
    assert len(set(msgs)) == 1


def test_sequential_with_anomaly_member(fields, tmp_path):
    x, t = fields
    g = GlobalStandardScaler().fit(x)
    a = AnomalyScaler(["hour", "month"]).fit(g.transform(x), t)
    jg = JGlobalStandardScaler().fit(x)
    ja = JAnomalyScaler(["hour", "month"]).fit(jg.transform(x), t)
    s, js = SequentialScaler(g, a), JSequentialScaler(jg, ja)
    sel = slice(500, 560)
    z = s.transform(x[sel], time=t[sel])
    assert rel(z, js.transform(x[sel], time=t[sel])) <= SCALER_TOL
    assert rel(s.inverse_transform(z, time=t[sel]), x[sel]) <= 1e-6
    s.save(tmp_path / "seq")
    back = jload_scaler(tmp_path / "seq")
    np.testing.assert_array_equal(back.transform(x[sel], time=t[sel]), z)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("scaler_toy")
    jgenerate_toy_data(root, sampling_kwargs={"subdivisions": 2,
                                              "nest": True},
                       n_timesteps=1600, seed=4)
    return root, SphericalDataset.open(root / DYN), JSphericalDataset.open(
        root / DYN)


def test_resolve_scalers_names_an_anomaly_scaler(toy):
    root, dyn, jdyn = toy
    (root / "Scalers").mkdir(exist_ok=True)
    JGlobalStandardScaler().fit_dataset(jdyn).save(
        root / "Scalers" / "GlobalStandardScaler_dynamic.npz")
    JAnomalyScaler("month").fit(jdyn.read_all(), jdyn.time).save(
        root / "Scalers" / "MonthlyStdAnomalyScaler_dynamic.npz")
    dl = {"scaler_dynamic": ["GlobalStandardScaler_dynamic.npz",
                             "MonthlyStdAnomalyScaler_dynamic.npz"]}
    scaler, scaler_bc = resolve_scalers(dl, root)
    jscaler, jscaler_bc = jresolve_scalers(dl, root)
    assert isinstance(scaler.scalers[1], AnomalyScaler)
    assert scaler_bc is None and jscaler_bc is None
    x = dyn.read_stacked(np.arange(40, 60))
    np.testing.assert_array_equal(scaler.transform(x, time=dyn.time[40:60]),
                                  jscaler.transform(x, time=jdyn.time[40:60]))


def _skills_close(skill, jskill):
    assert skill.feature_order == jskill.feature_order
    np.testing.assert_array_equal(skill.leadtime_hours,
                                  jskill.leadtime_hours)
    assert set(skill.skills) == set(jskill.skills)
    for k in skill.skills:
        assert rel(skill.skills[k], jskill.skills[k]) <= SKILL_TOL, k


def test_persistence_skills_match_jax(toy):
    _, dyn, jdyn = toy
    leads = np.arange(1, 6)
    _skills_close(persistence_skills(dyn, leads),
                  jpersistence_skills(jdyn, leads))


def test_climatology_skills_match_jax(toy):
    _, dyn, jdyn = toy
    x = dyn.read_all()
    clim = Climatology("dayofyear").fit(x, dyn.time)
    jclim = JClimatology("dayofyear").fit(x, jdyn.time)
    leads = np.arange(0, 3)
    _skills_close(climatology_skills(dyn, clim, leads),
                  jclimatology_skills(jdyn, jclim, leads))
