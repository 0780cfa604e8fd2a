"""The port's plotting package (`deepsphere_weather_torch/plotting/`) vs the
JAX package's.

Each public function runs in both packages in this one process (both
select matplotlib's Agg backend at import, and the rcParams are the
process's), on the same inputs: each package's own `SkillDataset`,
`SphericalDataset` and `ARTrainingInfo` from one seed, and one
duck-typed forecast (a persistence forecast of a toy store) and one
anomaly scaler for the animations, which take them through their
methods only. Bars: the same file names; every PNG decoded to pixel
arrays exactly equal; every GIF with as many frames, each equal.
`voronoi_patches` and `hovmoller_data` give equal arrays. Skips without
matplotlib.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("matplotlib")
from torch_threads import one_torch_thread  # noqa: E402,F401

import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
from PIL import Image, ImageSequence  # noqa: E402

from deepsphere_weather_tpu import plotting as jplotting  # noqa: E402
from deepsphere_weather_tpu.data import SphericalDataset as JSphericalDataset  # noqa: E402
from deepsphere_weather_tpu.engine.training import (  # noqa: E402
    ARTrainingInfo as JARTrainingInfo,
)
from deepsphere_weather_tpu.sphere import build_sampling as jbuild_sampling  # noqa: E402
from deepsphere_weather_tpu.verif import SkillDataset as JSkillDataset  # noqa: E402

from deepsphere_weather_torch import plotting  # noqa: E402
from deepsphere_weather_torch.data import (  # noqa: E402
    AnomalyScaler,
    SphericalDataset,
    generate_toy_data,
)
from deepsphere_weather_torch.engine import ARTrainingInfo  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.verif import SkillDataset  # noqa: E402

HP = ("healpix", {"subdivisions": 2, "nest": True})
SIDES = {"port": plotting, "jax": jplotting}


def _files(root):
    return sorted(p.relative_to(root).as_posix()
                  for p in Path(root).rglob("*") if p.is_file())


def _same_pictures(root):
    """The port's and the JAX package's outputs under root/port and
    root/jax: the same names, PNG pixels equal, GIF frames equal."""
    names = _files(root / "port")
    assert names and names == _files(root / "jax")
    for name in names:
        a, b = root / "port" / name, root / "jax" / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(mpimg.imread(a), mpimg.imread(b),
                                          err_msg=name)
        else:
            with Image.open(a) as ia, Image.open(b) as ib:
                assert ia.n_frames == ib.n_frames > 1, name
                for fa, fb in zip(ImageSequence.Iterator(ia),
                                  ImageSequence.Iterator(ib)):
                    np.testing.assert_array_equal(
                        np.asarray(fa.convert("RGB")),
                        np.asarray(fb.convert("RGB")), err_msg=name)
    return names


def _save(ax_or_artist, path):
    fig = ax_or_artist.figure
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=60)
    plt.close(fig)


@pytest.fixture(scope="module")
def skills():
    """Spatial (3 leads) and global (4 leads) skills, each package's own
    SkillDataset from one seed."""
    samp = build_sampling(*HP)
    rng = np.random.default_rng(0)
    names = ["BIAS", "RMSE", "rSD", "pearson_R2", "error_CoV", "KGE", "MAE"]
    spatial = {k: rng.standard_normal((3, samp.n_nodes, 2)) for k in names}
    spatial["RMSE"] = np.abs(spatial["RMSE"])
    spatial["BIAS"][0, 5, 1] = np.nan
    glob = {k: np.cumsum(np.abs(rng.standard_normal((4, 2))), 0)
            for k in names}
    out = {}
    for side, cls in (("port", SkillDataset), ("jax", JSkillDataset)):
        out[side] = (
            cls(spatial, np.array([6.0, 12.0, 18.0]), ["t850", "z500"],
                lat=samp.lat, lon=samp.lon),
            cls(glob, np.array([6.0, 12.0, 18.0, 24.0]), ["t850", "z500"]))
    return out


def test_skill_plots_match_jax(skills, tmp_path):
    for side, mod in SIDES.items():
        spatial, glob = skills[side]
        out = tmp_path / side
        samp = (build_sampling if side == "port" else jbuild_sampling)(*HP)
        mod.plot_skill_maps(spatial, out / "maps", skills=["BIAS", "RMSE"])
        mod.plot_skill_maps(spatial, out / "maps_mesh", sampling=samp,
                            leadtime_indices=[1])
        mod.plot_global_skills(glob, out / "global")
        mod.plot_skills_distribution(spatial, out / "dist")
        mod.benchmark_global_skills({"a": glob, "b": glob}, out / "bench",
                                    benchmarks={"ref": glob})
        mod.benchmark_global_skill({"a": glob}, "MAE", out / "one.png")
        _save(mod.plot_global_skill(glob, "KGE", label="x"),
              out / "global_one.png")
        _save(mod.plot_map(spatial["RMSE"][0, :, 0], spatial.lat,
                           spatial.lon, title="t"), out / "map.png")
    names = _same_pictures(tmp_path)
    assert "global/global_skills.png" in names and \
        "maps_mesh/skill_maps_z500.png" in names


def test_mesh_plots_match_jax(tmp_path):
    samp, jsamp = build_sampling(*HP), jbuild_sampling(*HP)
    patches, idx = plotting.voronoi_patches(samp)
    jpatches, jidx = jplotting.voronoi_patches(jsamp)
    np.testing.assert_array_equal(idx, jidx)
    assert len(patches) == len(jpatches)
    for a, b in zip(patches, jpatches):
        np.testing.assert_array_equal(a, b)
    vals = np.random.default_rng(1).random(samp.n_nodes)
    for side, mod, s in (("port", plotting, samp),
                         ("jax", jplotting, jsamp)):
        _save(mod.plot_polygons(vals, s, title="v", vmin=0.1),
              tmp_path / side / "poly.png")
        _save(mod.plot_mesh(s), tmp_path / side / "mesh.png")
        field = mod.SphereField(vals, s)
        assert not field.has_mesh
        _save(field.plot(cmap="magma"), tmp_path / side / "field.png")
        assert field.has_mesh
        _save(field.plot_mesh(), tmp_path / side / "field_mesh.png")
    _same_pictures(tmp_path)
    with pytest.raises(ValueError, match="n_nodes"):
        plotting.plot_polygons(vals[:-1], samp)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("plot_toy")
    generate_toy_data(root, sampling_kwargs=HP[1], n_timesteps=24, seed=3)
    path = root / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr"
    return {"port": SphericalDataset.open(path),
            "jax": JSphericalDataset.open(path)}


def test_hovmoller_matches_jax(toy, tmp_path):
    vals = np.random.default_rng(2).random((20, 48))
    coord = np.linspace(-88, 88, 48)
    time = np.arange("2010-01-01", "2010-01-21", dtype="datetime64[D]")
    h, bins = plotting.hovmoller_data(vals, coord, 10.0)
    jh, jbins = jplotting.hovmoller_data(vals, coord, 10.0)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(bins, jbins)
    for side, mod in SIDES.items():
        out = tmp_path / side
        mod.create_hovmoller_plots(toy[side], out / "lat")
        mod.create_hovmoller_plots(toy[side], out / "lon", bin_dim="lon",
                                   bin_res=30.0, time_subset=slice(2, 20))
        _save(mod.plot_hovmoller(vals, time, coord, title="h"),
              out / "panel.png")
        d = mod.HovmollerDiagram(vals, time, coord, bin_res=10.0)
        np.testing.assert_array_equal(d.data, h)
        _save(d.plot(title="zonal mean"), out / "diagram.png")
    names = _same_pictures(tmp_path)
    assert "lat/hovmoller_z500_lat.png" in names


class _Persistence:
    """A forecast of `n_lead` 6-hour leads from one reference time of a
    store: each lead the observation at the reference time. Duck-types
    the forecast datasets the animations read."""

    def __init__(self, ds, ref_index, n_lead):
        self.ds, self.ref = ds, ref_index
        self.feature_order, self.lat, self.lon = (ds.feature_order, ds.lat,
                                                  ds.lon)
        self.leadtime_hours = 6.0 * np.arange(1, n_lead + 1)
        self.n_leadtime = n_lead

    def valid_time(self, lt):
        return self.ds.time[[self.ref]] + np.timedelta64(
            int(self.leadtime_hours[lt]), "h")

    def read_leadtime(self, lt):
        return self.ds.read_stacked([self.ref]) + 0.1 * lt


def test_animations_match_jax(toy, tmp_path):
    scaler = AnomalyScaler(time_groups="month", standardized=True).fit(
        toy["port"].read_stacked(range(toy["port"].n_time)),
        toy["port"].time, feature_order=toy["port"].feature_order)
    for side, mod in SIDES.items():
        ds = toy[side]
        fc = _Persistence(ds, 10, 3)
        samp = (build_sampling if side == "port" else jbuild_sampling)(*HP)
        out = tmp_path / side
        mod.create_gif_forecast_error(fc, ds, out / "err.gif",
                                      variable="z500", sampling=samp)
        mod.create_gif_forecast_anom_error(fc, ds, scaler,
                                           out / "anom_err.gif")
        mod.create_gif_forecast_evolution(fc, out / "evo.gif",
                                          variable="t850")
    assert _same_pictures(tmp_path) == ["anom_err.gif", "err.gif",
                                        "evo.gif"]
    # leads past the observations are dropped; none left raises
    late = _Persistence(toy["port"], toy["port"].n_time - 1, 2)
    with pytest.warns(UserWarning, match="dropped 2/2"), \
            pytest.raises(ValueError, match="nothing to animate"):
        plotting.create_gif_forecast_error(late, toy["port"],
                                           tmp_path / "x.gif")


def test_training_plots_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    record = dict(
        iterations=list(range(1, 41)),
        training_total_loss=np.exp(-np.arange(40) / 15).tolist(),
        validation_iterations=[10, 20, 30, 40],
        validation_total_loss=[0.6, 0.4, 0.35, 0.3],
        per_iteration_loss=[rng.random(k).tolist() for k in (1, 1, 2, 2)],
        ar_growth_events=[25])
    for side, cls in (("port", ARTrainingInfo), ("jax", JARTrainingInfo)):
        cls(**record).plots(tmp_path / side, ylim=(0, 1.2))
    assert _same_pictures(tmp_path) == [
        "figs/training_info/loss_curves.png",
        "figs/training_info/per_leadtime_loss.png"]
