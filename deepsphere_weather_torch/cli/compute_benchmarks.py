"""Benchmark-forecast computation driver.

Port of `deepsphere_weather_tpu/cli/compute_benchmarks.py` (reference:
scripts/05_compute_verif_benchmarks.py:22-119): the persistence and the
monthly and weekly climatology forecasts' skills on the data, saved under
<data_dir>/Benchmarks as {Persistence,WeeklyClimatology,
MonthlyClimatology}_{Spatial,Global}_Skills.npz. The global skills weight
the nodes by their spherical Voronoi areas (scipy), from the stored
coordinates. Numpy and scipy only; nothing here uses the card.

Usage:
    python -m deepsphere_weather_torch.cli.compute_benchmarks --data_dir DATA \\
        [--leadtimes 39]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(data_dir, n_leadtimes: int = 39, verbose: bool = True):
    import scipy.spatial

    from ..data import Climatology, SphericalDataset, load_scaler
    from ..verif import climatology_skills, global_summary, persistence_skills

    data_dir = Path(data_dir)
    out_dir = data_dir / "Benchmarks"
    out_dir.mkdir(parents=True, exist_ok=True)
    ds = SphericalDataset.open(
        data_dir / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr")
    # area weights from the stored coordinates (no sampling spec needed)
    coords = np.stack([
        np.cos(np.deg2rad(ds.lat)) * np.cos(np.deg2rad(ds.lon)),
        np.cos(np.deg2rad(ds.lat)) * np.sin(np.deg2rad(ds.lon)),
        np.sin(np.deg2rad(ds.lat))], axis=1)
    aw = scipy.spatial.SphericalVoronoi(coords).calculate_areas()
    aw = aw / aw.sum()

    leadtimes = np.arange(1, n_leadtimes + 1)

    ps = persistence_skills(ds, leadtimes)
    ps.save(out_dir / "Persistence_Spatial_Skills.npz")
    global_summary(ps, aw).save(out_dir / "Persistence_Global_Skills.npz")
    if verbose:
        print(f"persistence RMSE at +{n_leadtimes} steps: "
              f"{np.round(global_summary(ps, aw)['RMSE'][-1], 3)}")

    for groups, tag in (("month", "Monthly"), ("weekofyear", "Weekly")):
        clim_path = data_dir / "Climatology" / f"{tag}Climatology_dynamic.npz"
        if clim_path.exists():
            clim = load_scaler(clim_path)
        else:
            clim = Climatology(time_groups=groups).fit(
                ds.read_all(), ds.time, feature_order=ds.feature_order)
        cs = climatology_skills(ds, clim, leadtimes)
        cs.save(out_dir / f"{tag}Climatology_Spatial_Skills.npz")
        global_summary(cs, aw).save(
            out_dir / f"{tag}Climatology_Global_Skills.npz")
        if verbose:
            print(f"{tag} climatology RMSE: "
                  f"{np.round(global_summary(cs, aw)['RMSE'][-1], 3)}")
    return out_dir


def cli():
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--leadtimes", type=int, default=39)
    args = p.parse_args()
    main(args.data_dir, n_leadtimes=args.leadtimes)


if __name__ == "__main__":
    cli()
