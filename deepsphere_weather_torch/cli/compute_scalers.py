"""Scaler and climatology computation driver.

Port of `deepsphere_weather_tpu/cli/compute_scalers.py` (reference:
scripts/04a_compute_scalers.py:42-384). It fits and saves the scaler
family the reference precomputes: GlobalStandardScaler and
GlobalMinMaxScaler, the monthly and weekly anomaly scalers (plain and
standardized, over a reference period), the MinMax of the standardized
anomalies, and the monthly, weekly, daily and hourly-monthly
climatologies. The port's scalers are numpy only (no pandas), so this
runs on the card's machine too; nothing here uses the card.

Usage:
    python -m deepsphere_weather_torch.cli.compute_scalers --data_dir DATA \\
        [--reference_period 1980-01-01 2010-12-31]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple


def main(data_dir, reference_period: Optional[Tuple[str, str]] = None,
         verbose: bool = True):
    from ..data import (
        AnomalyScaler,
        Climatology,
        GlobalMinMaxScaler,
        GlobalStandardScaler,
        SphericalDataset,
    )

    data_dir = Path(data_dir)
    out_dir = data_dir / "Scalers"
    out_dir.mkdir(parents=True, exist_ok=True)
    clim_dir = data_dir / "Climatology"
    clim_dir.mkdir(parents=True, exist_ok=True)

    ds = SphericalDataset.open(
        data_dir / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr")
    data = ds.read_all()

    def log(msg):
        if verbose:
            print(msg, flush=True)

    # --- global scalers ----------------------------------------------------
    s = GlobalStandardScaler().fit_dataset(ds)
    s.save(out_dir / "GlobalStandardScaler_dynamic.npz")
    log("GlobalStandardScaler fitted")
    s = GlobalMinMaxScaler().fit_dataset(ds)
    s.save(out_dir / "GlobalMinMaxScaler_dynamic.npz")
    log("GlobalMinMaxScaler fitted")

    # --- boundary-condition scaler (raw TOA spans 0..1361 W/m^2 next to
    # O(1) standardized dynamic features without it) -----------------------
    bc_path = data_dir / "Data" / "bc" / "time_chunked" / "bc.zarr"
    if bc_path.exists():
        sbc = GlobalStandardScaler().fit_dataset(
            SphericalDataset.open(bc_path))
        sbc.save(out_dir / "GlobalStandardScaler_bc.npz")
        log("GlobalStandardScaler (bc) fitted")

    # --- anomaly scalers (per node, monthly/weekly, plain + standardized) --
    for groups, tag in (("month", "Monthly"), ("weekofyear", "Weekly")):
        for standardized, stag in ((False, ""), (True, "Std")):
            a = AnomalyScaler(time_groups=groups, standardized=standardized,
                              reference_period=reference_period).fit(
                data, ds.time, feature_order=ds.feature_order)
            a.save(out_dir / f"{tag}{stag}AnomalyScaler_dynamic.npz")
            log(f"{tag}{stag}AnomalyScaler fitted")
        # MinMax of the standardized anomalies: `a` is the standardized
        # scaler of the loop's last pass
        anom = a.transform(data, time=ds.time)
        mm = GlobalMinMaxScaler().fit(anom, feature_order=ds.feature_order)
        mm.save(out_dir / f"{tag}MinMaxStdAnomalyScaler_dynamic.npz")
        log(f"{tag}MinMaxStdAnomalyScaler fitted")

    # --- climatologies ------------------------------------------------------
    # HourlyMonthly is the compound ['hour', 'month'] grouping
    # (reference scripts/04a:355-364), not plain hourly
    for groups, tag in (("month", "Monthly"), ("weekofyear", "Weekly"),
                        ("dayofyear", "Daily"),
                        (["hour", "month"], "HourlyMonthly")):
        c = Climatology(time_groups=groups,
                        reference_period=reference_period).fit(
            data, ds.time, feature_order=ds.feature_order)
        c.save(clim_dir / f"{tag}Climatology_dynamic.npz")
        log(f"{tag}Climatology fitted")
    return out_dir


def cli():
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--reference_period", nargs=2, default=None)
    args = p.parse_args()
    main(args.data_dir,
         reference_period=tuple(args.reference_period)
         if args.reference_period else None)


if __name__ == "__main__":
    cli()
