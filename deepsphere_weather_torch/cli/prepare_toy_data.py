"""Toy-data preparation driver.

Port of `deepsphere_weather_tpu/cli/prepare_toy_data.py` (reference:
scripts/06_prepare_toy_data.py): the synthetic ERA5-like fixture (one
year of six-hour steps on nested HEALPix at the requested resolution by
default) and its global standard scalers, the data directory every
driver points at. Numpy only: nothing here runs on the card.

Usage:
    python -m deepsphere_weather_torch.cli.prepare_toy_data --out_dir DATA \\
        [--subdivisions 16] [--n_timesteps 1460]
"""

from __future__ import annotations

import argparse


def main(out_dir, subdivisions: int = 16, n_timesteps: int = 1460,
         start: str = "2010-01-01", dt_hours: int = 6, seed: int = 0,
         verbose: bool = True):
    from pathlib import Path

    from ..data import GlobalStandardScaler, generate_toy_data

    dyn, bc, static = generate_toy_data(
        out_dir, sampling_kwargs={"subdivisions": subdivisions, "nest": True},
        start=start, n_timesteps=n_timesteps, dt_hours=dt_hours, seed=seed)
    scaler_dir = Path(out_dir) / "Scalers"
    scaler_dir.mkdir(parents=True, exist_ok=True)
    GlobalStandardScaler().fit_dataset(dyn).save(
        scaler_dir / "GlobalStandardScaler_dynamic.npz")
    GlobalStandardScaler().fit_dataset(bc).save(
        scaler_dir / "GlobalStandardScaler_bc.npz")
    if verbose:
        print(f"toy data: {dyn.n_time} steps x {dyn.n_node} nodes "
              f"({dyn.feature_order}) -> {out_dir}")
    return dyn, bc, static


def cli():
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--subdivisions", type=int, default=16)
    p.add_argument("--n_timesteps", type=int, default=1460)
    p.add_argument("--dt_hours", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    main(args.out_dir, subdivisions=args.subdivisions,
         n_timesteps=args.n_timesteps, dt_hours=args.dt_hours, seed=args.seed)


if __name__ == "__main__":
    cli()
