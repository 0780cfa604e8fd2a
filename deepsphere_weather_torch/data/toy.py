"""Synthetic ERA5-like toy data generator.

The port's copy of `deepsphere_weather_tpu/data/toy.py` (numpy and
scipy), over the port's own HEALPix sampling: the same seed gives the
same arrays as the JAX package's generator, exactly.

- dynamic: z500 (geopotential at 500 hPa, ~49000-58000 m^2/s^2) and t850
  (temperature at 850 hPa, ~250-300 K) with zonal structure, an annual
  cycle, propagating planetary waves, synoptic-scale anomalies advected
  by a midlatitude westerly jet, and a small AR(1) noise floor on smooth
  static spatial modes
- boundary conditions: TOA incident solar radiation from the actual
  declination/hour-angle geometry (reference bc variable 'tisr')
- static: scaled orography, land-sea mask, soil type, sin(latitude)

Used by the port's tests and by the protocol phase of `chip_smoke.py`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..sphere import build_sampling
from .dataset import SphericalDataset, StaticDataset, save_dynamic, save_static

__all__ = ["generate_toy_data", "toa_solar_radiation", "perturbation_basis"]


def toa_solar_radiation(time: np.ndarray, lat: np.ndarray,
                        lon: np.ndarray) -> np.ndarray:
    """Top-of-atmosphere incident solar radiation [W/m^2], shape [T, V]."""
    t = np.asarray(time, dtype="datetime64[ns]")
    day_of_year = ((t - t.astype("datetime64[Y]")) /
                   np.timedelta64(1, "D")).astype(np.float64)
    hour = ((t - t.astype("datetime64[D]")) /
            np.timedelta64(1, "h")).astype(np.float64)
    decl = np.deg2rad(-23.44) * np.cos(2 * np.pi * (day_of_year + 10) / 365.25)
    lat_r = np.deg2rad(lat)[None, :]
    lon_r = np.deg2rad(lon)[None, :]
    hour_angle = (2 * np.pi * (hour[:, None] / 24.0) + lon_r) - np.pi
    cos_zenith = (np.sin(lat_r) * np.sin(decl[:, None])
                  + np.cos(lat_r) * np.cos(decl[:, None]) * np.cos(hour_angle))
    return (1361.0 * np.maximum(cos_zenith, 0.0)).astype(np.float32)


def _smooth_modes(rng, coords: np.ndarray, n_modes: int, length: float) -> np.ndarray:
    """Random smooth fields on the sphere: gaussians at random centers."""
    centers = rng.standard_normal((n_modes, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    d2 = 2.0 - 2.0 * coords @ centers.T          # squared chordal distance
    return np.exp(-d2 / (2 * length ** 2))        # [V, n_modes]


def _advected_synoptic(rng, lat: np.ndarray, lon: np.ndarray,
                       n_timesteps: int, dt_hours: float, amp: float,
                       nlat: int = 128, corr_days: float = 5.0,
                       u_max: float = 25.0, k_center: int = 10,
                       lat_smooth_deg: float = 6.0) -> np.ndarray:
    """Synoptic-scale anomalies advected by a westerly jet, [T, V] float32.

    A linear stochastic advection model on a regular lat-lon grid:
    per-latitude-row zonal spectra c[lat, k] evolve as a complex AR(1)
    whose deterministic part is a phase rotation exp(-i*k*dlon(lat)) —
    exact semi-Lagrangian zonal advection by u(lat) = u_max*sin(2*lat)^2
    (westerlies peaking at +-45 deg, calm at equator/poles) — plus
    spatially smooth innovations band-passed around zonal wavenumber
    `k_center` and lat-smoothed over `lat_smooth_deg`.

    Predictability structure (what makes this a fair weather analog):
    persistence decorrelates in one 6 h step at jet latitudes (the field
    moves ~k_center * u_max * dt / (R cos lat) ~ 1 rad of phase), while a
    model that learns the local advection + damping can forecast down to
    the innovation floor sqrt(1 - rho^2) ~ 0.3 of the field variance
    (rho = exp(-dt / corr_days)). The displacement per step is several
    pixels at HEALPix-64 (~0.9 deg) and ~1-2 pixels at HEALPix-16, so the
    dynamics are resolvable by local graph-conv stencils at both scales.
    """
    nlon = 2 * nlat
    nk = nlon // 2 + 1
    dlat = 180.0 / nlat
    grid_lat = np.deg2rad(-90.0 + dlat * (np.arange(nlat) + 0.5))
    dt_sec = dt_hours * 3600.0
    r_earth = 6.371e6

    u = u_max * np.sin(2.0 * grid_lat) ** 2                      # [nlat]
    dlon_step = u * dt_sec / (r_earth * np.cos(grid_lat))        # [rad]
    k = np.arange(nk, dtype=np.float64)
    phase = np.exp(-1j * k[None, :] * dlon_step[:, None])        # [nlat, nk]

    rho = float(np.exp(-dt_hours / (24.0 * corr_days)))
    s = np.sqrt(1.0 - rho ** 2)
    # band-pass around k_center, zero at k=0 (no zonal-mean drift)
    kf = (k / k_center) * np.exp(0.5 * (1.0 - (k / k_center) ** 2))

    # innovations for all steps at once; lat-smoothed in one vectorized pass
    w = (rng.standard_normal((n_timesteps, nlat, nk))
         + 1j * rng.standard_normal((n_timesteps, nlat, nk)))
    from scipy.ndimage import gaussian_filter1d
    sigma_rows = lat_smooth_deg / dlat
    w = (gaussian_filter1d(w.real, sigma_rows, axis=1)
         + 1j * gaussian_filter1d(w.imag, sigma_rows, axis=1))
    w *= kf[None, None, :]

    # AR(1) with phase advection; c[0] = w[0] is already the stationary law
    for t in range(1, n_timesteps):
        w[t] = rho * phase * w[t - 1] + s * w[t]

    field = np.fft.irfft(w, n=nlon, axis=2)                      # [T, nlat, nlon]
    del w
    field /= max(field.std(), 1e-12)

    # bilinear sample at the node positions (periodic in lon)
    fl = (np.deg2rad(lat) - grid_lat[0]) / np.deg2rad(dlat)
    il0 = np.clip(np.floor(fl).astype(np.int64), 0, nlat - 2)
    wl = np.clip(fl - il0, 0.0, 1.0)
    fj = np.mod(np.deg2rad(lon), 2 * np.pi) / (2 * np.pi) * nlon
    jl0 = np.floor(fj).astype(np.int64) % nlon
    wj = fj - np.floor(fj)
    jl1 = (jl0 + 1) % nlon
    out = ((1 - wl) * (1 - wj) * field[:, il0, jl0]
           + (1 - wl) * wj * field[:, il0, jl1]
           + wl * (1 - wj) * field[:, il0 + 1, jl0]
           + wl * wj * field[:, il0 + 1, jl1])
    return (amp * out).astype(np.float32)


def perturbation_basis(sampling, n_modes: int = 32, length: float = 0.4,
                       seed: int = 0) -> np.ndarray:
    """Smooth spatial basis [V, n_modes] with unit pointwise variance
    under N(0,1) mode coefficients.

    Ensemble initial-condition / stochastic-model-error perturbations:
    drawing coeff ~ N(0, 1) per mode and forming
    basis @ coeff yields a spatially-correlated field whose per-node
    standard deviation is exactly 1 — scale by the desired sigma. The
    correlation length matches the toy generator's AR(1) noise modes, so
    perturbations project onto the directions the toy's unpredictable
    component actually lives in."""
    rng = np.random.default_rng(seed)
    modes = _smooth_modes(rng, sampling.coords_3d, n_modes, length)  # [V, M]
    norm = np.sqrt((modes ** 2).sum(axis=1, keepdims=True)) + 1e-12
    return (modes / norm).astype(np.float32)


def generate_toy_data(
    out_dir,
    sampling: str = "healpix",
    sampling_kwargs: Optional[Dict] = None,
    start: str = "2010-01-01",
    n_timesteps: int = 1460,          # 1 year at 6 h
    dt_hours: int = 6,
    seed: int = 0,
) -> Tuple[SphericalDataset, SphericalDataset, StaticDataset]:
    """Generate and save toy dynamic/bc/static stores; returns open datasets."""
    if sampling_kwargs is None:
        sampling_kwargs = {"subdivisions": 16, "nest": True}
    out_dir = Path(out_dir)
    samp = build_sampling(sampling, sampling_kwargs)
    V = samp.n_nodes
    lat, lon = samp.lat, samp.lon
    coords = samp.coords_3d
    rng = np.random.default_rng(seed)

    time = (np.datetime64(start) +
            np.arange(n_timesteps) * np.timedelta64(dt_hours, "h"))
    t_frac = np.arange(n_timesteps) * dt_hours / (24 * 365.25)  # years
    lat_r = np.deg2rad(lat)
    lon_r = np.deg2rad(lon)

    # --- base climate structure -----------------------------------------
    annual = np.cos(2 * np.pi * (t_frac - 0.5))[:, None]          # +1 in July
    zonal_t = 288.0 - 30.0 * np.sin(lat_r) ** 2                   # [V]
    seasonal_t = 15.0 * np.sin(lat_r)[None, :] * annual
    zonal_z = 5650.0 - 350.0 * np.sin(lat_r) ** 2
    seasonal_z = 80.0 * np.sin(lat_r)[None, :] * annual

    # --- propagating planetary waves -------------------------------------
    def waves(amp, wavenumbers, period_days):
        f = np.zeros((n_timesteps, V), dtype=np.float64)
        for m, p in zip(wavenumbers, period_days):
            phase = 2 * np.pi * (t_frac * 365.25 / p)
            f += (amp * np.cos(lat_r)[None, :]
                  * np.cos(m * lon_r[None, :] - phase[:, None]
                           + rng.uniform(0, 2 * np.pi)))
        return f

    wave_z = waves(60.0, (4, 6), (8.0, 5.0))
    wave_t = waves(3.0, (5, 7), (7.0, 4.0))

    # --- synoptic anomalies advected by the westerly jet ------------------
    # The dominant weather component: resolvable local dynamics a graph
    # CNN can learn (persistence decorrelates in ~1 step at jet latitudes)
    synop_z = _advected_synoptic(rng, lat, lon, n_timesteps, dt_hours,
                                 amp=90.0)
    synop_t = _advected_synoptic(rng, lat, lon, n_timesteps, dt_hours,
                                 amp=4.5)

    # --- AR(1) weather noise on smooth static spatial modes ---------------
    # kept small: this component is persistent-but-unpredictable, so it
    # sets the floor on how much any model can beat persistence
    def ar1_noise(n_modes, length, sigma, rho=0.95):
        modes = _smooth_modes(rng, coords, n_modes, length)       # [V, M]
        a = np.zeros((n_timesteps, n_modes))
        eps = rng.standard_normal((n_timesteps, n_modes))
        for i in range(1, n_timesteps):
            a[i] = rho * a[i - 1] + np.sqrt(1 - rho ** 2) * eps[i]
        return sigma * a @ modes.T                                 # [T, V]

    noise_z = ar1_noise(24, 0.45, 20.0)
    noise_t = ar1_noise(24, 0.40, 1.2)

    # geopotential stored as z [m^2/s^2] (g * height), like ERA5
    g0 = 9.80665
    z500 = (zonal_z[None, :] + seasonal_z + wave_z + synop_z + noise_z) * g0
    t850 = zonal_t[None, :] + seasonal_t + wave_t + synop_t + noise_t

    ds_dynamic = save_dynamic(
        out_dir / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr",
        {"z500": z500.astype(np.float32), "t850": t850.astype(np.float32)},
        time=time, lat=lat, lon=lon)

    # --- boundary conditions ---------------------------------------------
    tisr = toa_solar_radiation(time, lat, lon)
    ds_bc = save_dynamic(
        out_dir / "Data" / "bc" / "time_chunked" / "bc.zarr",
        {"tisr": tisr}, time=time, lat=lat, lon=lon)

    # --- static fields -----------------------------------------------------
    orog = 800.0 * np.maximum(_smooth_modes(rng, coords, 12, 0.3).sum(axis=1)
                              - 0.8, 0.0)
    lsm = (_smooth_modes(rng, coords, 10, 0.5).sum(axis=1) > 0.9).astype(np.float32)
    slt = (lsm * rng.integers(1, 7, V)).astype(np.float32)
    ds_static = save_static(
        out_dir / "Data" / "static.zarr",
        {
            "orog": (orog / orog.max() if orog.max() > 0 else orog).astype(np.float32),
            "lsm": lsm,
            "slt": slt / 7.0,
            "sin_latitude": np.sin(lat_r).astype(np.float32),
        },
        lat=lat, lon=lon)
    return ds_dynamic, ds_bc, ds_static
