"""The GRIB ingest chain of `tests/test_ingest.py` as two functions, shared
by `tests/test_torch_ingest.py` (each package's modules passed in) and
chip_smoke.py's ingest16 (the port's): a raw GRIB2 tree in the reference's
layout, then remap -> reformat -> zarrify -> rechunk -> statics into the
data directory `cli.train_predict` reads. A helper, not a test; it imports
no package of its own, so the card's runs may import it."""

import time
from pathlib import Path

import numpy as np

T0 = np.datetime64("2010-01-01T00")
LEVELS = (("z", 500, 54000.0, -3500.0, 300.0),
          ("z", 850, 14000.0, -1500.0, 150.0),
          ("t", 500, 253.0, -25.0, 3.0),
          ("t", 850, 281.0, -30.0, 4.0))


def write_grib_tree(grib, root, dataset, native, grid, n_t, seed):
    """`<root>/<dataset>/<native>/{dynamic,static}/<var>/*.grib` with
    `grib` (either package's `data.grib`): z and t at 500 and 850 hPa and
    accumulated TOA solar radiation (J/m^2 over the 6-hour step, as ERA5's
    tisr) every 6 hours from T0 for `n_t` steps, in two files, and
    topography, land-sea mask and soil type. Smooth latitude and longitude
    structure plus noise from `seed`, so that conservation is a real check.
    Returns {(t, var, level): source field}, the GRIB files' bytes and
    their count."""
    root = Path(root)
    lat, lon = grid.latlon()
    rng = np.random.default_rng(seed)
    times = T0 + np.arange(n_t) * np.timedelta64(6, "h")
    slat, c3lon = np.sin(np.deg2rad(lat)), np.cos(3 * np.deg2rad(lon))
    fields, n_bytes, n_files = {}, 0, 0
    top = root / dataset / native
    for part, ts in enumerate(np.array_split(np.arange(n_t), 2)):
        recs = []
        for ti in ts:
            wave = np.sin(2 * np.pi * ti / n_t)
            for var, lev, base, a_lat, a_noise in LEVELS:
                v = (base + a_lat * slat ** 2 + 0.1 * a_lat * c3lon
                     + a_noise * rng.standard_normal(grid.n_points)
                     + 0.02 * base * wave).astype(np.float32)
                fields[(ti, var, lev)] = v
                recs.append(grib.GribRecord(var, v, times[ti], grid,
                                            level_hPa=lev))
            frac = np.maximum(slat * np.sin(2 * np.pi * ti / 4 / n_t)
                              + 0.3, 0.0)
            tisr = (1361.0 * frac * 6 * 3600.0).astype(np.float32)
            fields[(ti, "tisr", None)] = tisr
            recs.append(grib.GribRecord("tisr", tisr, times[ti], grid,
                                        surface_type=8))
        path = grib.write_grib2(
            top / "dynamic" / "dynamic_variables" / f"part{part}.grib",
            recs)
        n_bytes += path.stat().st_size
        n_files += 1
    orog = np.maximum(800.0 * np.sin(3 * np.deg2rad(lat))
                      * np.cos(2 * np.deg2rad(lon)), 0.0).astype(np.float32)
    lsm = (orog > 100).astype(np.float32)
    slt = (lsm * ((np.arange(grid.n_points) % 6) + 1)).astype(np.float32)
    for var, vals in (("topography", orog), ("land_sea_mask", lsm),
                      ("soil_type", slt)):
        fields[(0, var, None)] = vals
        path = grib.write_grib2(top / "static" / var / f"{var}.grib",
                                [grib.GribRecord(var, vals, T0, grid)])
        n_bytes += path.stat().st_size
        n_files += 1
    return {"fields": fields, "bytes": n_bytes, "files": n_files}


def ingest(pp, save_static, root, dataset, sampling_name, dst, data_dir,
           time_chunk):
    """Remap the tree under `root` onto `dst` with `pp` (either package's
    `data.preprocess`; the weights on disk under `<root>/weights`), then
    write `data_dir`'s Data/: the dynamic store (z500, t850) and the
    boundary-condition store (tisr, de-accumulated to W/m^2) time-chunked,
    the dynamic one also space-chunked, and the static store (orog scaled,
    lsm, slt / 7, sin_latitude) with `save_static`. Returns the remapped
    files and the host seconds of each stage."""
    data_dir = Path(data_dir)
    secs = {}
    t0 = time.perf_counter()
    dyn = pp.remap_grib_files(root, dataset, sampling_name, "dynamic", dst,
                              verbose=False)
    static = pp.remap_grib_files(root, dataset, sampling_name, "static",
                                 dst, verbose=False)
    secs["remap"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches, bc_batches = [], []
    for fp in dyn:
        with np.load(fp) as z:
            data = {k: z[k] for k in z.files
                    if k not in ("lat", "lon", "time")}
            times = z["time"].view("datetime64[ns]")
        flat = pp.reformat_pl(data)
        batches.append(({"z500": flat["z500"], "t850": flat["t850"]},
                        times))
        bc_batches.append(({"tisr": pp.reformat_toa(
            flat["tisr"], accumulation_hours=6).astype(np.float32)}, times))
    tc = data_dir / "Data" / "dynamic" / "time_chunked" / "dynamic.zarr"
    pp.zarrify_raw_data(tc, batches, time_chunk=time_chunk, lat=dst.lat,
                        lon=dst.lon)
    pp.zarrify_raw_data(data_dir / "Data" / "bc" / "time_chunked"
                        / "bc.zarr", bc_batches, time_chunk=time_chunk,
                        lat=dst.lat, lon=dst.lon)
    secs["zarrify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp.rechunk_to_space_chunked(
        tc, data_dir / "Data" / "dynamic" / "space_chunked" / "dynamic.zarr",
        node_chunk=16)
    secs["rechunk"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = {}
    for fp in static:
        with np.load(fp) as z:
            for k in z.files:
                if k not in ("lat", "lon", "time"):
                    st[k] = np.squeeze(z[k])
    orog = st["topography"]
    save_static(data_dir / "Data" / "static.zarr", {
        "orog": (orog / orog.max()).astype(np.float32),
        "lsm": st["land_sea_mask"].astype(np.float32),
        "slt": (st["soil_type"] / 7.0).astype(np.float32),
        "sin_latitude": np.sin(np.deg2rad(dst.lat)).astype(np.float32),
    }, lat=dst.lat, lon=dst.lon)
    secs["statics"] = time.perf_counter() - t0
    return {"dynamic": dyn, "static": static, "seconds": secs}
