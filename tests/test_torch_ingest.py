"""The port's ingest, preprocessing and native layers vs the JAX package.

- native conservative weights (`native/geometry.cpp` through
  `sphere.remap.compute_interpolation_weights`) against the JAX package's
  numpy geometry (`_conservative_weights_numpy`, what it runs without its
  own library) to 1e-12: HEALPix 8 -> 4, O8 -> HEALPix-4 and an
  equiangular pair; the port's own plain version the same;
- the native build (`native/build.py`): a broken or missing compiler
  raises with its output; two processes building into one empty build
  directory at once both load the library, built once;
- the native bulk chunk reader against the JAX package's per-chunk Python
  path, exactly, on raw, zlib and blosc stores with missing chunks read as
  the fill value, whole and in small batches;
- `remap_grib_files` of one GRIB tree (O8, `tests/test_ingest.py`'s
  fields): the same output and cached-weight file names, fields equal to
  1e-6 relative (a class field remapped by the largest area fraction:
  where a destination cell's largest overlaps tie within 1e-12, the
  native and numpy overlaps, 1e-15 apart, pick different tied sources, so
  there the port's class is held to one of the tied sources' classes); `zarrify_raw_data` / `rechunk_to_space_chunked` of the
  same batches: equal stores; `open_netcdf4` and `load_external_skill` of
  one h5py-written file: equal; the largest-area-fraction weights keep
  empty rows empty;
- the port's chain on that tree (`tests/torch_ingest_chain.py`) ends in a
  few CPU training steps through its `cli.train_predict` (HEALPix-4,
  knn 8), after `cli.compute_scalers`;
- `tests/test_ingest.py`'s adversarial cases in both packages: a missing
  analysis fails `zarrify_raw_data`, a classic reduced grid's file-carried
  pl remaps conservatively.
"""

import json
import os
import shutil
import subprocess
import sys
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest
from scipy import sparse

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401
from torch_ingest_chain import ingest, write_grib_tree  # noqa: E402

from deepsphere_weather_tpu.data import grib as jgrib  # noqa: E402
from deepsphere_weather_tpu.data import preprocess as jpp  # noqa: E402
from deepsphere_weather_tpu.data import zarrstore as jzarr  # noqa: E402
from deepsphere_weather_tpu.data.dataset import save_static as jsave_static  # noqa: E402
from deepsphere_weather_tpu.sphere import build_sampling as jbuild_sampling  # noqa: E402
from deepsphere_weather_tpu.sphere.remap import (  # noqa: E402
    _conservative_weights_numpy as jweights_numpy,
    compute_interpolation_weights as jweights,
)
from deepsphere_weather_tpu.verif.external import (  # noqa: E402
    load_external_skill as jload_external_skill,
)

from deepsphere_weather_torch.data import grib  # noqa: E402
from deepsphere_weather_torch.data import preprocess as pp  # noqa: E402
from deepsphere_weather_torch.data import zarrstore  # noqa: E402
from deepsphere_weather_torch.data.dataset import save_static  # noqa: E402
from deepsphere_weather_torch.native import build, chunkio, geometry  # noqa: E402
from deepsphere_weather_torch.sphere import build_sampling  # noqa: E402
from deepsphere_weather_torch.sphere.remap import (  # noqa: E402
    _conservative_weights_numpy,
    compute_interpolation_weights,
)
from deepsphere_weather_torch.verif import load_external_skill  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HP4 = ("healpix", {"subdivisions": 4, "nest": True})
PAIRS = {
    "healpix8_to_4": (("healpix", {"subdivisions": 8, "nest": True}), HP4),
    "o8_to_healpix4": (("gauss", {"nlat": 16, "nlon": list(
        grib.octahedral_pl(8))}), HP4),
    "equiangular16x32_to_8x16": (("equiangular", {"nlat": 16, "nlon": 32}),
                                 ("equiangular", {"nlat": 8, "nlon": 16})),
}
WEIGHT_TOL = 1e-12
DATASET, NATIVE, SAMPLING_NAME = "TOY_GRIB", "O8", "Healpix_toy"


@pytest.mark.parametrize("pair", list(PAIRS))
def test_native_weights_match_jax_numpy(pair):
    (sn, skw), (dn, dkw) = PAIRS[pair]
    src, dst = build_sampling(sn, skw), build_sampling(dn, dkw)
    jsrc, jdst = jbuild_sampling(sn, skw), jbuild_sampling(dn, dkw)
    W, a_src, a_dst = geometry.conservative_weights(src, dst)
    jW, ja_src, ja_dst = jweights_numpy(jsrc, jdst)
    assert W.shape == jW.shape == (dst.n_nodes, src.n_nodes)
    assert abs(W - jW).max() <= WEIGHT_TOL
    np.testing.assert_array_equal(a_src, ja_src)
    np.testing.assert_array_equal(a_dst, ja_dst)
    if pair == "o8_to_healpix4":
        # the port's plain version is the JAX package's numpy path
        pW, _, _ = _conservative_weights_numpy(src, dst)
        assert abs(pW - jW).max() == 0.0
    # the normalized weights the remap pools and preprocessing use
    Wn, _, _ = compute_interpolation_weights(src, dst)
    assert abs(Wn - sparse.diags(1.0 / ja_dst) @ jW).max() <= WEIGHT_TOL


def test_broken_compiler_raises(tmp_path, monkeypatch):
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\n"
                    "case \"$*\" in *--version*|*--help*) echo fake 1.0;;\n"
                    "*) echo 'fake-g++: error: broken toolchain' >&2; "
                    "exit 1;; esac\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "CXX", str(fake))
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="broken toolchain"):
        build.load_library("geometry")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        build.load_library("chunkio")


def test_concurrent_builds_load_one_library(tmp_path):
    """Two processes started together on an empty build directory: both
    load the library and compute with it; one library, no temporary file
    left."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from deepsphere_weather_torch.native import build, geometry\n"
            "from deepsphere_weather_torch.sphere import build_sampling\n"
            "build.BUILD_DIR = Path(sys.argv[1])\n"
            "W, _, _ = geometry.conservative_weights(\n"
            "    build_sampling('healpix', {'subdivisions': 2, 'nest': True}),\n"
            "    build_sampling('healpix', {'subdivisions': 1, 'nest': True}))\n"
            "print(W.nnz, W.sum())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    files = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert [f for f in files if f.endswith(".so")] == [
        f for f in files if f.startswith("libdsw_geometry_")]
    assert len([f for f in files if f.endswith(".so")]) == 1


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
def test_bulk_reader_matches_python_chunks(compressor, tmp_path,
                                           monkeypatch):
    from deepsphere_weather_torch.native import bloscio

    if compressor == "blosc" and not bloscio.available():
        pytest.skip("libblosc is not installed on this host")
    g = jzarr.create_group(tmp_path / "n.zarr", overwrite=True)
    a = g.create_array("x", shape=(50, 33, 3), chunks=(8, 16, 3),
                       dtype=np.float32, compressor=compressor,
                       fill_value=3.5)
    data = np.random.default_rng(3).standard_normal(
        (50, 33, 3)).astype(np.float32)
    a[0:24] = data[0:24]               # chunks of rows 24.. stay missing
    ja = jzarr.open_group(tmp_path / "n.zarr")["x"]
    want = np.stack([ja._read_chunk(i) for i in
                     ja._chunks_overlapping(ja._norm_key(...)[0])])
    calls = []
    real = chunkio.read_chunks
    monkeypatch.setattr(chunkio, "read_chunks",
                        lambda paths, *a, **k: calls.append(len(paths))
                        or real(paths, *a, **k))
    arr = zarrstore.open_group(tmp_path / "n.zarr")["x"]
    idxs = arr._chunks_overlapping(arr._norm_key(...)[0])
    got = np.stack([c for _, c in arr._read_chunks_uncached(idxs)])
    assert calls == [len(idxs)]
    np.testing.assert_array_equal(got, want)
    # a selection through the chunk LRU and in batches of 3 chunks
    monkeypatch.setattr(type(arr), "_BULK_BATCH_BYTES",
                        3 * 8 * 16 * 3 * 4)
    zarrstore.set_chunk_cache_bytes(0)
    try:
        np.testing.assert_array_equal(arr[5:47, 3:30], ja[5:47, 3:30])
    finally:
        zarrstore.set_chunk_cache_bytes(512 * 1024 * 1024)
    assert calls[1:] == [3, 3, 3, 3]      # 6 x 2 chunks
    np.testing.assert_array_equal(arr[...], ja[...])
    assert (arr[24:] == 3.5).all() and (arr[:24] == data[:24]).all()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One O8 GRIB tree (both packages write it byte for byte alike),
    ingested by each package into its own copy."""
    root = tmp_path_factory.mktemp("ingest")
    grid = grib.GridSpec("reduced_gg", 16, pl=grib.octahedral_pl(8))
    tree = write_grib_tree(grib, root / "port", DATASET, NATIVE, grid,
                           n_t=60, seed=7)
    shutil.copytree(root / "port", root / "jax")
    out = {"root": root, "tree": tree, "grid": grid}
    for side, mod, save, build_s in (
            ("port", pp, save_static, build_sampling),
            ("jax", jpp, jsave_static, jbuild_sampling)):
        with mock.patch.dict(mod.NATIVE_GRIDS, {DATASET: NATIVE}):
            out[side] = ingest(mod, save, root / side, DATASET,
                               SAMPLING_NAME, build_s(*HP4),
                               root / side / "data", time_chunk=24)
    return out


def _laf_ties(src, dst, tol=1e-12):
    """Per destination cell, the sources whose overlap fraction is within
    `tol` of its largest (more than one: a tie, where the largest-area
    choice is float noise), and the mask of tied cells."""
    W = pp.remap_weights_for_source(src, dst, cache=False)
    cands = []
    for r in range(W.shape[0]):
        d = W.data[W.indptr[r]:W.indptr[r + 1]]
        cols = W.indices[W.indptr[r]:W.indptr[r + 1]]
        cands.append(set(cols[d >= d.max() - tol]) if len(d) else set())
    return np.array([len(c) > 1 for c in cands]), cands


def _check_laf(got, want, src_vals, src, dst):
    """A largest-area-fraction remap against the JAX package's: equal where
    the largest overlap is unique, one of the tied sources' values where
    it ties."""
    tied, cands = _laf_ties(src, dst)
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    np.testing.assert_array_equal(got[~tied], want[~tied])
    for r in np.nonzero(tied)[0]:
        assert got[r] in {src_vals[c] for c in cands[r]}, r
    return int(tied.sum())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_remap_grib_files_matches_jax(trees):
    root = trees["root"]
    for kind in ("dynamic", "static"):
        port = [p.relative_to(root / "port") for p in trees["port"][kind]]
        assert port == [p.relative_to(root / "jax")
                        for p in trees["jax"][kind]]
        for p in port:
            with np.load(root / "port" / p) as a, \
                    np.load(root / "jax" / p) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].shape == b[k].shape, (p, k)
                    if k in ("time", "lat", "lon", "level"):
                        np.testing.assert_array_equal(a[k], b[k])
                    elif k == "soil_type":
                        _check_laf(a[k], b[k], trees["tree"]["fields"][
                            (0, k, None)], trees["grid"].to_sampling(),
                            build_sampling(*HP4))
                    else:
                        assert _rel(a[k], b[k]) <= 1e-6, (p, k)
    names = {side: sorted(p.name for p in (root / side / "weights")
                          .glob("*.npz")) for side in ("port", "jax")}
    assert names["port"] == names["jax"] == [
        f"weights_conservative_{NATIVE}_{SAMPLING_NAME}.npz",
        f"weights_largest_area_fraction_{NATIVE}_{SAMPLING_NAME}.npz"]
    # the soil type kept its classes (largest area fraction)
    with np.load(root / "port" / trees["port"]["static"][2]) as z:
        assert set(np.unique(z["soil_type"])) <= set(range(7))
    # a second run finds the outputs and remaps nothing
    with mock.patch.dict(pp.NATIVE_GRIDS, {DATASET: NATIVE}):
        assert pp.remap_grib_files(root / "port", DATASET, SAMPLING_NAME,
                                   "dynamic", build_sampling(*HP4),
                                   verbose=False) == []


def test_remap_is_conservative(trees):
    """The ingested z500 keeps the GRIB field's global area-weighted mean
    (2e-3, the bar of tests/test_ingest.py)."""
    from deepsphere_weather_torch.sphere.remap import area_weights

    w_src = area_weights(trees["grid"].to_sampling()).astype(np.float64)
    w_dst = area_weights(build_sampling(*HP4)).astype(np.float64)
    with np.load(trees["port"]["dynamic"][0]) as z:
        dst = z["z"][0, 0].astype(np.float64)
    src = trees["tree"]["fields"][(0, "z", 500)].astype(np.float64)
    m_src, m_dst = w_src @ src / w_src.sum(), w_dst @ dst / w_dst.sum()
    assert abs(m_dst - m_src) / abs(m_src) < 2e-3


def _store(path):
    """Every array of a zarr group with its metadata, by name."""
    out = {}
    for p in sorted(Path(path).iterdir()):
        if (p / ".zarray").exists():
            out[p.name] = (json.loads((p / ".zarray").read_text()),
                           zarrstore.ZarrArray(p)[...])
    return out, json.loads((Path(path) / ".zattrs").read_text())


def test_zarrify_and_rechunk_stores_equal(trees, tmp_path):
    rng = np.random.default_rng(0)
    t0 = np.datetime64("2010-01-01")
    batches = [({"z500": rng.random((4, 48)).astype(np.float32),
                 "t850": rng.random((4, 48)).astype(np.float32)},
                t0 + np.arange(4 * i, 4 * i + 4) * np.timedelta64(6, "h"))
               for i in range(3)]
    samp = build_sampling("healpix", {"subdivisions": 2, "nest": True})
    for mod, side in ((pp, "port"), (jpp, "jax")):
        mod.zarrify_raw_data(tmp_path / side / "t.zarr", batches,
                             time_chunk=5, lat=samp.lat, lon=samp.lon)
        mod.rechunk_to_space_chunked(tmp_path / side / "t.zarr",
                                     tmp_path / side / "s.zarr",
                                     node_chunk=7)
    for name in ("t.zarr", "s.zarr"):
        a, b = _store(tmp_path / "port" / name), _store(tmp_path / "jax"
                                                        / name)
        assert a[1] == b[1] and sorted(a[0]) == sorted(b[0])
        for k in a[0]:
            assert a[0][k][0] == b[0][k][0], k
            np.testing.assert_array_equal(a[0][k][1], b[0][k][1])
    # the chain's stores of one tree: equal arrays, metadata and layout
    for rel in ("Data/dynamic/time_chunked/dynamic.zarr",
                "Data/dynamic/space_chunked/dynamic.zarr",
                "Data/bc/time_chunked/bc.zarr", "Data/static.zarr"):
        a = _store(trees["root"] / "port" / "data" / rel)
        b = _store(trees["root"] / "jax" / "data" / rel)
        assert a[1] == b[1] and sorted(a[0]) == sorted(b[0])
        for k in a[0]:
            assert a[0][k][0] == b[0][k][0], (rel, k)
            if k == "slt":
                _check_laf(a[0][k][1] * 7, b[0][k][1] * 7, trees["tree"][
                    "fields"][(0, "soil_type", None)],
                    trees["grid"].to_sampling(), build_sampling(*HP4))
            else:
                assert _rel(a[0][k][1], b[0][k][1]) <= 1e-6, (rel, k)
    bad = np.array(["2010-01-01", "2010-01-02", "2010-01-04"],
                   dtype="datetime64[ns]")
    for mod in (pp, jpp):
        with pytest.raises(ValueError, match="missing/irregular"):
            mod.check_no_missing_timesteps(bad)


def test_netcdf4_and_external_skill_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(4)
    path = tmp_path / "skill.nc"
    with h5py.File(path, "w") as f:
        lead = f.create_dataset("leadtime", data=np.arange(6, 126, 6.0))
        lead.make_scale("leadtime")
        level = f.create_dataset("level", data=np.array([500, 850]))
        level.make_scale("level")
        for name in ("z500", "t850"):
            d = f.create_dataset(name, data=rng.random(20))
            d.dims[0].attach_scale(lead)
        d = f.create_dataset("z", data=rng.random((20, 2)))
        d.dims[0].attach_scale(lead)
        d.dims[1].attach_scale(level)
    got, want = pp.open_netcdf4(path), jpp.open_netcdf4(path)
    assert sorted(got) == sorted(want)
    assert got["__dims__"] == want["__dims__"] and \
        want["__dims__"]["z"] == ("leadtime", "level")
    for k in got:
        if k != "__dims__":
            np.testing.assert_array_equal(got[k], want[k])
    flat, jflat = pp.reformat_pl(got), jpp.reformat_pl(want)
    assert sorted(flat) == sorted(jflat) and "z850" in flat
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k])
    for kw in ({}, {"variables": ["t850"], "skill_name": "MAE"}):
        s, js = load_external_skill(path, **kw), jload_external_skill(
            path, **kw)
        assert s.feature_order == js.feature_order
        np.testing.assert_array_equal(s.leadtime_hours, js.leadtime_hours)
        for sk in js.skills:
            np.testing.assert_array_equal(s[sk], js[sk])
    with h5py.File(tmp_path / "bad.nc", "w") as f:
        f.create_dataset("z500", data=rng.random(3))
    for load in (load_external_skill, jload_external_skill):
        with pytest.raises(ValueError, match="lead-time"):
            load(tmp_path / "bad.nc")


def test_laf_keeps_empty_rows_empty():
    """A destination row with no source overlap remaps to 0, not to source
    cell 0's class (the JAX package's regression, on the port's copy)."""
    W = sparse.csr_matrix((np.array([0.25, 0.75, 1.0]), np.array([0, 2, 1]),
                           np.array([0, 2, 2, 3])), shape=(3, 4))
    arrays = {"data": W.data, "indices": W.indices, "indptr": W.indptr,
              "shape": np.asarray(W.shape)}
    dst = build_sampling("healpix", {"subdivisions": 1, "nest": True})
    with mock.patch.object(pp, "cached_arrays",
                           side_effect=lambda key, build: arrays):
        laf = pp.remap_weights_for_grid(2, 2, dst,
                                        method="largest_area_fraction")
    np.testing.assert_array_equal(laf.toarray(), [[0, 0, 1, 0],
                                                  [0, 0, 0, 0],
                                                  [0, 1, 0, 0]])
    # LAF and conservative remaps of a class field against JAX's
    field = np.random.default_rng(0).integers(0, 7, (1, 18, 36)).astype(
        np.float32)
    dst, jdst = build_sampling(*HP4), jbuild_sampling(*HP4)
    out = {}
    for method in ("largest_area_fraction", "conservative"):
        out[method] = pp.remap_to_sampling(
            field, dst, weights=pp.remap_weights_for_grid(
                18, 36, dst, cache=False, method=method))
        want = jpp.remap_to_sampling(
            field, jdst, weights=jpp.remap_weights_for_grid(
                18, 36, jdst, cache=False, method=method))
        if method == "conservative":
            assert _rel(out[method], want) <= 1e-6
        else:
            _check_laf(out[method], want, field.reshape(-1), build_sampling(
                "equiangular", {"nlat": 18, "nlon": 36}), dst)
    assert set(np.unique(out["largest_area_fraction"])) <= set(range(7))
    assert not set(np.unique(out["conservative"])) <= set(range(7))
    for name, method in (("slt", "largest_area_fraction"),
                         ("soil_type", "largest_area_fraction"),
                         ("z500", "conservative")):
        assert pp.get_variable_interp_method(name) == method


def test_port_chain_trains_through_the_cli(trees, tmp_path):
    from deepsphere_weather_torch.cli import compute_scalers
    from deepsphere_weather_torch.cli.train_predict import main

    data = trees["root"] / "port" / "data"
    compute_scalers.main(data, verbose=False)
    assert (data / "Scalers" / "GlobalStandardScaler_dynamic.npz").exists()
    cfg = {
        "model_settings": {
            "sampling_name": SAMPLING_NAME, "sampling": HP4[0],
            "sampling_kwargs": HP4[1], "knn": 8,
            "architecture_name": "UNetSpherical", "pool_method": "Max"},
        "training_settings": {
            "epochs": 1, "learning_rate": 0.002, "training_batch_size": 4,
            "validation_batch_size": 4, "scoring_interval": 4},
        "ar_settings": {"input_k": [-3, -2, -1], "output_k": [0],
                        "forecast_cycle": 1, "ar_iterations": 1},
        "dataloader_settings": {"num_workers": 0},
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    exp, gs = main(tmp_path / "config.json", data, tmp_path / "exp",
                   force=True, ar_iterations_prediction=2, verbose=False,
                   device="cpu")
    assert np.isfinite(gs["RMSE"]).all() and gs["RMSE"].shape == (3, 2)
    assert (exp / "model_weights" / "model.npz").exists()
    info = json.loads((exp / "training_info" / "ar_training_info.json")
                      .read_text())
    assert info["iterations"] and np.isfinite(
        info["training_total_loss"]).all()


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("case", ["missing_timestep", "classic_reduced_pl"])
def test_adversarial_ingest(case, side, tmp_path):
    """tests/test_ingest.py's adversarial cases in either package: a GRIB
    archive with a missing analysis fails `zarrify_raw_data`; a classic
    reduced Gaussian grid (non-octahedral pl, carried by the file)
    round-trips and remaps conservatively (global mean within 2e-3)."""
    g, mod = (grib, pp) if side == "port" else (jgrib, jpp)
    build_s = build_sampling if side == "port" else jbuild_sampling
    if case == "missing_timestep":
        grid = g.GridSpec("regular_ll", 8, nlon=16)
        rng = np.random.default_rng(3)
        times = np.array(["2010-01-01T00", "2010-01-01T06",
                          "2010-01-01T18"], dtype="datetime64[ns]")
        g.write_grib2(tmp_path / "gap.grib", [g.GribRecord(
            "t", rng.normal(270, 10, grid.n_points).astype(np.float32), t,
            grid, level_hPa=850) for t in times])
        fields, tt, _ = g.read_grib2(tmp_path / "gap.grib")
        lat, lon = grid.latlon()
        with pytest.raises(ValueError, match="missing/irregular timesteps"):
            mod.zarrify_raw_data(tmp_path / "d.zarr",
                                 [({"t850": fields["t"][:, 0]}, tt)],
                                 time_chunk=4, lat=lat, lon=lon)
        return
    half = [16, 20, 24, 28, 32, 32, 36, 36]
    pl = tuple(half + half[::-1])
    grid = g.GridSpec("reduced_gg", 16, pl=pl)
    lat, lon = grid.latlon()
    f = (250.0 + 30.0 * np.sin(np.deg2rad(lat)) ** 2
         + 2.0 * np.cos(2 * np.deg2rad(lon))).astype(np.float32)
    g.write_grib2(tmp_path / "n8.grib", [g.GribRecord(
        "t", f, np.datetime64("2010-01-01T00"), grid, level_hPa=850)])
    fields, _, g2 = g.read_grib2(tmp_path / "n8.grib")
    assert g2.pl == pl
    dst = build_s(*HP4)
    W, w_src, w_dst = (compute_interpolation_weights if side == "port"
                       else jweights)(g2.to_sampling(), dst)
    from_remap = mod.remap_to_sampling(fields["t"][0, 0][None], dst,
                                       weights=W)[0]
    m_src = float(w_src @ f.astype(np.float64) / w_src.sum())
    m_dst = float(w_dst @ from_remap.astype(np.float64) / w_dst.sum())
    assert abs(m_dst - m_src) / abs(m_src) < 2e-3
