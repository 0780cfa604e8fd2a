"""The port's GRIB2 codec (`deepsphere_weather_torch/data/grib.py`) vs the
JAX package's.

- `write_grib2` of the same records gives byte-identical files in both
  packages: reduced (octahedral and classic) and regular Gaussian grids,
  regular lat/lon, isobaric stacks, TOA and surface fields, constant
  fields (0-bit packing), NaN points (section-6 bitmap), 2 m / 10 m names;
- `read_grib2` of those files gives exactly equal fields, times and
  `GridSpec`s in both;
- the golden messages of `tests/test_grib_golden.py` (built octet by octet
  from the WMO spec, never by a writer) decode to the hand-computed values
  in both packages, and the corrupt ones are refused by both;
- the simple-packing helpers at every bit width 1-24 and the
  sign-magnitude integers agree exactly.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from test_grib_golden import (  # noqa: E402
    grib2_message,
    ident_section,
    latlon_grid_section,
    pack_msb,
    product_section,
    reduced_gaussian_grid_section,
    repr_section,
    section,
    u,
)

from deepsphere_weather_tpu.data import grib as jgrib  # noqa: E402

from deepsphere_weather_torch.data import grib as pgrib  # noqa: E402

PACKAGES = {"jax": jgrib, "port": pgrib}
T0 = np.datetime64("2010-01-01T00")


def _grid(pkg, kind, nlat, nlon=None, pl=None):
    return pkg.GridSpec(kind, nlat, nlon=nlon, pl=pl)


def _records(pkg, case):
    """The records of one case, built from one seed in either package."""
    rng = np.random.default_rng(CASES.index(case))
    times = [T0 + np.timedelta64(6 * i, "h") for i in range(3)]
    if case == "octahedral_levels":
        grid = _grid(pkg, "reduced_gg", 16, pl=pkg.octahedral_pl(8))
        return [pkg.GribRecord(var, (base + 50 * rng.standard_normal(
                    grid.n_points)).astype(np.float32), t, grid,
                    level_hPa=lev)
                for t in times
                for var, lev, base in (("z", 500, 54000.0),
                                       ("z", 850, 14000.0),
                                       ("t", 500, 253.0), ("t", 850, 281.0))]
    if case == "classic_reduced_toa":
        half = [16, 20, 24, 28, 32, 32, 36, 36]
        grid = _grid(pkg, "reduced_gg", 16, pl=tuple(half + half[::-1]))
        return [pkg.GribRecord("tisr", (1e7 * rng.random(grid.n_points))
                               .astype(np.float32), t, grid, surface_type=8)
                for t in times]
    if case == "regular_gaussian":
        grid = pkg.GridSpec.from_name("F8")
        return [pkg.GribRecord("msl", 1e5 + 300 * rng.standard_normal(
            grid.n_points), t, grid) for t in times]
    if case == "latlon_statics":
        grid = _grid(pkg, "regular_ll", 24, nlon=48)
        lsm = (rng.random(grid.n_points) > 0.5).astype(np.float32)
        return [pkg.GribRecord("land_sea_mask", lsm, T0, grid),
                pkg.GribRecord("soil_type", np.full(grid.n_points, 3.0),
                               T0, grid),
                pkg.GribRecord("topography", 800 * rng.random(
                    grid.n_points), T0, grid)]
    if case == "bitmap_nan":
        grid = _grid(pkg, "regular_ll", 8, nlon=16)
        vals = rng.normal(0.5, 0.2, grid.n_points).astype(np.float32)
        vals[rng.random(grid.n_points) > 0.6] = np.nan
        return [pkg.GribRecord("soil_type", vals, T0, grid)]
    if case == "height_above_ground":
        grid = _grid(pkg, "regular_ll", 4, nlon=8)
        return [pkg.GribRecord("2t", 280 + rng.random(32), t, grid)
                for t in times] + [
            pkg.GribRecord("10u", -5 + rng.random(32), t, grid)
            for t in times]
    raise KeyError(case)


CASES = ["octahedral_levels", "classic_reduced_toa", "regular_gaussian",
         "latlon_statics", "bitmap_nan", "height_above_ground"]


def _same_read(a, b):
    """Two `read_grib2` results: exactly equal fields (NaN where NaN),
    times and grids."""
    (fa, ta, ga), (fb, tb, gb) = a, b
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k])
    np.testing.assert_array_equal(ta, tb)
    assert ta.dtype == tb.dtype
    assert dataclasses.astuple(ga) == dataclasses.astuple(gb)


@pytest.mark.parametrize("case", CASES)
def test_write_grib2_bytes_identical(case, tmp_path):
    paths = {name: pkg.write_grib2(tmp_path / f"{name}.grib",
                                   _records(pkg, case))
             for name, pkg in PACKAGES.items()}
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()


@pytest.mark.parametrize("case", CASES)
def test_read_grib2_equal(case, tmp_path):
    path = jgrib.write_grib2(tmp_path / "c.grib", _records(jgrib, case))
    port = pgrib.read_grib2(path)
    _same_read(port, jgrib.read_grib2(path))
    # the port reads its own file as it reads the JAX package's
    _same_read(pgrib.read_grib2(pgrib.write_grib2(
        tmp_path / "p.grib", _records(pgrib, case))), port)


# --- the golden messages of tests/test_grib_golden.py ------------------

LL = dict(nlat=2, nlon=3, la1=45_000_000, lo1=0, la2=-45_000_000,
          lo2=240_000_000, di=120_000_000, dj=90_000_000)


def _golden(case):
    """(message bytes, check(read result, package)) of one golden case."""
    if case == "latlon_negative_scales":
        xs = [0, 1, 2, 3, 4, 5]
        msg = grib2_message(0, [
            ident_section(2020, 1, 15, 12), latlon_grid_section(**LL),
            product_section(category=0, number=0, sfc_type=100,
                            sfc_scale=0, sfc_value=85_000),
            repr_section(n_packed=6, R=-2.5, E=-1, D=1, nbits=4),
            section(6, u(255, 1)), section(7, pack_msb(xs, 4))])

        def check(res, pkg):
            fields, times, grid = res
            assert grid == pkg.GridSpec("regular_ll", 2, nlon=3)
            np.testing.assert_array_equal(times, np.array(
                ["2020-01-15T12:00:00"], dtype="datetime64[ns]"))
            assert list(fields["level"]) == [850]
            np.testing.assert_allclose(
                fields["t"][0, 0], [(-2.5 + x * 0.5) / 10.0 for x in xs],
                rtol=0, atol=1e-6)
        return msg, check
    if case == "reduced_gaussian_pl":
        pl = (2, 3, 3, 2)
        msg = grib2_message(0, [
            ident_section(2021, 7, 1, 0),
            reduced_gaussian_grid_section(nlat=4, pl=pl),
            product_section(category=3, number=4, sfc_type=100,
                            sfc_scale=0, sfc_value=50_000),
            repr_section(n_packed=10, R=50_000.0, E=2, D=0, nbits=8),
            section(6, u(255, 1)), section(7, pack_msb(range(10), 8))])

        def check(res, pkg):
            fields, _, grid = res
            assert grid.kind == "reduced_gg" and grid.pl == pl
            assert grid.n_points == 10 and list(fields["level"]) == [500]
            np.testing.assert_allclose(
                fields["z"][0, 0], [50_000.0 + 4.0 * x for x in range(10)],
                rtol=0, atol=1e-2)
        return msg, check
    if case == "bitmap":
        msg = grib2_message(2, [
            ident_section(2020, 6, 1, 6), latlon_grid_section(**LL),
            product_section(category=0, number=0, sfc_type=1, sfc_scale=0,
                            sfc_value=0),
            repr_section(n_packed=4, R=0.0, E=0, D=0, nbits=8),
            section(6, u(0, 1) + bytes([0b10110100])),
            section(7, pack_msb([7, 11, 13, 17], 8))])

        def check(res, pkg):
            vals = res[0]["land_sea_mask"][0]
            np.testing.assert_allclose(vals[[0, 2, 3, 5]], [7, 11, 13, 17])
            assert np.isnan(vals[[1, 4]]).all()
        return msg, check
    if case == "height_above_ground":
        xs = list(range(6))

        def msg_of(cat, num, sfc_type, sfc_value, R):
            return grib2_message(0, [
                ident_section(2020, 1, 1, 0), latlon_grid_section(**LL),
                product_section(category=cat, number=num, sfc_type=sfc_type,
                                sfc_scale=0, sfc_value=sfc_value),
                repr_section(6, R=R, E=0, D=0, nbits=4),
                section(6, u(255, 1)), section(7, pack_msb(xs, 4))])
        msg = (msg_of(0, 0, 103, 2, 250.0) + msg_of(2, 2, 103, 10, -3.0)
               + msg_of(19, 3, 1, 0, 0.0))

        def check(res, pkg):
            fields = res[0]
            assert set(fields) == {"2t", "10u", "param_0_19_3"}
            np.testing.assert_allclose(fields["2t"][0], [250 + x for x in xs])
            np.testing.assert_allclose(fields["10u"][0], [-3 + x for x in xs])
        return msg, check
    if case == "surface_scale":
        msg = grib2_message(0, [
            ident_section(2020, 1, 1, 0), latlon_grid_section(**LL),
            product_section(category=0, number=0, sfc_type=100,
                            sfc_scale=-1, sfc_value=8_500),
            repr_section(6, R=250.0, E=0, D=0, nbits=4),
            section(6, u(255, 1)), section(7, pack_msb(range(6), 4))])

        def check(res, pkg):
            assert list(res[0]["level"]) == [850]
        return msg, check
    raise KeyError(case)


GOLDEN = ["latlon_negative_scales", "reduced_gaussian_pl", "bitmap",
          "height_above_ground", "surface_scale"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("case", GOLDEN)
def test_golden_messages(case, pkg, tmp_path):
    msg, check = _golden(case)
    path = tmp_path / "golden.grib2"
    path.write_bytes(msg)
    res = PACKAGES[pkg].read_grib2(path)
    check(res, PACKAGES[pkg])
    if pkg == "port":
        _same_read(res, jgrib.read_grib2(path))


def _bad_bitmap():
    return grib2_message(2, [
        ident_section(2020, 6, 1, 6), latlon_grid_section(**LL),
        product_section(category=0, number=0, sfc_type=1, sfc_scale=0,
                        sfc_value=0),
        repr_section(n_packed=3, R=0.0, E=0, D=0, nbits=8),
        section(6, u(0, 1) + bytes([0b11110000])),
        section(7, pack_msb([1, 2, 3], 8))])


def _mixed_grids():
    def one(nlon):
        ll = dict(LL, nlon=nlon)
        return grib2_message(0, [
            ident_section(2020, 1, 1, 0), latlon_grid_section(**ll),
            product_section(category=0, number=0, sfc_type=1, sfc_scale=0,
                            sfc_value=0),
            repr_section(2 * nlon, R=0.0, E=0, D=0, nbits=4),
            section(6, u(255, 1)), section(7, pack_msb(range(2 * nlon), 4))])
    return one(3) + one(4)


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("case,match", [
    ("bad_bitmap", "bitmap"), ("mixed_grids", "mixed grids"),
    ("not_grib", "no GRIB2 messages"), ("missing_message", "missing"),
    ("no_trailer", "7777")])
def test_corrupt_files_refused(case, match, pkg, tmp_path):
    path = tmp_path / "bad.grib2"
    if case == "bad_bitmap":
        path.write_bytes(_bad_bitmap())
    elif case == "mixed_grids":
        path.write_bytes(_mixed_grids())
    elif case == "not_grib":
        path.write_bytes(b"not a grib message")
    elif case == "missing_message":
        # one (time, level) of one variable absent from the file
        jgrib.write_grib2(path, _records(jgrib, "octahedral_levels")[:-1])
    else:
        good = jgrib.write_grib2(tmp_path / "g.grib2",
                                 _records(jgrib, "bitmap_nan")).read_bytes()
        path.write_bytes(good[:-4] + b"8888")
    with pytest.raises(ValueError, match=match):
        PACKAGES[pkg].read_grib2(path)


# --- packing helpers ----------------------------------------------------

@pytest.mark.parametrize("nbits", list(range(1, 25)))
def test_simple_packing_matches_jax(nbits):
    v = np.random.default_rng(nbits).normal(scale=100.0, size=257) - 50.0
    X, R, E, D, nb = pgrib._pack_simple(v, nbits=nbits)
    jX, jR, jE, jD, jnb = jgrib._pack_simple(v, nbits=nbits)
    np.testing.assert_array_equal(X, jX)
    assert (R, E, D, nb) == (jR, jE, jD, jnb) and nb == nbits
    raw = pgrib._bits_to_bytes(X, nbits)
    assert raw == jgrib._bits_to_bytes(jX, nbits)
    y = pgrib._bytes_to_values(raw, v.size, nbits, float(R), E, D)
    np.testing.assert_array_equal(
        y, jgrib._bytes_to_values(raw, v.size, nbits, float(R), E, D))
    assert np.max(np.abs(y - v)) <= 2.0 ** E * (1 + 1e-6)


@pytest.mark.parametrize("value,width", [
    (0, 1), (-1, 1), (127, 1), (-127, 1), (300, 2), (-300, 2),
    (-32767, 2), (45_000_000, 4), (-45_000_000, 4)])
def test_sign_magnitude_matches_jax(value, width):
    wire = pgrib._s(value, width)
    assert wire == jgrib._s(value, width)
    assert pgrib._read_s(wire, 0, width) == value


def test_grid_helpers_match_jax():
    for n in (8, 32, 320):
        assert pgrib.octahedral_pl(n) == jgrib.octahedral_pl(n)
        np.testing.assert_array_equal(pgrib.gaussian_latitudes(2 * n),
                                      jgrib.gaussian_latitudes(2 * n))
    for name in ("O32", "F80", "N320"):
        assert dataclasses.astuple(pgrib.GridSpec.from_name(name)) == \
            dataclasses.astuple(jgrib.GridSpec.from_name(name))
    grid = pgrib.GridSpec("reduced_gg", 64, pl=pgrib.octahedral_pl(32))
    jg = jgrib.GridSpec("reduced_gg", 64, pl=jgrib.octahedral_pl(32))
    assert grid.n_points == 5248
    for a, b in zip(grid.latlon(), jg.latlon()):
        np.testing.assert_array_equal(a, b)
    assert grid.to_sampling().cache_key() == jg.to_sampling().cache_key()
    with pytest.raises(ValueError, match="unknown grid name"):
        pgrib.GridSpec.from_name("X12")
    with pytest.raises(ValueError, match="unknown shortname"):
        pgrib.write_grib2("/dev/null", [pgrib.GribRecord(
            "nope", np.zeros(4), T0, pgrib.GridSpec("regular_ll", 2,
                                                    nlon=2))])
