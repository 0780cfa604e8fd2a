"""Spherical sampling definitions (numpy; the port's own copy).

Mirrors `deepsphere_weather_tpu/sphere/samplings.py`: the five families
and their builders, with the same arithmetic, so the pixel centers are
bit-equal to the JAX package's and `Sampling.cache_key()` names the same
cache files:

- healpix       (subdivisions=nside, nest=True)
- equiangular   (nlat, nlon)
- icosahedral   (subdivisions)
- cubed         (subdivisions)
- gauss         (nlat, nlon='ecmwf-octahedral', an int or a pl list)

Each builder returns pixel-center (lon, lat) in degrees.
`coarsen_sampling_kwargs` is the UNet pyramid's coarsening rule.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np

from .healpix import healpix_lonlat

__all__ = [
    "Sampling",
    "build_sampling",
    "coarsen_sampling_kwargs",
    "check_sampling",
    "check_conv_type",
    "check_pool_method",
    "check_skip_connection",
    "VALID_SAMPLINGS",
]

VALID_SAMPLINGS = ("healpix", "equiangular", "icosahedral", "cubed", "gauss")


@dataclasses.dataclass(frozen=True)
class Sampling:
    """A spherical sampling: pixel centers + identity metadata."""

    name: str                 # one of VALID_SAMPLINGS
    kwargs: tuple             # canonicalized (key, value) pairs -> hashable cache key
    lon: np.ndarray           # degrees, [0, 360)
    lat: np.ndarray           # degrees, [-90, 90]

    @property
    def n_nodes(self) -> int:
        return int(self.lon.shape[0])

    @property
    def coords_3d(self) -> np.ndarray:
        """Unit-sphere xyz coordinates, shape (n_nodes, 3)."""
        lon = np.deg2rad(self.lon)
        lat = np.deg2rad(self.lat)
        return np.stack(
            [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
            axis=1,
        )

    @property
    def kwargs_dict(self) -> Dict:
        return dict(self.kwargs)

    def cache_key(self) -> str:
        """Same key as the JAX package, so both stacks share cache files."""
        def short(v):
            if isinstance(v, tuple) and len(v) > 8:
                h = hashlib.sha1(repr(v).encode()).hexdigest()[:12]
                return f"seq{len(v)}-{h}"
            return v
        items = "_".join(f"{k}-{short(v)}" for k, v in sorted(self.kwargs))
        return f"{self.name}_{items}"


def _canon_kwargs(kwargs: Dict) -> tuple:
    def canon(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return tuple(int(x) for x in np.asarray(v).ravel())
        return v
    return tuple(sorted((str(k), canon(kwargs[k])) for k in kwargs))


def _healpix(subdivisions: int, nest: bool = True) -> tuple:
    lon, lat = healpix_lonlat(subdivisions, nest=nest)
    return lon, lat


def _equiangular(nlat: int, nlon: int) -> tuple:
    """Equiangular (regular lat/lon) grid; cell-center convention.

    Row-major flattening (lat ring, then lon) matches the reference's 1d<->2d
    reshape contract (reference: modules/layers.py:408-426).
    """
    lat_1d = 90.0 - (np.arange(nlat) + 0.5) * (180.0 / nlat)
    lon_1d = (np.arange(nlon)) * (360.0 / nlon)
    lon2d, lat2d = np.meshgrid(lon_1d, lat_1d)
    return lon2d.ravel(), lat2d.ravel()


def _icosahedral(subdivisions: int) -> tuple:
    """Icosahedral sampling: subdivided icosahedron vertices projected to the sphere.

    `subdivisions` is the number of edge splits per subdivision level being a
    power of two in the reference configs; here it is the subdivision frequency
    (each original edge is split into `subdivisions` segments), giving
    n = 10*subdivisions^2 + 2 vertices.
    """
    f = int(subdivisions)
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    # Collect unique vertices of the subdivided mesh via barycentric lattice points.
    pts = [verts]
    for (a, b, c) in faces:
        va, vb, vc = verts[a], verts[b], verts[c]
        for i in range(f + 1):
            for j in range(f + 1 - i):
                k = f - i - j
                if (i == f) or (j == f) or (k == f):
                    continue  # corner: already in verts
                p = (i * va + j * vb + k * vc) / f
                pts.append(p[None, :])
    pts = np.concatenate(pts, axis=0)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    # Deduplicate edge points shared between faces.
    key = np.round(pts * 1e8).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    pts = pts[np.sort(idx)]
    lat = np.rad2deg(np.arcsin(np.clip(pts[:, 2], -1, 1)))
    lon = np.rad2deg(np.arctan2(pts[:, 1], pts[:, 0])) % 360.0
    return lon, lat


def _cubed(subdivisions: int) -> tuple:
    """Equiangular cubed-sphere: 6 faces x subdivisions^2 cell centers."""
    n = int(subdivisions)
    # cell-centered equiangular coordinates on each face
    a = (np.arange(n) + 0.5) / n * (np.pi / 2) - np.pi / 4
    xa, ya = np.meshgrid(np.tan(a), np.tan(a))
    ones = np.ones_like(xa)
    faces = [
        np.stack([ones, xa, ya], -1),      # +x
        np.stack([-ones, -xa, ya], -1),    # -x
        np.stack([-xa, ones, ya], -1),     # +y
        np.stack([xa, -ones, ya], -1),     # -y
        np.stack([ya, xa, ones], -1),      # +z
        np.stack([ya, -xa, -ones], -1),    # -z  (sign keeps orientation consistent)
    ]
    pts = np.concatenate([f.reshape(-1, 3) for f in faces], axis=0)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    lat = np.rad2deg(np.arcsin(np.clip(pts[:, 2], -1, 1)))
    lon = np.rad2deg(np.arctan2(pts[:, 1], pts[:, 0])) % 360.0
    return lon, lat


def _gauss(nlat: int, nlon="ecmwf-octahedral") -> tuple:
    """Gauss-Legendre grid: Gaussian latitudes x (regular | reduced) lon.

    nlat is the total number of Gaussian latitudes (both hemispheres); the
    ECMWF octahedral reduced grid O{nlat/2} puts 20 + 4*i points on the i-th
    ring from each pole (reference scalability grids O24..O320,
    scripts_figs/scalability_plot.py:68-216). nlon may also be an explicit
    per-row point-count sequence (len nlat) — the `pl` list carried by
    reduced-Gaussian GRIB files (e.g. ERA5's N320), see data/grib.py.
    """
    nlat = int(nlat)
    nodes, _ = np.polynomial.legendre.leggauss(nlat)
    # leggauss returns ascending nodes = sin(lat); order north->south like ECMWF
    lat_1d = np.rad2deg(np.arcsin(nodes))[::-1]
    pl = None
    if isinstance(nlon, (list, tuple, np.ndarray)):
        pl = [int(x) for x in nlon]
        if len(pl) != nlat:
            raise ValueError(f"explicit pl list has {len(pl)} rows for "
                             f"nlat={nlat}")
    lons, lats = [], []
    for i, lat in enumerate(lat_1d):
        if pl is not None:
            n_i = pl[i]
        elif isinstance(nlon, str):
            if nlon != "ecmwf-octahedral":
                raise ValueError(f"unknown reduced grid spec {nlon!r}")
            ring = min(i, nlat - 1 - i)
            n_i = 20 + 4 * ring
        else:
            n_i = int(nlon)
        lons.append(np.arange(n_i) * (360.0 / n_i))
        lats.append(np.full(n_i, lat))
    return np.concatenate(lons), np.concatenate(lats)


_BUILDERS = {
    "healpix": _healpix,
    "equiangular": _equiangular,
    "icosahedral": _icosahedral,
    "cubed": _cubed,
    "gauss": _gauss,
}


def build_sampling(name: str, sampling_kwargs: Dict) -> Sampling:
    name = check_sampling(name)
    kwargs = {k: v for k, v in sampling_kwargs.items() if k not in ("k", "lap_type")}
    lon, lat = _BUILDERS[name](**kwargs)
    return Sampling(name=name, kwargs=_canon_kwargs(kwargs), lon=lon, lat=lat)


def coarsen_sampling_kwargs(name: str, sampling_kwargs: Dict, coarsening: int) -> Dict:
    """Graph coarsening rule per sampling (reference: modules/utils_models.py:91-102)."""
    name = check_sampling(name)
    kw = dict(sampling_kwargs)
    if name == "equiangular":
        kw["nlat"] = kw["nlat"] // coarsening
        kw["nlon"] = kw["nlon"] // coarsening
    elif name in ("healpix", "icosahedral", "cubed"):
        kw["subdivisions"] = kw["subdivisions"] // coarsening
    elif name == "gauss":
        kw["nlat"] = kw["nlat"] // coarsening
    return kw


def check_sampling(sampling: str) -> str:
    if not isinstance(sampling, str):
        raise TypeError("'sampling' must be a string")
    s = sampling.lower()
    if s not in VALID_SAMPLINGS:
        raise ValueError(f"'sampling' must be one of {VALID_SAMPLINGS}, got {sampling!r}")
    return s


def check_conv_type(conv_type: str, sampling: Optional[str] = None) -> str:
    if not isinstance(conv_type, str):
        raise TypeError("'conv_type' must be a string")
    c = conv_type.lower()
    if c not in ("graph", "image"):
        raise ValueError("'conv_type' must be 'graph' or 'image'")
    if c == "image" and sampling is not None and check_sampling(sampling) != "equiangular":
        raise ValueError("conv_type='image' is only valid for sampling='equiangular'")
    return c


def check_pool_method(pool_method: str) -> str:
    if not isinstance(pool_method, str):
        raise TypeError("'pool_method' must be a string")
    p = pool_method.lower()
    valid = ("max", "avg", "interp", "maxval", "maxarea", "learn")
    if p not in valid:
        raise ValueError(f"'pool_method' must be one of {valid}, got {pool_method!r}")
    return p


def check_skip_connection(skip_connection) -> str:
    if skip_connection is None:
        skip_connection = "none"
    if not isinstance(skip_connection, str):
        raise TypeError("'skip_connection' must be a string")
    s = skip_connection.lower()
    if s not in ("none", "stack", "sum", "avg"):
        raise ValueError("'skip_connection' must be one of none/stack/sum/avg")
    return s
